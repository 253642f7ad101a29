"""CLIP byte-level BPE tokenizer (host-side, pure python).

Counterpart of hipie_tpu/models/text/clip_tokenizer.py (the same code, kept in
the port so that it imports nothing of the JAX package).

Implements the openai-CLIP / open_clip tokenization scheme used by the
reference's frozen MaskCLIP text tower (reference: hipie/open_vocab/clip.py
ClipAdapter.build_text_embed tokenizes via open_clip.tokenize):
  * byte -> printable-unicode table, lowercased + whitespace-cleaned text,
  * regex word splitting (contractions, letters, numbers, other),
  * BPE merges ranked by a merges file (`bpe_simple_vocab_16e6.txt` layout:
    first line is a header, each following line "tok_a tok_b"),
  * every word ends with '</w>'; special tokens <start_of_text>/<end_of_text>,
  * context length 77, sequences truncated with EOT forced at the end.

No merges file ships with this repo: pass the
open_clip merges file path to `CLIPTokenizer.from_merges_file`, or use
`CLIPTokenizer.toy()` in tests (a miniature merge table with identical
mechanics).
"""

from __future__ import annotations

import functools
import gzip
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable unicode mapping (GPT-2/CLIP standard)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# openai-CLIP uses \p{L}/\p{N} via the `regex` package; ascii classes cover the
# English label sets the reference ships (openseg_labels/*)
_WORD_RE = re.compile(
    r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE)


class CLIPTokenizer:
    """Byte-level BPE with the CLIP merge table."""

    def __init__(self, merges: Sequence[Tuple[str, str]], context_length: int = 77):
        self.byte_encoder = bytes_to_unicode()
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.cache = {"<start_of_text>": "<start_of_text>",
                      "<end_of_text>": "<end_of_text>"}
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]
        self.context_length = context_length

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_merges_file(cls, path: str, context_length: int = 77) -> "CLIPTokenizer":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # open_clip layout: lines[1 : 49152-256-2+1] are the merges
        merges = [tuple(l.split()) for l in lines[1:49152 - 256 - 2 + 1]
                  if len(l.split()) == 2]
        return cls(merges, context_length)

    @classmethod
    def toy(cls, context_length: int = 77) -> "CLIPTokenizer":
        """Miniature merge table for tests — same mechanics, tiny vocab."""
        words = ["person", "dog", "cat", "photo", "scene", "a", "the",
                 "small", "medium", "large", "this", "is", "there", "in", "of"]
        merges: List[Tuple[str, str]] = []
        seen = set()
        for w in words:
            # build left-to-right merges for each word ending in </w>
            parts = list(w[:-1]) + [w[-1] + "</w>"]
            while len(parts) > 1:
                pair = (parts[0], parts[1])
                if pair not in seen:
                    seen.add(pair)
                    merges.append(pair)
                parts = [parts[0] + parts[1]] + parts[2:]
        return cls(merges, context_length)

    # -- bpe ------------------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = whitespace_clean(text).lower()
        ids: List[int] = []
        for token in _WORD_RE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" ")
                       if t in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize to (N, context_length) int32, sot ... eot, zero-padded;
        over-length sequences are truncated with eot forced last (open_clip)."""
        n = len(texts)
        out = np.zeros((n, self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode_text(t) + [self.eot]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
