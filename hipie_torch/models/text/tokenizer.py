"""Host-side WordPiece tokenizer (bert-base-uncased compatible).

Counterpart of hipie_tpu/models/text/tokenizer.py (the same code, kept in the
port so that it imports nothing of the JAX package).

The reference relies on HF `AutoTokenizer.from_pretrained("projects/HIPIE/bert-base-uncased")`
(hipie_img.py:150-160). This environment has no network and no bundled vocab, so we
implement WordPiece directly: given the standard `vocab.txt` of bert-base-uncased the
outputs (ids + offsets) match HF's BertTokenizerFast for the prompts HIPIE builds.
A deterministic toy vocab is generated for unit tests.

Offsets are char-level (start, end) per token, which is what the positive-map builder
needs (reference: coco_dataset_mapper_uni.py create_positive_map uses
tokenizer(..., return_offsets_mapping-like charspans via tokenized.char_to_token).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


class WordPieceTokenizer:
    """Lowercasing BasicTokenizer + WordPiece with char offsets."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        self.cls_token_id = vocab["[CLS]"]
        self.sep_token_id = vocab["[SEP]"]
        self.pad_token_id = vocab["[PAD]"]
        self.unk_token_id = vocab[unk_token]
        # '.' id, used as the class separator / sentence splitter.
        self.dot_token_id = vocab.get(".", self.unk_token_id)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @classmethod
    def toy(cls, words: Sequence[str] = ()) -> "WordPieceTokenizer":
        """Deterministic small vocab for tests: specials + single chars +
        ##-continuation chars + words.

        The ## continuation pieces make the toy tokenizer TOTAL over ascii
        words (any word decomposes into char pieces) — without them every
        multi-char word hit [UNK], which collapsed all class names to ONE
        embedding and made VL class logits class-independent end to end
        (root cause of the round-4 overfit eval collapse, TRAINLOG.md)."""
        tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."]
        tokens += [chr(c) for c in range(ord("a"), ord("z") + 1)]
        tokens += [str(d) for d in range(10)]
        tokens += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
        tokens += ["##" + str(d) for d in range(10)]
        for w in words:
            if w not in tokens:
                tokens.append(w)
        return cls({t: i for i, t in enumerate(tokens)})

    # -- basic tokenization ------------------------------------------------

    def _clean(self, text: str) -> str:
        return "".join(" " if _is_whitespace(c) else c
                       for c in text if c != "\x00" and not _is_control(c))

    def _basic_tokenize(self, text: str) -> List[Tuple[str, int, int]]:
        """Split on whitespace and punctuation; returns (word, start, end)."""
        text = self._clean(text)
        words: List[Tuple[str, int, int]] = []
        i = 0
        n = len(text)
        while i < n:
            ch = text[i]
            if _is_whitespace(ch):
                i += 1
                continue
            if _is_punctuation(ch):
                words.append((ch, i, i + 1))
                i += 1
                continue
            j = i
            while j < n and not _is_whitespace(text[j]) and not _is_punctuation(text[j]):
                j += 1
            words.append((text[i:j], i, j))
            i = j
        return words

    def _wordpiece(self, word: str) -> Optional[List[str]]:
        if len(word) > self.max_chars_per_word:
            return None
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return None
            pieces.append(piece)
            start = end
        return pieces

    # -- public API ---------------------------------------------------------

    def tokenize(self, text: str):
        """Returns (ids, offsets) WITHOUT special tokens. offsets: [(start, end)]."""
        ids: List[int] = []
        offsets: List[Tuple[int, int]] = []
        for word, s, e in self._basic_tokenize(text):
            w = word.lower() if self.do_lower_case else word
            if self.do_lower_case:
                w = "".join(c for c in unicodedata.normalize("NFD", w)
                            if unicodedata.category(c) != "Mn")
            pieces = self._wordpiece(w)
            if pieces is None:
                ids.append(self.unk_token_id)
                offsets.append((s, e))
                continue
            pos = 0
            for p in pieces:
                plen = len(p) - 2 if p.startswith("##") else len(p)
                ids.append(self.vocab[p])
                offsets.append((s + pos, min(s + pos + plen, e)))
                pos += plen
        return ids, offsets

    def encode(self, text: str, max_len: int = 512, pad_to_max: bool = True):
        """[CLS] + tokens + [SEP], truncated/padded. Returns dict of python lists.

        offsets for special/pad tokens are (0, 0) like HF fast tokenizers.
        """
        ids, offsets = self.tokenize(text)
        ids = ids[: max_len - 2]
        offsets = offsets[: max_len - 2]
        input_ids = [self.cls_token_id] + ids + [self.sep_token_id]
        out_offsets = [(0, 0)] + offsets + [(0, 0)]
        attn = [1] * len(input_ids)
        if pad_to_max:
            pad = max_len - len(input_ids)
            input_ids += [self.pad_token_id] * pad
            out_offsets += [(0, 0)] * pad
            attn += [0] * pad
        return {"input_ids": input_ids, "attention_mask": attn, "offsets": out_offsets}

    def char_to_token(self, offsets: Sequence[Tuple[int, int]], char_idx: int) -> Optional[int]:
        """Token index containing char position, mirroring HF char_to_token."""
        for ti, (s, e) in enumerate(offsets):
            if s <= char_idx < e:
                return ti
        return None
