"""Long-prompt (>512 tokens) chunked BERT encoding.

Counterpart of hipie_tpu/models/text/frontend.py (reference bert_model.py:60-135).
Open-vocab label-set prompts (Pascal-Context-459, ADE-847; 1536 tokens) exceed
BERT's 512 positions. The token stream is split at '.'/EOS separators into
chunks of at most 510 tokens; continuation chunks get a [CLS] in front; each
chunk is encoded on its own and its hidden states are copied back to their
positions in the stream. Positions after the last separator stay zero.

``plan_chunks`` is host code over numpy, the same as the JAX package's;
``encode_long_prompt`` encodes the (n_chunks, 512) batch in one call.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

CLS_ID = 101
EOS_ID = 102
PAD_ID = 0


class ChunkPlan(NamedTuple):
    chunk_ids: np.ndarray      # (n_chunks, 512) int32
    chunk_mask: np.ndarray     # (n_chunks, 512) int32
    src_spans: List[Tuple[int, int]]   # in-chunk (start, end) to copy
    tgt_spans: List[Tuple[int, int]]   # positions in the original stream


def plan_chunks(input_ids: np.ndarray, attn_mask: np.ndarray,
                sep_id: int) -> ChunkPlan:
    """Split a (L,) token stream at separators into <=510-token chunks."""
    ids = np.asarray(input_ids).copy()
    mask = np.asarray(attn_mask).copy()
    chunks_ids, chunks_mask, src_spans, tgt_spans = [], [], [], []
    begin = 0
    start_src = 0
    cur_ids, cur_mask = ids, mask
    while True:
        seps = np.where((cur_ids == sep_id) | (cur_ids == EOS_ID))[0]
        seps = seps[seps < 510]
        if len(seps) == 0:
            break
        last = int(seps[-1])
        piece = cur_ids[: last + 1].copy()
        piece[-1] = EOS_ID
        piece_mask = cur_mask[: last + 1]
        l_valid = len(piece)
        out_ids = np.full(512, PAD_ID, ids.dtype)
        out_mask = np.zeros(512, mask.dtype)
        if start_src == 0:
            out_ids[:l_valid] = piece
            out_mask[:l_valid] = piece_mask
            src_spans.append((0, l_valid))
        else:
            out_ids[0] = CLS_ID
            out_ids[1:1 + l_valid] = piece
            if l_valid + 1 < 512:
                out_ids[1 + l_valid] = sep_id
            out_mask[0] = 1
            out_mask[1:1 + l_valid] = piece_mask
            src_spans.append((1, 1 + l_valid))
        tgt_spans.append((begin, begin + l_valid))
        chunks_ids.append(out_ids)
        chunks_mask.append(out_mask)
        start_src = 1
        cur_ids = cur_ids[l_valid:]
        cur_mask = cur_mask[l_valid:]
        begin += l_valid
    return ChunkPlan(np.stack(chunks_ids).astype(np.int32),
                     np.stack(chunks_mask).astype(np.int32),
                     src_spans, tgt_spans)


def encode_long_prompt(bert, plan: ChunkPlan, total_len: int,
                       device: torch.device) -> torch.Tensor:
    """Encode the plan's chunks with ``bert(ids, mask)`` -> (n, 512, C) and
    reassemble them into (1, total_len, C); uncovered positions are zero."""
    hidden = bert(torch.from_numpy(plan.chunk_ids).long().to(device),
                  torch.from_numpy(plan.chunk_mask).to(device))
    out = hidden.new_zeros((total_len, hidden.shape[-1]))
    for i, ((s0, s1), (t0, t1)) in enumerate(zip(plan.src_spans, plan.tgt_spans)):
        out[t0:t1] = hidden[i, s0:s1]
    return out[None]
