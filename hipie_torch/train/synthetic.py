"""Synthetic training batches from a numpy seed, at the R50 recipe's per-card
shape, for driving the training step without a dataset (the card check in
chip_smoke.py and the step profiler in hipie_torch/train/profile.py)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from hipie_torch.losses.criterion import Targets
from hipie_torch.ops.box_ops import box_xyxy_to_cxcywh, masks_to_boxes
from hipie_torch.train.step import TrainBatch

N_CLASSES = 133                   # COCO panoptic: 80 things + 53 stuff


def train_batches(cfg, n: int, seed: int = 0, img: int = 1024, slots: int = 100,
                  batch: int = 2) -> List[TrainBatch]:
    """``n`` TrainBatches (on the CPU): ``batch`` LSJ canvases of img x img (the
    second padded past column 7/8 of the width), a max_query_len-token prompt
    whose 133 classes own one or two tokens each, ``slots`` GT slots per image
    of which a different count is valid (things and stuff), masks at stride 4
    and their boxes. The defaults are the recipe's: 2 canvases of 1024x1024,
    100 slots (max_insts_num), masks of 256x256."""
    rng = np.random.RandomState(seed + 3)
    L = cfg.model.text.max_query_len
    hm = img // 4
    widths = [img] + [img * 7 // 8] * (batch - 1)
    span = [(1 + (2 * c) % (L - 3), 1 + c % 2) for c in range(N_CLASSES)]   # (start, n tokens)
    out = []
    for _ in range(n):
        masks = np.zeros((batch, slots, hm, hm), np.float32)
        labels = np.zeros((batch, slots), np.int64)
        pm = np.zeros((batch, slots, L), np.float32)
        is_thing = np.zeros((batch, slots), bool)
        valid = np.zeros((batch, slots), bool)
        for b in range(batch):
            wm = widths[b] // 4
            for k in range(rng.randint(slots // 5, slots * 9 // 10)):
                c = rng.randint(N_CLASSES)
                y0, x0 = rng.randint(0, hm - 8), rng.randint(0, wm - 8)
                y1, x1 = y0 + rng.randint(8, hm - y0 + 1), x0 + rng.randint(8, wm - x0 + 1)
                masks[b, k, y0:y1, x0:x1] = 1.0
                labels[b, k] = c % cfg.model.num_classes
                st, nt = span[c]
                pm[b, k, st:st + nt] = 1.0 / nt
                is_thing[b, k] = c < 80
                valid[b, k] = True
        m = torch.from_numpy(masks)
        boxes = masks_to_boxes(m.flatten(0, 1)).reshape(batch, slots, 4) / hm
        pad = np.zeros((batch, img, img), bool)
        for b in range(1, batch):
            pad[b, :, widths[b]:] = True
        images = rng.randint(0, 256, (batch, img, img, 3)).astype(np.uint8)
        images[pad] = 0
        ids = (np.arange(L)[None].repeat(batch, 0) % 1000 + 999) % cfg.model.text.vocab_size
        t = Targets(torch.from_numpy(labels), box_xyxy_to_cxcywh(boxes), m,
                    torch.from_numpy(pm), torch.from_numpy(is_thing), torch.from_numpy(valid))
        out.append(TrainBatch(torch.from_numpy(images), torch.from_numpy(pad),
                              torch.from_numpy(ids), torch.ones(batch, L, dtype=torch.long),
                              torch.tensor([[img, w] for w in widths]), t))
    return out
