"""The two-stage selections: record the side under test's, replay them in the
reference, and read how far each choice lies from the reference's own.

The encoder's top-900 proposals and MaskDINO's top-300 are ``Tensor.topk``
calls over dim 1 with those k. Runs in other precisions put near-tied
proposals in another order, and a slot's content then meets another box, so
the reference follows the choice it judges (``Replay``) and, at the same
point, holds the choice against its own scores: the gap of a chosen proposal
is how far its score lies below the reference's k-th best, over the spread of
the reference's scores of that image.
"""

from __future__ import annotations

from typing import List, Optional, Set

import torch

_topk = torch.Tensor.topk


class Record:
    """While ``active`` holds a list, each two-stage top-k appends its indices
    (on the device, no synchronize) to it."""

    def __init__(self, ks: Set[int]):
        self.ks = ks
        self.active: Optional[List[torch.Tensor]] = None
        self.inside = False

    def __enter__(self):
        ks, me = self.ks, self

        def topk(t, k, dim=-1, largest=True, sorted=True):
            if me.inside:                   # a torch function mode calls back in
                return _topk(t, k, dim, largest, sorted)
            me.inside = True
            try:
                res = _topk(t, k, dim, largest, sorted)
            finally:
                me.inside = False
            if me.active is not None and dim == 1 and k in ks:
                me.active.append(res.indices)
            return res

        torch.Tensor.topk = topk
        return self

    def __exit__(self, *exc):
        torch.Tensor.topk = _topk
        return False


class Replay:
    """Each two-stage top-k takes the next recorded indices; ``gaps`` gets
    each one's largest gap."""

    def __init__(self, ks: Set[int], chosen: List[torch.Tensor]):
        self.ks, self.queue, self.gaps = ks, list(chosen), []
        self.inside = False

    def __enter__(self):
        me = self

        def topk(t, k, dim=-1, largest=True, sorted=True):
            if me.inside or dim != 1 or k not in me.ks:
                return _topk(t, k, dim, largest, sorted)
            me.inside = True
            try:
                return me.take(t, k)
            finally:
                me.inside = False

        torch.Tensor.topk = topk
        return self

    def take(self, t, k):
        idx = self.queue.pop(0).to(t.device)
        if idx.shape[1] != k:
            raise AssertionError(f"a recorded choice of {idx.shape[1]} where {k} are taken")
        self.gaps.append(choice_gap(t, idx))
        return torch.return_types.topk((t.gather(1, idx), idx))

    def __exit__(self, *exc):
        torch.Tensor.topk = _topk
        if exc[0] is None and self.queue:
            raise AssertionError(f"{len(self.queue)} recorded two-stage choices left over")
        return False


def choice_gap(scores: torch.Tensor, idx: torch.Tensor) -> float:
    s = scores.detach().float()
    valid = s > torch.finfo(torch.float32).min / 2
    k = idx.shape[1]
    kth = _topk(s, k, 1, True, True).values[:, -1:]
    hi = torch.where(valid, s, torch.full_like(s, -float("inf"))).amax(1, keepdim=True)
    lo = torch.where(valid, s, torch.full_like(s, float("inf"))).amin(1, keepdim=True)
    chosen = s.gather(1, idx)
    gap = (kth - chosen).clamp(min=0) / (hi - lo).clamp(min=1e-30)
    return float(gap.max())
