"""The port's tensor- and sequence-parallel helpers
(hipie_torch/parallel/tensor.py) as the benchmark's one process sees them: a
model group of one rank, so no module is sharded (``tp`` stays 1), there are
no token shares, and every collective is the identity. ``row_linear`` and
``ffn`` keep the port's arithmetic."""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class TPLayout(NamedTuple):
    """A module's split over the model group, as the port declares it (unused
    at one rank)."""

    columns: Dict[str, int]
    rows: Tuple[str, ...]
    partial: Tuple[str, ...] = ()
    unit: int = 1


def shard_module_(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """The sharding plan: empty at one rank."""
    return {}


def _identity(x: torch.Tensor, *_) -> torch.Tensor:
    return x


copy_to_model = column_input = gather_tokens = split_tokens = _identity
gather_tokens_replicated = sum_over_model = _identity


def token_shards(n_tokens: int) -> None:
    return None


def row_linear(linear: nn.Linear, x: torch.Tensor, tokens: Optional[object] = None
               ) -> torch.Tensor:
    """The port's row-parallel linear at one rank: the product, then the bias
    in the product's dtype."""
    y = F.linear(x, linear.weight)
    return y + linear.bias.to(y.dtype)


def ffn(linear1: nn.Linear, linear2: nn.Linear, x: torch.Tensor, tp: int,
        tokens: Optional[object] = None, act=F.relu) -> torch.Tensor:
    return linear2(act(linear1(x)))


def reduce_model_gradients(model: nn.Module, params: Iterable[nn.Parameter],
                           sequence_parallel: bool) -> int:
    """The collectives run: none."""
    return 0


def sharded_mask(model: nn.Module, params: Iterable[nn.Parameter]) -> List[bool]:
    return [False for _ in params]
