"""The port's data-parallel helpers (hipie_torch/parallel/mesh.py) as the
benchmark's one process sees them: a data group of one rank, so every
collective is the identity and every shard the whole batch."""

from __future__ import annotations

from typing import List

import torch


def data_size() -> int:
    return 1


def count_unit() -> float:
    """One count of the global batch in ``global_count``'s units."""
    return 1.0


def global_count(x: torch.Tensor) -> torch.Tensor:
    return x


def global_max(x: torch.Tensor) -> torch.Tensor:
    return x


def global_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def shard_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return x


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    return x


def reduce_gradients(params: List[torch.nn.Parameter]) -> int:
    """The collectives run: none."""
    return 0
