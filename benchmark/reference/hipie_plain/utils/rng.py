"""Random draws of the training step, behind one small key interface.

The JAX package threads ``jax.random`` keys (split, fold_in) through the step;
the port keeps that structure so that every draw has its place in it:
``Keys.split(n)``, ``Keys.fold_in(i)``, ``Keys.uniform(shape)`` and
``Keys.randint(low, high, shape)``. ``GeneratorKeys`` draws from one explicit
``torch.Generator`` in call order (split and fold_in return the same stream),
so a run is fixed by its seed. A test hands in keys that replay another
source's draws instead.

Under data parallelism (hipie_plain/parallel/mesh.py) a draw whose shape
carries the batch goes through ``batch_uniform`` / ``batch_randint``: every
rank draws the global batch's shape from the same keys and keeps its own rows,
so the ranks' keys advance in lockstep and each rank gets the draws one
process with the global batch gives its images.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from hipie_plain.parallel.mesh import data_size, shard_rows


class Keys:
    """The interface: sub-keys and draws on ``device``."""

    def split(self, n: int) -> List["Keys"]:
        raise NotImplementedError

    def fold_in(self, data: int) -> "Keys":
        raise NotImplementedError

    def uniform(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """f32 uniform on [0, 1)."""
        raise NotImplementedError

    def randint(self, low: int, high: int, shape: Sequence[int], device=None) -> torch.Tensor:
        """int64 uniform on [low, high)."""
        raise NotImplementedError


class GeneratorKeys(Keys):
    """Keys drawing in call order from one ``torch.Generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def split(self, n: int) -> List["Keys"]:
        return [self] * n

    def fold_in(self, data: int) -> "Keys":
        return self

    def uniform(self, shape, device=None) -> torch.Tensor:
        out = torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)
        return out.to(device) if device is not None else out

    def randint(self, low, high, shape, device=None) -> torch.Tensor:
        out = torch.randint(low, high, tuple(shape), generator=self.generator,
                            device=self.generator.device)
        return out.to(device) if device is not None else out


def _global(shape: Sequence[int], axis: int) -> List[int]:
    shape = list(shape)
    shape[axis] *= data_size()
    return shape


def batch_uniform(keys: Keys, shape: Sequence[int], axis: int = 0, device=None) -> torch.Tensor:
    """``keys.uniform(shape)`` where ``shape[axis]`` is this rank's batch (or
    batch-major rows): drawn at the global batch's shape, this rank's rows kept."""
    return shard_rows(keys.uniform(_global(shape, axis), device), axis)


def batch_randint(keys: Keys, low: int, high: int, shape: Sequence[int], axis: int = 0,
                  device=None) -> torch.Tensor:
    """``keys.randint`` as ``batch_uniform`` draws."""
    return shard_rows(keys.randint(low, high, _global(shape, axis), device), axis)
