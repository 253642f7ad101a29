"""Random draws of the training step, behind one small key interface.

The JAX package threads ``jax.random`` keys (split, fold_in) through the step;
the port keeps that structure so that every draw has its place in it:
``Keys.split(n)``, ``Keys.fold_in(i)``, ``Keys.uniform(shape)`` and
``Keys.randint(low, high, shape)``. ``GeneratorKeys`` draws from one explicit
``torch.Generator`` in call order (split and fold_in return the same stream),
so a run is fixed by its seed. A test hands in keys that replay another
source's draws instead.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


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
