"""Optimizer: AdamW over parameter groups with their own learning rates,
global-norm clipping, the warmup + step-decay schedule and gradient
accumulation.

Counterpart of hipie_tpu/train/optimizer.py (reference train_net.py:166-244 and
detectron2 WarmupMultiStepLR). Groups, by the reference's parameter names that
the port's module tree carries:

  * frozen: the FrozenBN statistics and affine terms (buffers here) and the
    stem and res2 convolutions (FREEZE_AT=2): no update, no decay, and no
    gradient (``requires_grad`` off);
  * lang: the text encoder, at ``lang_lr``;
  * vl: the encoder's vision-language fusion blocks, at ``vl_lr``;
  * backbone: the rest of the backbone, at base_lr x ``backbone_lr_mult``;
  * offsets: sampling offsets, bg query references and reference points, at
    base_lr x ``offsets_lr_mult``;
  * base: everything else, at ``base_lr``.

Each group is AdamW as optax composes it: Adam (b1 0.9, b2 0.999, eps 1e-8, bias
corrected), plus weight decay on every parameter of the group, times the
group's learning rate at the step; ``torch.optim.AdamW`` computes the same
update. The gradients are first clipped to a global L2 norm of ``clip_norm``
over all trainable parameters (optax.clip_by_global_norm), and with
``grad_accum`` k > 1 their mean over k micro-steps is applied every k-th step
(optax.MultiSteps). ``mu_dtype="bfloat16"`` (a first moment in bf16, a memory
knob of the JAX package for 16 GB chips) is not ported and raises.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from hipie_torch.config import SolverConfig

_FROZEN_STAGE_RE = re.compile(r"\.backbone\.(stem|res2)\.")


def label_for_name(name: str, frozen_prefixes: Iterable[str] = ()) -> str:
    """The group of a state_dict entry, by its reference name."""
    if any(name.startswith(p) for p in frozen_prefixes) or _FROZEN_STAGE_RE.search(name):
        return "frozen"
    if "text_encoder" in name:
        return "lang"
    if ".vl_layers." in name:
        return "vl"
    if ".backbone." in name and "mask_dino" not in name:
        return "backbone"
    if "sampling_offsets" in name or "bg_query_refs" in name or "reference_points" in name:
        return "offsets"
    return "base"


def frozen_prefixes(model: torch.nn.Module) -> Tuple[str, ...]:
    """Name prefixes of the FrozenBN modules (found by their running_mean
    buffer): all their entries are frozen."""
    return tuple(name[: -len("running_mean")] for name, _ in model.named_buffers()
                 if name.endswith(".running_mean"))


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """Group label of every state_dict entry (parameters and buffers)."""
    fz = frozen_prefixes(model)
    return {name: label_for_name(name, fz) for name in model.state_dict()}


def freeze_(model: torch.nn.Module) -> Dict[str, str]:
    """Turn off ``requires_grad`` of the frozen parameters; returns the labels."""
    labels = param_labels(model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    return labels


def lr_schedule(cfg: SolverConfig, base: float):
    """step -> lr: linear warmup from 1e-3 x base over ``warmup_iters`` steps,
    then x ``lr_decay_gamma`` at each of ``lr_decay_steps`` (d2 WarmupMultiStepLR)."""
    warmup_factor = 1e-3

    def fn(step: int) -> float:
        warm = 1.0
        if cfg.warmup_iters > 0 and step < cfg.warmup_iters:
            alpha = min(max(step / cfg.warmup_iters, 0.0), 1.0)
            warm = warmup_factor * (1 - alpha) + alpha
        decay = 1.0
        for s in cfg.lr_decay_steps:
            if step >= s:
                decay *= cfg.lr_decay_gamma
        return base * warm * decay

    return fn


def group_base_lrs(cfg: SolverConfig) -> Dict[str, float]:
    return {"base": cfg.base_lr, "backbone": cfg.base_lr * cfg.backbone_lr_mult,
            "offsets": cfg.base_lr * cfg.offsets_lr_mult, "lang": cfg.lang_lr,
            "vl": cfg.vl_lr}


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / norm) (optax's rule, no
    epsilon); returns the norm before clipping. Stays on the device."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class GroupedAdamW:
    """The optimizer of the training step over a model's trainable parameters.

    ``step()`` applies the next update from the parameters' ``.grad``:
    clipping, then AdamW with each group's lr at ``updates`` (the schedule's
    0-based step). With ``grad_accum`` k > 1, ``step`` adds the gradients to a
    mean and updates only every k-th call."""

    def __init__(self, cfg: SolverConfig, model: torch.nn.Module):
        if getattr(cfg, "mu_dtype", "float32") != "float32":
            raise NotImplementedError(f"mu_dtype={cfg.mu_dtype!r} is not ported (f32 moments only)")
        self.cfg = cfg
        self.labels = freeze_(model)
        self.base_lrs = group_base_lrs(cfg)
        self.schedules = {g: lr_schedule(cfg, lr) for g, lr in self.base_lrs.items()}
        named = {g: [] for g in self.base_lrs}
        for name, p in model.named_parameters():
            if p.requires_grad:
                named[self.labels[name]].append(p)
        self.params = [p for g in self.base_lrs for p in named[g]]
        self.opt = torch.optim.AdamW(
            [{"params": named[g], "lr": self.schedules[g](0), "group": g}
             for g in self.base_lrs if named[g]],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
        self.updates = 0          # optimizer updates made (the schedule's count)
        self._micro = 0
        self._acc: Optional[List[torch.Tensor]] = None

    def step(self) -> Optional[torch.Tensor]:
        """Apply (or, inside an accumulation window, accumulate) the current
        gradients; returns the global grad norm of an applied update, else None."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        k = self.cfg.grad_accum
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            # running mean, as optax.MultiSteps keeps it
            torch._foreach_mul_(self._acc, self._micro / (self._micro + 1))
            torch._foreach_add_(self._acc, [g / (self._micro + 1) for g in grads])
            self._micro += 1
            if self._micro < k:
                return None
            grads = self._acc
            self._micro = 0
        norm = clip_by_global_norm_(grads, self.cfg.clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.schedules[group["group"]](self.updates)
        self.opt.step()
        self.updates += 1
        if k > 1:
            self._acc = None
        return norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, object]:
        """The inner AdamW's state (moments and step counts by parameter
        index), the schedule's update count and the accumulation window."""
        return {"adamw": self.opt.state_dict(), "updates": self.updates,
                "micro": self._micro, "acc": self._acc}

    def load_state_dict(self, sd: Dict[str, object]) -> None:
        self.opt.load_state_dict(sd["adamw"])
        self.updates = int(sd["updates"])
        self._micro = int(sd["micro"])
        acc = sd["acc"]
        self._acc = None if acc is None else [a.to(p.device, p.dtype)
                                              for a, p in zip(acc, self.params)]
