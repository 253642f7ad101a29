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
(optax.MultiSteps). ``mu_dtype="bfloat16"`` keeps the first moment in bf16
(a memory knob of the JAX package for 16 GB chips: half a float a parameter),
step for step as optax's ``scale_by_adam(mu_dtype=bfloat16)`` does it
(``AdamWLowMu``); other dtypes raise.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from hipie_plain.config import SolverConfig
from hipie_plain.parallel.tensor import sharded_mask, sum_over_model

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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[List[bool]] = None) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / norm) (optax's rule, no
    epsilon); returns the norm before clipping. Stays on the device.

    ``sharded`` marks the gradients of tensor-parallel shards: the norm is the
    whole model's, their squares summed over the model group and the
    replicated ones' counted once."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if sharded is None or not any(sharded):
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(sharded, device=norms.device)
        sq = norms.square()
        sq_sharded = sum_over_model(torch.where(mask, sq, 0.0).sum())
        norm = (sq_sharded + torch.where(mask, 0.0, sq).sum()).sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def _chunks(params: List[torch.Tensor], limit: int = 1 << 26) -> Iterator[List[int]]:
    """Indices of ``params`` in runs of at least ``limit`` elements (the last
    shorter), so that an update's f32 temporaries stay a fraction of the model."""
    run, n = [], 0
    for i, p in enumerate(params):
        run.append(i)
        n += p.numel()
        if n >= limit:
            yield run
            run, n = [], 0
    if run:
        yield run


class AdamWLowMu(torch.optim.Optimizer):
    """AdamW with the first moment stored in a narrower float (bf16), the
    arithmetic of optax's chain scale_by_adam(mu_dtype=...) ->
    add_decayed_weights -> scale_by_learning_rate -> apply_updates:

      mu = (1 - b1) * g + b1 * mu    b1 * mu in mu's dtype (b1 rounded to it,
                                     as a Python float meets a bf16 array in
                                     JAX), the sum in f32
      nu = (1 - b2) * g * g + b2 * nu                      (f32)
      u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p
      p = p + (-lr) * u;  mu is rounded to its dtype (nearest even) for storage.

    ``torch.optim.AdamW`` with a bf16 ``exp_avg`` would instead do its lerp in
    bf16 and bias-correct the rounded moment."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
            # a group's parameters step together; optax counts in int32 and
            # takes b^t and 1 - b^t in f32
            t = torch.tensor(float(self.state[params[0]]["step"]), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
            b1_low = float(torch.tensor(b1, dtype=self.mu_dtype))
            for run in _chunks(params):
                ps = [params[i] for i in run]
                grads = [p.grad for p in ps]
                mus = [self.state[p]["exp_avg"] for p in ps]
                nus = [self.state[p]["exp_avg_sq"] for p in ps]
                mu = torch._foreach_mul(grads, 1 - b1)
                torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(mus, b1_low)])
                g2 = torch._foreach_mul(grads, grads)
                torch._foreach_mul_(g2, 1 - b2)
                torch._foreach_mul_(nus, b2)
                torch._foreach_add_(nus, g2)
                del g2
                denom = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                upd = torch._foreach_div(mu, bc1)
                torch._foreach_div_(upd, denom)
                del denom
                if group["weight_decay"]:
                    torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
                torch._foreach_mul_(upd, -group["lr"])
                torch._foreach_add_(ps, upd)
                torch._foreach_copy_(mus, mu)

    def load_state_dict(self, state_dict) -> None:
        """torch casts every float state to its parameter's dtype on load: put
        the first moment back in its own (exact, it was stored in it)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)


MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GroupedAdamW:
    """The optimizer of the training step over a model's trainable parameters.

    ``step()`` applies the next update from the parameters' ``.grad``:
    clipping, then AdamW with each group's lr at ``updates`` (the schedule's
    0-based step). With ``grad_accum`` k > 1, ``step`` adds the gradients to a
    mean and updates only every k-th call."""

    def __init__(self, cfg: SolverConfig, model: torch.nn.Module):
        mu_dtype = getattr(cfg, "mu_dtype", "float32")
        if mu_dtype not in MU_DTYPES:
            raise NotImplementedError(f"mu_dtype={mu_dtype!r}: the port takes "
                                      f"{' or '.join(MU_DTYPES)}")
        self.cfg = cfg
        self.labels = freeze_(model)
        self.base_lrs = group_base_lrs(cfg)
        self.schedules = {g: lr_schedule(cfg, lr) for g, lr in self.base_lrs.items()}
        named = {g: [] for g in self.base_lrs}
        for name, p in model.named_parameters():
            if p.requires_grad:
                named[self.labels[name]].append(p)
        self.params = [p for g in self.base_lrs for p in named[g]]
        by_id = {id(p): n for n, p in model.named_parameters()}
        self.names = [by_id[id(p)] for p in self.params]
        self.sharded = sharded_mask(model, self.params)
        groups = [{"params": named[g], "lr": self.schedules[g](0), "group": g}
                  for g in self.base_lrs if named[g]]
        kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
        self.opt = (torch.optim.AdamW(groups, **kw) if mu_dtype == "float32" else
                    AdamWLowMu(groups, lr=0.0, mu_dtype=MU_DTYPES[mu_dtype], **kw))
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
        norm = clip_by_global_norm_(grads, self.cfg.clip_norm, self.sharded)
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
