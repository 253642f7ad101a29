"""Checkpointing: save and resume the training state, load weights by name.

Counterpart of hipie_tpu/train/checkpoint.py (detectron2 DetectionCheckpointer,
engine/defaults.py resume_or_load restoring model + iteration + optimizer
state; PeriodicCheckpointer with its ``last_checkpoint`` marker; .pth interop
with shape-mismatch skipping). A checkpoint is one ``torch.save`` file,
``model_{step:07d}.pth`` (or ``<name>.pth``), holding

  * ``model``: the model's ``state_dict`` under the reference's names;
  * ``optimizer``: ``GroupedAdamW.state_dict()`` (the inner AdamW's moments and
    step counts, the schedule's update count, the accumulation window);
  * ``step``: the training step.

A save writes ``<path>.tmp`` and renames it over the destination, keeping the
previous file as ``<path>.old`` until the rename is done, so a crash never
loses the last good checkpoint; ``latest_checkpoint`` recovers from either.
Resuming restores the model, the optimizer and the step, as the JAX package
does; the trainer's random keys and the loader's sampler start again from
``cfg.seed`` (JAX's Trainer.train and TrainLoader do the same).

Under tensor parallelism the file holds whole tensors under the reference's
names, as orbax's global arrays do: every rank of the model group takes part
in gathering the shards (parameters, AdamW's moments, the accumulation
window) and the main process writes them; a restore or a weights load cuts
them to the rank's shard. So a checkpoint written at one tp restores at any
other.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from hipie_torch.parallel.multihost import is_main_process
from hipie_torch.parallel.tensor import gather_shard, shard_state_dict, take_shard, tp_plan
from hipie_torch.parallel.mesh import model_rank, model_size
from hipie_torch.train.step import TrainState


def _path(directory: str, step: int, name: str = "") -> str:
    return os.path.join(directory, f"{name or f'model_{step:07d}'}.pth")


def _map_sharded(opt_sd: Dict, names: List[str], plan: Dict, fn) -> Dict:
    """``GroupedAdamW.state_dict()`` with ``fn(tensor, (dim, blocks))`` applied
    to the moments and accumulators of the plan's parameters."""
    adamw = opt_sd["adamw"]
    per = {}
    for i, st in adamw["state"].items():
        spec = plan.get(names[i])
        per[i] = st if spec is None else {
            k: fn(v, spec) if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
    acc = opt_sd["acc"]
    if acc is not None:
        acc = [fn(a, plan[n]) if n in plan else a for a, n in zip(acc, names)]
    return {**opt_sd, "adamw": {**adamw, "state": per}, "acc": acc}


def full_state(state: TrainState) -> Tuple[Dict, Dict]:
    """The model's and the optimizer's state dicts with whole tensors (the
    model group's shards gathered; a collective under tensor parallelism)."""
    model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
    plan = tp_plan(state.model)
    if plan:
        model_sd = {k: gather_shard(v, *plan[k]) if k in plan else v
                    for k, v in model_sd.items()}
        opt_sd = _map_sharded(opt_sd, state.optimizer.names, plan,
                              lambda t, spec: gather_shard(t, *spec))
    return model_sd, opt_sd


def save_checkpoint(directory: str, state: TrainState, step: int, name: str = "",
                    update_marker: bool = True) -> str:
    """Save under model_{step:07d}.pth (or ``name``.pth); returns the path.
    Under tensor parallelism every rank calls it (the shards are gathered) and
    the main process writes."""
    path = _path(directory, step, name)
    model_sd, opt_sd = full_state(state)
    if tp_plan(state.model) and not is_main_process():
        return path
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"model": model_sd, "optimizer": opt_sd, "step": int(step)}, tmp)
    if os.path.exists(path):
        old = f"{path}.old"
        os.replace(path, old)
        os.replace(tmp, path)
        os.remove(old)
    else:
        os.replace(tmp, path)
    if update_marker:
        with open(os.path.join(directory, "last_checkpoint"), "w") as f:
            f.write(os.path.basename(path))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint the ``last_checkpoint`` marker names; if a save was cut
    between its two renames, the ``.old`` (previous) or ``.tmp`` (new, whole)
    file that survived."""
    marker = os.path.join(directory, "last_checkpoint")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        path = os.path.join(directory, f.read().strip())
    if os.path.exists(path):
        return path
    for alt in (f"{path}.old", f"{path}.tmp"):
        if os.path.exists(alt):
            print(f"[checkpoint] {path} missing (interrupted save); resuming from {alt}")
            return alt
    return None


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a save_checkpoint file into ``state`` (model strictly by name,
    optimizer, step), cut to the rank's shards under tensor parallelism.
    The file is read to the host; ``load_state_dict`` copies
    each tensor to its parameter's device (AdamW's step counts stay on the
    host, as the optimizer keeps them)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    plan = tp_plan(state.model)
    model_sd, opt_sd = ckpt["model"], ckpt["optimizer"]
    if plan:
        tp, rank = model_size(), model_rank()
        model_sd = shard_state_dict(model_sd, plan)
        opt_sd = _map_sharded(opt_sd, state.optimizer.names, plan,
                              lambda t, spec: take_shard(t, *spec, rank, tp).clone())
    state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(ckpt["step"])
    return state


def merge_matching(model: torch.nn.Module, loaded: Dict[str, torch.Tensor]
                   ) -> Tuple[List[str], List[str]]:
    """Copy the entries of ``loaded`` whose name and shape match the model's;
    skip the rest, with a note (detectron2's shape-mismatch skipping).
    Returns (copied names, skipped names: a name both have at other shapes)."""
    own = model.state_dict()
    copied, skipped = [], []
    with torch.no_grad():
        for k, v in own.items():
            src = loaded.get(k)
            if src is None:
                continue
            if tuple(src.shape) != tuple(v.shape):
                skipped.append(k)
                continue
            v.copy_(src)
            copied.append(k)
    if skipped:
        print(f"[checkpoint] skipped {len(skipped)} shape-mismatched tensors: {skipped[:8]}")
    return copied, skipped


def load_weights(path: str, state: TrainState) -> Tuple[List[str], List[str]]:
    """Initial weights from ``path``: a HIPIE state_dict under the reference's
    names (``export_hipie_checkpoint``'s output, or a save_checkpoint file,
    whose model entry is used), merged by name and shape. Raises where the file
    cannot be read: training from random weights when the caller pointed at
    real ones is never right."""
    if path.endswith(".pkl"):
        raise NotImplementedError(
            f"{path}: backbone pretrain conversion (.pkl, hipie_tpu/utils/converter.py) is "
            f"not ported yet; pass a HIPIE state_dict (.pth)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if not isinstance(sd, dict) or not sd:
        raise ValueError(f"{path}: not a state_dict")
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    plan = tp_plan(state.model)
    if plan:
        sd = shard_state_dict(sd, plan)
    copied, skipped = merge_matching(state.model, sd)
    print(f"[checkpoint] loaded {len(copied)} of {len(state.model.state_dict())} tensors "
          f"from {path}")
    return copied, skipped


def resume_or_load(directory: str, state: TrainState, weights_path: Optional[str] = None,
                   resume: bool = True) -> Tuple[TrainState, bool]:
    """detectron2 resume_or_load: resume from the run directory's last
    checkpoint if ``resume`` and there is one, else load ``weights_path`` if
    given. Returns (state, resumed)."""
    if resume:
        last = latest_checkpoint(directory)
        if last is not None:
            return restore_checkpoint(last, state), True
    if weights_path:
        load_weights(weights_path, state)
    return state, False
