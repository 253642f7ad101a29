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
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from hipie_torch.train.step import TrainState


def _path(directory: str, step: int, name: str = "") -> str:
    return os.path.join(directory, f"{name or f'model_{step:07d}'}.pth")


def save_checkpoint(directory: str, state: TrainState, step: int, name: str = "",
                    update_marker: bool = True) -> str:
    """Save under model_{step:07d}.pth (or ``name``.pth); returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step, name)
    tmp = f"{path}.tmp"
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(step)}, tmp)
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
    optimizer, step). The file is read to the host; ``load_state_dict`` copies
    each tensor to its parameter's device (AdamW's step counts stay on the
    host, as the optimizer keeps them)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
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
