"""The port's spans and counters, on the profiler's clock.

Spans are ``torch.profiler`` named ranges (kineto user annotations): when a
profiler records, they land in its trace beside the card's kernels, copies and
memsets, on one clock, and the CUDA correlation id links each launch to the
host range it was made in. When no profiler is active on the calling thread,
``span`` returns one shared null context: a flag check, under a microsecond,
so spans cost untraced steps and requests next to nothing. Tracing is on
exactly when a profiler records; there is no switch of its own.

The spans, from the request down (``hipie_torch/models``):

* ``model.forward`` (``HIPIEModel.forward``, a batch), ``model.text``
  (``encode_text``), ``model.backbone``, ``model.transformer`` (VL fusion,
  deformable encoder, two-stage selection, decoder), ``model.masks`` (the
  CondInst mask head and dynamic masks), ``model.maskdino``;
* ``model.remat``: inside each block ``layers.maybe_checkpoint`` checkpoints,
  once in the forward and again in its recompute during the backward;
* ``post.image`` (``hipie_inference``, one image), ``post.nms``
  (``nms_keep_mask``: on a card the score sort and K-F's launches; on the CPU
  the plain version's IoU, copies and scan), ``post.nms_scan`` (the plain
  version's host scan alone, so on the CPU only), ``post.panoptic`` (semantic
  and panoptic fusion).

``train/step.py``'s ranges (``cdn``, ``forward``, ``crit_*``, ``backward``,
``allreduce``, ``optimizer``) are spans too: its ``scope`` is ``span``.

``COUNTS`` holds module-level counters, ``count(name, n)`` adds to one. Each
``host_sync.<site>`` counter counts the passes through one place where the
host blocks on the card when the tensors live there: a device-to-host read or
a blocking host-to-device copy, each of which drains the card's queue.

The older counters stay where they were, read by the benchmark and the card
checks: ``hipie_torch.kernels.LAUNCHES`` (kernel launches by name),
``hipie_torch.losses.matcher.HOST_SYNCS`` (the matchers' convergence checks,
also counted here as ``host_sync.matcher_done``) and
``hipie_torch.ops.ms_deform_attn.BWD_DESIGN_LAUNCHES`` (K-D's launches by
design).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict

import torch

_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled

COUNTS: Dict[str, int] = defaultdict(int)


def span(name: str):
    """A named range in the profiler's trace while a profiler records on this
    thread; otherwise a shared null context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n
