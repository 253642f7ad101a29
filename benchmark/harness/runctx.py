"""What a per-layer metric's reader sees of a run (``benchmark/metrics/<name>.py``).

A reader is a module with ``read(run) -> float | None`` and, where it needs to
watch the window, ``setup(run)``, called just before the window opens in the
traced run. It finds on ``run``:

* ``kind`` ("serve" or "train"), ``images`` and ``steps`` completed in the
  window, ``window_s`` (the host clock's), ``requests``;
* ``trace``: the reduced profiler trace of the window (``harness.trace``);
* ``counters``: what the harness counted over the window (``host_syncs``,
  ``launches``, ``nms_kept``);
* ``flops_per_image``: the reference's forward operations per image, counted
  from shapes (``torch.utils.flop_counter``) when it ran;
* ``model``: the program's model; ``wrap(module, name, record)`` calls
  ``record(*args, **kwargs)`` before each call of ``module.name`` during the
  window; ``time_module(path)`` gives the (start, end) CUDA event pairs of a
  submodule's forward calls; ``on_request_end`` takes callables the serving
  loop calls after each request's last launch, before its synchronize;
  ``shared``, a dict readers may share state through.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class Run:
    def __init__(self, kind: str):
        self.kind = kind
        self.images = 0
        self.steps = 0
        self.requests = 0
        self.window_s = 0.0
        self.trace = None
        self.counters: Dict[str, Any] = {}
        self.flops_per_image: Optional[float] = None
        self.model = None
        self.on_request_end: List[Callable[[], None]] = []
        self.shared: Dict[str, Any] = {}
        self._undo: List[Callable[[], None]] = []

    def wrap(self, module, name: str, record) -> None:
        inner = getattr(module, name)

        def wrapped(*args, **kwargs):
            record(*args, **kwargs)
            return inner(*args, **kwargs)

        setattr(module, name, wrapped)
        self._undo.append(lambda: setattr(module, name, inner))

    def time_module(self, path: str) -> list:
        import torch

        mod = self.model.get_submodule(path)
        pairs: list = []
        state: Dict[str, Any] = {}

        def pre(m, a, kw=None):
            state["start"] = torch.cuda.Event(enable_timing=True)
            state["start"].record()

        def post(m, a, out, kw=None):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pairs.append((state.pop("start"), end))

        h1 = mod.register_forward_pre_hook(pre)
        h2 = mod.register_forward_hook(post)
        self._undo.append(h1.remove)
        self._undo.append(h2.remove)
        return pairs

    def undo(self) -> None:
        while self._undo:
            self._undo.pop()()


def event_ms(pairs) -> float:
    return float(sum(a.elapsed_time(b) for a, b in pairs))
