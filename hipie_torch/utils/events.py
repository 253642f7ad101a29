"""Metrics/event logging: scalar store + console/JSON writers + profiler.

The port's copy of hipie_tpu/utils/events.py (detectron2 EventStorage,
CommonMetricPrinter and JSONWriter metrics.json; wall-time tracking in place of
the IterationTimer hook). ``EventStorage`` is the JAX package's, line for line;
``Profiler`` traces with torch.profiler (CPU and CUDA activities) where the JAX
package's uses jax.profiler.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Any, Dict, Optional


class EventStorage:
    def __init__(self, output_dir: str = "output", window: int = 20):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._history: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._latest: Dict[str, float] = {}
        self.iter = 0
        self._json_path = os.path.join(output_dir, "metrics.json")
        self._start = time.time()
        self._iter_times: deque = deque(maxlen=window)
        self._last_tick = None
        self._tb = None

    def enable_tensorboard(self):
        """Mirror scalars to TensorBoard (reference: TensorboardXWriter,
        utils/events.py:131; W&B mirrors TB via sync_tensorboard). Uses
        torch.utils.tensorboard (bundled with the baked-in torch); silently
        disabled if unavailable."""
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=os.path.join(self.output_dir, "tb"))
        except Exception:
            self._tb = None

    def put_scalars(self, **scalars):
        for k, v in scalars.items():
            v = float(v)
            self._history[k].append(v)
            self._latest[k] = v

    def median(self, key: str) -> float:
        vals = sorted(self._history[key])
        return vals[len(vals) // 2] if vals else 0.0

    def tick(self):
        now = time.time()
        if self._last_tick is not None:
            self._iter_times.append(now - self._last_tick)
        self._last_tick = now
        self.iter += 1

    def write_json(self):
        rec = {"iteration": self.iter, **self._latest}
        with open(self._json_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in self._latest.items():
                self._tb.add_scalar(k, v, self.iter)

    def log_console(self, max_iter: Optional[int] = None, lr: Optional[float] = None):
        it_time = (sum(self._iter_times) / len(self._iter_times)
                   if self._iter_times else 0.0)
        eta = ""
        if max_iter and it_time:
            secs = int((max_iter - self.iter) * it_time)
            eta = f"eta: {secs // 3600}:{secs % 3600 // 60:02d}:{secs % 60:02d}  "
        losses = "  ".join(
            f"{k}: {self.median(k):.4g}" for k in sorted(self._history)
            if k.startswith(("loss", "total")))
        lr_s = f"lr: {lr:.3e}  " if lr is not None else ""
        print(f"{eta}iter: {self.iter}  {losses}  {lr_s}time: {it_time:.4f}s",
              flush=True)


class Profiler:
    """torch.profiler trace of iterations [start_iter, start_iter + num_iters),
    written as a Chrome trace under ``output_dir/profile``."""

    def __init__(self, output_dir: str, start_iter: int = -1, num_iters: int = 5):
        self.dir = os.path.join(output_dir, "profile")
        self.start_iter = start_iter
        self.stop_iter = start_iter + num_iters
        self._prof = None

    def maybe_start(self, it: int):
        if it == self.start_iter:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def maybe_stop(self, it: int):
        if self._prof is not None and it >= self.stop_iter:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.dir, f"trace_{it}.json"))
            self._prof = None
