"""Training loop: steps from an iterator of batches, the lr schedule, timing and
per-step metrics.

Counterpart of hipie_tpu/train/trainer.py (detectron2 TrainerBase with its
IterationTimer, LRScheduler logging and PeriodicWriter hooks). Each step ends
in a device synchronize, so that its wall time is the step's time on the card
(the step is eager and its matchers sync anyway); its metrics then go to the
host, and every ``log_period`` steps to the console and to ``metrics.json``.
Checkpoint save and resume, periodic evaluation and the data pipeline are not
ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from hipie_torch.config import HIPIEConfig
from hipie_torch.train.optimizer import lr_schedule
from hipie_torch.train.step import TrainBatch, TrainState, _device_of
from hipie_torch.utils.events import EventStorage, Profiler
from hipie_torch.utils.rng import GeneratorKeys, Keys


class Trainer:
    """Runs ``train_step`` (from make_train_step) over batches from ``loader``.
    Random draws come from a ``torch.Generator`` on ``device`` seeded with
    ``cfg.seed`` unless ``keys`` is given. ``history`` keeps every step's
    metrics on the host, with the step's wall time ("time_s") and the base lr
    it used ("lr")."""

    def __init__(self, cfg: HIPIEConfig, state: TrainState, train_step: Callable,
                 loader: Iterator, log_period: int = 20, profile_at: int = -1,
                 device="cuda", keys: Optional[Keys] = None):
        self.cfg = cfg
        self.state = state
        self.train_step = train_step
        self.loader = loader
        self.device = _device_of(device)
        self.keys = keys or GeneratorKeys(
            torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.storage = EventStorage(cfg.output_dir)
        self.profiler = Profiler(cfg.output_dir, start_iter=profile_at)
        self.log_period = log_period
        self.history: List[Dict[str, float]] = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, max_iter: Optional[int] = None) -> TrainState:
        """Take steps until ``state.step`` reaches ``max_iter`` (default the
        solver's max_iter); returns the state."""
        cfg = self.cfg.solver
        max_iter = max_iter or cfg.max_iter
        it = self.state.step
        data_iter = iter(self.loader)
        lr_fn = lr_schedule(cfg, cfg.base_lr)
        while it < max_iter:
            self.profiler.maybe_start(it)
            t_data = time.perf_counter()
            batch = next(data_iter)
            if isinstance(batch, dict):
                batch = TrainBatch(**batch)
            data_time = time.perf_counter() - t_data
            t0 = time.perf_counter()
            lr = lr_fn(self.state.optimizer.updates)
            self.state, metrics = self.train_step(self.state, batch, self.keys)
            self._sync()
            step_time = time.perf_counter() - t0
            self.storage.tick()
            it += 1
            self.storage.put_scalars(data_time=data_time)
            self._record(metrics, lr, step_time, it, max_iter, last=it >= max_iter)
            self.profiler.maybe_stop(it)
        self.storage.write_json()
        return self.state

    def _record(self, metrics, lr, step_time, it, max_iter, last=False):
        host = {k: float(v) for k, v in metrics.items()}
        self.history.append({**host, "lr": lr, "time_s": step_time, "iter": it})
        if last or it % self.log_period == 0:
            self.storage.put_scalars(**host)
            self.storage.log_console(max_iter, lr=lr)
            self.storage.write_json()
