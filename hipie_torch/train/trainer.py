"""Training loop: steps from an iterator of batches, the lr schedule, timing,
per-step metrics, periodic checkpoints and evaluation.

Counterpart of hipie_tpu/train/trainer.py (detectron2 TrainerBase with its
IterationTimer, LRScheduler logging, PeriodicCheckpointer, EvalHook +
BestCheckpointer and PeriodicWriter hooks). Each step ends in a device
synchronize, so that its wall time is the step's time on the card (the step
is eager and its matchers sync anyway); its metrics then go to the host, and
every ``log_period`` steps to the console and to ``metrics.json``.

The loader yields ``(task, batch)`` pairs (``TrainLoader``) or bare batches;
``train_step`` is one step function or a dict of them by task ("detection",
"grounding"). Each batch moves to the device before its step, inside the
data time. Every ``solver.checkpoint_period`` steps and at ``max_iter`` the
state is saved (``train/checkpoint.py``); every ``test.eval_period`` steps
``eval_fn(model)`` runs and the best value of ``test.best_metric`` (default:
the first result key) is kept as ``model_best`` with its value in
``best_checkpoint``, which a resumed run reads back. ``checkpoints=False``
turns the saves off for runs that only measure steps (chip_smoke.py's
synthetic-batch phases, ``hipie_torch.train.profile``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Union

import torch

from hipie_torch.config import HIPIEConfig
from hipie_torch.train.checkpoint import resume_or_load, save_checkpoint
from hipie_torch.train.optimizer import lr_schedule
from hipie_torch.train.step import TrainBatch, TrainState, _device_of
from hipie_torch.utils.events import EventStorage, Profiler
from hipie_torch.utils.rng import GeneratorKeys, Keys


class Trainer:
    """Runs ``train_step`` (from make_train_step, or a dict of them by task)
    over batches from ``loader``. Random draws come from a ``torch.Generator``
    on ``device`` seeded with ``cfg.seed`` unless ``keys`` is given.
    ``history`` keeps every step's metrics on the host, with the step's wall
    time ("time_s"), the time it waited for its batch ("data_time_s"), its task
    and the base lr it used ("lr")."""

    def __init__(self, cfg: HIPIEConfig, state: TrainState,
                 train_step: Union[Callable, Dict[str, Callable]], loader: Iterator,
                 eval_fn: Optional[Callable[[torch.nn.Module], Dict[str, float]]] = None,
                 log_period: int = 20, profile_at: int = -1, device="cuda",
                 keys: Optional[Keys] = None, checkpoints: bool = True):
        self.cfg = cfg
        self.state = state
        self.train_step = train_step
        self.loader = loader
        self.eval_fn = eval_fn
        self.checkpoints = checkpoints
        self.device = _device_of(device)
        self.keys = keys or GeneratorKeys(
            torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.storage = EventStorage(cfg.output_dir)
        self.profiler = Profiler(cfg.output_dir, start_iter=profile_at)
        self.log_period = log_period
        self.history: List[Dict[str, float]] = []
        self._best_metric = float("-inf")

    def resume_or_load(self, weights: Optional[str] = None, resume: bool = True) -> bool:
        """Resume from ``cfg.output_dir``'s last checkpoint (and the best
        metric's watermark), else load ``weights``; returns whether it resumed."""
        self.state, resumed = resume_or_load(self.cfg.output_dir, self.state, weights, resume)
        if resumed:
            self.storage.iter = self.state.step
            marker = os.path.join(self.cfg.output_dir, "best_checkpoint")
            if os.path.exists(marker):
                try:
                    with open(marker) as f:
                        self._best_metric = float(f.read().strip().rsplit("=", 1)[-1])
                except (ValueError, OSError):
                    pass
        return resumed

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
        eval_period = self.cfg.test.eval_period or 5000
        while it < max_iter:
            self.profiler.maybe_start(it)
            t_data = time.perf_counter()
            batch = next(data_iter)
            task = None
            if isinstance(batch, tuple) and len(batch) == 2 and isinstance(batch[0], str):
                task, batch = batch
            if isinstance(batch, dict):
                batch = TrainBatch(**batch)
            batch = batch.to(self.device)
            data_time = time.perf_counter() - t_data
            step_fn = (self.train_step[task or "detection"] if isinstance(self.train_step, dict)
                       else self.train_step)
            t0 = time.perf_counter()
            lr = lr_fn(self.state.optimizer.updates)
            self.state, metrics = step_fn(self.state, batch, self.keys)
            self._sync()
            step_time = time.perf_counter() - t0
            self.storage.tick()
            it += 1
            self.storage.put_scalars(data_time=data_time)
            self._record(metrics, lr, step_time, data_time, task, it, max_iter,
                         last=it >= max_iter)
            self.profiler.maybe_stop(it)
            if self.checkpoints and (it % cfg.checkpoint_period == 0 or it == max_iter):
                save_checkpoint(self.cfg.output_dir, self.state, it)
            if self.eval_fn is not None and it % eval_period == 0:
                self._evaluate(it)
        self.storage.write_json()
        return self.state

    def _record(self, metrics, lr, step_time, data_time, task, it, max_iter, last=False):
        host = {k: float(v) for k, v in metrics.items()}
        if task is not None and isinstance(self.train_step, dict) and len(self.train_step) > 1:
            # multi-task runs: each task's total, so each task's descent shows
            host[f"total_loss_{task}"] = host.get("total_loss", 0.0)
        self.history.append({**host, "lr": lr, "time_s": step_time, "data_time_s": data_time,
                             "task": task, "iter": it})
        if last or it % self.log_period == 0:
            self.storage.put_scalars(**host)
            self.storage.log_console(max_iter, lr=lr)
            self.storage.write_json()

    def _evaluate(self, it: int) -> Dict[str, float]:
        """EvalHook + BestCheckpointer: run eval_fn on the model, log its
        results, and keep a better value of the best metric as model_best."""
        results = self.eval_fn(self.state.model)
        self.storage.put_scalars(**{f"eval/{k}": v for k, v in results.items()})
        self.history[-1]["eval"] = dict(results)
        metric = self.cfg.test.best_metric or (sorted(results)[0] if results else "")
        if metric in results:
            val = float(results[metric])
            if val > self._best_metric:
                self._best_metric = val
                save_checkpoint(self.cfg.output_dir, self.state, it, name="model_best",
                                update_marker=False)
                with open(os.path.join(self.cfg.output_dir, "best_checkpoint"), "w") as f:
                    f.write(f"model_best iter={it} {metric}={val}\n")
        return results
