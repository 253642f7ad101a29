"""Training cells: the program's ``make_train_step`` step, one after another.

Set-up builds one training state (the model built for training, its weights
drawn from the seed in f32, its optimizer) and its step, makes a pool of
batches on the card from the seed (``harness.traffic``), and drives that same
state through the first ``check_steps`` steps on pool batches 0, 1, 2 (rows
that all differ), then through one step on each of the pool's other batches,
so that every shape the window meets (the GT counts differ from batch to
batch) is warm. The window then cycles through the pool from batch 0, each
step ended by one synchronize.

``correct``: during the check steps the harness records each step's loss, the
first gradient as the optimizer got it (its first moment after one step over
1 - beta1, as per-leaf norms), each leaf's change after the last check step
(before the window's first step changes it), and the program's discrete
choices: the two-stage top-k, the matchers' outputs (simOTA, the auction, the
encoder's Hungarian match) and the mask losses' point picks. Once the window
has closed and the program is freed, the plain reference (f32, TF32 off), from
the same weights, batches and random draws, takes the same steps, following
the recorded choices (whose discrete near-ties round apart between
precisions), and ``judge`` compares:

* ``loss_gap``: the relative gap of the first step's total loss;
* ``grad_gap``: the median leaf's gap between the two first-gradient norms,
  over the reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``delta_gap``: the same for the change after the check steps, leaving out
  the leaves whose reference gradient is under a thousandth of the median
  leaf's (they move under Adam by round-off alone);
* ``choice_gap``: the first step's two-stage choices against the reference's
  own scores.

Every run also logs the look behind those choices (PERF.md): every step's
loss and the worst leaves.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import torch

from harness import common, traffic
from harness.choices import Record, Replay

BETA1 = 0.9
MATCHERS = ("simota_match", "auction_assignment", "hungarian_vl_match")


def wrap_batch(b: Dict[str, Any], step_mod, crit_mod):
    t = crit_mod.Targets(b["labels"], b["boxes"], b["masks"], b["positive_map"],
                         b["is_thing"], b["valid"])
    return step_mod.TrainBatch(b["images"], b["pad_mask"], b["input_ids"], b["lang_mask"],
                               b["image_sizes"], t)


def key_seed(seed: int) -> int:
    return (int(seed) * 40503 + 7) % (1 << 62)


class Recorder:
    """Records (or, given another run's record, replays) a step's discrete
    choices in a criterion module: point picks, matchers."""

    def __init__(self, crit_mod, replay=None):
        self.crit = crit_mod
        self.saved = {n: getattr(crit_mod, n) for n in ("uncertain_point_coords", *MATCHERS)}
        self.rec = {"picks": [], "matches": []}
        self.replay = None if replay is None else {k: list(v) for k, v in replay.items()}

    def __enter__(self):
        saved, me = self.saved, self

        def pick(*a, **k):
            got = saved["uncertain_point_coords"](*a, **k)      # its draws still advance
            if me.replay is None:
                me.rec["picks"].append(got)
                return got
            return me.replay["picks"].pop(0).to(got.device)

        def matcher(name):
            def match(*a, **k):
                if me.replay is not None:
                    return me.replay["matches"].pop(0).to(a[0].device)
                got = saved[name](*a, **k)
                me.rec["matches"].append(got)
                return got
            return match

        self.crit.uncertain_point_coords = pick
        for name in MATCHERS:
            setattr(self.crit, name, matcher(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.crit, name, fn)
        if exc[0] is None and self.replay is not None and any(self.replay.values()):
            raise AssertionError("recorded picks or matches left over")
        return False


def leaf_norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack([t.detach().float().norm() for t in tensors]).tolist()


def first_grad_norms(opt) -> List[float]:
    """From the inner AdamW's first moments after one step: |m1| / (1 - beta1)."""
    return [n / (1.0 - BETA1) for n in leaf_norms(
        [opt.opt.state[p]["exp_avg"] if p in opt.opt.state else torch.zeros(1, device=p.device)
         for p in opt.params])]


def change_norms(opt, start: Dict[str, torch.Tensor]) -> List[float]:
    return leaf_norms([p.detach() - start[n].to(p.device, p.dtype)
                       for n, p in zip(opt.names, opt.params)])


def check_steps(step, state, batches, keys, crit_mod, step_mod, ks, start_weights,
                replay=None):
    """Drive the state through the check steps; returns what they recorded:
    losses, first-gradient norms, change norms, choices (or replays ``replay``)."""
    out: Dict[str, Any] = {"loss": [], "choices": [], "gaps": []}
    for i, batch in enumerate(batches):
        rp = None if replay is None else {"picks": replay["picks"][i],
                                          "matches": replay["matches"][i]}
        with Recorder(crit_mod, rp) as rec:
            if replay is None:
                with Record(ks) as r2:
                    chosen: List[torch.Tensor] = []
                    r2.active = chosen
                    _, metrics = step(state, batch, keys)
                out["choices"].append(chosen)
            else:
                with Replay(ks, replay["choices"][i]) as r2:
                    _, metrics = step(state, batch, keys)
                out["gaps"].extend(r2.gaps)
        out["loss"].append(float(metrics["total_loss"]))
        out.setdefault("picks_rec", []).append(rec.rec["picks"])
        out.setdefault("matches_rec", []).append(rec.rec["matches"])
        if i == 0:
            out["grad"] = first_grad_norms(state.optimizer)
    out["change"] = change_norms(state.optimizer, start_weights)
    out["names"] = list(state.optimizer.names)
    return out


def program_state(cell, seed: int, dev, marks):
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.train.step import create_train_state, make_train_step

    cfg = common.program_config(cell.config)
    with torch.device(dev):
        model = HIPIEModel(cfg.model, train=True)
    marks.append(("model built", time.perf_counter()))
    model.float()
    common.fill_weights_(model, common.weight_seed(cell.config), torch.float32)
    marks.append(("weights drawn", time.perf_counter()))
    state = create_train_state(cfg, device=dev, model=model)
    marks.append(("optimizer", time.perf_counter()))
    return cfg, state, make_train_step(cfg, state, device=dev)


def run_program(cell, seed: int, seconds: float, dev, t0: float, run, trace=None) -> Dict[str, Any]:
    import hipie_torch.losses.criterion as crit_mod
    import hipie_torch.train.step as step_mod
    from hipie_torch import kernels
    from hipie_torch.losses import matcher
    from hipie_torch.utils.rng import GeneratorKeys

    mix = cell.traffic
    marks = [("start", time.perf_counter())]
    cfg, state, step = program_state(cell, seed, dev, marks)
    mc = cfg.model
    pool = traffic.train_pool(mix, seed, mc.text.max_query_len, mc.text.vocab_size,
                              mc.num_classes, dev)
    marks.append(("pool", time.perf_counter()))
    batches = [wrap_batch(b, step_mod, crit_mod) for b in pool]
    keys = GeneratorKeys(torch.Generator(device=dev).manual_seed(key_seed(seed)))
    n_check = mix["check_steps"]
    start = {n: p.detach().clone() for n, p in zip(state.optimizer.names, state.optimizer.params)}
    rec = check_steps(step, state, batches[:n_check], keys, crit_mod, step_mod,
                      common.two_stage_ks(mc), start)
    del start
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    marks.append(("check steps", time.perf_counter()))
    for batch in batches[n_check:]:
        step(state, batch, keys)
    sync()
    marks.append(("warm-up steps", time.perf_counter()))
    common.log_marks(marks, t0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run.model = state.model
    for reader in run.shared.get("readers", []):
        if hasattr(reader, "setup"):
            reader.setup(run)
    kernels.reset_launch_counts()
    s0 = matcher.HOST_SYNCS[0]
    smi_start = common.smi() if dev.type == "cuda" else "cpu"
    use0 = common.usage()
    k = 0
    ctx = trace if trace is not None else contextlib.nullcontext()
    with ctx:
        with torch.profiler.record_function("bench.window"):
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < seconds:
                step(state, batches[k % len(batches)], keys)
                sync()
                k += 1
            t_end = time.perf_counter()
    run.undo()
    smi_end = common.smi() if dev.type == "cuda" else "cpu"
    syncs = matcher.HOST_SYNCS[0] - s0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    b = mix["batch"]
    run.steps, run.images, run.window_s = k, k * b, t_end - t_start
    run.counters = {"host_syncs": syncs, "launches": launches}
    run.model = None
    counts = [traffic.work_counts(mix, b) for b in pool]
    common.log(f"[work] steps {k} of {b} images; valid GTs per step "
               f"{[sum(c['valid']) for c in counts]} (things {[sum(c['things']) for c in counts]}, "
               f"stuff {[sum(c['stuff']) for c in counts]}) over the pool's cycle; matcher host "
               f"syncs per step {syncs / max(k, 1):.3f}; kernel launches per step "
               f"{({n: c / max(k, 1) for n, c in launches.items()})}; check-step losses "
               f"{rec['loss']}")
    common.log(f"[work] card at the window's start: {smi_start}; at its end: {smi_end}; "
               f"{common.usage(use0)}")
    del state, step, batches
    return {"steps": k, "images": k * b, "window_s": t_end - t_start, "setup_s": t_start - t0,
            "peak": peak, "record": rec, "pool": pool[:n_check]}


def reference_steps(cell, seed: int, dev, pool, replay, run=None, lowp=False) -> Dict[str, Any]:
    """The reference's check steps, from the same weights, batches and draws,
    following ``replay`` (or recording its own choices where it is None).
    With ``lowp`` it computes in fp8 (the control)."""
    import hipie_plain.losses.criterion as crit_mod
    import hipie_plain.train.step as step_mod
    from hipie_plain.models.hipie import HIPIEModel
    from hipie_plain.utils.rng import GeneratorKeys

    from harness.lowp import Fp8Mode

    cfg = common.reference_config(cell.config)
    with torch.device(dev):
        model = HIPIEModel(cfg.model, train=True)
    model.float()
    common.fill_weights_(model, common.weight_seed(cell.config), torch.float32)
    state = step_mod.create_train_state(cfg, device=dev, model=model)
    inner_make = step_mod.make_loss_fn
    counted = {}

    def make_loss_fn(*a, **k):
        fn = inner_make(*a, **k)

        def loss_fn(batch, keys):
            if run is None or counted:
                return fn(batch, keys)
            from torch.utils.flop_counter import FlopCounterMode

            with FlopCounterMode(display=False) as fc:
                got = fn(batch, keys)
            counted["flops"] = fc.get_total_flops()
            run.flops_per_image = counted["flops"] / batch.images.shape[0]
            return got
        return loss_fn

    step_mod.make_loss_fn = make_loss_fn
    try:
        step = step_mod.make_train_step(cfg, state, device=dev)
    finally:
        step_mod.make_loss_fn = inner_make
    batches = [wrap_batch(b, step_mod, crit_mod) for b in pool]
    keys = GeneratorKeys(torch.Generator(device=dev).manual_seed(key_seed(seed)))
    start = common.draw_weights([(n, tuple(p.shape)) for n, p in model.named_parameters()],
                                common.weight_seed(cell.config), dev, torch.float32)
    start = {n: start[n] if n in start else p.detach().clone()
             for n, p in model.named_parameters()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with Fp8Mode() if lowp else contextlib.nullcontext():
            got = check_steps(step, state, batches, keys, crit_mod, step_mod,
                              common.two_stage_ks(cfg.model), start, replay=replay)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return got


def as_replay(rec) -> Dict[str, Any]:
    return {"choices": rec["choices"], "picks": rec["picks_rec"], "matches": rec["matches_rec"]}


def leaf_gaps(got: List[float], want: List[float], keep=None) -> List[float]:
    """Each leaf's gap between the two norms, over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    import statistics

    idx = range(len(want)) if keep is None else keep
    med = statistics.median(want[i] for i in idx)
    return [abs(got[i] - want[i]) / max(want[i], med) for i in idx]


def compare(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """The numbers compared between a side's record and the reference's (see
    PERF.md for why the first step's loss and the median leaf's gradient
    stand in for every step's loss and the worst leaf)."""
    import statistics

    if got["names"] != want["names"]:
        raise AssertionError("the two sides train different parameters")
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["loss"], want["loss"])]
    g_med = statistics.median(want["grad"])
    moved = [i for i, g in enumerate(want["grad"]) if g >= 1e-3 * g_med]
    grads = leaf_gaps(got["grad"], want["grad"])
    deltas = leaf_gaps(got["change"], want["change"], moved)
    names = want["names"]
    for what, gaps, idx in (("grad", grads, range(len(grads))), ("change", deltas, moved)):
        idx = list(idx)
        worst = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:3]
        common.log(f"[judge] {what}: worst leaf {max(gaps):.4g}, median {statistics.median(gaps):.4g}; "
                   + "; ".join(f"{names[idx[i]]} {gaps[i]:.4g}" for i in worst))
    other = [g for g, n in zip(grads, names) if "sampling_offsets" not in n]
    common.log(f"[judge] every step's loss gap {losses}; two-stage gaps by step {want['gaps']}; "
               f"{len(grads) - len(moved)} leaves left out of the change")
    n_first = len(want["gaps"]) // max(len(want["loss"]), 1)
    return {"loss_gap": losses[0], "grad_gap": statistics.median(grads),
            "delta_gap": statistics.median(deltas),
            "choice_gap": max(want["gaps"][:n_first], default=0.0),
            # the look beside the numbers compared (main.execute passes it on as "look")
            "look.loss.worst_step": max(losses), "look.grad.worst": max(grads),
            "look.grad.worst_outside_offsets": max(other, default=0.0),
            "look.change.worst": max(deltas)}


def judge(cell, seed: int, dev, got: Dict[str, Any], run=None) -> Dict[str, float]:
    rec = got["record"]
    want = reference_steps(cell, seed, dev, got["pool"], as_replay(rec), run)
    return compare(rec, want)


def control(cell, seed: int, dev) -> Dict[str, float]:
    """The control's readings: the reference in fp8 in the program's place,
    judged as the program is (the f32 reference following its choices)."""
    mc = common.reference_config(cell.config).model
    pool = traffic.train_pool(cell.traffic, seed, mc.text.max_query_len, mc.text.vocab_size,
                              mc.num_classes, dev)[:cell.traffic["check_steps"]]
    low = reference_steps(cell, seed, dev, pool, None, lowp=True)
    gc_free()
    want = reference_steps(cell, seed, dev, pool, as_replay(low))
    return compare(low, want)


def gc_free():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
