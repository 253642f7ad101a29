"""Where a training step's time goes, on one card.

    python3 -m hipie_torch.train.profile [--preset r50|vit_huge] [--steps 3] [--seed 0]
        [KEY VALUE ...]

The step is one of those chip_smoke.py's train phases drive: the preset's
config (r50_coco_panoptic() or vit_huge_coco_panoptic(), with its drop path
and activation checkpointing) at full width, batch 2 of 1024x1024 canvases
(hipie_torch/train/synthetic.py), bf16 autocast, seeded random weights. 2
warm-up steps, then ``--steps`` steps timed by the host clock (each ends in a
synchronize), the same steps with CUDA events at the step's named ranges
(hipie_torch/train/step.py ``scope``: cdn, forward, each criterion pass
(crit_fg, crit_bg or crit_bg_lang, crit_enc, crit_gt_dn, crit_maskdino,
crit_maskdino_dn, crit_maskdino_interm), backward, allreduce (empty without
a process group), optimizer) for the device time between a range's start and
end, and
one step under torch.profiler for the device's busy time (the sum of its
kernels' and copies' times), idle share and top kernels, with the device time
and launches of K-A, K-E, K-B and K-D.

KEY VALUE pairs override the preset's config, as train_net's do: for example
``model.bg_query_from_lang True model.loss.final_bg_weight 1.0`` profiles the
step with language-derived bg queries and their crit_bg_lang pass.

Prints one line per measurement, then one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

WARMUP = 2


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


class _PhaseTimer:
    """Stands in for step.scope: CUDA events at each named range's start and
    end on the current stream; take() gives ms per range name since the last
    take (call after a synchronize)."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def __call__(self, name):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.setdefault(name, []).append((start, end))

    def take(self):
        out = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.events.items()}
        self.events = {}
        return out


def profile_step(dev, card, steps: int, seed: int, preset: str = "r50", overrides=None):
    import hipie_torch.train.step as step_module
    from hipie_torch import kernels
    from hipie_torch.config import apply_overrides
    from hipie_torch.losses import matcher
    from hipie_torch.presets import r50_coco_panoptic, vit_huge_coco_panoptic
    from hipie_torch.train.synthetic import train_batches
    from hipie_torch.utils.rng import GeneratorKeys

    make_cfg = {"r50": r50_coco_panoptic, "vit_huge": vit_huge_coco_panoptic}[preset]
    cfg = dataclasses.replace(apply_overrides(make_cfg(), dict(overrides or {})),
                              output_dir=tempfile.mkdtemp(prefix="hipie_train_"))
    state = step_module.create_train_state(cfg, seed=seed, device=dev)
    step = step_module.make_train_step(cfg, state, device=dev)
    keys = GeneratorKeys(torch.Generator(device=dev).manual_seed(seed))
    batches = iter(train_batches(cfg, WARMUP + 2 * steps + 1, seed))

    def timed():
        t0 = time.perf_counter()
        step(state, next(batches), keys)
        torch.cuda.synchronize()
        return 1000.0 * (time.perf_counter() - t0)

    for _ in range(WARMUP):
        timed()
    torch.cuda.reset_peak_memory_stats()
    s0 = matcher.HOST_SYNCS[0]
    plain_ms = [timed() for _ in range(steps)]
    syncs = (matcher.HOST_SYNCS[0] - s0) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    timer, scope = _PhaseTimer(), step_module.scope
    step_module.scope = timer
    try:
        phase_rows = []
        for _ in range(steps):
            wall = timed()
            phase_rows.append({"wall_ms": wall, **timer.take()})
    finally:
        step_module.scope = scope
    phases = {k: float(np.mean([r.get(k, 0.0) for r in phase_rows])) for k in phase_rows[0]}

    kernels.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_ms = timed()
    launches = dict(kernels.LAUNCHES)
    by_name = {}
    for e in prof.events():
        # the device timeline also carries the step's named ranges, projected
        # from the host ("gpu_user_annotation"): kernels and copies only
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1000.0, count + 1)
    if not by_name:
        raise SystemExit("profile: the profiler recorded no device time")
    per_kernel = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    # device kernels by the hand-written kernels' names (K-E is two a launch:
    # bwd_q_wgmma and bwd_kv_wgmma at the training shapes, dq_kernel and
    # dkv_kernel at the others; K-D one, ms_deform_attn_bwd_kernel, on its
    # atomics design, five on its binned one: ms_deform_attn_bwd_bin_count,
    # _bin_scan, _bin_scatter, _accumulate, _unpermute)
    kernel_names = {"vit_attention": ("vit_attention_kernel",),
                    "vit_attention_bwd": ("bwd_q_wgmma", "bwd_kv_wgmma", "dq_kernel",
                                          "dkv_kernel"),
                    "ms_deform_attn": ("ms_deform_attn_kernel",),
                    "ms_deform_attn_bwd": ("ms_deform_attn_bwd_",)}
    own = {name: [sum(r[i] for r in per_kernel if any(k in r[0] for k in keys)) for i in (1, 2)]
           for name, keys in kernel_names.items()}
    for name, (_, count) in own.items():
        if launches[name] and not count:
            raise SystemExit(f"profile: {name} launched {launches[name]} times, but the trace "
                             f"holds none of its device kernels {kernel_names[name]}")
    plain_mean = float(np.mean(plain_ms))
    print(f"{preset} train step, card {card}: {WARMUP} warm-up steps; ms per step "
          f"{[round(t, 1) for t in plain_ms]}, mean {plain_mean:.1f}; peak memory {peak:.2f} GiB; "
          f"matcher host syncs per step {syncs:.1f}")
    print("device ms between the start and end of each named range (mean of "
          f"{steps} steps): " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()))
    print(f"profiled step {prof_ms:.1f} ms; device busy {busy:.1f} ms; idle share "
          f"{1 - busy / plain_mean:.4f} of the plain steps' mean ({1 - busy / prof_ms:.4f} of "
          f"the profiled step); launches {launches}")
    for name, (ms, count) in own.items():
        print(f"{name}: {ms:.3f} ms of device time in {count} device kernels "
              f"({launches[name]} launches of its wrapper)")
    for name, ms, count in per_kernel[:20]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}")
    return {"preset": preset, "card": card, "plain_ms": plain_ms, "peak_gib": peak,
            "host_syncs": syncs,
            "phases_ms": phases, "profiled_ms": prof_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / plain_mean, "launches": launches,
            "kernel_device_ms": {n: v[0] for n, v in own.items()},
            "top_kernels": [{"name": n[:200], "ms": ms, "count": c}
                            for n, ms, c in per_kernel[:20]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("r50", "vit_huge"), default="r50")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("opts", nargs="*", default=[], help="KEY VALUE config overrides")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_name()
    out = profile_step(dev, card, args.steps, args.seed, args.preset,
                       dict(zip(args.opts[::2], args.opts[1::2])))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
