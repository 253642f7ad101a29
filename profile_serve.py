"""Where the time of a ViT-H serving request goes, on one GPU.

    python3 profile_serve.py [--requests 5] [--seed 0]

Serves the model of chip_smoke.py's serve phase (its ``vit_huge_server``:
HIPIEModel(vit_huge_coco_panoptic()) in bf16 with seeded random weights, the
256-token prompt encoded once) distinct 1024x1024 uint8 images:

 * 2 warm-up requests, then ``--requests`` plain ones: host wall clock per
   request, ended by a synchronize;
 * 3 plain requests under torch.profiler (device activity only), each timed
   the same way: device busy time per request (the sum of every kernel's and
   copy's time on the card) and the kernels that take the most device time.
   The idle share is 1 - busy / the plain requests' mean wall time: the same
   work, with nothing added on the host. The profiler slows the host, so the
   profiled requests' own idle share is printed beside it but overstates the
   idle;
 * ``--requests`` more with CUDA events on stage hooks and around K-A's and
   K-B's calls: each stage's time and K-A's and K-B's times per request. The
   hooks slow the host, so these requests' wall times are not the ones above.

K-A's and K-B's device times per request (the profiled requests' kernels of
their names) are printed beside the top kernels.

Prints a readable report, then one JSON line with the numbers. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from chip_smoke import card_name, serve_images, timing_msda, timing_vit_attention, vit_huge_server

WARMUP = 2
PROFILED = 3


class _StageTimer:
    """CUDA events around each call of the named modules (a stage may be several
    modules called one after another), summed per request."""

    def __init__(self, stages):
        self.events = {name: [] for name in stages}
        for name, modules in stages.items():
            for module in modules:
                module.register_forward_pre_hook(self._start(name))
                module.register_forward_hook(self._end(name))

    def _start(self, name):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name].append([ev, None])
        return hook

    def _end(self, name):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name][-1][1] = ev
        return hook

    def take(self):
        """Stage -> ms since the last take (call after a synchronize)."""
        out = {name: sum(a.elapsed_time(b) for a, b in evs) for name, evs in self.events.items()}
        for evs in self.events.values():
            evs.clear()
        return out


def _timed(request, img) -> float:
    t0 = time.perf_counter()
    request(img)
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0)


def main(argv=None) -> int:
    from hipie_torch import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_name()
    cfg, model, request = vit_huge_server(dev, args.seed)
    images = iter(serve_images(WARMUP + PROFILED + 2 * args.requests, args.seed))

    with torch.inference_mode():
        for _ in range(WARMUP):
            _timed(request, next(images))
        plain_ms = [_timed(request, next(images)) for _ in range(args.requests)]

        kernels.reset_launch_counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            prof_ms = [_timed(request, next(images)) for _ in range(PROFILED)]
        launches = {k: v / PROFILED for k, v in kernels.LAUNCHES.items()}

        detr = model.detr.detr
        stages = {"backbone": [detr.backbone[0].backbone], "input_proj": list(detr.input_proj),
                  "encoder": [detr.transformer.encoder],
                  "decoder": list(detr.transformer.decoder.layers),
                  "condinst": [model.detr.mask_head]}
        if hasattr(model.detr, "mask_dino"):
            stages["maskdino"] = [model.detr.mask_dino]
        timer = _StageTimer(stages)
        rows = []
        for _ in range(args.requests):
            with timing_vit_attention() as ka_events, timing_msda() as kb_events:
                wall = _timed(request, next(images))
            rows.append({"hooked_wall_ms": wall, **{f"{k}_ms": v for k, v in timer.take().items()},
                         "ka_ms": sum(a.elapsed_time(b) for a, b in ka_events),
                         "ka_launches": len(ka_events),
                         "kb_ms": sum(a.elapsed_time(b) for a, b in kb_events),
                         "kb_launches": len(kb_events)})

    # device-side events only (kernels, copies): an operator's own row would
    # count its kernels' time a second time
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1000.0, count + 1)
    if not by_name:
        raise SystemExit("profile_serve: the profiler recorded no device time")
    per_kernel = sorted(((name, ms / PROFILED, count // PROFILED)
                         for name, (ms, count) in by_name.items()), key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    # device ms and launches per request of each hand-written kernel, by name
    own = {name: [sum(r[i] for r in per_kernel if f"{name}_kernel" in r[0]) for i in (1, 2)]
           for name in ("vit_attention", "ms_deform_attn")}
    plain_mean, prof_mean = float(np.mean(plain_ms)), float(np.mean(prof_ms))
    idle, idle_profiled = 1 - busy / plain_mean, 1 - busy / prof_mean
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print(f"card {card}; {WARMUP} warm-up requests")
    print(f"plain requests: ms {[round(t, 3) for t in plain_ms]}, mean {plain_mean:.3f}")
    print(f"profiled requests: ms {[round(t, 3) for t in prof_ms]}, mean {prof_mean:.3f}; "
          f"device busy {busy:.3f} ms per request; launches per request {launches}")
    for name, (ms, count) in own.items():
        print(f"{name}: {ms:.4f} ms of device time per request in {count} launches")
    print(f"idle share {idle:.4f} of the plain requests' mean wall time "
          f"({idle_profiled:.4f} of the profiled requests', which the profiler slows)")
    for name, ms, count in per_kernel[:12]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}")
    print("requests with stage hooks and K-A events:")
    for i, r in enumerate(rows):
        print(f"  request {i}: " + ", ".join(f"{k} {v:.3f}" for k, v in r.items()))
    print("  mean: " + ", ".join(f"{k} {v:.3f}" for k, v in mean.items()))
    print(json.dumps({"card": card, "plain_ms": plain_ms, "profiled_ms": prof_ms,
                      "device_busy_ms": busy, "idle_share": idle,
                      "idle_share_profiled": idle_profiled, "launches_per_request": launches,
                      "kernel_device_ms": {n: ms for n, (ms, _) in own.items()}, "hooked": rows,
                      "hooked_mean": mean,
                      "top_kernels": [{"name": n[:200], "ms": ms, "count": c}
                                      for n, ms, c in per_kernel[:12]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
