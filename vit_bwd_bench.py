"""Kernel K-E (the ViT global-attention backward) against other K-E sources, on one card.

    python3 vit_bwd_bench.py [--iters 10] [--baseline OLD.cu ...]

For each case of chip_smoke.py's VIT_BWD_CASES it holds K-E against
``vit_attention_bwd_plain`` (``check_vit_attention_bwd``), names the design
the C entry point takes there (``vit_attention_bwd_design``) and times it with
chip_smoke.py's ``cuda_time_ms`` (CUDA events around a CUDA graph of
launches). At the training shape it also gives each device kernel's time, by
name, from torch.profiler over ``--iters`` eager calls (the query-major and
key-major passes).

Each ``--baseline`` is another K-E source with the same C entry point,
``hipie_vit_attention_bwd(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv,
drel_h, drel_w, dvec, bh, n, hd, kh, kw, scale, stream)``, built with nvcc
into its own library under hipie_torch/_build (hipie_torch/csrc on the include
path) and timed in turns with the current kernel (baseline, current, current,
baseline), after the same check. To compare with an older kernel, write it
from git into a git-ignored directory: ``git show <commit>:hipie_torch/csrc/
vit_attention_bwd.cu > _checkout/vit_attention_bwd.cu``. Prints one line per
case and source, the card, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from chip_smoke import (SEED, VIT_BWD_CASES, _vit_bwd_inputs, bound, card_name,
                        check_vit_attention_bwd, cuda_time_ms, nbytes, PEAK_BF16_TENSOR)

CSRC = Path(__file__).resolve().parent / "hipie_torch" / "csrc"


def load_source(src: Path):
    """Build one K-E source into its own library; returns run(q, k, v, rel_h,
    rel_w, out, lse, dout, scale) -> the five gradients."""
    from hipie_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = Path(tempfile.mkdtemp(prefix="vit_bwd_", dir=build.BUILD_DIR)) / "lib.so"
    nvcc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
                           str(lib_path), str(src)], capture_output=True, text=True)
    if nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{nvcc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).hipie_vit_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, rel_h, rel_w, out, lse, dout, scale):
        bh, n, hd = q.shape
        kh, kw = rel_h.shape[-1], rel_w.shape[-1]
        grads = [torch.empty_like(t) for t in (q, k, v, rel_h, rel_w)]
        dvec = torch.empty(bh * n * (1 + kh), device=q.device, dtype=torch.float32)
        err = fn(*(t.data_ptr() for t in (q, k, v, rel_h, rel_w, out, lse, dout, *grads, dvec)),
                 bh, n, hd, kh, kw, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
        build.check(err, f"K-E from {src}")
        return tuple(grads)

    return run


def kernel_ms(fn, iters: int) -> dict:
    """Device ms of each kernel ``fn`` launches, per call, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1000.0 / iters
    return by_name


def main(argv=None) -> int:
    from hipie_torch.ops.vit_attention import (vit_attention_backward, vit_attention_bwd_design,
                                               vit_attention_bwd_plain)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vit_bwd_bench: no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_name()
    others = {str(src): load_source(src) for src in args.baseline}
    rows = []
    for i, (name, bh, kh, kw, hd) in enumerate(VIT_BWD_CASES):
        inputs = _vit_bwd_inputs(bh, kh, kw, hd, dev, SEED + 200 + i)
        scale = hd ** -0.5
        n = kh * kw
        want = vit_attention_bwd_plain(*inputs, scale)
        current = lambda: vit_attention_backward(*inputs, scale)
        check_vit_attention_bwd(f"K-E ({name})", current(), want)
        bnd = bound(5 * 2.0 * bh * n * n * hd, nbytes(*inputs) + nbytes(*want), PEAK_BF16_TENSOR,
                    "tensor cores")
        row = {"case": name, "bh": bh, "n": n, "hd": hd, "kh": kh, "kw": kw,
               "design": vit_attention_bwd_design(n, hd, kh, kw),
               "ms": cuda_time_ms(current, args.iters), "bound_ms": bnd["bound_ms"]}
        if name == "train":
            row["kernels_ms"] = kernel_ms(current, args.iters)
        line = (f"{name:13s} BH={bh} N={n} hd={hd} Kh={kh} Kw={kw} {row['design']}: "
                f"{row['ms']:.4f} ms ({100 * bnd['bound_ms'] / row['ms']:.1f}% of its "
                f"{bnd['bound_ms']:.4f} ms bound)")
        if "kernels_ms" in row:
            line += "; by kernel " + ", ".join(f"{k[:80]} {v:.4f}"
                                               for k, v in row["kernels_ms"].items())
        print(line, flush=True)
        for src, run in others.items():
            other = lambda: run(*inputs, scale)
            check_vit_attention_bwd(f"K-E ({name}) from {src}", other(), want)
            turns = [cuda_time_ms(f, args.iters) for f in (other, current, current, other)]
            row.setdefault("baselines", {})[src] = {
                "ms": (turns[0] + turns[3]) / 2, "current_ms": (turns[1] + turns[2]) / 2,
                "turns_ms": turns}
            b = row["baselines"][src]
            print(f"{'':13s} {src}: {b['ms']:.4f} ms against {b['current_ms']:.4f} in turns "
                  f"({b['ms'] / b['current_ms']:.3f}x)", flush=True)
        rows.append(row)
        del inputs, want
    print(f"card {card}")
    print(json.dumps({"card": card, "iters": args.iters, "cases": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
