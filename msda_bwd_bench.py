"""Kernel K-D (the MSDA backward) by design and against other K-D sources, on one card.

    python3 msda_bwd_bench.py [--iters 10] [--sass] [--baseline OLD.cu ...]

For each case of chip_smoke.py's MSDA_BWD_CASES (the training step's K-D
shapes, bf16 and f32, the encoder also with local locations) it holds the
design K-D's C entry point takes there (its rule,
``ms_deform_attn_bwd_design``) and, where the rule takes the atomics design,
the binned design asked for, against the plain version's autograd with
chip_smoke.py's ``check_msda_bwd``; times each with chip_smoke.py's
``cuda_time_ms`` (CUDA events around a CUDA graph of launches) and gives the
binned design's bins, chunks and global adds as its launch wrote them
(``bwd_binned_stats``). At the training encoder it also gives each device
kernel's time, by name, from torch.profiler over ``--iters`` eager calls.

Each ``--baseline`` is another K-D source with the first design's C entry
point, ``hipie_ms_deform_attn_bwd(value, shapes, level_start, loc, attw, gout,
grad_value, grad_loc, grad_attw, b, s, m, d, q, n_levels, n_points,
value_is_bf16, vec_channels, threads_per_pair, stream)``, built with nvcc into
its own library under hipie_torch/_build (hipie_torch/csrc on the include
path) and timed in turns with the rule's design (baseline, current, current,
baseline), after the same check. The first design's source (the atomics
design alone) is how the atomics design is timed at the shapes where the rule
takes the binned one: write it from git into a git-ignored directory,
``git show <commit>:hipie_torch/csrc/ms_deform_attn_bwd.cu >
_checkout/ms_deform_attn_bwd.cu``. ``--sass`` compiles a one-line shared f32
``atomicAdd`` for sm_90a and prints the instructions cuobjdump gives it, and
the shared-memory atomics it finds in the built accumulate kernels. Prints one
line per case and source, the card, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import torch

from chip_smoke import (MSDA_BWD_CASES, MSDA_D, MSDA_M, SEED, card_name, check_msda_bwd,
                        cuda_time_ms, msda_inputs)
from vit_bwd_bench import kernel_ms

CSRC = Path(__file__).resolve().parent / "hipie_torch" / "csrc"
# a shared f32 atomicAdd alone, for --sass
PROBE = r"""
extern "C" __global__ void shared_f32_atomic_add(float* out, float v) {
  __shared__ float s[64];
  s[threadIdx.x] = 0.f;
  __syncthreads();
  atomicAdd(&s[threadIdx.x ^ 1], v);
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x];
}
"""


def load_source(src: Path):
    """Build one K-D source with the first design's C entry into its own
    library; returns run(value, levels, loc, attw, gout) -> the three gradients."""
    from hipie_torch.kernels import build
    from hipie_torch.ops.ms_deform_attn import _level_tables, backward_plan

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = Path(tempfile.mkdtemp(prefix="msda_bwd_", dir=build.BUILD_DIR)) / "lib.so"
    nvcc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
                           str(lib_path), str(src)], capture_output=True, text=True)
    if nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{nvcc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).hipie_ms_deform_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(value, levels, loc, attw, gout):
        b, s, m, d = value.shape
        q, p = loc.shape[1], loc.shape[4]
        vc, tpp = backward_plan(d, value.element_size(), 16)
        shapes_t, starts_t = _level_tables(levels, value.device)
        gv = torch.zeros((b, s, m, d), dtype=torch.float32, device=value.device)
        gl, ga = torch.empty_like(loc), torch.empty_like(attw)
        err = fn(value.data_ptr(), shapes_t.data_ptr(), starts_t.data_ptr(), loc.data_ptr(),
                 attw.data_ptr(), gout.data_ptr(), gv.data_ptr(), gl.data_ptr(), ga.data_ptr(),
                 b, s, m, d, q, len(levels), p, int(value.dtype == torch.bfloat16), vc, tpp,
                 torch.cuda.current_stream(value.device).cuda_stream)
        build.check(err, f"K-D from {src}")
        return gv.to(value.dtype), gl, ga

    return run


def _sass_atomics(binary: Path, kernel_part: str) -> dict:
    """The atomic and reduction instructions (ATOMS, ATOM, RED) cuobjdump -sass
    finds in the kernels of ``binary`` whose names hold ``kernel_part``, by
    opcode."""
    from hipie_torch.kernels import build

    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(binary)], capture_output=True, text=True,
                          check=True).stdout
    found, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            continue
        if kernel and kernel_part in kernel and "*/" in line:
            op = line.split("*/", 1)[-1].strip().split(" ")[0].rstrip(";")
            if op.startswith(("ATOMS", "RED", "ATOM")):
                found.setdefault(kernel[:90], Counter())[op] += 1
    return {k: dict(v) for k, v in found.items()}


def shared_atomics_sass() -> dict:
    """What sm_90a makes of a shared f32 atomicAdd (the probe), and the
    shared-memory atomics of the built binned accumulate kernels."""
    from hipie_torch.kernels import build

    work = Path(tempfile.mkdtemp(prefix="sass_probe_", dir=build.BUILD_DIR))
    (work / "probe.cu").write_text(PROBE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-cubin", "-o",
                    str(work / "probe.cubin"), str(work / "probe.cu")], check=True,
                   capture_output=True, text=True)
    return {"probe_shared_f32_atomic_add": _sass_atomics(work / "probe.cubin", "shared_f32"),
            "accumulate": _sass_atomics(build.build().path, "accumulate")}


def main(argv=None) -> int:
    from hipie_torch.ops.ms_deform_attn import (_ms_deform_attn_backward_design,
                                                bwd_binned_stats, ms_deform_attn_backward,
                                                ms_deform_attn_backward_plain)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("msda_bwd_bench: no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_name()
    out = {"card": card, "iters": args.iters}
    if args.sass:
        out["sass_atomics"] = shared_atomics_sass()
        print(f"shared f32 atomicAdd alone: {out['sass_atomics']['probe_shared_f32_atomic_add']}; "
              f"accumulate kernels: {out['sass_atomics']['accumulate']}", flush=True)
    others = {str(src): load_source(src) for src in args.baseline}
    rows = []
    for i, (name, levels, b, q, dtype, locations) in enumerate(MSDA_BWD_CASES):
        value, loc, w = msda_inputs(levels, q, dtype, locations, dev, SEED + 100 + i, b)
        gout = torch.randn((b, q, MSDA_M * MSDA_D), generator=torch.Generator(
            device=dev).manual_seed(SEED + i), device=dev).to(dtype)
        want = ms_deform_attn_backward_plain(value, levels, loc, w, gout)
        got, rule, _ = _ms_deform_attn_backward_design(value, levels, loc, w, gout)
        row = {"case": name, "b": b, "q": q, "dtype": str(dtype)[6:], "locations": locations,
               "rule": rule, "ms": {}, "rel_err": {},
               "atomic_adds": loc[..., 0].numel() * 4 * MSDA_D}
        calls = {rule: lambda: ms_deform_attn_backward(value, levels, loc, w, gout)}
        if rule == "atomics":
            calls["binned"] = lambda: _ms_deform_attn_backward_design(
                value, levels, loc, w, gout, force_binned=True)[0]
        for design, call in calls.items():
            got, taken, scratch = _ms_deform_attn_backward_design(
                value, levels, loc, w, gout, force_binned=design == "binned")
            assert taken == design, (taken, design)
            errs, _ = check_msda_bwd(f"K-D {design} ({name})", got, want, loc, levels)
            if design == "binned":
                row.update(bwd_binned_stats(scratch))
            row["rel_err"][design] = [e[0] for e in errs]
            row["ms"][design] = cuda_time_ms(call, args.iters)
            if name == "train_encoder":
                row.setdefault("kernels_ms", {})[design] = kernel_ms(call, args.iters)
        line = (f"{name:20s} B={b} Q={q} {row['dtype']} {locations}: rule {rule}; "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in row["ms"].items()))
        if "n_chunks" in row:
            line += (f"; {row['n_bins']} bins, {row['n_chunks']} chunks, "
                     f"{row['global_adds'] / 1e6:.1f} M global adds (atomics: "
                     f"{row['atomic_adds'] / 1e6:.1f} M)")
        print(line, flush=True)
        for design, ks in row.get("kernels_ms", {}).items():
            print(f"{'':20s} {design} by kernel: "
                  + ", ".join(f"{k[:60]} {v:.4f}" for k, v in ks.items()), flush=True)
        current = calls[rule]
        for src, run in others.items():
            other = lambda: run(value, levels, loc, w, gout)
            check_msda_bwd(f"K-D ({name}) from {src}", other(), want, loc, levels)
            turns = [cuda_time_ms(f, args.iters) for f in (other, current, current, other)]
            row.setdefault("baselines", {})[src] = {
                "ms": (turns[0] + turns[3]) / 2, "current_ms": (turns[1] + turns[2]) / 2,
                "turns_ms": turns}
            bl = row["baselines"][src]
            print(f"{'':20s} {src}: {bl['ms']:.4f} ms against {bl['current_ms']:.4f} ({rule}) "
                  f"in turns ({bl['ms'] / bl['current_ms']:.3f}x)", flush=True)
        rows.append(row)
        del value, loc, w, gout, want, got
    print(f"card {card}")
    out["cases"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
