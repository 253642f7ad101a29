"""Kernel K-B (fused MSDA) against variants of itself, on one card.

    python3 msda_bench.py [--iters 20] [--baseline OLD.cu]

For each of chip_smoke.py's MSDA_CASES (the ViT-H and R50 paths' shapes, L*P
= 16) it holds K-B against the plain version (``check_msda``) and times it
with chip_smoke.py's ``cuda_time_ms`` (CUDA events around a CUDA graph of
launches):

  * under its own plan, and with each choice of sample groups (1 and 4);
  * "cp_async": hipie_torch/csrc/ms_deform_attn.cu built with
    -DHIPIE_MSDA_STAGE_CP_ASYNC=1, which copies each tile's locations and
    weights into shared memory with 16-byte cp.async before reading them;
  * "baseline", with --baseline: another K-B source whose C entry takes no
    launch plan, ``hipie_ms_deform_attn(value, shapes, level_start, loc, attw,
    out, b, s, m, d, q, n_levels, n_points, value_is_bf16, stream)``, the form
    before ``kernel_plan``. To compare with an older kernel, write it from git
    into a git-ignored directory: ``git show <commit>:hipie_torch/csrc/
    ms_deform_attn.cu > _checkout/ms_deform_attn.cu``.

Each variant is built with nvcc into its own library under hipie_torch/_build
and timed in turns with the current kernel (variant, current, current,
variant). Prints one line per case, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from chip_smoke import (MSDA_CASES, MSDA_D, MSDA_M, SEED, card_name, check_msda, cuda_time_ms,
                        msda_inputs)

SOURCE = Path(__file__).resolve().parent / "hipie_torch" / "csrc" / "ms_deform_attn.cu"


def load_variant(src: Path, defines=(), plan_args: bool = True):
    """Build one K-B source into its own library; returns run(value, levels,
    loc, w, plan) -> out. ``plan_args`` False binds the C entry without the
    launch plan."""
    from hipie_torch.kernels import build
    from hipie_torch.ops.ms_deform_attn import _level_tables

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = Path(tempfile.mkdtemp(prefix="msda_variant_", dir=build.BUILD_DIR)) / "lib.so"
    nvcc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-shared", "-o",
                           str(lib_path), str(src)], capture_output=True, text=True)
    if nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{nvcc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).hipie_ms_deform_attn
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * (11 if plan_args else 8)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(value, levels, loc, w, plan):
        b, s, m, d = value.shape
        q, p = loc.shape[1], loc.shape[4]
        shapes_t, starts_t = _level_tables(levels, value.device)
        out = torch.empty((b, q, m * d), dtype=value.dtype, device=value.device)
        args = [value.data_ptr(), shapes_t.data_ptr(), starts_t.data_ptr(), loc.data_ptr(),
                w.data_ptr(), out.data_ptr(), b, s, m, d, q, len(levels), p,
                int(value.dtype == torch.bfloat16)]
        if plan_args:
            args += [plan.vec_bytes, plan.chunk_threads, plan.groups]
        build.check(fn(*args, torch.cuda.current_stream(value.device).cuda_stream),
                    f"K-B from {src.name}")
        return out

    return run


def main(argv=None) -> int:
    from hipie_torch.ops.ms_deform_attn import (_launch, kernel_plan, ms_deform_attn,
                                                ms_deform_attn_plain)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--baseline", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("msda_bench: no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_name()
    variants = {"cp_async": load_variant(SOURCE, ["-DHIPIE_MSDA_STAGE_CP_ASYNC=1"])}
    if args.baseline is not None:
        variants["baseline"] = load_variant(args.baseline, plan_args=False)
    rows = []
    for i, (name, levels, q, dtype, locations) in enumerate(MSDA_CASES):
        value, loc, w = msda_inputs(levels, q, dtype, locations, dev, SEED + i)
        want = ms_deform_attn_plain(value, levels, loc, w)
        plan = kernel_plan(MSDA_D, value.element_size(), q * MSDA_M)
        current = lambda: ms_deform_attn(value, levels, loc, w)
        check_msda(name, current(), want)
        row = {"case": name, "q": q, "s": value.shape[1], "dtype": str(dtype)[6:],
               "locations": locations, "plan": plan._asdict(),
               "ms": cuda_time_ms(current, args.iters)}
        for g in (1, 4):
            split = lambda: _launch(value, levels, loc, w, kernel_plan(
                MSDA_D, value.element_size(), q * MSDA_M, groups=g))
            check_msda(f"{name}, {g} sample groups", split(), want)
            row[f"groups{g}_ms"] = cuda_time_ms(split, args.iters)
        for vname, run in variants.items():
            other = lambda: run(value, levels, loc, w, plan)
            check_msda(f"{name}, {vname}", other(), want)
            turns = [cuda_time_ms(f, args.iters) for f in (other, current, current, other)]
            row[f"{vname}_ms"] = (turns[0] + turns[3]) / 2
            row[f"{vname}_current_ms"] = (turns[1] + turns[2]) / 2
            row[f"{vname}_turns_ms"] = turns
        rows.append(row)
        print(f"{name:18s} Q={q:5d} S={row['s']:5d} {row['dtype']:8s} kernel {row['ms']:.4f} ms "
              f"(1 group {row['groups1_ms']:.4f}, 4 groups {row['groups4_ms']:.4f}; plan "
              f"{row['plan']}); " + "; ".join(
                  f"{v} {row[f'{v}_ms']:.4f} against {row[f'{v}_current_ms']:.4f} in turns "
                  f"({row[f'{v}_current_ms'] / row[f'{v}_ms']:.3f}x)" for v in variants),
              flush=True)
        del value, loc, w, want
    print(f"card {card}")
    print(json.dumps({"card": card, "iters": args.iters, "cases": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
