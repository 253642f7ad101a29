"""One run of one cell: parse, refuse without the cards, set up, measure,
judge, print.

The last lines of standard error give each number compared beside its limit;
the last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``;
``checks`` (the numbers compared and their limits) comes last.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time
import traceback
from typing import Any, Dict, List

from harness import common
from harness.runctx import Run

def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"benchmark: the cell asks for {n} cards, "
                         f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def p95(values: List[float]) -> float:
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def execute(cell: common.Cell, seed: int, seconds: float, trace: bool, dev, t0: float,
            fault=None) -> Dict[str, Any]:
    """Everything but the printing; returns the result's dict and the checks.
    ``fault`` (tests only) breaks the timed path underneath."""
    import torch

    from harness import serve, train
    from harness.trace import Trace

    kind = cell.traffic["kind"]
    run = Run(kind)
    readers = {m["name"]: common.load_reader(m["name"]) for m in cell.per_layer} if trace else {}
    run.shared["readers"] = list(readers.values())
    tr = Trace() if trace else None
    if fault is not None:
        fault.install()
    try:
        if kind == "serve":
            got = serve.run_program(cell, seed, seconds, dev, t0, run, tr)
        elif kind == "train":
            got = train.run_program(cell, seed, seconds, dev, t0, run, tr)
        else:
            raise SystemExit(f"unknown traffic kind {kind!r}")
    finally:
        if fault is not None:
            fault.remove()
    found = common.forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: modules of JAX or of the JAX package are loaded: {found}")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if tr is not None:
        t = time.perf_counter()
        run.trace = tr.reduce()
        del tr
        common.log(f"[trace] {run.trace.n_events} events read in {time.perf_counter() - t:.1f} s; "
                   f"busy {run.trace.busy_s:.4f} of {run.trace.window_s:.4f} s; "
                   f"{len(run.trace.launched)} of {len(run.trace.intervals)} device intervals "
                   f"linked to their launch")
    attempted = got["requests"] if kind == "serve" else got["steps"]
    try:
        if kind == "serve":
            vals = serve.judge(cell, seed, dev, got["kept"], got["lang"], got["pool"], run)
        else:
            vals = train.judge(cell, seed, dev, got, run)
    except Exception:     # the reference could not follow what the program produced
        common.log("[judge] the reference could not follow the program:\n"
                   + traceback.format_exc(limit=6))
        vals = {k: float("inf") for k in cell.limits}
    common.log(f"[judge] done {time.perf_counter() - t0:.1f} s after the start")
    checks = common.checks_from(vals, cell.limits)
    correct = all(c.ok for c in checks) and attempted > 0
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in cell.per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"setup_s": got["setup_s"]}
        if kind == "serve":
            e2e["serve_img_per_s"] = got["images"] / got["window_s"]
            e2e["serve_p95_ms"] = 1000.0 * p95(got["latencies_s"])
        else:
            e2e["train_img_per_s"] = got["images"] / got["window_s"]
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(got["peak"])}
    result: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted), "failed": 0,
                              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": [[n, s] for n, s in run.trace.gaps[:10]]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    look = {k: v for k, v in vals.items() if k not in cell.limits}
    return {"result": result, "checks": checks, "run": run, "look": look}


def main(argv, t0: float) -> int:
    args = parse(argv)
    common.set_cache_dirs()
    cell = common.load_cell(args.workload)
    require_cards(cell.chips)
    import torch

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    got = execute(cell, args.seed, args.seconds, bool(args.trace), dev, t0)
    found = common.forbidden_modules()
    if found:
        common.log(f"benchmark: modules of JAX or of the JAX package are loaded: {found}")
        return 3
    for c in got["checks"]:
        common.log(f"[check] {c.name} {c.value!r} limit {c.limit!r} "
                   f"{'ok' if c.ok else 'FAILED'}")
    print(json.dumps(got["result"]), flush=True)
    return 0
