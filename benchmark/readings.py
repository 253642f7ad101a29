"""The readings a cell's limits are set from, in one process on the card.

    python3 benchmark/readings.py --workload <name> --seconds 4 \
        --seeds 1,2,3 --control 4,5,6 [--faults 7,8,9] [--out file.json]

For each of ``--seeds`` a whole run of the cell (a short window) and its
numbers compared; for each of ``--control`` the control's numbers (the
reference in fp8 in the program's place); for each of ``--faults`` (training
cells) the numbers of a run with the loss taken over half of each batch
(``tests/faults.py``). Prints one JSON line per reading and writes them all to
``--out``. The benchmark's own runs never run any of this.
"""

import time

T0 = time.perf_counter()

import argparse                  # noqa: E402
import gc                        # noqa: E402
import json                      # noqa: E402
import sys                       # noqa: E402
from pathlib import Path         # noqa: E402

_BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(_BENCH), str(_BENCH / "reference"), str(_BENCH.parent), str(_BENCH / "tests")]

from harness import common, main, serve, train   # noqa: E402


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def run(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    cell = common.load_cell(args.workload)
    main.require_cards(cell.chips)
    import torch

    dev = torch.device("cuda", 0)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in _seeds(args.seeds):
        t = time.perf_counter()
        run = main.execute(cell, seed, args.seconds, False, dev, t)
        got = run["result"]
        emit({"side": "program", "seed": seed, "correct": got["correct"],
              "values": {k: v["value"] for k, v in got["checks"].items()}, "look": run["look"],
              "metrics": {k: v["value"] for k, v in got["metrics"].items()},
              "seconds": time.perf_counter() - t})
        _free()
    for seed in _seeds(args.control):
        t = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            vals = serve.control(cell, seed, dev, cell.traffic["sample_requests"])
        else:
            vals = train.control(cell, seed, dev)
        emit({"side": "control", "seed": seed, "values": vals, "seconds": time.perf_counter() - t})
        _free()
    for seed in _seeds(args.faults):
        import faults

        t = time.perf_counter()
        run = main.execute(cell, seed, args.seconds, False, dev, t, fault=faults.TrainHalfBatch())
        got = run["result"]
        emit({"side": "half_batch", "seed": seed,
              "values": {k: v["value"] for k, v in got["checks"].items()}, "look": run["look"],
              "seconds": time.perf_counter() - t})
        _free()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "card": common.smi(),
                                              "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
