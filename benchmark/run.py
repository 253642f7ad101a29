"""The benchmark of hipie_torch, the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in BENCHMARK.json at the checkout's root;
each cell's configuration, traffic mix, limits and per-layer readers are files
under benchmark/ found by name (see harness/). Needs as many CUDA cards as the
cell asks for, and exits with an error otherwise.
"""

import time

T0 = time.perf_counter()        # set-up is timed from here

import sys                       # noqa: E402
from pathlib import Path         # noqa: E402

_BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(_BENCH), str(_BENCH / "reference"), str(_BENCH.parent)]

from harness.main import main    # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
