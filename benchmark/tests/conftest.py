"""The benchmark's own tests (CPU; the ones marked ``cuda`` skip without a card).

    python3 -m pytest benchmark/tests -q
"""

import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH / "reference"), str(BENCH.parent), str(Path(__file__).parent)]
os.environ.setdefault("OMP_NUM_THREADS", "2")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips where torch.cuda finds none)")
