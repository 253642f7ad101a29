"""On the card, at the cells' own sizes: a short run of each cell is correct,
and the control (the reference in fp8 in the program's place) fails a limit.

    python3 -m pytest benchmark/tests/test_bench_card.py -m cuda -q      # ~10 min on one H100
"""

import time

import pytest
import torch

from harness import common, main, serve, train

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["vith_serve_coco", "vith_train_coco"])
def test_a_short_run_is_correct_and_the_control_is_not(dev, name):
    cell = common.load_cell(name)
    got = main.execute(cell, 3000000017, 2.0, False, dev, time.perf_counter())["result"]
    assert got["correct"], got["checks"]
    if cell.traffic["kind"] == "serve":
        low = serve.control(cell, 3000000017, dev, cell.traffic["sample_requests"])
    else:
        low = train.control(cell, 3000000017, dev)
    assert any(low[k] > lim for k, lim in cell.limits.items()), low
