"""``correct`` at a tiny size on the CPU: the whole run but the look for a
card, once sound and once with each fault a cell can have planted under the
timed path; and the control (the reference in fp8 in the program's place)
against each cell's limits."""

import time

import pytest
import torch

import faults
from bench_tiny import tiny_cell
from harness import main, serve, train

CPU = torch.device("cpu")
SERVE, TRAIN = "vith_serve_coco", "vith_train_coco"


def _run(cell, fault=None, seed=21):
    return main.execute(cell, seed, 0.5, False, CPU, time.perf_counter(), fault=fault)["result"]


def test_sound_runs_are_correct():
    assert _run(tiny_cell(SERVE))["correct"]
    assert _run(tiny_cell(TRAIN))["correct"]


@pytest.mark.parametrize("fault,cell", [(faults.ServeHalfBatch, SERVE),
                                        (faults.ServeAlteredAnswer, SERVE),
                                        (faults.TrainStateUnchanged, TRAIN),
                                        (faults.TrainHalfBatch, TRAIN)])
def test_a_broken_timed_path_is_not_correct(fault, cell):
    got = _run(tiny_cell(cell), fault())
    assert not got["correct"], got["checks"]


def test_the_serving_control_fails_its_limits():
    cell = tiny_cell(SERVE, "bfloat16")
    low = serve.control(cell, 21, CPU, 2)
    assert any(low[k] > lim for k, lim in cell.limits.items()), low


def test_the_training_control_fails_its_limits():
    cell = tiny_cell(TRAIN)
    low = train.control(cell, 21, CPU)
    assert any(low[k] > lim for k, lim in cell.limits.items()), low
