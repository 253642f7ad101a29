"""The plain reference (benchmark/reference/hipie_plain, a frozen copy of the
port's plain versions) against the port, at a tiny size on the CPU where the
port runs its plain versions too."""

import time

import torch

from bench_tiny import tiny_cell
from harness import common, serve, traffic, train
from harness.runctx import Run


def test_reference_serves_what_the_port_serves():
    dev = torch.device("cpu")
    cell = tiny_cell("vith_serve_coco")
    prog, ref = serve.program_side(cell, 11, dev), serve.reference_side(cell, 11, dev)
    prog.model.float()
    pool = traffic.serve_pool(cell.traffic, 11, pin=False)
    x = serve.request_batches(cell.traffic, pool)[0]
    with torch.no_grad():
        prog.encode()
        ref.encode()
        assert torch.equal(prog.lang, ref.lang)
        a, b = serve.flat(serve.trim(prog.forward(x))), serve.flat(serve.trim(ref.forward(x)))
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_reference_trains_as_the_port_trains():
    dev = torch.device("cpu")
    cell = tiny_cell("vith_train_coco")
    cell.config = dict(cell.config, overrides={**cell.config["overrides"],
                                               "model.dtype": "float32"})
    run = Run("train")
    got = train.run_program(cell, 5, 0.0, dev, time.perf_counter(), run)
    want = train.reference_steps(cell, 5, dev, got["pool"], train.as_replay(got["record"]))
    vals = train.compare(got["record"], want)
    assert vals["loss_gap"] < 1e-6 and vals["choice_gap"] == 0.0
    assert vals["grad_gap"] < 1e-4 and vals["delta_gap"] < 1e-4


def test_weights_are_the_same_on_both_sides():
    named = [("a.weight", (4, 3)), ("a.bias", (4,)), ("n.weight", (4,)),
             ("s.sampling_offsets.bias", (8,))]
    one = common.draw_weights(named, 3, "cpu", torch.bfloat16)
    two = common.draw_weights(named, 3, "cpu", torch.bfloat16)
    assert set(one) == {"a.weight", "a.bias"}
    assert all(torch.equal(one[k], two[k]) for k in one)
    other = common.draw_weights(named, 4, "cpu", torch.bfloat16)
    assert not torch.equal(one["a.weight"], other["a.weight"])
