"""The readers of the program's spans and counters on made-up events: idle time
inside spans, the recompute's spans inside the backward, the counters' growth
over the window."""

import pytest

from harness import common, spans, trace
from harness.runctx import Run


def _run(kind, events, **n):
    run = Run(kind)
    run.trace = trace.reduce_events(events)
    for k, v in n.items():
        setattr(run, k, v)
    return run


def _serving_events():
    # (name, on the device, start us, end us, user annotation, correlation id)
    return [
        ("bench.window", False, 0.0, 200.0, True, 1),
        ("model.forward", False, 10.0, 60.0, True, 2),
        ("model.maskdino", False, 40.0, 55.0, True, 3),
        ("cudaLaunchKernel", False, 12.0, 13.0, False, 101),
        ("cudaLaunchKernel", False, 41.0, 42.0, False, 102),     # inside model.maskdino
        ("cudaLaunchKernel", False, 50.0, 51.0, False, 103),     # inside model.maskdino
        ("k1", True, 15.0, 30.0, False, 101),
        ("k2", True, 45.0, 70.0, False, 102),                    # runs past model.forward
        ("k3", True, 52.0, 75.0, False, 103),                    # overlaps k2
        # two images' post-processing; the second's post.nms overlaps its own
        # span and a nested span repeats part of the first
        ("post.image", False, 60.0, 100.0, True, 4),
        ("post.nms", False, 80.0, 95.0, True, 5),
        ("post.image", False, 100.0, 150.0, True, 6),
        ("post.nms", False, 90.0, 120.0, True, 7),
        ("cudaLaunchKernel", False, 101.0, 102.0, False, 104),
        ("k4", True, 110.0, 130.0, False, 104),
    ]


def test_idle_in_spans_counts_the_union_once_and_work_running_into_it():
    assert spans.idle_in_spans_us([(5, 20, "k"), (15, 30, "k")], [(10, 40), (12, 25)]) == 10.0
    assert spans.idle_in_spans_us([], [(0, 10), (5, 15), (20, 30)]) == 25.0
    assert spans.idle_in_spans_us([(0, 50, "k")], [(10, 40)]) == 0.0
    assert spans.idle_in_spans_us([(0, 50, "k")], [(40, 80)], window=(0, 60)) == 10.0


def test_serving_readers():
    run = _run("serve", _serving_events(), images=2)
    # model.forward 10..60: busy 15..30 and 45..60 (k2 runs past its end) -> idle 20
    assert common.load_reader("forward_idle_ms.serve").read(run) == pytest.approx(20e-3 / 2)
    # post.image 60..150: busy 60..75 (k2, k3 launched before) and 110..130 -> idle 55
    assert common.load_reader("postproc_idle_ms.serve").read(run) == pytest.approx(55e-3 / 2)
    # launched inside model.maskdino: k2 and k3, union 45..75
    assert common.load_reader("maskdino_ms.serve").read(run) == pytest.approx(30e-3 / 2)


def test_readers_find_nothing_in_a_program_without_the_spans():
    events = [e for e in _serving_events() if not e[0].startswith(("model.", "post."))]
    run = _run("serve", events, images=2)
    for name in ("forward_idle_ms.serve", "postproc_idle_ms.serve", "maskdino_ms.serve"):
        assert common.load_reader(name).read(run) is None, name
    run = _run("train", events, steps=1)
    assert common.load_reader("recompute_ms.train").read(run) is None


def test_recompute_reads_only_the_remat_spans_inside_the_backward():
    events = [
        ("bench.window", False, 0.0, 300.0, True, 1),
        ("forward", False, 10.0, 100.0, True, 2),
        ("model.remat", False, 20.0, 40.0, True, 3),           # the forward's pass
        ("backward", False, 120.0, 260.0, True, 4),
        ("model.remat", False, 150.0, 170.0, True, 5),         # the recompute
        ("model.remat", False, 200.0, 210.0, True, 6),         # the recompute
        ("cudaLaunchKernel", False, 25.0, 26.0, False, 101),
        ("cudaLaunchKernel", False, 155.0, 156.0, False, 102),
        ("cudaLaunchKernel", False, 180.0, 181.0, False, 103),  # the backward's own
        ("cudaLaunchKernel", False, 205.0, 206.0, False, 104),
        ("fwd", True, 30.0, 50.0, False, 101),
        ("re1", True, 160.0, 175.0, False, 102),
        ("bwd", True, 182.0, 199.0, False, 103),
        ("re2", True, 206.0, 216.0, False, 104),
    ]
    assert spans.spans_within([(20, 40), (150, 170), (200, 210)], [(120, 260)]) == [
        (150, 170), (200, 210)]
    run = _run("train", events, steps=2)
    assert common.load_reader("recompute_ms.train").read(run) == pytest.approx(25e-3 / 2)


@pytest.mark.parametrize("name,kind,per", [("syncs.serve", "serve", "images"),
                                           ("syncs.train", "train", "steps")])
def test_sync_readers_read_the_counters_growth_over_the_window(name, kind, per):
    from hipie_torch.utils import trace as program_trace

    reader = common.load_reader(name)
    program_trace.count("host_sync.normalize", 7)        # before the window
    run = Run(kind)
    reader.setup(run)
    program_trace.count("host_sync.normalize", 2)
    program_trace.count("host_sync.nms_to_host", 4)
    program_trace.count("other.counter", 100)            # not a sync
    setattr(run, per, 3)
    assert reader.read(run) == pytest.approx(6 / 3)


def test_sync_readers_find_nothing_without_the_counters(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "hipie_torch.utils.trace", None)
    assert spans.host_syncs() is None
    run = Run("serve")
    reader = common.load_reader("syncs.serve")
    reader.setup(run)
    run.images = 4
    assert reader.read(run) is None
