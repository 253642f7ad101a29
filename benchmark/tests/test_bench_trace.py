"""The trace's reduction: busy time, idle gaps and the device time of the work
launched inside a host range, on made-up events."""

from harness import trace


def _events():
    # (name, on the device, start us, end us, user annotation, correlation id)
    return [
        ("bench.window", False, 0.0, 100.0, True, 1),
        ("backward", False, 10.0, 40.0, True, 2),
        ("cudaLaunchKernel", False, 12.0, 13.0, False, 101),    # inside backward
        ("cudaLaunchKernel", False, 30.0, 31.0, False, 102),    # inside backward
        ("cudaLaunchKernel", False, 50.0, 51.0, False, 103),    # after it
        ("aten::mm", False, 60.0, 90.0, False, 7),
        ("k1", True, 20.0, 30.0, False, 101),
        ("k2", True, 25.0, 45.0, False, 102),                   # overlaps k1, runs past the range
        ("k3", True, 55.0, 60.0, False, 103),
    ]


def test_busy_idle_and_gaps():
    r = trace.reduce_events(_events())
    assert r.window_s == 100e-6 and r.busy_us == 30.0
    assert r.gaps[0] == ("aten::mm", 40e-6)           # 60..100: the host in aten::mm
    assert [n for n, _ in r.gaps] == ["aten::mm", "host_idle", "cudaLaunchKernel"]


def test_range_busy_counts_the_work_launched_inside_it_once():
    r = trace.reduce_events(_events())
    assert len(r.launched) == 3
    assert r.range_busy_us(lambda n: n == "backward") == 25.0    # k1 and k2's union
    assert r.range_busy_us(lambda n: n == "forward") == 0.0


def test_nested_spans_count_once():
    launched = [(5.0, 0.0, 10.0), (6.0, 5.0, 12.0), (20.0, 20.0, 21.0)]
    assert trace.busy_in_spans(launched, [(4.0, 8.0), (5.0, 7.0)]) == 12.0
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4.0
