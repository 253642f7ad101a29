"""syncs.train (syncs/step): the program's blocking syncs per step, the growth
of its ``host_sync.*`` counters (hipie_torch/utils/trace.py ``COUNTS``: each
device-to-host read or blocking host-to-device copy where it happens, the
matchers' convergence checks among them) over the traced window, over the
steps."""

from harness.spans import host_syncs


def setup(run):
    run.shared["syncs.train"] = host_syncs()


def read(run):
    n0, n1 = run.shared.get("syncs.train"), host_syncs()
    if n0 is None or n1 is None or not run.steps:
        return None
    return (n1 - n0) / run.steps
