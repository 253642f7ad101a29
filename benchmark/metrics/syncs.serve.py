"""syncs.serve (syncs/img): the program's blocking syncs per image, the growth
of its ``host_sync.*`` counters (hipie_torch/utils/trace.py ``COUNTS``: each
device-to-host read or blocking host-to-device copy where it happens) over the
traced window, over the images."""

from harness.spans import host_syncs


def setup(run):
    run.shared["syncs.serve"] = host_syncs()


def read(run):
    n0, n1 = run.shared.get("syncs.serve"), host_syncs()
    if n0 is None or n1 is None or not run.images:
        return None
    return (n1 - n0) / run.images
