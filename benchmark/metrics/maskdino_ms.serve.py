"""maskdino_ms.serve (ms): device busy ms per image of the work launched inside
the program's ``model.maskdino`` spans (hipie_torch/models/detector.py: the
MaskDINO branch and its class head): the union of the device intervals whose
launch lies in a span's host time, from the traced window (harness/trace.py),
over the images."""


def read(run):
    t = run.trace
    if t is None or not run.images or not t.launched:
        return None
    us = t.range_busy_us(lambda name: name == "model.maskdino")
    return us / 1e3 / run.images if us > 0 else None
