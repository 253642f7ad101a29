"""criterion_ms.train (ms): device busy ms per step of the work launched inside
the program's criterion ranges (``crit_*`` in hipie_torch/train/step.py: the
fg, bg, encoder, gt/dn and MaskDINO passes with their matchers): the union of
the device intervals of the kernels, copies and memsets whose launch lies in
one of the ranges' host spans, from the traced window (harness/trace.py), over
the steps. Idle gaps inside the ranges do not count."""


def read(run):
    t = run.trace
    if t is None or not run.steps or not t.launched:
        return None
    us = t.range_busy_us(lambda name: name.startswith("crit_"))
    return us / 1e3 / run.steps if us > 0 else None
