"""backward_ms.train (ms): device busy ms per step of the work launched inside
the program's ``backward`` range (hipie_torch/train/step.py): the union of the
device intervals of the kernels, copies and memsets whose launch lies in the
range's host span, from the traced window (harness/trace.py), over the steps.
Idle gaps inside the range do not count."""


def read(run):
    t = run.trace
    if t is None or not run.steps or not t.launched:
        return None
    us = t.range_busy_us(lambda name: name == "backward")
    return us / 1e3 / run.steps if us > 0 else None
