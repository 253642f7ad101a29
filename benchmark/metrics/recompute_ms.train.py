"""recompute_ms.train (ms): device busy ms per step of activation
checkpointing's recompute: the work launched inside the program's
``model.remat`` spans (hipie_torch/layers.py ``maybe_checkpoint``: a
checkpointed ViT block or VL encoder or decoder layer) that lie inside a
``backward`` span (hipie_torch/train/step.py), the union of their device
intervals, from the traced window (harness/trace.py), over the steps."""

from harness.spans import spans_within
from harness.trace import busy_in_spans


def read(run):
    t = run.trace
    if t is None or not run.steps or not t.launched:
        return None
    inner = spans_within(t.spans.get("model.remat", []), t.spans.get("backward", []))
    us = busy_in_spans(t.launched, inner) if inner else 0.0
    return us / 1e3 / run.steps if us > 0 else None
