"""forward_idle_ms.serve (ms): card-idle ms per image inside the program's
``model.forward`` spans (``HIPIEModel.forward``, one a request): the union of
the spans' host time minus the part of it in which any kernel, copy or memset
ran on the card, from the traced window (harness/spans.py), over the images.
Launch-bound stretches and queues drained by blocking copies."""

from harness.spans import idle_in_spans_us


def read(run):
    t = run.trace
    spans = t.spans.get("model.forward") if t is not None else None
    if not spans or not run.images:
        return None
    return idle_in_spans_us(t.intervals, spans, t.window) / 1e3 / run.images
