"""postproc_idle_ms.serve (ms): card-idle ms per image inside the program's
``post.image`` spans (``hipie_inference``, one image each): the union of the
spans' host time minus the part of it in which any kernel, copy or memset ran
on the card, from the traced window (harness/spans.py), over the images. The
wait in NMS's copy to the host, its host scan and the launches the card
outruns."""

from harness.spans import idle_in_spans_us


def read(run):
    t = run.trace
    spans = t.spans.get("post.image") if t is not None else None
    if not spans or not run.images:
        return None
    return idle_in_spans_us(t.intervals, spans, t.window) / 1e3 / run.images
