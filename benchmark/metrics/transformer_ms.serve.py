"""transformer_ms.serve (ms): device ms per image of the VL encoder and the
decoder (``detr.detr.transformer``: fusion, MSDA encoder, two-stage selection,
decoder), from CUDA events at its forward's start and end in each request of
the traced window, over the images."""

from harness.runctx import event_ms

PATH = "detr.detr.transformer"


def setup(run):
    run.shared["transformer_ms"] = run.time_module(PATH)


def read(run):
    pairs = run.shared.get("transformer_ms")
    if not pairs or not run.images:
        return None
    return event_ms(pairs) / run.images
