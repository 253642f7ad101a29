"""backbone_ms.serve (ms): device ms per image of the backbone
(``detr.detr.backbone.0.backbone``, the ViT), from CUDA events at its forward's
start and end in each request of the traced window, over the images."""

from harness.runctx import event_ms

PATH = "detr.detr.backbone.0.backbone"


def setup(run):
    run.shared["backbone_ms"] = run.time_module(PATH)


def read(run):
    pairs = run.shared.get("backbone_ms")
    if not pairs or not run.images:
        return None
    return event_ms(pairs) / run.images
