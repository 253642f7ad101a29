"""postproc_ms.serve (ms): ms per image of post-processing (``hipie_inference``:
token pooling, NMS, top-k, semantic and panoptic fusion), from a CUDA event
when the model's forward returns to one after the request's last image is
post-processed, on the card's timeline: from the end of the model's device
work to the end of post-processing's, the host's NMS loop included."""

import torch


def setup(run):
    pairs, state = [], {}

    def at_forward_end(module, args, out):
        state["start"] = torch.cuda.Event(enable_timing=True)
        state["start"].record()

    def at_request_end():
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        pairs.append((state.pop("start"), end))

    h = run.model.register_forward_hook(at_forward_end)
    run._undo.append(h.remove)
    run.on_request_end.append(at_request_end)
    run.shared["postproc_ms"] = pairs


def read(run):
    pairs = run.shared.get("postproc_ms")
    if not pairs or not run.images:
        return None
    return sum(a.elapsed_time(b) for a, b in pairs) / run.images
