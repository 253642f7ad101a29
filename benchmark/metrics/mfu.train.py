"""mfu.train (%): three times the forward's operations per image (the model and
the losses, counted from shapes on the plain reference's first check step by
torch.utils.flop_counter; the backward taken as twice the forward, so remat's
recompute does not count), times the images of the traced window's steps, over
the window's time and the card's bf16 peak (989 TFLOP/s, NVIDIA H100 SXM)."""

from harness.common import H100_BF16_FLOPS


def read(run):
    if not run.flops_per_image or not run.images or run.window_s <= 0:
        return None
    return 100.0 * 3.0 * run.flops_per_image * run.images / run.window_s / H100_BF16_FLOPS
