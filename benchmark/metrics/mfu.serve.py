"""mfu.serve (%): the served model's operations per image, counted from shapes
on the plain reference's forward (torch.utils.flop_counter: matrix products
and convolutions; the global attention's two products included, the sampling
of MSDA not), times the images the traced window completed, over the window's
time and the card's bf16 peak (989 TFLOP/s, NVIDIA H100 SXM)."""

from harness.common import H100_BF16_FLOPS


def read(run):
    if not run.flops_per_image or not run.images or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_image * run.images / run.window_s / H100_BF16_FLOPS
