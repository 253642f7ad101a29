"""The yardstick of the hand-written kernels: each one's operations and bytes
from its launch's shapes, and its bound on one NVIDIA H100 (the larger of
operations over the peak of the units it runs on and bytes over HBM's rate;
every input read once, every output written once).

K-A ViT global attention (bf16 tensor cores): QK^T and PV, 4 BH N^2 hd.
K-E its backward: five products of 2 BH N^2 hd (S recomputed, dV, dP, dQ, dK).
K-B MSDA forward (f32 cores): 4 corner weights times a multiply-add per
sample and channel, 8 B Q M L P D. K-D its backward: twice that.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

from harness.common import H100_BF16_FLOPS, H100_F32_FLOPS, H100_HBM_BYTES


class Bound(NamedTuple):
    flops: float
    bytes: float
    peak: float

    @property
    def seconds(self) -> float:
        return max(self.flops / self.peak, self.bytes / H100_HBM_BYTES)


def ka(bh: int, n: int, hd: int, kh: int, kw: int, with_lse: bool = False,
       itemsize: int = 2) -> Bound:
    flops = 4.0 * bh * n * n * hd
    nbytes = (4 * bh * n * hd + bh * n * (kh + kw)) * itemsize + (4 * bh * n if with_lse else 0)
    return Bound(flops, nbytes, H100_BF16_FLOPS)


def ke(bh: int, n: int, hd: int, kh: int, kw: int, itemsize: int = 2) -> Bound:
    flops = 10.0 * bh * n * n * hd
    reads = (5 * bh * n * hd + bh * n * (kh + kw)) * itemsize + 4 * bh * n
    writes = (3 * bh * n * hd + bh * n * (kh + kw)) * itemsize
    return Bound(flops, reads + writes, H100_BF16_FLOPS)


def kb(b: int, s: int, q: int, m: int, d: int, levels: int, points: int,
       itemsize: int = 2) -> Bound:
    samples = b * q * m * levels * points
    nbytes = b * s * m * d * itemsize + samples * 2 * 4 + samples * 4 + b * q * m * d * itemsize
    return Bound(8.0 * samples * d, nbytes, H100_F32_FLOPS)


def kd(b: int, s: int, q: int, m: int, d: int, levels: int, points: int,
       itemsize: int = 2) -> Bound:
    samples = b * q * m * levels * points
    value, loc, w = b * s * m * d * itemsize, samples * 2 * 4, samples * 4
    cot = b * q * m * d * itemsize
    return Bound(16.0 * samples * d, 2 * (value + loc + w) + cot, H100_F32_FLOPS)


# device kernels of each hand-written kernel, by name in the trace
KERNEL_NAMES: Dict[str, Tuple[str, ...]] = {
    "K-A": ("vit_attention_kernel",),
    "K-E": ("bwd_q_wgmma", "bwd_kv_wgmma", "dq_kernel", "dkv_kernel"),
    "K-B": ("ms_deform_attn_kernel",),
    "K-D": ("ms_deform_attn_bwd_",),
}


def install_recorders(run) -> Dict[str, list]:
    """Record each launch's Bound of K-A, K-E, K-B and K-D while the window
    runs, by wrapping the port's launchers (the functions that call the C
    entry points). Returns {kernel: [Bound, ...]}; idempotent within a run."""
    if "roofline" in run.shared:
        return run.shared["roofline"]
    import hipie_torch.ops.ms_deform_attn as msda
    import hipie_torch.ops.vit_attention as vit

    got = {k: [] for k in KERNEL_NAMES}

    def msda_shape(value, spatial_shapes, loc):
        b, s, m, d = value.shape
        return b, s, loc.shape[1], m, d, len(spatial_shapes), loc.shape[4], value.element_size()

    def on_ka(q, k, v, rel_h, rel_w, scale, with_lse):
        bh, n, hd = q.shape
        got["K-A"].append(ka(bh, n, hd, rel_h.shape[-1], rel_w.shape[-1], with_lse,
                             q.element_size()))

    def on_ke(q, k, v, rel_h, rel_w, *rest):
        bh, n, hd = q.shape
        got["K-E"].append(ke(bh, n, hd, rel_h.shape[-1], rel_w.shape[-1], q.element_size()))

    def on_kb(value, spatial_shapes, loc, *rest, **kw):
        got["K-B"].append(kb(*msda_shape(value, spatial_shapes, loc)))

    def on_kd(value, spatial_shapes, loc, *rest, **kw):
        got["K-D"].append(kd(*msda_shape(value, spatial_shapes, loc)))

    run.wrap(vit, "_forward_kernel", on_ka)
    run.wrap(vit, "vit_attention_backward", on_ke)
    run.wrap(msda, "_launch", on_kb)
    run.wrap(msda, "_ms_deform_attn_backward_design", on_kd)
    run.shared["roofline"] = got
    return got


def roofline_percent(run, kernel: str):
    """100 x (sum of the launches' bounds) / (their device time in the trace),
    or None where the window launched none or the trace holds none."""
    got = run.shared.get("roofline", {}).get(kernel)
    if not got or run.trace is None:
        return None
    us, n = run.trace.kernel_us(KERNEL_NAMES[kernel])
    if n == 0 or us <= 0:
        return None
    return 100.0 * sum(b.seconds for b in got) / (us / 1e6)
