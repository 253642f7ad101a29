"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

 1. device: the card's name and power limit (nvidia-smi), and torch's view.
 2. build: compile the hand-written kernels (hipie_torch/csrc/*.cu) for sm_90a,
    one nvcc per source in parallel, and print nvcc's register and
    shared-memory report.
 3. kernels: every kernel of the serving and training paths against its
    plain PyTorch version on the card at the paths' shapes, with max errors,
    tolerances and times (CUDA events around a CUDA graph of calls, so that the
    small shapes show the card's time and not the host's); each kernel's bound
    (operations over the peak rate of their type, or bytes over the HBM rate,
    whichever is larger) and, where one PyTorch call computes the same
    function, that call's time (SDPA with the rel-pos bias prebuilt as a bf16
    mask for K-A, SDPA's backward with that mask requiring grad plus the two
    reductions of its gradient for K-E, einsum for K-C; the port never calls
    them); K-A at VIT_CASES (a request's shape and the ViT-H train step's),
    with and without its logsumexp output (against torch.logsumexp); K-E (the backward
    of K-A) at VIT_BWD_CASES against vit_attention_bwd_plain
    (check_vit_attention_bwd), naming the design (wgmma or mma.sync) the C
    entry point took at each; and the
    ``flat4`` MSDA formulation (K-C) against the fused one (K-B) at the R50
    encoder shape. K-B runs MSDA_CASES: the ViT-H and R50 encoders (uniform
    and local locations), decoders and MaskDINO decoders in bf16, the R50 ones
    and the ViT-H encoder in f32, and the training step's three shapes at
    batch 2 at 1024x1024 and at the pipeline phase's 256x256; its record
    adds each case's numbers and bound and the encoder's corner-row traffic
    and rate. K-D (the MSDA backward) runs MSDA_BWD_CASES, every training
    shape in bf16 and f32 (the encoder also with local locations; the
    pipeline phase's 256x256 shapes in bf16),
    against the plain version's autograd (``check_msda_bwd``), its plain time
    by CUDA events around eager calls (autograd does not go into a graph),
    naming the design its C entry launched at each ("binned" or "atomics")
    and, for the binned one, its bins, chunks and global adds as the launch
    wrote them into its scratch (``bwd_binned_stats``), beside the atomics
    design's adds.
 4. reference: the tiny-config slice (narrow ViT) in f32 on the card, against
    the same weights run on the CPU through the plain versions, once with
    fused MSDA and once with ``flat4``.
 5. serve: HIPIEModel for vit_huge_coco_panoptic() at full width in bf16,
    random weights from a seeded torch.Generator; the 256-token class prompt is
    encoded once, then 3 distinct 1024x1024 uint8 images are answered through
    HIPIEModel.forward(..., lang_hidden=...) and hipie_inference. The kernels'
    launch counts over those requests must be exactly the path's, and K-A's
    and K-B's times per request are summed from CUDA events around their calls.
    K-B's launches are also counted by shape: its ms per request is each
    shape's time from phase 3 times these counts.
 6. predict: HIPIEPredictor over HIPIEModel(r50_coco_panoptic()) at full width
    in bf16 with seeded random weights and the toy tokenizer over the COCO
    panoptic words, on distinct 480x640 uint8 images (resized to 800x1067,
    padded to the 800x1216 bucket): 2 panoptic calls with the 133 labels, 1
    grounding call, 1 PartSegmDemo panoptic + parts call (exact K-B counts),
    then the panoptic call through a second model with msda_method="flat4"
    and the same weights (exact K-C counts); then one f32 request through both
    methods, compared before any top-k.
 7. train: r50_coco_panoptic() trained at full width through
    hipie_torch.train (create_train_state, make_train_step, Trainer): f32
    master weights, bf16 autocast compute, random init from a seeded
    torch.Generator, TRAIN_STEPS optimizer steps on synthetic batches from the
    seed (2 canvases of 1024x1024, one with a pad band; a 256-token prompt; 100
    GT slots, a different count of things and stuff valid per image; masks at
    256x256). It asserts every loss term finite, every trainable parameter a
    finite gradient and every frozen one none (the optimizer's labels), the
    parameters moved, the lr equal to the schedule, and K-B and K-D launched
    exactly 21 times each a step; it prints the ms per step, peak memory and
    matcher host syncs per step. Every encoder-shape K-D launch of phases 7
    and 8 must take the binned design, and every launch the design the rule
    names at its shape (``check_kd_designs``).
 8. ViT-H train: the same for vit_huge_coco_panoptic() (full width and depth,
    drop path, activation checkpointing of the ViT blocks and the encoder and
    decoder layers), VIT_TRAIN_STEPS steps: each kernel's launches a step
    exact as train_launches counts them from the config (K-A 48 with remat's
    recomputation, K-E 24, K-B 33, K-D 21), and every global block whose
    attention branch the last step kept has nonzero qkv and rel-pos gradients.
    K-A's and K-E's counts are also held to the 24 global blocks ViT-H has,
    counted without the model's dispatch predicate, and every K-E launch must
    take the wgmma design.
 9. pipeline: dataset to PQ through the port's entry points. The fixture
    (hipie_torch.tools.make_tiny_coco: 6 train and 4 val 256x256 PNG images,
    the refcoco splits) in a temporary directory; train_net.main on
    configs/smoke_tiny_coco.yaml (R50 and BERT-base at full width, batch 2 of
    256x256 LSJ crops, 64 text tokens) over coco_panoptic_train and
    refcoco-mixed, so that the detection and the grounding steps both run:
    PIPE_STEPS steps, a checkpoint and an inline evaluation (2 val images)
    at the last; a fresh Trainer resumed from that checkpoint, its model and
    AdamW state bit-equal to the saved ones and its step PIPE_STEPS, then
    PIPE_MORE_STEPS more steps; eval_net.main on coco_panoptic_val with the
    checkpoint (box and mask AP, PQ, SQ, RQ, PQ_th, PQ_st, each finite; with
    random weights PQ may be 0). It prints each step's task, loss, data time
    and step time, the fixture's size, whether the native mask IoU (evalcore)
    built, each checkpoint's bytes and seconds to save, the seconds to resume;
    K-B and K-D must each be launched in the phase (counts reset before it).
Every shape at which phases 5 and 8 launched K-A, every shape at which phases
5 to 9 launched K-B, every shape at which phases 7 to 9 launched K-D, and
every shape at which phase 8 launched K-E must be one that phase 3 checked.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_REQUESTS = 3
IMG = 1024
N_CLASSES = 133                   # COCO panoptic: 80 things + 53 stuff
# R50 path: 480x640 images -> 800x1067, padded to the 800x1216 bucket. Levels
# at strides 8, 16, 32 and the extra stride-64 map (13x19 from 25x38).
R50_IMAGE = (480, 640)
R50_BUCKET = (800, 1216)
R50_LEVELS = ((100, 152), (50, 76), (25, 38), (13, 19))
R50_S = sum(h * w for h, w in R50_LEVELS)          # 20197 encoder queries
# ViT-H path: the 1024x1024 image's levels at strides 8 to 64.
VITH_LEVELS = ((128, 128), (64, 64), (32, 32), (16, 16))
VITH_S = sum(h * w for h, w in VITH_LEVELS)        # 21760 encoder queries
# K-B's cases: every (levels, Q, dtype) the serving and predictor paths give
# it (8 heads of 32, 4 points a level; encoder Q = S and decoder 900 + 10
# queries over the levels largest first, MaskDINO's 300 over them smallest
# first; the predictor's f32 request), and both encoders with local
# locations. main() fails if the paths launch K-B at a shape not here.
MSDA_M, MSDA_D, MSDA_P = 8, 32, 4
# The R50 training step (hipie_torch.train): batch 2 of 1024x1024 canvases, so
# the ViT-H levels; encoder Q = S, decoder 200 CDN + 10 bg + 900 fg queries,
# MaskDINO decoder 200 seg-DN + 300 queries (levels smallest first).
TRAIN_B = 2
TRAIN_DEC_Q = 200 + 10 + 900
TRAIN_MD_Q = 200 + 300
# The pipeline phase (configs/smoke_tiny_coco.yaml: R50, batch 2 of 256x256
# LSJ crops): levels at strides 8 to 64, encoder Q = S = 1360, the decoder's
# and MaskDINO's queries as in the training step above.
PIPE_SIZE = 256
PIPE_LEVELS = ((32, 32), (16, 16), (8, 8), (4, 4))
PIPE_S = sum(h * w for h, w in PIPE_LEVELS)        # 1360 encoder queries
MSDA_CASES = (
    # name, levels, B, Q, dtype, locations
    ("encoder", VITH_LEVELS, 1, VITH_S, torch.bfloat16, "uniform"),
    ("encoder_local", VITH_LEVELS, 1, VITH_S, torch.bfloat16, "local"),
    ("decoder", VITH_LEVELS, 1, 910, torch.bfloat16, "uniform"),
    ("maskdino", VITH_LEVELS[::-1], 1, 300, torch.bfloat16, "uniform"),
    ("encoder_f32", VITH_LEVELS, 1, VITH_S, torch.float32, "uniform"),
    ("r50_encoder", R50_LEVELS, 1, R50_S, torch.bfloat16, "uniform"),
    ("r50_encoder_local", R50_LEVELS, 1, R50_S, torch.bfloat16, "local"),
    ("r50_decoder", R50_LEVELS, 1, 910, torch.bfloat16, "uniform"),
    ("r50_maskdino", R50_LEVELS[::-1], 1, 300, torch.bfloat16, "uniform"),
    ("r50_encoder_f32", R50_LEVELS, 1, R50_S, torch.float32, "uniform"),
    ("r50_decoder_f32", R50_LEVELS, 1, 910, torch.float32, "uniform"),
    ("r50_maskdino_f32", R50_LEVELS[::-1], 1, 300, torch.float32, "uniform"),
    ("train_encoder", VITH_LEVELS, TRAIN_B, VITH_S, torch.bfloat16, "uniform"),
    ("train_decoder", VITH_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("train_maskdino", VITH_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("pipe_encoder", PIPE_LEVELS, TRAIN_B, PIPE_S, torch.bfloat16, "uniform"),
    ("pipe_decoder", PIPE_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("pipe_maskdino", PIPE_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
)
# K-D's cases: every shape the training phase launches it at (bf16), each also
# in f32, and the encoder with local locations; main() fails if the training
# phase launches K-D at a shape not here. The encoder cases take K-D's binned
# design, the others its atomics design (the C entry's rule).
MSDA_BWD_CASES = (
    ("train_encoder", VITH_LEVELS, TRAIN_B, VITH_S, torch.bfloat16, "uniform"),
    ("train_encoder_local", VITH_LEVELS, TRAIN_B, VITH_S, torch.bfloat16, "local"),
    ("train_decoder", VITH_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("train_maskdino", VITH_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("train_encoder_f32", VITH_LEVELS, TRAIN_B, VITH_S, torch.float32, "uniform"),
    ("train_decoder_f32", VITH_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.float32, "uniform"),
    ("train_maskdino_f32", VITH_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.float32, "uniform"),
    ("pipe_encoder", PIPE_LEVELS, TRAIN_B, PIPE_S, torch.bfloat16, "uniform"),
    ("pipe_decoder", PIPE_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("pipe_maskdino", PIPE_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
)
# K-A's cases (name, BH, Kh, Kw, hd), bf16: a ViT-H request (one image: BH =
# 16, N = 4096, hd 80) and the ViT-H training step (batch 2: BH = 32), each
# with and without the logsumexp. main() fails if the serve or a train phase
# launches K-A at a shape not here.
VIT_CASES = (
    ("serve", 16, 64, 64, 80),
    ("train", 32, 64, 64, 80),
)
# K-E's cases (name, BH, Kh, Kw, hd), bf16: the ViT-H training shape (batch 2:
# BH = 32, N = 4096, hd 80), one image, ViT-L's head dim 64 (these three take
# the wgmma design: Kw = 64, hd 64 or 80, N a multiple of 128), then Kh = Kw =
# 40 (the per-element bias path), a partial last 64-row tile (N = 400) and Kh
# != Kw (these take the mma.sync design). The record names the design each
# case took. main() fails if the ViT-H train phase launches K-E at a shape not
# here, or at one the wgmma design does not take.
VIT_BWD_CASES = (
    ("train", 32, 64, 64, 80),
    ("one_image", 16, 64, 64, 80),
    ("vit_large", 32, 64, 64, 64),
    ("kh40", 32, 40, 40, 80),
    ("partial_tile", 32, 20, 20, 80),
    ("kh_ne_kw", 32, 32, 48, 80),
)
# Published H100 SXM peaks (NVIDIA's data sheet), for each kernel's bound.
PEAK_BF16_TENSOR = 989e12        # FLOP/s, dense bf16 on the tensor cores
PEAK_F32 = 67e12                 # FLOP/s, f32 outside the tensor cores
PEAK_HBM = 3.35e12               # bytes/s


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` by CUDA events around one replay of a CUDA graph that
    holds ``iters`` calls: the card's time alone, without the host's cost of
    launching (which exceeds K-B's at its small shapes). Repeated calls on
    the same inputs find them in L2 where they fit, as the path's do after
    the op that writes them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up, off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, flop_rate: float, unit: str) -> dict:
    """Least time for the work: the larger of the operations over the peak rate
    of their type and the bytes (each input read once, each output written
    once) over the HBM rate."""
    ops_ms, bytes_ms = 1e3 * flops / flop_rate, 1e3 * nbytes / PEAK_HBM
    by_ops = ops_ms >= bytes_ms
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if by_ops else "bytes",
            "bound_unit": unit if by_ops else "HBM", "bound_flops": flops, "bound_bytes": nbytes}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def check_attention(what, got, want):
    """(max abs err, tol, relative norm err) of a ViT attention output against
    the plain version; raises past either limit. A softmax over thousands of
    keys gives small outputs (std ~0.03 at the ViT-H shape), so the limits
    scale with the output: 2^-6 max|want| is 2-4 bf16 ulps of the largest
    output (each side rounds P and the output to bf16, at other points), and
    a relative norm error of 1e-2 catches a scale error or a dropped 128-key
    tile (>= 3% at N = 4096)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    tol = 2 ** -6 * w.abs().max().item()
    rel = ((g - w).norm() / w.norm()).item()
    if not (err <= tol and rel <= 1e-2):
        raise AssertionError(f"{what} disagrees with the plain version: max abs err {err} "
                             f"(tol {tol}), relative norm err {rel} (tol 1e-2)")
    return err, tol, rel


def rel_norm_err(got, want) -> float:
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def check_vit_attention_bwd(what, got, want):
    """Relative norm errors of K-E's (dq, dk, dv, d rel_h, d rel_w) against
    vit_attention_bwd_plain on the same bf16 inputs, lse and cotangent; raises
    past a limit. Both compute in f32 and round each gradient to bf16 once.
    dq and dk: the kernel also rounds dS to bf16 (2^-9 relative a value) for
    its tensor-core products where the plain version keeps f32 (~2.6e-3 in
    norm at the ViT-H shape): 1e-2, which a dropped 64-key tile (~12%)
    exceeds. dv, d rel_h, d rel_w: both take the same bf16 P or f32 dS and
    differ in summation order, the exp2 approximation and the output's one
    rounding (at most 2^-9 a value): 2e-3."""
    errs = []
    for name, g, w in zip(("dq", "dk", "dv", "d rel_h", "d rel_w"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what} {name}: {g.dtype} {tuple(g.shape)} against "
                                 f"{w.dtype} {tuple(w.shape)}, or not finite")
        g, w = g.float(), w.float()
        rel = rel_norm_err(g, w)
        tol = 1e-2 if name in ("dq", "dk") else 2e-3
        if not rel <= tol:
            raise AssertionError(f"{what} {name} disagrees with the plain version: relative "
                                 f"norm err {rel} (tol {tol})")
        errs.append((rel, tol, (g - w).abs().max().item()))
    return errs


def vit_shape(q, rel_h, rel_w):
    """K-A's and K-E's shape of a call: (BH, N, hd, Kh, Kw, dtype)."""
    return (*q.shape, rel_h.shape[-1], rel_w.shape[-1], str(q.dtype)[6:])


def check_msda(what, got, want):
    """(max abs err, its limit, relative norm err) of K-B against the plain
    version; raises past a limit. Both sample the same values in f32 and
    differ in summation order: f32 to 1e-5. bf16 then rounds once on each
    side: at most one bf16 ulp of the largest output, 2^-7 max|plain|, and a
    relative norm error of 1e-3 (a dropped sample moves it by several %)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
    if got.dtype == torch.float32:
        tol, rel_tol = 1e-5, 1e-5
    else:
        tol, rel_tol = 2 ** -7 * w.abs().max().item(), 1e-3
    if not (got.dtype == want.dtype and got.shape == want.shape and err <= tol
            and rel <= rel_tol):
        raise AssertionError(f"{what} disagrees with the plain version: {got.dtype} "
                             f"{tuple(got.shape)} against {want.dtype} {tuple(want.shape)}, "
                             f"max abs err {err} (tol {tol}), relative norm err {rel} "
                             f"(tol {rel_tol})")
    return err, tol, rel


def local_locations(rng: np.random.Generator, shapes, m: int, p: int, b: int = 1) -> np.ndarray:
    """(b, S, m, L, p, 2) f32: query i (position i of the level-ordered map)
    samples each level l at its own pixel centre plus N(0, 2) pixels of level
    l per point and axis: the locality MSDeformAttn's radial grid gives."""
    centres = []
    for h, w in shapes:
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        centres.append(np.stack([xs.ravel(), ys.ravel()], -1))
    c = np.concatenate(centres).astype(np.float32)                        # (S, 2) as (x, y)
    wh = np.array([[w, h] for h, w in shapes], np.float32)               # (L, 2)
    off = rng.standard_normal((b, len(c), m, len(shapes), p, 2), dtype=np.float32) * 2.0
    return c[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]


def msda_inputs(levels, q: int, dtype, locations: str, dev, seed: int, b: int = 1):
    """MSDA inputs for one of MSDA_CASES or MSDA_BWD_CASES, made from ``seed``
    with numpy: value (b, S, 8, 32) N(0, 1), locations (b, Q, 8, L, 4, 2)
    uniform over [-0.05, 1.05] (some samples off the map) or local (Q = S),
    weights (b, Q, 8, L, 4) summing to 1 over (L, P)."""
    rng = np.random.default_rng(seed)
    s, n_levels = sum(h * w for h, w in levels), len(levels)
    value = rng.standard_normal((b, s, MSDA_M, MSDA_D), dtype=np.float32)
    if locations == "local":
        assert q == s, "local locations need Q = S"
        loc = local_locations(rng, levels, MSDA_M, MSDA_P, b)
    else:
        loc = rng.uniform(-0.05, 1.05, (b, q, MSDA_M, n_levels, MSDA_P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (b, q, MSDA_M, n_levels, MSDA_P)).astype(np.float32)
    w /= w.sum(axis=(-1, -2), keepdims=True)
    return (torch.from_numpy(value).to(dev, dtype), torch.from_numpy(loc).to(dev),
            torch.from_numpy(w).to(dev))


def msda_shape(value, spatial_shapes, sampling_locations, attention_weights, method="fused"):
    """K-B's shape of an MSDA call, (levels, B, Q, M, D, dtype); None for a
    call that does not reach K-B."""
    if method != "fused":
        return None
    levels = tuple((int(h), int(w)) for h, w in spatial_shapes)
    b, q, m = sampling_locations.shape[:3]
    return levels, b, q, m, value.shape[-1], str(value.dtype)[6:]


def corner_bytes(value, loc) -> int:
    """Bytes of the corner rows K-B gathers: 4 rows of D values per sample."""
    b, q, m, n_levels, p, _ = loc.shape
    return b * q * m * n_levels * p * 4 * value.shape[-1] * value.element_size()


def phase_device():
    card = card_name()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return card


def phase_build():
    from hipie_torch.kernels import build

    info = build.build()
    log(f"[build] {info.path} in {info.seconds:.1f} s (cached: {info.cached})")
    for line in info.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    build.load()


def phase_kernels(dev, card):
    """Each kernel vs its plain version at the serving path's shapes, with its
    bound and the time of the one PyTorch call that computes the same function
    (timed here only, never called by the port)."""
    from hipie_torch import kernels

    rng = np.random.RandomState(SEED)
    records = []
    ka_record, vit_cases = _check_vit_attention(dev, card, rng)
    records.append(ka_record)
    bwd_record, bwd_vit_cases = _check_vit_attention_bwd(dev, card)
    records.append(bwd_record)

    msda_record, msda_cases = _check_msda(dev, card)
    records.append(msda_record)
    records.append(_check_msda_reduce(dev))
    _check_flat4(dev, rng)
    bwd_record, bwd_cases = _check_msda_bwd(dev, card)
    records.append(bwd_record)
    kernels.reset_launch_counts()      # launches made for comparison do not count
    return records, vit_cases, msda_cases, bwd_cases, bwd_vit_cases


def _check_vit_attention(dev, card, rng):
    """K-A at every case of VIT_CASES, with and without the logsumexp:
    the output against vit_attention_plain (check_attention), the lse
    against torch.logsumexp of the plain logits, each timed. At the serving
    shape also the plain version and the library call: SDPA with the bias
    materialised once as a bf16 mask. Returns the record (the serving shape's
    numbers, every case's under "shapes") and the cases."""
    from hipie_torch.ops.vit_attention import (vit_attention_forward, vit_attention_logits,
                                               vit_attention_plain, vit_global_attention)

    cases = []
    for i, (name, bh, kh, kw, hd) in enumerate(VIT_CASES):
        # the serving case draws from the phase's stream, each other from its own seed
        r = rng if i == 0 else np.random.RandomState(SEED + 100 + i)
        n = kh * kw
        mk = lambda *s, sc=1.0: torch.from_numpy(sc * r.randn(*s).astype(np.float32)).to(
            dev, torch.bfloat16)
        q, k, v = mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, hd)
        rh, rw = mk(bh, n, kh, sc=0.3), mk(bh, n, kw, sc=0.3)
        scale = hd ** -0.5
        got = vit_global_attention(q, k, v, rh, rw, scale)
        want = vit_attention_plain(q, k, v, rh, rw, scale)
        torch.cuda.synchronize()
        err, tol, rel = check_attention(f"vit_attention ({name})", got, want)
        # the training forward: K-A also writes the per-row logsumexp
        out_lse, lse = vit_attention_forward(q, k, v, rh, rw, scale)
        lse_want = torch.logsumexp(vit_attention_logits(q, k, rh, rw, scale), -1)
        torch.cuda.synchronize()
        lse_err = (lse - lse_want).abs().max().item()
        if not (torch.equal(out_lse, got) and lse_err <= 1e-4):
            raise AssertionError(f"vit_attention with lse ({name}): output changed or lse off "
                                 f"by {lse_err} (tol 1e-4; both take f32 logits, the kernel "
                                 f"exp2 in another order)")
        del lse_want
        ms = cuda_time_ms(lambda: vit_global_attention(q, k, v, rh, rw, scale), 20)
        lse_ms = cuda_time_ms(lambda: vit_attention_forward(q, k, v, rh, rw, scale), 20)
        b = bound(4.0 * bh * n * n * hd, nbytes(q, k, v, rh, rw, got), PEAK_BF16_TENSOR,
                  "tensor cores")
        c = {"case": name, "bh": bh, "n": n, "hd": hd, "kh": kh, "kw": kw, "ms": ms,
             "ms_with_lse": lse_ms, "max_abs_err": err, "rel_err": rel,
             "lse_max_abs_err": lse_err, **b, "shape": vit_shape(q, rh, rw)}
        line = (f"[kernels] vit_attention {name} BH={bh} N={n} hd={hd} Kh={kh} Kw={kw} bf16: "
                f"max abs err {err:.3e} (tol {tol:.3e}; relative norm err {rel:.3e}, tol 1e-2), "
                f"kernel {ms:.4f} ms, with the logsumexp written (training) {lse_ms:.4f} ms, "
                f"lse max abs err {lse_err:.3e} (tol 1e-4); bound {b['bound_ms']:.4f} ms "
                f"({b['bound_unit']}: {b['bound_flops'] / 1e9:.1f} GFLOP, "
                f"{b['bound_bytes'] / 1e6:.1f} MB), kernel at {100 * b['bound_ms'] / ms:.1f}% "
                f"of the bound")
        if i == 0:
            c["plain_ms"] = cuda_time_ms(lambda: vit_attention_plain(q, k, v, rh, rw, scale), 5)
            # library yardstick: SDPA with the bias materialised once as a bf16 mask
            make_bias = lambda: (rh[:, :, :, None] + rw[:, :, None, :]).reshape(1, bh, n, n)
            c["library_bias_build_ms"] = cuda_time_ms(make_bias, 5)
            bias = make_bias()
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q.view(1, bh, n, hd), k.view(1, bh, n, hd), v.view(1, bh, n, hd),
                attn_mask=bias, scale=scale)
            lib_err, _, lib_rel = check_attention("the SDPA yardstick", sdpa()[0], want)
            c["library_ms"] = cuda_time_ms(sdpa, 10)
            del bias
            line += (f"; plain {c['plain_ms']:.3f} ms, SDPA with a prebuilt bf16 mask "
                     f"{c['library_ms']:.4f} ms (max abs err {lib_err:.3e}, relative norm err "
                     f"{lib_rel:.3e}), mask build {c['library_bias_build_ms']:.4f} ms, kernel "
                     f"{c['library_ms'] / ms:.2f}x faster than SDPA")
        log(line + f"; card {card}")
        cases.append(c)
        del q, k, v, rh, rw, got, want, out_lse, lse
    serve = cases[0]
    record = {"name": "vit_attention", "route": "cuda",
              "source": "hipie_torch/csrc/vit_attention.cu",
              "replaces": "hipie_tpu/ops/pallas/vit_attention_kernel.py:148",
              **{k: serve[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "bound_unit", "bound_flops", "bound_bytes", "library_ms",
                                       "library_bias_build_ms", "ms_with_lse",
                                       "lse_max_abs_err")},
              "library_call": "scaled_dot_product_attention",
              "shapes": {c["case"]: {k: c[k] for k in ("bh", "n", "hd", "kh", "kw", "ms",
                                                       "ms_with_lse", "bound_ms", "rel_err",
                                                       "lse_max_abs_err")}
                         for c in cases}}
    return record, cases


def _vit_bwd_inputs(bh, kh, kw, hd, dev, seed):
    """K-E's inputs from ``seed`` with numpy, bf16: q, k, v, the cotangent
    N(0, 1), rel_h and rel_w N(0, 0.3^2); then K-A's output and logsumexp."""
    from hipie_torch.ops.vit_attention import vit_attention_forward

    rng = np.random.RandomState(seed)
    n = kh * kw
    mk = lambda *s, sc=1.0: torch.from_numpy(sc * rng.randn(*s).astype(np.float32)).to(
        dev, torch.bfloat16)
    q, k, v, dout = mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, hd)
    rh, rw = mk(bh, n, kh, sc=0.3), mk(bh, n, kw, sc=0.3)
    out, lse = vit_attention_forward(q, k, v, rh, rw, hd ** -0.5)
    return q, k, v, rh, rw, out, lse, dout


def _check_vit_attention_bwd(dev, card):
    """K-E at every case of VIT_BWD_CASES against vit_attention_bwd_plain
    (check_vit_attention_bwd), timed; at the training shape also the plain
    version, autograd of vit_attention_plain, and the library call: SDPA's
    backward with the bias prebuilt as a bf16 mask that requires grad, plus the
    two reductions of the mask's gradient to d rel_h and d rel_w. Returns the
    record and the cases."""
    from hipie_torch.ops.vit_attention import (vit_attention_backward, vit_attention_bwd_design,
                                               vit_attention_bwd_plain, vit_attention_plain)

    cases = []
    for i, (name, bh, kh, kw, hd) in enumerate(VIT_BWD_CASES):
        args = _vit_bwd_inputs(bh, kh, kw, hd, dev, SEED + 200 + i)
        q, k, v, rh, rw, out, lse, dout = args
        scale = hd ** -0.5
        got = vit_attention_backward(*args, scale)
        want = vit_attention_bwd_plain(*args, scale)
        torch.cuda.synchronize()
        errs = check_vit_attention_bwd(f"vit_attention_bwd ({name})", got, want)
        ms = cuda_time_ms(lambda: vit_attention_backward(*args, scale), 10)
        n = kh * kw
        # five products of 2 BH N^2 hd; q, k, v, out, dout, rel_h, rel_w and lse
        # read once, the five gradients written once
        bnd = bound(5 * 2.0 * bh * n * n * hd, nbytes(*args) + nbytes(*got), PEAK_BF16_TENSOR,
                    "tensor cores")
        c = {"case": name, "bh": bh, "n": n, "hd": hd, "kh": kh, "kw": kw, "ms": ms,
             "design": vit_attention_bwd_design(n, hd, kh, kw),
             "rel_err": {k_: e[0] for k_, e in zip(("dq", "dk", "dv", "drel_h", "drel_w"), errs)},
             "max_abs_err": max(e[2] for e in errs), "bound_ms": bnd["bound_ms"],
             "shape": vit_shape(q, rh, rw)}
        line = (f"[kernels] vit_attention_bwd {name} BH={bh} N={n} hd={hd} Kh={kh} Kw={kw} bf16, "
                f"{c['design']} design: relative norm err dq/dk/dv/drel_h/drel_w "
                f"{[f'{e[0]:.2e}' for e in errs]} (tol "
                f"{[e[1] for e in errs]}), kernel {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_unit']}: {bnd['bound_flops'] / 1e9:.1f} GFLOP, "
                f"{bnd['bound_bytes'] / 1e6:.1f} MB), at {100 * bnd['bound_ms'] / ms:.1f}%")
        if name == "train":
            c["plain_ms"] = cuda_time_ms_eager(lambda: vit_attention_bwd_plain(*args, scale), 3)
            leaves = [t.detach().requires_grad_() for t in (q, k, v, rh, rw)]
            o = vit_attention_plain(*leaves, scale)
            c["plain_autograd_ms"] = cuda_time_ms_eager(
                lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), 3)
            del o, leaves
            bias = (rh[:, :, :, None] + rw[:, :, None, :]).reshape(1, bh, n, n)
            lib_in = [t.view(1, bh, n, hd).detach().requires_grad_() for t in (q, k, v)]
            lib_in.append(bias.detach().requires_grad_())
            o = torch.nn.functional.scaled_dot_product_attention(*lib_in[:3], attn_mask=lib_in[3],
                                                                 scale=scale)

            def library():
                dq, dk, dv, dm = torch.autograd.grad(o, lib_in, dout.view(1, bh, n, hd),
                                                     retain_graph=True)
                dm = dm.view(bh, n, kh, kw).float()
                return dq[0], dk[0], dv[0], dm.sum(-1).to(rh.dtype), dm.sum(-2).to(rw.dtype)

            # SDPA rounds P and the mask gradient to bf16 at other points: 1e-2 for all five
            lib_errs = [rel_norm_err(g, w) for g, w in zip(library(), want)]
            if not max(lib_errs) <= 1e-2:
                raise AssertionError(f"the SDPA backward yardstick disagrees with the plain "
                                     f"version: relative norm errs {lib_errs} (tol 1e-2)")
            c["library_ms"] = cuda_time_ms_eager(library, 3)
            del o, lib_in, bias
            line += (f"; plain {c['plain_ms']:.3f} ms (autograd of vit_attention_plain "
                     f"{c['plain_autograd_ms']:.3f} ms), SDPA backward with a bf16 mask that "
                     f"requires grad + the two reductions {c['library_ms']:.4f} ms (relative "
                     f"norm err against the plain version "
                     f"{[f'{e:.2e}' for e in lib_errs]}, tol 1e-2)")
            train_bound = bnd
        log(line + f"; card {card}")
        cases.append(c)
        del args, q, k, v, rh, rw, out, lse, dout, got, want
    train = cases[0]
    record = {"name": "vit_attention_bwd", "route": "cuda",
              "source": "hipie_torch/csrc/vit_attention_bwd.cu",
              "replaces": "hipie_tpu/ops/pallas/vit_attention_kernel.py:200",
              "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": train["ms"],
              "plain_ms": train["plain_ms"], "plain_autograd_ms": train["plain_autograd_ms"],
              **train_bound, "library_ms": train["library_ms"],
              "library_call": "scaled_dot_product_attention backward (bf16 mask with grad) + "
                              "two sums of the mask gradient",
              "shapes": {c["case"]: {k: c[k] for k in ("bh", "n", "hd", "kh", "kw", "design",
                                                       "ms", "bound_ms", "rel_err")}
                         for c in cases}}
    return record, cases


def _check_msda(dev, card):
    """K-B at every case of MSDA_CASES: held to check_msda's limits against the
    plain version, both timed. Returns the record (the ViT-H encoder's time,
    bound and plain time, and every case's numbers under "shapes") and the
    cases; main() adds the ms per request once the serve phase has counted
    K-B's launches at each shape."""
    from hipie_torch.ops.ms_deform_attn import (BLOCK_THREADS, GATHER_BATCH, MAX_PAIRS,
                                                TABLE_CHUNK, kernel_constants, kernel_plan,
                                                ms_deform_attn, ms_deform_attn_plain)

    constants = kernel_constants()
    if constants != (BLOCK_THREADS, TABLE_CHUNK, GATHER_BATCH, MAX_PAIRS):
        raise AssertionError(f"K-B's built constants {constants} differ from the wrapper's")
    cases = []
    for i, (name, levels, b, q, dtype, locations) in enumerate(MSDA_CASES):
        value, loc, w = msda_inputs(levels, q, dtype, locations, dev, SEED + i, b)
        got = ms_deform_attn(value, levels, loc, w)
        want = ms_deform_attn_plain(value, levels, loc, w)
        torch.cuda.synchronize()
        err, tol, rel = check_msda(f"ms_deform_attn ({name})", got, want)
        ms = cuda_time_ms(lambda: ms_deform_attn(value, levels, loc, w), 20)
        plain_ms = cuda_time_ms(lambda: ms_deform_attn_plain(value, levels, loc, w), 5)
        traffic = corner_bytes(value, loc)
        # per sample: 4 corners x D channels, a multiply-add each, in f32
        case_bound = bound(8.0 * loc[..., 0].numel() * MSDA_D, nbytes(value, loc, w, got),
                           PEAK_F32, "f32 cores")
        c = {"case": name, "b": b, "q": q, "s": value.shape[1], "dtype": str(dtype)[6:],
             "locations": locations, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
             "bound_ms": case_bound["bound_ms"],
             "tol": tol, "rel_err": rel, "corner_bytes": traffic,
             "corner_rate_tbs": traffic / ms / 1e9,
             "plan": kernel_plan(MSDA_D, value.element_size(), b * q * MSDA_M)._asdict(),
             "shape": msda_shape(value, levels, loc, w)}
        cases.append(c)
        log(f"[kernels] ms_deform_attn {name} B={b} Q={q} S={c['s']} M={MSDA_M} D={MSDA_D} "
            f"L={len(levels)} P={MSDA_P} {c['dtype']}, {locations} locations: max abs err "
            f"{err:.3e} (tol {tol:.3e}), relative norm err {rel:.3e}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {c['bound_ms']:.4f} ms, corner rows "
            f"{traffic / 1e6:.1f} MB at "
            f"{c['corner_rate_tbs']:.2f} TB/s; plan {c['plan']}")
        if name == "encoder":
            bnd, enc = case_bound, c
        del value, loc, w, got, want
    log(f"[kernels] ms_deform_attn bound {bnd['bound_ms']:.4f} ms ({bnd['bound_unit']}: "
        f"{bnd['bound_bytes'] / 1e6:.1f} MB), kernel at "
        f"{100 * bnd['bound_ms'] / enc['ms']:.1f}% of "
        f"the bound at the ViT-H encoder shape; no single PyTorch call computes MSDA "
        f"(library_ms null); card {card}")
    record = {"name": "ms_deform_attn", "route": "cuda",
              "source": "hipie_torch/csrc/ms_deform_attn.cu",
              "replaces": "hipie_tpu/ops/ms_deform_attn.py:719",
              "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": enc["ms"],
              "plain_ms": enc["plain_ms"], **bnd, "library_ms": None,
              "library_note": "no single PyTorch call computes MSDA: the nearest is one "
                              "grid_sample per level plus a weighted sum, the plain version",
              "shapes": {c["case"]: {k: c[k] for k in ("b", "q", "s", "dtype", "locations", "ms",
                                                       "plain_ms", "bound_ms", "max_abs_err",
                                                       "tol", "rel_err", "plan")}
                         for c in cases},
              "corner_bytes": enc["corner_bytes"], "corner_rate_tbs": enc["corner_rate_tbs"]}
    return record, cases


def msda_ms_per_request(cases, counts, local: bool = False) -> float:
    """K-B ms per request: each shape's time (uniform locations, or local ones
    where a case has them) times its launches per request, as counted."""
    times = {c["shape"]: c["ms"] for c in cases if c["locations"] == "uniform"}
    if local:
        times.update({c["shape"]: c["ms"] for c in cases if c["locations"] == "local"})
    return sum(n * times[shape] for shape, n in counts.items())


def check_msda_coverage(cases, ran) -> None:
    """Fails if the paths launched K-B at a shape no case checked."""
    check_coverage("K-B", cases, ran)


def _check_msda_reduce(dev):
    """K-C at the R50 path's row counts: encoder (Q = 20197), decoder (910) and
    MaskDINO decoder (300) queries x 8 heads x K = 16 samples, 4d = 128."""
    from hipie_torch.ops.msda_reduce import (msda_weighted_segment_sum,
                                             msda_weighted_segment_sum_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k, fd = 16, 128
    rec, max_err = None, 0.0
    for qn, dtype in ((R50_S, torch.bfloat16), (R50_S, torch.float32), (910, torch.bfloat16),
                      (300, torch.bfloat16)):
        n = qn * 8 * k
        g = torch.randn(n, fd, generator=gen, device=dev).to(dtype)
        cw = torch.rand(n, 4, generator=gen, device=dev).to(dtype)
        got = msda_weighted_segment_sum(g, cw, k)
        want = msda_weighted_segment_sum_plain(g, cw, k)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = 1e-5 * scale          # same values, f32 sums: summation order only
        ms = cuda_time_ms(lambda: msda_weighted_segment_sum(g, cw, k), 10)
        plain_ms = cuda_time_ms(lambda: msda_weighted_segment_sum_plain(g, cw, k), 5)
        log(f"[kernels] msda_reduce N={n} K={k} 4d={fd} {str(dtype)[6:]}: max abs err {err:.3e} "
            f"(output scale {scale:.3e}, tol {tol:.3e}), kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"msda_reduce disagrees with its plain version: {err} > {tol}")
        max_err = max(max_err, err)
        if rec is None:           # the record carries the encoder bf16 shape's times
            s, d = n // k, fd // 4
            lib = lambda: torch.einsum("skcd,skc->scd", g.view(s, k, 4, d),
                                       cw.view(s, k, 4)).reshape(s, fd)
            lib_err = (lib().float() - want).abs().max().item()
            lib_tol = 2 ** -7 * scale      # einsum rounds its output to the input's bf16
            if not lib_err <= lib_tol:
                raise AssertionError(f"einsum yardstick disagrees: {lib_err} > {lib_tol}")
            library_ms = cuda_time_ms(lib, 10)
            b = bound(2.0 * n * fd, nbytes(g, cw, got), PEAK_F32, "f32 cores")
            log(f"[kernels] msda_reduce bound {b['bound_ms']:.4f} ms ({b['bound_unit']}: "
                f"{b['bound_bytes'] / 1e6:.1f} MB), kernel at {100 * b['bound_ms'] / ms:.1f}% of "
                f"the bound; einsum {library_ms:.4f} ms (max abs err {lib_err:.3e})")
            rec = {"name": "msda_reduce", "route": "cuda",
                   "source": "hipie_torch/csrc/msda_reduce.cu",
                   "replaces": "hipie_tpu/ops/pallas/msda_reduce_kernel.py:88",
                   "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms,
                   "library_call": "einsum"}
        del g, cw, got, want
    rec["max_abs_err"] = max_err
    return rec


def _check_flat4(dev, rng):
    """ms_deform_attn(method="flat4") (gather + K-C) against "fused" (K-B) at the
    R50 encoder shape, S = Q = 20197, 8 heads x 32, 4 levels x 4 points."""
    from hipie_torch import kernels
    from hipie_torch.ops.ms_deform_attn import ms_deform_attn

    shapes, s = R50_LEVELS, R50_S
    m, d, n_levels, p = 8, 32, 4, 4
    loc = torch.from_numpy(rng.uniform(-0.05, 1.05, (1, s, m, n_levels, p, 2))
                           .astype(np.float32)).to(dev)
    w = rng.uniform(0, 1, (1, s, m, n_levels, p)).astype(np.float32)
    w = torch.from_numpy(w / w.sum(axis=(-1, -2), keepdims=True)).to(dev)
    value32 = torch.from_numpy(rng.randn(1, s, m, d).astype(np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        value = value32.to(dtype)
        before = dict(kernels.LAUNCHES)
        got = ms_deform_attn(value, shapes, loc, w, method="flat4")
        if (kernels.LAUNCHES["msda_reduce"] != before["msda_reduce"] + 1
                or kernels.LAUNCHES["ms_deform_attn"] != before["ms_deform_attn"]):
            raise AssertionError("flat4 did not go through K-C alone")
        want = ms_deform_attn(value, shapes, loc, w, method="fused")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        vmax, omax = value.float().abs().max().item(), want.float().abs().max().item()
        if dtype == torch.float32:
            tol = 1e-5        # the same f32 samples, summed in another order
        else:
            # flat4 rounds each corner weight to bf16 (2^-9 relative); a (query,
            # head)'s weights sum to <= 1, so that part is <= 2^-9 max|value|;
            # then each side rounds its output to bf16 (2^-9 of it, each).
            tol = 2 ** -9 * (vmax + 2 * omax)
        flat4_ms = cuda_time_ms(lambda: ms_deform_attn(value, shapes, loc, w, method="flat4"), 10)
        fused_ms = cuda_time_ms(lambda: ms_deform_attn(value, shapes, loc, w, method="fused"), 10)
        log(f"[kernels] ms_deform_attn flat4 vs fused Q=S={s} M={m} D={d} L={n_levels} P={p} "
            f"{str(dtype)[6:]}: max abs err {err:.3e} (tol {tol:.3e}), flat4 {flat4_ms:.3f} ms, "
            f"fused {fused_ms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"flat4 disagrees with fused MSDA: {err} > {tol}")


def cuda_time_ms_eager(fn, iters: int) -> float:
    """Mean ms of ``fn`` by CUDA events around ``iters`` eager calls after one
    warm-up: for calls that cannot go into a CUDA graph (autograd), and slow
    enough that the host's launch cost hides behind the card."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


LATTICE_MARGIN = 1e-3        # pixels


def off_lattice(loc, levels) -> torch.Tensor:
    """(B, Q, M, L, P) bool: samples whose pixel coordinates (x = loc_x W - 0.5,
    y = loc_y H - 0.5) lie more than LATTICE_MARGIN from every integer."""
    keep = []
    for lvl, (h, w) in enumerate(levels):
        x = loc[:, :, :, lvl, :, 0].double() * w - 0.5
        y = loc[:, :, :, lvl, :, 1].double() * h - 0.5
        keep.append(((x - x.round()).abs() > LATTICE_MARGIN)
                    & ((y - y.round()).abs() > LATTICE_MARGIN))
    return torch.stack(keep, 3)


def check_msda_bwd(what, got, want, loc, levels):
    """Relative norm errors of K-D's (grad value, grad locations, grad weights)
    against the plain version's autograd; raises past a limit. Both take the
    same inputs and sum the same f32 products in other orders (K-D's scatter by
    atomics, in an order that changes from run to run): 1e-5 in f32. In bf16
    both read the same bf16 values and cotangent exactly and compute in f32;
    each rounds its value gradient to bf16 once (about 2^-9 relative per
    element, so ~1.5e-3 in norm): 4e-3 for the value gradient, 1e-4 for the
    f32 location and weight gradients, where a sample dropped or counted twice
    moves each by several %. Bilinear interpolation has no derivative on the
    pixel lattice, and K-D (x = loc W - 0.5) and grid_sample (from grid =
    2 loc - 1) round the pixel coordinate differently, so a sample within an ulp
    of the lattice may take the other side's one-sided derivative: the location
    gradient is compared on samples more than LATTICE_MARGIN (1e-3 pixel, some
    hundred ulps at W = 128) off it (about 0.4% are left out; both must be
    finite everywhere)."""
    errs = []
    keep = off_lattice(loc, levels)[..., None].expand_as(loc)
    for name, g, w in zip(("value", "loc", "weights"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what} grad {name}: {g.dtype} {tuple(g.shape)} against "
                                 f"{w.dtype} {tuple(w.shape)}, or not finite")
        g, w = g.float(), w.float()
        if name == "loc":
            g, w = g[keep], w[keep]
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        if got[0].dtype == torch.float32:
            tol = 1e-5
        else:
            tol = 4e-3 if name == "value" else 1e-4
        if not rel <= tol:
            raise AssertionError(f"{what} grad {name} disagrees with the plain version's "
                                 f"autograd: relative norm err {rel} (tol {tol})")
        errs.append((rel, tol, (g - w).abs().max().item()))
    return errs, 1.0 - keep.float().mean().item()


def _check_msda_bwd(dev, card):
    """K-D at every case of MSDA_BWD_CASES: held to check_msda_bwd's limits
    against the plain version's autograd, both timed, with the design the C
    entry launched there and, where that is the binned one, its bins, chunks
    and global adds beside the atomics design's adds. Returns
    the record (the training encoder's bf16 time, bound and plain time, and
    every case's numbers under "shapes") and the cases."""
    from hipie_torch.ops.ms_deform_attn import (_ms_deform_attn_backward_design, backward_plan,
                                                bwd_binned_stats, ms_deform_attn_backward,
                                                ms_deform_attn_backward_plain)

    cases = []
    for i, (name, levels, b, q, dtype, locations) in enumerate(MSDA_BWD_CASES):
        value, loc, w = msda_inputs(levels, q, dtype, locations, dev, SEED + 100 + i, b)
        gout = torch.randn((b, q, MSDA_M * MSDA_D), generator=torch.Generator(
            device=dev).manual_seed(SEED + i), device=dev).to(dtype)
        got, design, scratch = _ms_deform_attn_backward_design(value, levels, loc, w, gout)
        want = ms_deform_attn_backward_plain(value, levels, loc, w, gout)
        torch.cuda.synchronize()
        errs, left_out = check_msda_bwd(f"ms_deform_attn_bwd ({name})", got, want, loc, levels)
        binned = bwd_binned_stats(scratch) if design == "binned" else {}
        ms = cuda_time_ms(lambda: ms_deform_attn_backward(value, levels, loc, w, gout), 10)
        plain_ms = cuda_time_ms_eager(
            lambda: ms_deform_attn_backward_plain(value, levels, loc, w, gout), 3)
        # bytes: value, locations, weights and cotangent read once; the value
        # gradient (in the value's dtype, as the function returns it), the
        # location and weight gradients written once. Operations:
        # per sample and corner, a D-long dot and a D-long scaled add, in f32.
        samples = loc[..., 0].numel()
        bnd = bound(4.0 * 4 * samples * MSDA_D,
                    nbytes(value, loc, w, gout) + nbytes(value) + nbytes(loc, w),
                    PEAK_F32, "f32 cores")
        c = {"case": name, "b": b, "q": q, "s": value.shape[1], "dtype": str(dtype)[6:],
             "locations": locations, "ms": ms, "plain_ms": plain_ms,
             "rel_err": {k: e[0] for k, e in zip(("value", "loc", "weights"), errs)},
             "tol": {k: e[1] for k, e in zip(("value", "loc", "weights"), errs)},
             "max_abs_err": max(e[2] for e in errs), "bound_ms": bnd["bound_ms"],
             "loc_left_out": left_out,
             "atomic_adds": samples * 4 * MSDA_D,
             "plan": backward_plan(MSDA_D, value.element_size(), 16),
             "design": design, **binned,
             "shape": msda_shape(value, levels, loc, w)}
        cases.append(c)
        log(f"[kernels] ms_deform_attn_bwd {name} B={b} Q={q} S={c['s']} M={MSDA_M} "
            f"D={MSDA_D} L={len(levels)} P={MSDA_P} {c['dtype']}, {locations} locations: "
            f"relative norm err value/loc/weights {[f'{e[0]:.2e}' for e in errs]} (tol "
            f"{[e[1] for e in errs]}; {100 * left_out:.2f}% of locations on the lattice left out), "
            f"kernel {ms:.4f} ms, plain (autograd) {plain_ms:.3f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_unit']}, "
            f"{bnd['bound_bytes'] / 1e6:.1f} MB); {design} design"
            + (f" ({c['n_bins']} bins, {c['n_chunks']} chunks, {c['global_adds'] / 1e6:.1f} M "
               f"global f32 adds against the atomics design's {c['atomic_adds'] / 1e6:.1f} M)"
               if design == "binned" else
               f" ({c['atomic_adds'] / 1e6:.1f} M f32 atomic adds at "
               f"{c['atomic_adds'] / ms / 1e6:.1f} G/s)") + f"; card {card}")
        if name == "train_encoder":
            enc, b_enc = c, bnd
        del value, loc, w, gout, got, want, scratch
    record = {"name": "ms_deform_attn_bwd", "route": "cuda",
              "source": "hipie_torch/csrc/ms_deform_attn_bwd.cu",
              "replaces": "hipie_tpu/ops/ms_deform_attn.py:884",
              "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": enc["ms"],
              "plain_ms": enc["plain_ms"], **b_enc, "library_ms": None,
              "library_note": "no single PyTorch call computes the MSDA backward; the plain "
                              "version is grid_sample's autograd per level",
              "shapes": {c["case"]: {k: c[k] for k in ("b", "q", "s", "dtype", "locations", "ms",
                                                       "plain_ms", "bound_ms", "rel_err", "tol",
                                                       "loc_left_out", "plan", "design",
                                                       "atomic_adds", "n_bins", "n_chunks",
                                                       "global_adds") if k in c}
                         for c in cases}}
    return record, cases


def check_kd_designs(shapes, counted) -> dict:
    """K-D's designs in the train phases: every encoder-shape launch (Q = S)
    must take the binned design, every launch the design the C entry's rule
    names at its shape, and the launches the wrapper counted by design must
    be those. Returns launches by (case shape, design)."""
    from hipie_torch.ops.ms_deform_attn import ms_deform_attn_bwd_design

    by_shape = Counter()
    for levels, b, q, m, d, dtype in shapes:
        design = ms_deform_attn_bwd_design(levels, b, m, d, q, MSDA_P)
        if q == sum(h * w for h, w in levels) and design != "binned":
            raise AssertionError(f"K-D at the encoder shape {levels, b, q} takes the {design} "
                                 f"design, not the binned one")
        by_shape[(f"B={b} Q={q} {dtype}", design)] += 1
    want = Counter()
    for (_, design), n in by_shape.items():
        want[design] += n
    got = Counter()
    for c in counted:
        got.update(c)
    if +got != +want:
        raise AssertionError(f"the train phases launched K-D's designs {dict(got)}, the rule "
                             f"names {dict(want)} at their shapes")
    log(f"[train] K-D launches by shape and design, both train phases: "
        f"{ {f'{k[0]} {k[1]}': n for k, n in by_shape.items()} }")
    return {f"{k[0]} {k[1]}": n for k, n in by_shape.items()}


def check_coverage(what, cases, ran) -> None:
    """Fails if a path launched a kernel at a shape no case checked."""
    missing = set(ran) - {c["shape"] for c in cases}
    if missing:
        raise AssertionError(f"{what} ran at shapes chip_smoke.py does not check: "
                             f"{sorted(missing)}")


def _tiny_config():
    from hipie_torch.config import apply_overrides, tiny_test_config
    from hipie_torch.models.backbone.vit import VIT_VARIANTS

    VIT_VARIANTS.setdefault("vit_narrow", (64, 4, 4, 0.0))
    return apply_overrides(tiny_test_config(), {
        "model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 128,
        "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True})


def phase_reference(dev):
    """Tiny slice, f32: card (kernels) against CPU (plain versions), same weights."""
    from hipie_torch import kernels
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.utils.weights import random_init_

    cfg = _tiny_config()
    model = HIPIEModel(cfg.model).eval()
    random_init_(model, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    L = cfg.model.text.max_query_len
    args = (torch.from_numpy(rng.randint(0, 256, (1, 128, 128, 3)).astype(np.uint8)),
            torch.zeros(1, 128, 128, dtype=torch.bool),
            torch.from_numpy(rng.randint(0, cfg.model.text.vocab_size, (1, L))),
            torch.ones(1, L, dtype=torch.long), torch.tensor([[128, 128]]))
    for method, kernel in (("fused", "ms_deform_attn"), ("flat4", "msda_reduce")):
        m = HIPIEModel(cfg.model, msda_method=method).eval()
        m.load_state_dict(model.state_dict(), strict=True)
        with torch.inference_mode():
            ref = m(*args)
            m.to(dev)
            kernels.reset_launch_counts()
            out = m(*(a.to(dev) for a in args))
            torch.cuda.synchronize()
        n_msda = sum(1 for mod in m.modules() if type(mod).__name__ == "MSDeformAttn")
        if kernels.LAUNCHES[kernel] != n_msda or sum(kernels.LAUNCHES.values()) != n_msda:
            raise AssertionError(f"the {method} reference run launched {kernels.LAUNCHES}, "
                                 f"expected {n_msda} of {kernel} alone")
        for key, tol in (("memory", 1e-4), ("enc_outputs_class", 1e-4)):
            err = (out[key].float().cpu() - ref[key].float()).abs().max().item()
            log(f"[reference] tiny slice f32 {method} {key}: card vs CPU max abs err {err:.3e} "
                f"(tol {tol})")
            if not err <= tol:
                raise AssertionError(f"tiny slice {method} {key} on the card disagrees with "
                                     f"the CPU: {err}")
        del m
    kernels.reset_launch_counts()


def class_maps(L: int, dev):
    from hipie_torch.models.postprocess import ClassMaps

    mw = np.zeros((N_CLASSES, L), np.float32)
    tm = np.zeros((N_CLASSES, L), bool)
    for c in range(N_CLASSES):
        mw[c, (c % (L - 2)) + 1] = 1.0
        tm[c, (c % (L - 2)) + 1] = True
    return ClassMaps(torch.from_numpy(mw).to(dev), torch.from_numpy(tm).to(dev),
                     torch.arange(N_CLASSES, device=dev) < 80)


def check_result(res, cfg):
    k = cfg.test.detections_per_image
    h4 = IMG // 4
    expect = {"scores": (k,), "classes": (k,), "boxes": (k, 4), "mask_logits": (k, h4, h4),
              "sem_seg": (N_CLASSES, h4, h4), "panoptic": (h4, h4)}
    for name, shape in expect.items():
        t = getattr(res, name)
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.is_floating_point() and not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite values")
    if not (res.scores[:-1] >= res.scores[1:]).all():
        raise AssertionError("instance scores are not sorted")
    if int(res.panoptic.max()) > int(res.segment_valid.sum()):
        raise AssertionError("panoptic ids exceed the segment count")


@contextlib.contextmanager
def timing_calls(module, name, record=None, timed: bool = True):
    """Within the block ``module.name`` (a kernel wrapper as the model imports
    it) runs with a pair of CUDA events around each call (unless ``timed`` is
    false), and ``record``, if given, is called with each call's arguments;
    yields the list the (start, end) pairs go to."""
    events = []
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        if record is not None:
            record(*args, **kwargs)
        if not timed:
            return inner(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(module, name, wrapped)
    try:
        yield events
    finally:
        setattr(module, name, inner)


def timing_vit_attention():
    """timing_calls around K-A's wrapper as the ViT calls it."""
    import hipie_torch.models.backbone.vit as vit_module

    return timing_calls(vit_module, "vit_global_attention")


def timing_msda(shapes=None):
    """timing_calls around MSDA (K-B on the fused path) as MSDeformAttn calls
    it; each call's msda_shape is appended to ``shapes`` if given."""
    import hipie_torch.models.msda_module as msda_module

    record = None if shapes is None else (lambda *a, **k: shapes.append(msda_shape(*a, **k)))
    return timing_calls(msda_module, "ms_deform_attn", record)


def vit_huge_server(dev, seed: int = SEED):
    """HIPIEModel(vit_huge_coco_panoptic()) at full width in bf16 with random
    weights from a seeded torch.Generator, and ``request(img)``, which answers
    one (1, 1024, 1024, 3) uint8 image with a synthetic 256-token prompt (its
    text features encoded once, here) and a 133-class map. Returns
    (cfg, model, request); call ``request`` under torch.inference_mode()."""
    from hipie_torch.models.hipie import HIPIEModel, hipie_inference
    from hipie_torch.presets import vit_huge_coco_panoptic
    from hipie_torch.utils.weights import random_init_

    cfg = vit_huge_coco_panoptic()
    mc = cfg.model
    with torch.device(dev):
        model = HIPIEModel(mc).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(seed))
    model.to(torch.bfloat16)
    L = mc.text.max_query_len
    ids = torch.from_numpy((np.arange(L) % 1000 + 999)[None]).to(dev)
    am = torch.ones(1, L, dtype=torch.long, device=dev)
    maps = class_maps(L, dev)
    pad = torch.zeros(1, IMG, IMG, dtype=torch.bool, device=dev)
    sizes = torch.tensor([[IMG, IMG]], device=dev)
    with torch.inference_mode():
        lang_hidden = model.encode_text(ids, am)

    def request(img):
        out = model(img.to(dev), pad, ids, am, sizes, lang_hidden=lang_hidden)
        return hipie_inference(out, maps, cfg.test, mc, pad_mask_s4=pad[0][::4, ::4])

    return cfg, model, request


def serve_images(n: int, seed: int = SEED):
    rng = np.random.RandomState(seed + 1)
    return [torch.from_numpy(rng.randint(0, 256, (1, IMG, IMG, 3), dtype=np.uint8))
            for _ in range(n)]


def timing_vit_kernel(shapes):
    """timing_calls (untimed) around K-A's launcher, through which every
    K-A launch goes (serving's and the autograd Function's); each launch's
    vit_shape is appended to ``shapes``."""
    import hipie_torch.ops.vit_attention as vit_ops

    return timing_calls(vit_ops, "_forward_kernel",
                        lambda q, k, v, rh, rw, *a, **kw: shapes.append(vit_shape(q, rh, rw)),
                        timed=False)


def phase_serve(dev, card):
    from hipie_torch import kernels

    t0 = time.perf_counter()
    cfg, model, request = vit_huge_server(dev)
    mc = cfg.model
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] HIPIEModel(vit_huge_coco_panoptic) {n_params / 1e6:.1f} M params, bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")

    n_global = sum(1 for b in model.detr.detr.backbone[0].backbone.blocks if b.window_size == 0)
    n_msda = (mc.transformer.num_encoder_layers + mc.transformer.num_decoder_layers
              + mc.maskdino.dec_layers)
    torch.cuda.reset_peak_memory_stats()
    kb_shapes, ka_shapes = [], []
    with torch.inference_mode(), timing_vit_kernel(ka_shapes):
        kernels.reset_launch_counts()
        times, ka_ms, kb_ms = [], [], []
        for img in serve_images(N_REQUESTS):
            with timing_vit_attention() as events, timing_msda(kb_shapes) as kb_events:
                t0 = time.perf_counter()
                res = request(img)
                torch.cuda.synchronize()
                times.append(1000.0 * (time.perf_counter() - t0))
            ka_ms.append(sum(a.elapsed_time(b) for a, b in events))
            kb_ms.append(sum(a.elapsed_time(b) for a, b in kb_events))
            if len(events) != n_global or len(kb_events) != n_msda:
                raise AssertionError(f"{len(events)} K-A and {len(kb_events)} K-B calls in a "
                                     f"request, expected {n_global} and {n_msda}")
            check_result(res, cfg)
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[serve] {N_REQUESTS} requests, ms per request {[round(t, 3) for t in times]} "
        f"(first includes warm-up), peak memory {peak:.2f} GiB, card {card}")
    log(f"[serve] K-A ms per request by CUDA events ({n_global} launches each): "
        f"{[round(t, 4) for t in ka_ms]}; share of the request's wall time "
        f"{[round(a / b, 4) for a, b in zip(ka_ms, times)]}")
    log(f"[serve] K-B ms per request by CUDA events around its {n_msda} calls (host gaps "
        f"between an event and its launch included): {[round(t, 4) for t in kb_ms]}")
    log(f"[serve] last request: {int(res.segment_valid.sum())} panoptic segments, "
        f"top score {res.scores[0].item():.4f}")
    want = {"vit_attention": n_global * N_REQUESTS, "ms_deform_attn": n_msda * N_REQUESTS,
            "msda_reduce": 0, "ms_deform_attn_bwd": 0, "vit_attention_bwd": 0}
    log(f"[serve] kernel launches {launches}, expected {want} "
        f"({n_global} global ViT blocks and {n_msda} MSDA layers per request)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    kb_per_request = {shape: n / N_REQUESTS for shape, n in Counter(kb_shapes).items()}
    log(f"[serve] K-B launches per request by shape (levels, B, Q, M, D, dtype): "
        f"{kb_per_request}")
    return (launches, {name: count // N_REQUESTS for name, count in launches.items()},
            kb_per_request, ka_shapes)


def _check_prediction(res, task):
    oh, ow = R50_IMAGE
    inst = res["instances"]
    k = len(inst["scores"])
    if task == "grounding" and k != 1:
        raise AssertionError(f"grounding gave {k} instances, expected 1")
    expect = {"boxes": (k, 4), "scores": (k,), "classes": (k,), "masks": (k, oh, ow)}
    for name, shape in expect.items():
        if inst[name].shape != shape:
            raise AssertionError(f"{task} {name}: shape {inst[name].shape}, expected {shape}")
    if not (np.isfinite(inst["boxes"]).all() and np.isfinite(inst["scores"]).all()):
        raise AssertionError(f"{task}: non-finite boxes or scores")
    if task == "detection":
        pan, segments = res["panoptic_seg"]
        if pan.shape != (oh, ow) or res["sem_seg"].shape != (oh, ow):
            raise AssertionError(f"panoptic {pan.shape} / sem_seg {res['sem_seg'].shape}")
        if int(pan.max()) > len(segments) or int(res["sem_seg"].max()) >= N_CLASSES:
            raise AssertionError("panoptic ids or semantic classes out of range")
    elif "panoptic_seg" in res or "sem_seg" in res:
        raise AssertionError("grounding gave a panoptic or semantic map")


def phase_predict(dev, card):
    """The R50 predictor: panoptic, grounding and parts calls, fused and flat4."""
    import re

    from hipie_torch import kernels
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.predictor import HIPIEPredictor, PartSegmDemo, parse_def_string
    from hipie_torch.data.label_spaces import COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING
    from hipie_torch.data.prompts import build_prompt_spec
    from hipie_torch.data.transforms import pad_to_bucket, resize_shortest_edge
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_torch.presets import r50_coco_panoptic
    from hipie_torch.utils.weights import random_init_

    cfg = r50_coco_panoptic()
    mc = cfg.model
    t0 = time.perf_counter()
    models = {}
    for method in ("fused", "flat4"):
        with torch.device(dev):
            models[method] = HIPIEModel(mc, msda_method=method).eval()
    random_init_(models["fused"], torch.Generator(device=dev).manual_seed(SEED))
    models["fused"].to(torch.bfloat16)
    models["flat4"].to(torch.bfloat16).load_state_dict(models["fused"].state_dict(), strict=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models["fused"].parameters())
    log(f"[predict] HIPIEModel(r50_coco_panoptic) x2 (fused, flat4) {n_params / 1e6:.1f} M "
        f"params each, bf16, built in {time.perf_counter() - t0:.1f} s")

    labels = [n if thing else f"{n}:stuff"
              for n, thing in zip(COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING)]
    parts = ["head", "torso", "arm", "leg", "tail", "wheel", "window", "door"]
    expression = "the person on the left holding an umbrella"
    words = {w for text in COCO_PANOPTIC_133 + parts + [expression]
             for w in re.split(r"[^a-z0-9]+", text) if w}
    tok = WordPieceTokenizer.toy(words=sorted(words))
    preds = {m: HIPIEPredictor(cfg, model, tok, bucket=R50_BUCKET, device=dev)
             for m, model in models.items()}
    rng = np.random.RandomState(SEED + 2)
    images = [rng.randint(0, 256, R50_IMAGE + (3,)).astype(np.uint8) for _ in range(5)]
    n_msda = (mc.transformer.num_encoder_layers + mc.transformer.num_decoder_layers
              + mc.maskdino.dec_layers)

    calls = []

    def timed(name, fn, kernel="ms_deform_attn", passes=1):
        """Times one call and checks it launched n_msda x passes of ``kernel`` alone."""
        before = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        out = fn()
        calls.append((name, 1000.0 * (time.perf_counter() - t)))
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        want = {k: n_msda * passes if k == kernel else 0 for k in before}
        if delta != want:
            raise AssertionError(f"{name}: kernel launches {delta} != {want}")
        return out

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    fused = preds["fused"]
    for i in range(2):
        res = timed(f"panoptic{i}", lambda: fused(images[i], test_categories=labels))
        _check_prediction(res, "detection")
    log(f"[predict] panoptic: {len(res['panoptic_seg'][1])} segments, "
        f"{len(res['instances']['scores'])} instances above 0.5")
    res = timed("grounding", lambda: fused(images[2], task="grounding", expressions=expression))
    _check_prediction(res, "grounding")
    log(f"[predict] grounding: score {res['instances']['scores'][0]:.4f}, box "
        f"{np.round(res['instances']['boxes'][0], 1).tolist()}")
    demo = PartSegmDemo(fused, parts)
    things = [n for n, t in zip(COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING) if t]
    stuff = [n for n, t in zip(COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING) if not t]
    res = timed("parts (2 passes)",
                lambda: demo.forward_panoptic(images[3], things, stuff, do_part=True), passes=2)
    _check_prediction(res, "detection")
    part_sem = res["parts"]["part_sem_seg"]
    if (part_sem.shape != R50_IMAGE or part_sem.max() >= len(parts)
            or len(res["parts"]["instance_part_maps"]) != len(res["instances"]["masks"])):
        raise AssertionError("part segmentation output is malformed")
    fused_launches = dict(kernels.LAUNCHES)
    n_passes = 2 + 1 + 2
    want = {"vit_attention": 0, "ms_deform_attn": n_msda * n_passes, "msda_reduce": 0,
            "ms_deform_attn_bwd": 0, "vit_attention_bwd": 0}
    log(f"[predict] fused: kernel launches {fused_launches}, expected {want} "
        f"({n_msda} MSDA layers x {n_passes} model passes)")
    if fused_launches != want:
        raise AssertionError(f"launch counts {fused_launches} != {want}")

    kernels.reset_launch_counts()
    res = timed("panoptic flat4", lambda: preds["flat4"](images[4], test_categories=labels),
                kernel="msda_reduce")
    _check_prediction(res, "detection")
    flat4_launches = dict(kernels.LAUNCHES)
    want = {"vit_attention": 0, "ms_deform_attn": 0, "msda_reduce": n_msda,
            "ms_deform_attn_bwd": 0, "vit_attention_bwd": 0}
    log(f"[predict] flat4: kernel launches {flat4_launches}, expected {want}")
    if flat4_launches != want:
        raise AssertionError(f"launch counts {flat4_launches} != {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[predict] ms per call, host pre- and post-processing included (the first "
        f"includes warm-up): {[(n, round(t, 3)) for n, t in calls]}; peak memory {peak:.2f} GiB "
        f"(two bf16 models resident); card {card}")

    # one f32 request through both methods, compared before any top-k
    resized, _ = resize_shortest_edge(images[0], cfg.data.min_size_test, cfg.data.max_size_test)
    h, w = resized.shape[:2]
    padded, pad_mask = pad_to_bucket(resized, R50_BUCKET)
    names, is_thing = parse_def_string(labels)
    spec = build_prompt_spec(names, is_thing, tok, cfg.data.max_text_len)
    args = (torch.from_numpy(padded[None]).to(dev), torch.from_numpy(pad_mask[None]).to(dev),
            torch.from_numpy(spec.input_ids[None]).long().to(dev),
            torch.from_numpy(spec.attention_mask[None]).to(dev),
            torch.tensor([[h, w]], device=dev))
    outs = {}
    with torch.inference_mode():
        for method, model in models.items():
            outs[method] = model.float()(*args)
    torch.cuda.synchronize()
    for key in ("memory", "enc_outputs_class"):
        a, b = outs["flat4"][key].float(), outs["fused"][key].float()
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        tol = 1e-4        # the same f32 samples summed in another order, through 6 layers
        log(f"[predict] f32 {key} {tuple(b.shape)}: flat4 vs fused max abs err {err:.3e} "
            f"(scale {scale:.3e}, tol {tol})")
        if not (err <= tol and torch.isfinite(a).all()):
            raise AssertionError(f"f32 {key}: flat4 and fused disagree: {err} > {tol}")
    return flat4_launches


TRAIN_STEPS = 4
VIT_TRAIN_STEPS = 3
VITH_GLOBAL_BLOCKS = 24
TRAIN_N = 100                 # GT slots (max_insts_num)


def train_launches(cfg, model, img: int = IMG) -> dict:
    """Each kernel's launches in one training step, counted from the config
    and the model: K-B once a MSDA layer forward, again for each encoder and
    decoder layer that ``transformer.remat`` recomputes, K-D once a layer
    backward; K-A once a global ViT block that takes it (bf16 compute, N >=
    1024, N % 256 == 0), again under ``backbone.vit_remat``, K-E once each."""
    from hipie_torch.models.backbone.vit import ViTDet, use_kernel_attention

    mc = cfg.model
    tc = mc.transformer
    n_msda = tc.num_encoder_layers + tc.num_decoder_layers + mc.maskdino.dec_layers
    backbone = model.detr.detr.backbone[0].backbone
    n_ka = 0
    if isinstance(backbone, ViTDet):
        dtype = torch.bfloat16 if mc.dtype == "bfloat16" else torch.float32
        n_tokens = (img // mc.backbone.vit_patch_size) ** 2
        n_ka = sum(1 for b in backbone.blocks if b.window_size == 0
                   and use_kernel_attention(dtype, b.attn.use_rel_pos, n_tokens))
    return {"vit_attention": n_ka * (2 if getattr(backbone, "remat", False) else 1),
            "vit_attention_bwd": n_ka,
            "ms_deform_attn": n_msda + (tc.num_encoder_layers + tc.num_decoder_layers
                                        if tc.remat else 0),
            "ms_deform_attn_bwd": n_msda, "msda_reduce": 0}


def phase_train(dev, card, cfg=None, img: int = IMG, slots: int = TRAIN_N,
                steps: int = TRAIN_STEPS):
    """A config (default r50_coco_panoptic()) trained at full width through
    make_train_step and Trainer: f32 master weights, bf16 autocast compute,
    seeded random init, ``steps`` optimizer steps on synthetic batches, the
    launches of every kernel exact each step (``train_launches``). Returns
    (launches and times, K-A, K-B, K-D and K-E shapes)."""
    import hipie_torch.models.msda_module as msda_module
    import hipie_torch.ops.ms_deform_attn as msda_ops
    import hipie_torch.ops.vit_attention as vit_ops
    import hipie_torch.train.step as step_module
    from hipie_torch import kernels
    from hipie_torch.losses import matcher
    from hipie_torch.presets import r50_coco_panoptic
    from hipie_torch.train.optimizer import lr_schedule
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.synthetic import train_batches
    from hipie_torch.train.trainer import Trainer

    cfg = dataclasses.replace(cfg or r50_coco_panoptic(),
                              output_dir=tempfile.mkdtemp(prefix="hipie_train_"))
    mc = cfg.model
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=SEED, device=dev)
    model, opt = state.model, state.optimizer
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in opt.params)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    log(f"[train] HIPIEModel({mc.backbone.name}, train=True) {n_params / 1e6:.1f} M params "
        f"({n_train / 1e6:.1f} M trainable), f32 master weights, {mc.dtype} compute, remat "
        f"backbone {mc.backbone.vit_remat} transformer {mc.transformer.remat}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    want = train_launches(cfg, model, img)
    backbone = model.detr.detr.backbone[0].backbone
    drop_masks = []                    # a ViT's drop-path keep masks, step by step
    if hasattr(backbone, "draw_drop_masks"):
        draw = backbone.draw_drop_masks
        backbone.draw_drop_masks = lambda *a: drop_masks.append(draw(*a)) or drop_masks[-1]
    inner = make_train_step(cfg, state, device=dev)
    per_step, terms = [], []

    def train_step(st, batch, keys):
        k0, s0 = dict(kernels.LAUNCHES), matcher.HOST_SYNCS[0]
        out = inner(st, batch, keys)
        per_step.append(({k: kernels.LAUNCHES[k] - k0[k] for k in k0},
                         matcher.HOST_SYNCS[0] - s0))
        return out

    weight_fn = step_module.apply_weight_dict

    def recording_weights(losses, lcfg):
        terms.append(dict(losses))
        return weight_fn(losses, lcfg)

    batches = train_batches(cfg, steps, SEED, img=img, slots=slots, batch=TRAIN_B)
    trainer = Trainer(cfg, state, train_step, iter(batches), log_period=1, device=dev,
                      checkpoints=False)
    ka_shapes, kb_shapes, kd_shapes, ke_shapes = [], [], [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step_module.apply_weight_dict = recording_weights
    try:
        with timing_calls(msda_module, "ms_deform_attn",
                          lambda *a, **k: kb_shapes.append(msda_shape(*a, **k)), timed=False), \
                timing_calls(msda_ops, "ms_deform_attn_backward",
                             lambda *a: kd_shapes.append(msda_shape(*a[:4])), timed=False), \
                timing_calls(vit_ops, "vit_attention_backward",
                             lambda *a: ke_shapes.append(vit_shape(a[0], a[3], a[4])),
                             timed=False), \
                timing_vit_kernel(ka_shapes):
            kernels.reset_launch_counts()
            for k in msda_ops.BWD_DESIGN_LAUNCHES:
                msda_ops.BWD_DESIGN_LAUNCHES[k] = 0
            state = trainer.train(max_iter=steps)
            launches = dict(kernels.LAUNCHES)
            kd_designs = dict(msda_ops.BWD_DESIGN_LAUNCHES)
    finally:
        step_module.apply_weight_dict = weight_fn
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0

    for i, d in enumerate(terms):
        bad = [k for k, v in d.items() if not torch.isfinite(torch.as_tensor(v)).all()]
        if bad:
            raise AssertionError(f"train: non-finite loss terms {bad} in weighted dict {i}")
    n_terms = sum(len(d) for d in terms[:2])
    labels = opt.labels
    zero_grad, below_resolution = [], []
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            if p.requires_grad or p.grad is not None:
                raise AssertionError(f"train: frozen parameter {name} has a gradient")
            continue
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"train: trainable parameter {name} has no finite gradient")
        if not p.grad.any():
            zero_grad.append(name)
        elif torch.equal(p.detach(), before[name]):
            # AdamW moves an element by at most ~lr a step, so a step below the
            # f32 spacing at the element's value may round away: the warmup
            # starts the backbone group at 1e-8 (base lr x 0.1 x 1e-3), under
            # the spacing of 6e-8 at a LayerNorm weight's init of 1.0. Such a
            # parameter must still have the optimizer's moments.
            w = before[name].abs()
            spacing = w - torch.nextafter(w, torch.zeros_like(w))
            lr_max = max(opt.schedules[labels[name]](i) for i in range(steps))
            moments = opt.opt.state.get(p, {}).get("exp_avg")
            if moments is None or not moments.any() or not bool((lr_max < spacing).all()):
                raise AssertionError(f"train: parameter {name} did not move in {steps} steps")
            below_resolution.append(name)
    # a global ViT block's attention gets its gradient through K-E: nonzero
    # unless drop path dropped its branch for every sample of the last step
    last = drop_masks[-1] if drop_masks else None
    through_ke = [f"detr.detr.backbone.0.backbone.blocks.{i}.attn.{p}"
                  for i, b in enumerate(getattr(backbone, "blocks", []))
                  if b.window_size == 0 and (last is None or last[i, 0].any())
                  for p in ("qkv.weight", "qkv.bias", "rel_pos_h", "rel_pos_w")]
    if set(through_ke) & set(zero_grad) or not set(through_ke) <= set(labels):
        raise AssertionError(f"train: global-block attention parameters without a gradient: "
                             f"{sorted(set(through_ke) & set(zero_grad))}")
    base_fn = lr_schedule(cfg.solver, cfg.solver.base_lr)
    for i, h in enumerate(trainer.history):
        if h["lr"] != base_fn(i) or not np.isfinite(h["total_loss"]):
            raise AssertionError(f"train: step {i} lr {h['lr']} (schedule {base_fn(i)}), total "
                                 f"loss {h['total_loss']}")
    for g in opt.opt.param_groups:
        lr = opt.schedules[g["group"]](steps - 1)
        if g["lr"] != lr:
            raise AssertionError(f"train: group {g['group']} lr {g['lr']} != schedule {lr}")
    for i, (counts, _) in enumerate(per_step):
        if counts != want:
            raise AssertionError(f"train: step {i} launched {counts}, expected {want} a step")
    times = [h["time_s"] * 1e3 for h in trainer.history]
    syncs = [n for _, n in per_step]
    log(f"[train] {mc.backbone.name}: {steps} steps of batch {TRAIN_B} at {img}x{img}: total loss "
        f"{[round(h['total_loss'], 4) for h in trainer.history]}, lr (base group) "
        f"{[h['lr'] for h in trainer.history]}, grad norm "
        f"{[round(h['grad_norm'], 4) for h in trainer.history]}; {n_terms} loss terms a step, "
        f"all finite; {len(zero_grad)} trainable tensors with an all-zero gradient "
        f"{zero_grad[:6]}; {len(below_resolution)} unmoved, their steps below f32 resolution "
        f"{below_resolution[:4]}")
    log(f"[train] ms per step {[round(t, 1) for t in times]}; after the first: mean "
        f"{np.mean(times[1:]):.1f} ms; peak memory {peak:.2f} GiB; matcher host syncs per step "
        f"{syncs}; kernel launches per step {per_step[-1][0]} (expected {want}); "
        f"{len(through_ke) // 4} global blocks' attention checked for a nonzero gradient; "
        f"card {card}")
    return ({"launches": launches, "per_step": per_step[-1][0], "ms_per_step": times,
             "peak_gib": peak, "syncs": syncs, "kd_designs": kd_designs}, ka_shapes, kb_shapes,
            kd_shapes, ke_shapes)

PIPE_STEPS = 4
PIPE_MORE_STEPS = 2
SMOKE_CONFIG = "configs/smoke_tiny_coco.yaml"
PIPE_METRICS = ("bbox/AP", "segm/AP", "panoptic/PQ", "panoptic/SQ", "panoptic/RQ",
                "panoptic/PQ_th", "panoptic/PQ_st")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def check_bit_equal(what: str, got: dict, want: dict) -> int:
    """Every tensor of ``want`` is in ``got`` with the same dtype, shape and
    bits; returns the bytes compared."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ: {sorted(set(got) ^ set(want))[:8]}")
    n = 0
    for k, w in want.items():
        g = got[k]
        if not torch.is_tensor(w):
            if g != w:
                raise AssertionError(f"{what}: {k} = {g!r}, saved {w!r}")
            continue
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                _bits(g).cpu(), _bits(w).cpu()):
            raise AssertionError(f"{what}: {k} is not bit-equal to the saved tensor")
        n += w.numel() * w.element_size()
    return n


def optimizer_tensors(opt) -> dict:
    """GroupedAdamW's state as flat entries: each parameter's AdamW tensors by
    index, the update count and the accumulation window."""
    sd = opt.state_dict()
    out = {f"{i}.{k}": v for i, st in sd["adamw"]["state"].items() for k, v in st.items()}
    out.update(updates=sd["updates"], micro=sd["micro"], acc=sd["acc"])
    return out


def time_mapper(cfg, datasets, crops=(PIPE_SIZE, 1024)) -> dict:
    """Host ms per train image of the data path on the fixture's 6 train
    images: ``load`` (materialize_record: PNG decode, panoptic PNG to
    instance masks) and the training mapper (LSJ resize and crop, flip,
    prompt, padded targets) at each crop size; each timed after one warm-up
    pass."""
    from hipie_torch.data.mapper import HIPIEMapper
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer

    records = datasets.get_dataset("coco_panoptic_train")
    datasets.materialize_record(records[0])
    t0 = time.perf_counter()
    loaded = [datasets.materialize_record(r) for r in records]
    out = {"load": 1e3 * (time.perf_counter() - t0) / len(records)}
    for crop in crops:
        data_cfg = dataclasses.replace(cfg.data, crop_size=crop)
        mapper = HIPIEMapper(data_cfg, WordPieceTokenizer.toy(), max_gt=cfg.model.max_insts_num,
                             seed=SEED)
        mapper(loaded[0], bucket=(crop, crop))
        t0 = time.perf_counter()
        for r in loaded:
            mapper(r, bucket=(crop, crop))
        out[crop] = 1e3 * (time.perf_counter() - t0) / len(loaded)
    return out


def phase_pipeline(dev, card, config: str = "", opts=(), size: int = PIPE_SIZE):
    """Dataset to PQ through the port's entry points: the fixture from
    hipie_torch.tools.make_tiny_coco (6 train and 4 val PNG images of ``size``,
    the refcoco splits) in a temporary directory; train_net.main on
    ``config`` (configs/smoke_tiny_coco.yaml: R50 and BERT-base at full width,
    batch 2 of 256x256 LSJ crops) over coco_panoptic_train and refcoco-mixed
    for PIPE_STEPS steps, a checkpoint and an inline evaluation of 2 val images
    at the last; a fresh Trainer resumed from that checkpoint, its model and
    AdamW state bit-equal to the saved ones at step PIPE_STEPS, then
    PIPE_MORE_STEPS more steps (no more saves: the phase writes the step's
    checkpoint and model_best); eval_net.main on coco_panoptic_val with the
    checkpoint. Returns K-B's and K-D's launches and shapes over the phase."""
    import hipie_torch.data.datasets as datasets
    import hipie_torch.models.msda_module as msda_module
    import hipie_torch.ops.ms_deform_attn as msda_ops
    import hipie_torch.train.trainer as trainer_module
    from hipie_torch import kernels, native
    from hipie_torch.tools import eval_net, make_tiny_coco, train_net

    config = config or str(Path(__file__).resolve().parent / SMOKE_CONFIG)
    root = tempfile.mkdtemp(prefix="hipie_pipeline_")
    data, run = os.path.join(root, "data"), os.path.join(root, "run")
    kb_shapes, kd_shapes, saves = [], [], []
    save = trainer_module.save_checkpoint

    def timed_save(*a, **k):
        t = time.perf_counter()
        path = save(*a, **k)
        saves.append((os.path.basename(path), time.perf_counter() - t, os.path.getsize(path)))
        return path

    old_root = os.environ.get("HIPIE_DATASETS")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            make_tiny_coco.main(["--root", data, "--n-train", "6", "--n-val", "4", "--size",
                                 str(size), "--refcoco"])
        fixture_s = time.perf_counter() - t0
        n_files = sum(len(f) for _, _, f in os.walk(data))
        fixture_bytes = make_tiny_coco.dataset_bytes(data)
        os.environ["HIPIE_DATASETS"] = data
        datasets._register_builtin()            # the registry binds its root when imported
        mapper_ms = time_mapper(train_net.build_config(config, "", ()), datasets)
        argv = ["--config-file", config, "--device", str(dev), "--log-period", "1",
                "output_dir", run, "solver.checkpoint_period", str(PIPE_STEPS),
                "test.eval_period", str(PIPE_STEPS), "test.eval_max_images", "2",
                "data.train_datasets", "['coco_panoptic_train', 'refcoco-mixed']",
                "data.dataset_ratios", "[1.0, 1.0]", *opts]
        trainer_module.save_checkpoint = timed_save
        with timing_calls(msda_module, "ms_deform_attn",
                          lambda *a, **k: kb_shapes.append(msda_shape(*a, **k)), timed=False), \
                timing_calls(msda_ops, "ms_deform_attn_backward",
                             lambda *a: kd_shapes.append(msda_shape(*a[:4])), timed=False):
            kernels.reset_launch_counts()
            first = train_net.main(argv + ["solver.max_iter", str(PIPE_STEPS)])
            ckpt = os.path.join(run, f"model_{PIPE_STEPS:07d}.pth")
            if [n for n, _, _ in saves] != [os.path.basename(ckpt), "model_best.pth"]:
                raise AssertionError(f"pipeline: the first run saved {saves}, expected "
                                     f"{os.path.basename(ckpt)} and model_best.pth")
            second, _ = train_net.build_trainer(argv + [
                "solver.max_iter", str(PIPE_STEPS + PIPE_MORE_STEPS), "test.eval_period", "0"])
            second.checkpoints = False
            t0 = time.perf_counter()
            resumed = second.resume_or_load(None, resume=True)
            load_s = time.perf_counter() - t0
            if not resumed or second.state.step != PIPE_STEPS:
                raise AssertionError(f"pipeline: resume gave resumed={resumed}, step "
                                     f"{second.state.step}, expected step {PIPE_STEPS}")
            n_model = check_bit_equal("resumed model", second.state.model.state_dict(),
                                      first.state.model.state_dict())
            n_opt = check_bit_equal("resumed AdamW state",
                                    optimizer_tensors(second.state.optimizer),
                                    optimizer_tensors(first.state.optimizer))
            inline_eval = first.history[-1].get("eval", {})
            model = first.state.model
            n_params = sum(p.numel() for p in model.parameters())
            n_train = sum(p.numel() for p in first.state.optimizer.params)
            n_buffers = sum(b.numel() for b in model.buffers())
            del model
            history = first.history + [None]
            del first
            second.train()
            history += second.history
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                results = eval_net.main(["--config-file", config, "--dataset",
                                         "coco_panoptic_val", "--weights", ckpt,
                                         "--device", str(dev)])
            eval_s = time.perf_counter() - t0
            launches = {k: kernels.LAUNCHES[k] for k in ("ms_deform_attn", "ms_deform_attn_bwd")}
    finally:
        trainer_module.save_checkpoint = save
        if old_root is None:
            os.environ.pop("HIPIE_DATASETS", None)
        else:
            os.environ["HIPIE_DATASETS"] = old_root
        shutil.rmtree(root, ignore_errors=True)

    steps = [h for h in history if h is not None]
    tasks = Counter(h["task"] for h in steps)
    if set(tasks) != {"detection", "grounding"}:
        raise AssertionError(f"pipeline: the steps ran the tasks {dict(tasks)}, expected both "
                             f"detection and grounding")
    bad = [i for i, h in enumerate(steps) if not np.isfinite(h["total_loss"])]
    bad_metrics = [k for k in PIPE_METRICS if not np.isfinite(results.get(k, float("nan")))]
    if bad or bad_metrics or not inline_eval:
        raise AssertionError(f"pipeline: non-finite total loss at steps {bad}, eval metrics "
                             f"{bad_metrics} not finite, inline eval {inline_eval}")
    log(f"[pipeline] fixture: 6 train + 4 val images of {size}x{size} (PNG) and the refcoco "
        f"splits, {n_files} files, {fixture_bytes} bytes, made in {fixture_s:.2f} s; mask IoU "
        f"{native.status()}")
    log(f"[pipeline] host data path per train image (6 fixture images, after a warm-up): load "
        f"and decode {mapper_ms['load']:.2f} ms; mapper "
        + ", ".join(f"{v:.2f} ms at a {k}x{k} LSJ crop" for k, v in mapper_ms.items()
                    if k != "load"))
    log("[pipeline] steps (task, total loss, data_time ms, step ms): "
        + ", ".join("resume" if h is None else
                    f"({h['task']}, {h['total_loss']:.2f}, {1e3 * h['data_time_s']:.1f}, "
                    f"{1e3 * h['time_s']:.1f})" for h in history))
    log(f"[pipeline] {n_params} parameters ({n_train} trainable), {n_buffers} buffer values: "
        f"f32 weights and buffers plus two f32 AdamW moments = "
        f"{4 * (n_params + n_buffers) + 8 * n_train} bytes a checkpoint, before pickling")
    log(f"[pipeline] checkpoints: " + ", ".join(f"{n} {b} bytes saved in {t:.2f} s"
                                               for n, t, b in saves)
        + f"; resumed in {load_s:.2f} s at step {PIPE_STEPS}, model ({n_model} bytes) and "
          f"AdamW state ({n_opt} bytes) bit-equal to the saved ones")
    log(f"[pipeline] inline eval at step {PIPE_STEPS} (2 images): "
        f"{ {k: round(float(v), 4) for k, v in inline_eval.items() if k in PIPE_METRICS} }")
    log(f"[pipeline] eval_net coco_panoptic_val ({results['images']} images, "
        f"{results['sec_per_image']:.3f} s an image, {eval_s:.1f} s in all): "
        f"{ {k: round(float(results[k]), 4) for k in PIPE_METRICS} }; launches K-B "
        f"{launches['ms_deform_attn']}, K-D {launches['ms_deform_attn_bwd']}; card {card}")
    return ({"launches": launches, "steps": steps, "eval": results, "mapper_ms": mapper_ms},
            kb_shapes, kd_shapes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    records, vit_cases, msda_cases, bwd_cases, vit_bwd_cases = phase_kernels(dev, card)
    phase_reference(dev)
    launches, per_request, kb_per_request, serve_ka = phase_serve(dev, card)
    predict_shapes = []
    with timing_msda(predict_shapes):
        launches["msda_reduce"] = phase_predict(dev, card)["msda_reduce"]
    train, train_ka, train_kb, train_kd, _ = phase_train(dev, card)
    torch.cuda.empty_cache()
    from hipie_torch.presets import vit_huge_coco_panoptic

    vit_train, vit_ka, vit_kb, vit_kd, vit_ke = phase_train(
        dev, card, cfg=vit_huge_coco_panoptic(), steps=VIT_TRAIN_STEPS)
    torch.cuda.empty_cache()
    pipe, pipe_kb, pipe_kd = phase_pipeline(dev, card)
    missing = [k for k, n in pipe["launches"].items() if n == 0]
    if missing:
        raise AssertionError(f"the pipeline phase never launched {missing}: {pipe['launches']}")
    # ViT-H at 1024x1024: 32 blocks, 8 of them windowed (ViTDet's
    # window_block_indexes), so 24 global blocks at N = 4096 with rel-pos. Each
    # must take K-A, again under vit_remat, and K-E for its gradient: counted
    # here without the dispatch predicate that train_launches shares with the
    # model.
    vit_want = {"vit_attention": 2 * VITH_GLOBAL_BLOCKS, "vit_attention_bwd": VITH_GLOBAL_BLOCKS}
    vit_got = {k: vit_train["per_step"][k] for k in vit_want}
    if vit_got != vit_want:
        raise AssertionError(f"ViT-H train step launched {vit_got} of K-A and K-E, expected "
                             f"{vit_want}")
    check_coverage("K-A", vit_cases, serve_ka + train_ka + vit_ka)
    check_msda_coverage(msda_cases, [s for s in list(kb_per_request) + predict_shapes + train_kb
                                     + vit_kb + pipe_kb if s])
    check_coverage("K-D", bwd_cases, train_kd + vit_kd + pipe_kd)
    check_coverage("K-E", vit_bwd_cases, vit_ke)
    # every K-E launch of the ViT-H step on the wgmma design
    from hipie_torch.ops.vit_attention import vit_attention_bwd_design

    ke_designs = {vit_attention_bwd_design(n, hd, kh, kw) for _, n, hd, kh, kw, _ in vit_ke}
    if ke_designs != {"wgmma"}:
        raise AssertionError(f"the ViT-H train step launched K-E on the designs {ke_designs}, "
                             f"expected only the wgmma one")
    kd_designs = check_kd_designs(train_kd + vit_kd, [train["kd_designs"], vit_train["kd_designs"]])
    launches["ms_deform_attn_bwd"] = train["launches"]["ms_deform_attn_bwd"]
    launches["vit_attention_bwd"] = vit_train["launches"]["vit_attention_bwd"]
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["name"] in per_request:
            r["launches_per_request"] = per_request[r["name"]]
    next(r for r in records if r["name"] == "msda_reduce")["launches_per_flat4_call"] = (
        launches["msda_reduce"])
    kb = next(r for r in records if r["name"] == "ms_deform_attn")
    kb["launches_per_train_step"] = train["per_step"]["ms_deform_attn"]
    for r in records:
        if r["name"] in pipe["launches"]:
            r["launches_pipeline"] = pipe["launches"][r["name"]]
            shapes = pipe_kb if r["name"] == "ms_deform_attn" else pipe_kd
            r["pipeline_shapes"] = dict(Counter(f"S={sum(h * w for h, w in x[0])} B={x[1]} "
                                                f"Q={x[2]} {x[5]}" for x in shapes if x))
    kd = next(r for r in records if r["name"] == "ms_deform_attn_bwd")
    kd["launches_per_train_step"] = train["per_step"]["ms_deform_attn_bwd"]
    kd["train_ms_per_step"] = train["ms_per_step"]
    kd["train_peak_gib"] = train["peak_gib"]
    kd["train_designs"] = kd_designs
    for r in records:
        if r["name"] in ("vit_attention", "vit_attention_bwd", "ms_deform_attn",
                         "ms_deform_attn_bwd"):
            r["launches_per_vit_huge_train_step"] = vit_train["per_step"][r["name"]]
    ke = next(r for r in records if r["name"] == "vit_attention_bwd")
    ke["vit_huge_train_ms_per_step"] = vit_train["ms_per_step"]
    ke["vit_huge_train_peak_gib"] = vit_train["peak_gib"]
    ke["vit_huge_train_syncs"] = vit_train["syncs"]
    ke["vit_huge_train_designs"] = sorted(ke_designs)
    kb["launches_per_request_by_case"] = {
        c["case"]: kb_per_request[c["shape"]] for c in msda_cases
        if c["locations"] == "uniform" and c["shape"] in kb_per_request}
    kb["ms_per_request"] = msda_ms_per_request(msda_cases, kb_per_request)
    kb["ms_per_request_local"] = msda_ms_per_request(msda_cases, kb_per_request, local=True)
    log(f"[serve] K-B ms per ViT-H request from the shape times and the counted launches "
        f"{kb['launches_per_request_by_case']}: {kb['ms_per_request']:.4f} "
        f"({kb['ms_per_request_local']:.4f} with local encoder locations); card {card}")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
