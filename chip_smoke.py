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
    and the ViT-H encoder in f32, the training step's three shapes at
    batch 2 at 1024x1024 and at the pipeline phase's 256x256, and the
    decoders with language-derived bg queries (phase 12: R50, Q = 963;
    training, Q = 1142); its record
    adds each case's numbers and bound and the encoder's corner-row traffic
    and rate. K-D (the MSDA backward) runs MSDA_BWD_CASES, every training
    shape in bf16 and f32 (the encoder also with local locations; the
    pipeline phase's 256x256 shapes and phase 12's decoder in bf16),
    against the plain version's autograd (``check_msda_bwd``), its plain time
    by CUDA events around eager calls (autograd does not go into a graph),
    naming the design its C entry launched at each ("binned" or "atomics")
    and, for the binned one, its bins, chunks and global adds as the launch
    wrote them into its scratch (``bwd_binned_stats``), beside the atomics
    design's adds. K-F (greedy NMS) runs NMS_CASES at the serving shape (900
    boxes, 133 classes or none), its keep mask equal bit for bit to the plain
    version's and its call free of syncs, timed beside the plain host loop.
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
10. open-vocab: HIPIEPredictor over HIPIEModel(open_vocab_eval()) at full
    width (R50, BERT-base, 900 + 10 queries, MaskDINO) in bf16 with seeded
    weights and a CLIPScorer with full ViT-L-14-336 towers (visual 24 x 1024,
    16 heads, patch 14 at 336; text 12 x 768) in bf16 from a seeded generator;
    the toy tokenizers over Pascal-Context-459's names fill the 1536-token
    prompt, which BERT encodes in at least 3 chunks; OV_CALLS distinct 480x640
    images padded to the 800x1216 bucket. Every output finite, sem_seg over the
    459 classes, the CLIP text embeddings built once over the calls, the CLIP
    visual tower twice a call (the fg masks, then the fg + MaskDINO masks), K-B
    exactly 21 times a call and nothing else; ms per call, and by CUDA events
    the chunked BERT, the detector, both MaskCLIP passes and the text
    embedding; peak memory and parameter counts. Then eval_net.main with
    model.clip.enabled on phase 9's fixture (coco_panoptic_val): every metric
    finite.
11. backbones: HIPIEPredictor over swin_large_coco_panoptic() and
    convnext_large_coco_panoptic() at full width in bf16 with seeded weights,
    2 panoptic calls each over the 133 COCO labels: finite outputs, K-B exactly
    21 times a call; ms per call, the backbone's ms by CUDA events, peak memory
    and the backbone's parameter count.
12. branches: HIPIEPredictor over r50_coco_panoptic() at full width in bf16
    with seeded weights and each option that no preset turns on: language-
    derived bg queries (2 calls; the decoder takes the 53 stuff labels'
    queries in front, Q = 963), MaskDINO's own encoder (2 calls; K-B 27 a
    call, 6 of them at the encoder shape), the in-encoder BERT layers and the
    language content queries (1 call each): K-B exact a call and its queries
    by shape, finite and shaped results, ms per call. Then BRANCH_TRAIN_STEPS
    R50 training steps as phase 7's with bg_lang queries (32 slots, their
    criterion pass at weight 1) and the own encoder: K-B and K-D exactly 27 a
    step, the decoder at Q = 200 + 32 + 10 + 900; ms per step, peak memory
    and each named range's device ms by CUDA events (crit_bg_lang among
    them).
13. parallel: the data-parallel step (hipie_torch/parallel/) on the one card.
    (a) phase_parallel_vith: vit_huge_coco_panoptic() at full width and depth,
    2 steps on phase 8's batches from one CPU snapshot of the state and one
    seed, three times through the plain step and once under NCCL at world size
    1 (init_distributed in this process): at the first step the NCCL run's
    largest loss-term and gradient differences from the first plain run
    within twice the other plain runs' (the step adds with atomics, so it is
    not bitwise repeatable; the second step's reported), K-A 48, K-E 24, K-B 33 and K-D 21 a step exactly; ms per
    step, the "allreduce" range's device ms, collectives a step, peak memory.
    (b) phase_parallel_pair: r50_coco_panoptic() at full width as two gloo
    ranks on cuda:0 (NCCL refuses two ranks on one device), each with one
    image of phase 7's batch of 2 (GT counts differ, the second image all
    stuff): (i) one f32 step (TF32 off) against the one-process batch-2 step
    from the same weights and keys, the one-process run's point picks and
    matches replayed (loss terms within PAR_TERM_RTOL; the gradients' median
    within PAR_GRAD_MEDIAN_RTOL and each within PAR_GRAD_RTOL; the ranks' own
    matching, a second one-process run and one from weights nudged by one ulp
    reported beside);
    (ii) 2 bf16 steps through the Trainer, the ranks bit-identical after each,
    K-B and K-D 21 a step a rank; (iii) evaluate_detection_dataset sharded
    over phase 9's fixture val split with phase 9's checkpoint, every metric
    equal to phase 9's eval_net numbers, and with a predictor that answers
    from the ground truth, imperfectly (GtPredictor: every metric strictly
    between 0 and 100, where phase 9's few steps score 0), every metric equal
    to one process's. Each process's peak memory.
14. last modules (phase_last_modules): (a) 3 training steps each of
    swin_large_coco_panoptic() and convnext_large_coco_panoptic() as phase 7's
    (batch 2 at 1024x1024, 100 GT slots, bf16 autocast; K-B and K-D exact a
    step; finite loss terms and gradients; ms per step, peak memory); (b) 2
    ViT-H steps with solver.mu_dtype bfloat16: the first moment stored in bf16
    and the second step's peak at least 1.2 GiB under phase 8's f32 steps'
    after the first; (c)
    make_tiny_coco --ade-semseg (the val split as JPEG in the ADE20k layout),
    eval_net on ade20k_sem_seg_val with phase 9's checkpoint (mIoU finite) and
    with GtPredictor answering the GT exactly (mIoU 100); (d) the demo CLI on
    one of those JPEGs, detection and grounding, its files read back; (e) the
    JPEG decoder on the files committed under tests/data/jpeg/ against cv2's
    decodes committed beside them (within one level, mean 0.01) and its decode
    and encode ms at 640x480; (f) BoxInst's losses and logit gradient at N =
    100, 256x256, K = 3, dilation 2 against the CPU's, with their ms; then the
    bounds of CLIP's and Swin-L's attention from their shapes.
15. tensor parallel (phase_tensor_parallel): tp = 2 with shard_tokens on two
    gloo ranks on the one card (hipie_torch/parallel/tensor.py): (a) the ViT-H
    request in f32 against one process's with its two-stage choices replayed,
    then bf16 requests with K-A at BH = 8 and K-B at Q = 10880; (a') an R50
    predictor call (20197 tokens split 10099 / 10098); (b) the R50 step in f32
    against one process's (13b's limits), 2 bf16 steps with the replicated
    parameters bit-identical, its checkpoint restored at tp = 1 bit for bit;
    (c) a ViT-H step in f32 at batch 1 against one process's (within twice
    the one-process step's own round-off twin; the rel-pos tables' gradients
    among those held), then one in bf16 at batch 2 a rank, its launches exact.
Every shape at which phases 5, 8, 13, 14 and 15 launched K-A, every shape at
which phases 5 to 15 launched K-B, every shape at which phases 7 to 9 and 12 to
15 launched K-D, and every shape at which phases 8, 13, 14 and 15 launched K-E
must be one that phase 3 checked.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
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
# The branches phase: with model.bg_query_from_lang the R50 predictor's decoder
# takes one query per stuff label in front (COCO panoptic: 53), and the
# training step num_bg_lang_queries (32) after the 200 CDN slots. MaskDINO's
# own encoder runs at the main encoder's levels and Q = S (r50_encoder and
# train_encoder).
N_STUFF = 53
BG_LANG_SLOTS = 32
BG_LANG_DEC_Q = N_STUFF + 10 + 900
TRAIN_BG_LANG_DEC_Q = 200 + BG_LANG_SLOTS + 10 + 900
# The parallel phase's R50 steps: the training shapes in f32 (13b's
# one-process step), and at one image a rank ("rank_*", bf16 and f32).
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
    ("r50_decoder_bg_lang", R50_LEVELS, 1, BG_LANG_DEC_Q, torch.bfloat16, "uniform"),
    ("r50_maskdino", R50_LEVELS[::-1], 1, 300, torch.bfloat16, "uniform"),
    ("r50_encoder_f32", R50_LEVELS, 1, R50_S, torch.float32, "uniform"),
    ("r50_decoder_f32", R50_LEVELS, 1, 910, torch.float32, "uniform"),
    ("r50_maskdino_f32", R50_LEVELS[::-1], 1, 300, torch.float32, "uniform"),
    ("train_encoder", VITH_LEVELS, TRAIN_B, VITH_S, torch.bfloat16, "uniform"),
    ("train_decoder", VITH_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("train_decoder_bg_lang", VITH_LEVELS, TRAIN_B, TRAIN_BG_LANG_DEC_Q, torch.bfloat16,
     "uniform"),
    ("train_maskdino", VITH_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("pipe_encoder", PIPE_LEVELS, TRAIN_B, PIPE_S, torch.bfloat16, "uniform"),
    ("pipe_decoder", PIPE_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("pipe_maskdino", PIPE_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("train_encoder_f32", VITH_LEVELS, TRAIN_B, VITH_S, torch.float32, "uniform"),
    ("train_decoder_f32", VITH_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.float32, "uniform"),
    ("train_maskdino_f32", VITH_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.float32, "uniform"),
    ("rank_decoder", VITH_LEVELS, 1, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("rank_maskdino", VITH_LEVELS[::-1], 1, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("rank_decoder_f32", VITH_LEVELS, 1, TRAIN_DEC_Q, torch.float32, "uniform"),
    ("rank_maskdino_f32", VITH_LEVELS[::-1], 1, TRAIN_MD_Q, torch.float32, "uniform"),
    # phase 15, sequence parallelism at tp = 2: a rank's share of the encoder's
    # queries against the whole value table, and the f32 serving call's decoders
    ("sp_encoder", VITH_LEVELS, 1, VITH_S // 2, torch.bfloat16, "uniform"),
    ("sp_encoder_f32", VITH_LEVELS, 1, VITH_S // 2, torch.float32, "uniform"),
    ("decoder_f32", VITH_LEVELS, 1, 910, torch.float32, "uniform"),
    ("maskdino_f32", VITH_LEVELS[::-1], 1, 300, torch.float32, "uniform"),
    ("sp_train_encoder", VITH_LEVELS, TRAIN_B, VITH_S // 2, torch.bfloat16, "uniform"),
    ("sp_train_encoder_f32", VITH_LEVELS, TRAIN_B, VITH_S // 2, torch.float32, "uniform"),
    ("sp_r50_encoder", R50_LEVELS, 1, R50_S - R50_S // 2, torch.bfloat16, "uniform"),
    ("sp_r50_encoder_rank1", R50_LEVELS, 1, R50_S // 2, torch.bfloat16, "uniform"),
)
# K-D's cases: every shape the training phase launches it at (bf16), each also
# in f32, and the encoder with local locations; main() fails if the training
# phase launches K-D at a shape not here. The encoder cases take K-D's binned
# design, the others its atomics design (the C entry's rule).
MSDA_BWD_CASES = (
    ("train_encoder", VITH_LEVELS, TRAIN_B, VITH_S, torch.bfloat16, "uniform"),
    ("train_encoder_local", VITH_LEVELS, TRAIN_B, VITH_S, torch.bfloat16, "local"),
    ("train_decoder", VITH_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("train_decoder_bg_lang", VITH_LEVELS, TRAIN_B, TRAIN_BG_LANG_DEC_Q, torch.bfloat16,
     "uniform"),
    ("train_maskdino", VITH_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("train_encoder_f32", VITH_LEVELS, TRAIN_B, VITH_S, torch.float32, "uniform"),
    ("train_decoder_f32", VITH_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.float32, "uniform"),
    ("train_maskdino_f32", VITH_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.float32, "uniform"),
    ("pipe_encoder", PIPE_LEVELS, TRAIN_B, PIPE_S, torch.bfloat16, "uniform"),
    ("pipe_decoder", PIPE_LEVELS, TRAIN_B, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("pipe_maskdino", PIPE_LEVELS[::-1], TRAIN_B, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("rank_encoder", VITH_LEVELS, 1, VITH_S, torch.bfloat16, "uniform"),
    ("rank_decoder", VITH_LEVELS, 1, TRAIN_DEC_Q, torch.bfloat16, "uniform"),
    ("rank_maskdino", VITH_LEVELS[::-1], 1, TRAIN_MD_Q, torch.bfloat16, "uniform"),
    ("rank_encoder_f32", VITH_LEVELS, 1, VITH_S, torch.float32, "uniform"),
    ("rank_decoder_f32", VITH_LEVELS, 1, TRAIN_DEC_Q, torch.float32, "uniform"),
    ("rank_maskdino_f32", VITH_LEVELS[::-1], 1, TRAIN_MD_Q, torch.float32, "uniform"),
    # phase 15 (sequence parallelism at tp = 2): the R50 and ViT-H steps' share
    # of the encoder's queries at batch 2, f32 then bf16, the f32 ViT-H step's
    # at batch 1, and R50 serving's uneven split of 20197 tokens
    ("sp_train_encoder", VITH_LEVELS, TRAIN_B, VITH_S // 2, torch.bfloat16, "uniform"),
    ("sp_train_encoder_f32", VITH_LEVELS, TRAIN_B, VITH_S // 2, torch.float32, "uniform"),
    ("sp_rank_encoder_f32", VITH_LEVELS, 1, VITH_S // 2, torch.float32, "uniform"),
    ("sp_r50_encoder", R50_LEVELS, 1, R50_S - R50_S // 2, torch.bfloat16, "uniform"),
    ("sp_r50_encoder_rank1", R50_LEVELS, 1, R50_S // 2, torch.bfloat16, "uniform"),
)
# K-A's cases (name, BH, Kh, Kw, hd), bf16: a ViT-H request (one image: BH =
# 16, N = 4096, hd 80), the ViT-H training step (batch 2: BH = 32) and a
# tensor-parallel rank's half of the heads (BH = 8), each with and without the
# logsumexp. main() fails if the serve or a train phase
# launches K-A at a shape not here.
VIT_CASES = (
    ("serve", 16, 64, 64, 80),
    ("train", 32, 64, 64, 80),
    ("tp2", 8, 64, 64, 80),           # phase 15: a rank's 8 of 16 heads, one image
)
# (phase 15's ViT-H step, batch 2 a rank at 8 heads, takes K-A and K-E at BH =
# 16: the "serve" and "one_image" cases)
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
    records.append(_check_nms(dev, card))
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


# K-F's inputs: the serving path's NMS runs over the 900 fg queries of an image
# (900 + 10 queries, the 10 bg ones first) with their argmax over the 133 classes.
NMS_N = 900
NMS_THRESH = 0.7                 # test.nms_thresh
NMS_CASES = ("serve", "tied_scores", "duplicates", "zero_area", "all_overlap", "none_overlap",
             "near_threshold")


def nms_case(case: str, n: int, seed: int, with_classes: bool):
    """K-F's inputs from ``seed`` with numpy: boxes (n, 4) xyxy f32, scores (n,)
    f32 (an eighth of them tied), class ids (n,) int64 or None. "serve": boxes
    around n // 20 objects with their own classes (a fifth drawn at random of
    the 133), as a served image's fg queries give them; "tied_scores": the same
    boxes, 3 score values; "duplicates": the second half copies the first;
    "zero_area": a third of the boxes without width, a fifth without height;
    "all_overlap": one box jittered by 1e-3; "none_overlap": a grid of disjoint
    boxes; "near_threshold": pairs of a unit box and one of width ~0.7 on an
    integer grid, each pair's IoU within 1e-6 of 0.7 (in f32 as box_ops
    computes it), alternately above and at or below f32(0.7)."""
    from hipie_torch.ops.box_ops import elementwise_box_iou

    rng = np.random.RandomState(seed)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[rng.randint(0, n, n // 8)] = scores[0]
    obj = rng.randint(0, max(1, n // 20), n)
    cls = rng.randint(0, 3, n)
    if case in ("serve", "tied_scores", "duplicates", "zero_area"):
        centres = rng.uniform(0.1, 0.9, (max(1, n // 20), 2))[obj]
        cxcy = centres + rng.normal(0, 0.02, (n, 2))
        wh = rng.uniform(0.05, 0.4, (n, 2))
        boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], 1)
        obj_cls = rng.randint(0, N_CLASSES, max(1, n // 20))[obj]
        cls = np.where(rng.uniform(0, 1, n) < 0.2, rng.randint(0, N_CLASSES, n), obj_cls)
        if case == "tied_scores":
            scores = scores[rng.randint(0, 3, n)]
        elif case == "duplicates":
            boxes[n // 2:] = boxes[:n - n // 2]
            cls[n // 2:] = cls[:n - n // 2]
        elif case == "zero_area":
            boxes[::3, 2] = boxes[::3, 0]
            boxes[1::5, 3] = boxes[1::5, 1]
    elif case == "all_overlap":
        boxes = np.array([0.2, 0.3, 0.6, 0.8]) + rng.normal(0, 1e-3, (n, 4))
    elif case == "none_overlap":
        side = int(np.ceil(np.sqrt(n)))
        xy = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2)[:n]
        xy = xy[rng.permutation(n)] / side
        boxes = np.concatenate([xy, xy + 0.8 / side], 1)
    elif case == "near_threshold":
        m = (n + 1) // 2
        side = int(np.ceil(np.sqrt(m)))
        xy = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2)[:m]
        xy = (xy - side // 2).astype(np.float32)    # below 16 up to n = 1800: ulp <= 2^-20
        unit = torch.from_numpy(np.concatenate([xy, xy + 1], 1))
        j = np.arange(-40, 41, dtype=np.float32)
        x2 = (xy[:, :1] + (np.float32(0.7) + j * np.float32(5e-8))).astype(np.float32)
        narrow = unit[:, None, :].repeat(1, len(j), 1)
        narrow[:, :, 2] = torch.from_numpy(x2)
        iou = elementwise_box_iou(unit[:, None, :], narrow).numpy().astype(np.float64)
        above = (np.arange(m) % 2 == 0)[:, None]
        miss = np.abs(iou - 0.7) + 1.0 * ((iou > np.float32(0.7)) != above)
        pick = miss.argmin(1)
        got = iou[np.arange(m), pick]
        if not (np.abs(got - 0.7).max() <= 1e-6
                and ((got > np.float32(0.7)) == above[:, 0]).all()):
            raise AssertionError("nms_case: near_threshold pairs off 0.7 by "
                                 f"{np.abs(got - 0.7).max()}")
        pairs = np.stack([unit.numpy(), narrow[np.arange(m), pick].numpy()], 1)
        boxes = pairs.reshape(-1, 4)[:n]
    else:
        raise ValueError(f"nms_case: unknown case {case}")
    return (boxes.astype(np.float32), scores,
            cls.astype(np.int64) if with_classes else None)


def _check_nms(dev, card):
    """K-F against the plain version at the serving shape (NMS_N boxes, 133
    classes, f32), every NMS_CASES case with and without class ids: keep masks
    equal bit for bit, and no sync on the card's path (the sync debug mode set
    to raise around a call). Times at the "serve" case with classes: K-F on the
    card alone (CUDA events around a graph of calls), a call on the host's clock
    with its sort and launches (what a request pays), and the plain version on
    the card's tensors (IoU on the card, the copy to the host, the host loop,
    the copy back; host clock)."""
    from hipie_torch import kernels
    from hipie_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain

    rec = None
    for i, case in enumerate(NMS_CASES):
        for with_classes in (True, False):
            boxes, scores, cls = nms_case(case, NMS_N, SEED + 200 + i, with_classes)
            b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
            c = None if cls is None else torch.from_numpy(cls)
            want = nms_keep_mask(b, s, c, NMS_THRESH)
            bd, sd, cd = b.to(dev), s.to(dev), None if c is None else c.to(dev)
            torch.cuda.synchronize()
            before = kernels.LAUNCHES["nms"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = nms_keep_mask(bd, sd, cd, NMS_THRESH)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            got = got.cpu()
            mismatches = int((got != want).sum())
            classes = "133 classes" if cls is not None else "no classes"
            log(f"[kernels] nms {case} N={NMS_N} {classes}: {int(want.sum())} kept by the plain "
                f"version, {mismatches} entries differ (tol 0: bit-equal), launches "
                f"{kernels.LAUNCHES['nms'] - before}")
            if mismatches or got.dtype != torch.bool or kernels.LAUNCHES["nms"] != before + 1:
                raise AssertionError(f"nms {case}: {mismatches} keep entries differ from the "
                                     f"plain version's")
            if case == "serve" and with_classes:
                calls = 50
                ms = cuda_time_ms(lambda: nms_keep_mask(bd, sd, cd, NMS_THRESH), calls)
                nms_keep_mask(bd, sd, cd, NMS_THRESH)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(calls):
                    nms_keep_mask(bd, sd, cd, NMS_THRESH)
                torch.cuda.synchronize()
                host_ms = 1e3 * (time.perf_counter() - t) / calls
                nms_keep_mask_plain(bd, sd, cd, NMS_THRESH)
                t = time.perf_counter()
                for _ in range(5):
                    nms_keep_mask_plain(bd, sd, cd, NMS_THRESH)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t) / 5
                pairs = NMS_N * (NMS_N - 1) / 2
                # 14 f32 operations an IoU and its test; boxes, scores and class
                # ids read once, the keep mask written once
                b_ = bound(14.0 * pairs, nbytes(bd, sd, cd) + NMS_N, PEAK_F32, "f32 cores")
                log(f"[kernels] nms serve N={NMS_N}: K-F {ms:.4f} ms on the card (sort and two "
                    f"kernels, CUDA graph), {host_ms:.4f} ms a call on the host's clock (sort, "
                    f"launches, synchronize); plain version {plain_ms:.3f} ms (IoU on the card, "
                    f"two blocking copies, host loop); bound {b_['bound_ms']:.6f} ms "
                    f"({b_['bound_unit']}: {b_['bound_flops'] / 1e6:.1f} MFLOP, "
                    f"{b_['bound_bytes'] / 1e3:.1f} KB); card {card}")
                rec = {"name": "nms", "route": "cuda", "source": "hipie_torch/csrc/nms.cu",
                       "replaces": "hipie_tpu/ops/nms.py:21 (lax.scan, not Pallas)",
                       "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, **b_,
                       "library_ms": None, "library_call": None, "max_abs_err": 0.0,
                       "kept": int(want.sum())}
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
    log(f"[train] K-D launches by shape and design, all train phases: "
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


def msda_per_call(mc) -> int:
    """MSDeformAttn layers a model pass runs: encoder, decoder, MaskDINO decoder,
    and MaskDINO's own encoder where it does not share the main one."""
    return (mc.transformer.num_encoder_layers + mc.transformer.num_decoder_layers
            + mc.maskdino.dec_layers
            + (0 if mc.maskdino.shared_encoder else mc.maskdino.enc_layers))


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


def vit_huge_server(dev, seed: int = SEED, dtype=torch.bfloat16, overrides=None, out=None):
    """HIPIEModel(vit_huge_coco_panoptic()) at full width in ``dtype`` (bf16)
    with random weights from a seeded torch.Generator, cut to this rank's
    shard under a model axis (``shard_module_``, a no-op without one), and
    ``request(img)``, which answers one (1, 1024, 1024, 3) uint8 image with a
    synthetic 256-token prompt (its text features encoded once, here) and a
    133-class map. ``overrides`` go to the config; with ``out`` (a dict),
    each request also leaves the model's outputs there. Returns (cfg, model,
    request); call ``request`` under torch.inference_mode()."""
    from hipie_torch.config import apply_overrides
    from hipie_torch.models.hipie import HIPIEModel, hipie_inference
    from hipie_torch.parallel.tensor import shard_module_
    from hipie_torch.presets import vit_huge_coco_panoptic
    from hipie_torch.utils.weights import random_init_

    cfg = vit_huge_coco_panoptic()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    mc = cfg.model
    with torch.device(dev):
        model = HIPIEModel(mc).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(seed))
    model.to(dtype)
    shard_module_(model)
    L = mc.text.max_query_len
    ids = torch.from_numpy((np.arange(L) % 1000 + 999)[None]).to(dev)
    am = torch.ones(1, L, dtype=torch.long, device=dev)
    maps = class_maps(L, dev)
    pad = torch.zeros(1, IMG, IMG, dtype=torch.bool, device=dev)
    sizes = torch.tensor([[IMG, IMG]], device=dev)
    with torch.inference_mode():
        lang_hidden = model.encode_text(ids, am)

    def request(img):
        got = model(img.to(dev), pad, ids, am, sizes, lang_hidden=lang_hidden)
        if out is not None:
            out.update(got)
        return hipie_inference(got, maps, cfg.test, mc, pad_mask_s4=pad[0][::4, ::4])

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
    n_msda = msda_per_call(mc)
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
            "msda_reduce": 0, "ms_deform_attn_bwd": 0, "vit_attention_bwd": 0,
            "nms": N_REQUESTS}
    log(f"[serve] kernel launches {launches}, expected {want} "
        f"({n_global} global ViT blocks, {n_msda} MSDA layers and one NMS per request)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    kb_per_request = {shape: n / N_REQUESTS for shape, n in Counter(kb_shapes).items()}
    log(f"[serve] K-B launches per request by shape (levels, B, Q, M, D, dtype): "
        f"{kb_per_request}")
    return (launches, {name: count // N_REQUESTS for name, count in launches.items()},
            kb_per_request, ka_shapes)


def predictor_launches(n_msda: int, kernel: str = "ms_deform_attn", passes: int = 1) -> dict:
    """Each kernel's launches in ``passes`` predictor calls of one image: the
    model's n_msda MSDA layers on ``kernel`` (K-B, or K-C under flat4) and
    ``hipie_inference``'s NMS on K-F, once a call."""
    from hipie_torch import kernels

    return {k: n_msda * passes if k == kernel else passes if k == "nms" else 0
            for k in kernels.LAUNCHES}


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
    n_msda = msda_per_call(mc)

    calls = []

    def timed(name, fn, kernel="ms_deform_attn", passes=1):
        """Times one call and checks it launched n_msda x passes of ``kernel`` and
        K-F once a pass alone."""
        before = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        out = fn()
        calls.append((name, 1000.0 * (time.perf_counter() - t)))
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        want = predictor_launches(n_msda, kernel, passes)
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
    want = predictor_launches(n_msda, passes=n_passes)
    log(f"[predict] fused: kernel launches {fused_launches}, expected {want} "
        f"({n_msda} MSDA layers and one NMS x {n_passes} model passes)")
    if fused_launches != want:
        raise AssertionError(f"launch counts {fused_launches} != {want}")

    kernels.reset_launch_counts()
    res = timed("panoptic flat4", lambda: preds["flat4"](images[4], test_categories=labels),
                kernel="msda_reduce")
    _check_prediction(res, "detection")
    flat4_launches = dict(kernels.LAUNCHES)
    want = predictor_launches(n_msda, "msda_reduce")
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
VITH_BLOCKS = 32
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
    n_msda = msda_per_call(mc)
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
            "ms_deform_attn_bwd": n_msda, "msda_reduce": 0, "nms": 0}


def phase_train(dev, card, cfg=None, img: int = IMG, slots: int = TRAIN_N,
                steps: int = TRAIN_STEPS, ranges: bool = False, require_moved: bool = True):
    """A config (default r50_coco_panoptic()) trained at full width through
    make_train_step and Trainer: f32 master weights, bf16 autocast compute,
    seeded random init, ``steps`` optimizer steps on synthetic batches, the
    launches of every kernel exact each step (``train_launches``). With
    ``ranges``, each step's named ranges (hipie_torch/train/step.py ``scope``)
    are timed by CUDA events, as hipie_torch.train.profile times them, and the
    step syncs at its end. Without ``require_moved``, a trainable parameter
    with a finite gradient that did not move is counted, not an error
    (ConvNeXt's blocks sit behind layer scales of 1e-6, and AdamW's step of a
    gradient far below its eps is below f32 resolution). Returns (launches
    and times, K-A, K-B, K-D and K-E shapes)."""
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
    per_step, terms, range_ms = [], [], []
    timer = None
    if ranges:
        from hipie_torch.train.profile import _PhaseTimer

        timer = _PhaseTimer()

    step_peaks = []                    # each step's peak memory (GiB), the first's from the start

    def train_step(st, batch, keys):
        k0, s0 = dict(kernels.LAUNCHES), matcher.HOST_SYNCS[0]
        out = inner(st, batch, keys)
        per_step.append(({k: kernels.LAUNCHES[k] - k0[k] for k in k0},
                         matcher.HOST_SYNCS[0] - s0))
        if timer is not None:
            torch.cuda.synchronize()
            range_ms.append(timer.take())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            step_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.cuda.reset_peak_memory_stats()
        return out

    weight_fn, scope_fn = step_module.apply_weight_dict, step_module.scope

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
    if timer is not None:
        step_module.scope = timer
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
        step_module.apply_weight_dict, step_module.scope = weight_fn, scope_fn
    peak = (max(step_peaks + [torch.cuda.max_memory_allocated() / 2 ** 30])
            if dev.type == "cuda" else 0.0)

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
            if require_moved and (moments is None or not moments.any()
                                  or not bool((lr_max < spacing).all())):
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
        f"{zero_grad[:6]}; {len(below_resolution)} unmoved"
        + (", their steps below f32 resolution" if require_moved else "")
        + f" {below_resolution[:4]}")
    log(f"[train] ms per step {[round(t, 1) for t in times]}; after the first: mean "
        f"{np.mean(times[1:]):.1f} ms; peak memory {peak:.2f} GiB; matcher host syncs per step "
        f"{syncs}; kernel launches per step {per_step[-1][0]} (expected {want}); "
        f"{len(through_ke) // 4} global blocks' attention checked for a nonzero gradient; "
        f"card {card}")
    return ({"launches": launches, "per_step": per_step[-1][0], "ms_per_step": times,
             "peak_gib": peak, "syncs": syncs, "kd_designs": kd_designs, "range_ms": range_ms,
             "unmoved": len(below_resolution), "trainable": len(before),
             "step_peaks_gib": step_peaks,
             "mu_dtypes": sorted({str(st["exp_avg"].dtype) for st in opt.opt.state.values()
                                  if "exp_avg" in st})},
            ka_shapes, kb_shapes, kd_shapes, ke_shapes)

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


def phase_pipeline(dev, card, config: str = "", opts=(), size: int = PIPE_SIZE, root: str = ""):
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
    checkpoint. The fixture and the run go under ``root`` (kept; default a
    temporary directory, removed). Returns K-B's and K-D's launches and shapes
    over the phase."""
    import hipie_torch.data.datasets as datasets
    import hipie_torch.models.msda_module as msda_module
    import hipie_torch.ops.ms_deform_attn as msda_ops
    import hipie_torch.train.trainer as trainer_module
    from hipie_torch import kernels, native
    from hipie_torch.tools import eval_net, make_tiny_coco, train_net

    config = config or str(Path(__file__).resolve().parent / SMOKE_CONFIG)
    keep = bool(root)
    root = root or tempfile.mkdtemp(prefix="hipie_pipeline_")
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
        if not keep:
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


OV_CALLS = 2
OV_LABEL_SET = "pascal_context_459"


@contextlib.contextmanager
def recording_results(module, name, results):
    """Within the block, each result of ``module.name`` is appended to ``results``."""
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        results.append(out)
        return out

    setattr(module, name, wrapped)
    try:
        yield results
    finally:
        setattr(module, name, inner)


def check_inference_finite(what, res, n_classes=None):
    """Every floating output of an InferenceResult finite; sem_seg over n_classes."""
    for name, t in res._asdict().items():
        if t is not None and t.is_floating_point() and not torch.isfinite(t).all():
            raise AssertionError(f"{what}: non-finite {name}")
    if n_classes is not None and res.sem_seg.shape[0] != n_classes:
        raise AssertionError(f"{what}: sem_seg has {res.sem_seg.shape[0]} channels, expected "
                             f"{n_classes}")


def phase_open_vocab(dev, card, calls: int = OV_CALLS):
    """HIPIEPredictor over HIPIEModel(open_vocab_eval()) at full width (R50,
    BERT-base, 900 + 10 queries, MaskDINO) in bf16 with seeded random weights,
    a CLIPScorer with full ViT-L-14-336 towers (visual 24 x 1024, 16 heads,
    patch 14 at 336; text 12 x 768) in bf16 from a seeded generator, the toy
    tokenizers over Pascal-Context-459's names (all stuff, as its semantic
    evaluation takes them): ``calls`` distinct 480x640
    images padded to the 800x1216 bucket, each a 1536-token prompt encoded in
    chunks. Then eval_net.main with CLIP on over phase 9's fixture. Returns
    K-B's shapes and its launches per call."""
    import hipie_torch.models.clip as clip_module
    import hipie_torch.predictor as predictor_module
    from hipie_torch import kernels
    from hipie_torch.config import apply_overrides
    from hipie_torch.data.datasets_extra import openseg_names_and_things
    from hipie_torch.data.prompts import build_prompt_spec
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.models.postprocess_clip import CLIPScorer
    from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer
    from hipie_torch.models.text.frontend import plan_chunks
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.presets import open_vocab_eval
    from hipie_torch.utils.weights import random_init_

    base = open_vocab_eval()
    # the predictor tokenizes to data.max_text_len; the preset's 1536 tokens
    # are model.text.max_query_len
    cfg = apply_overrides(base, {"data.max_text_len": base.model.text.max_query_len})
    mc = cfg.model
    names, is_thing = openseg_names_and_things(OV_LABEL_SET)
    # the toy vocabulary without the names' words: they split into character
    # pieces, and the label set fills the 1536 tokens (as longer real-vocabulary
    # prompts with synonyms do), so the prompt is truncated and chunked
    tok = WordPieceTokenizer.toy()
    t0 = time.perf_counter()
    with torch.device(dev):
        model = HIPIEModel(mc, sep_token_id=tok.dot_token_id).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(SEED))
    model.to(torch.bfloat16)
    scorer = CLIPScorer(mc.clip, CLIPTokenizer.toy(), dtype=torch.bfloat16,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 10), device=dev)
    pred = HIPIEPredictor(cfg, model, tok, bucket=R50_BUCKET, device=dev, clip_scorer=scorer)
    torch.cuda.synchronize()
    count = lambda m: sum(p.numel() for p in m.parameters())
    log(f"[open-vocab] HIPIEModel(open_vocab_eval) {count(model) / 1e6:.1f} M params, CLIP "
        f"visual {count(scorer.maskclip) / 1e6:.1f} M and text {count(scorer.text) / 1e6:.1f} M, "
        f"bf16, built in {time.perf_counter() - t0:.1f} s")

    t = time.perf_counter()
    spec = build_prompt_spec(names, is_thing, tok, cfg.data.max_text_len)
    spec_ms = 1000.0 * (time.perf_counter() - t)
    plan = plan_chunks(spec.input_ids, spec.attention_mask, tok.dot_token_id)
    n_tokens = int(spec.attention_mask.sum())
    log(f"[open-vocab] {len(names)} classes, prompt {n_tokens} of {cfg.data.max_text_len} "
        f"tokens, {len(plan.src_spans)} chunks of {[b - a for a, b in plan.src_spans]} tokens, "
        f"{cfg.data.max_text_len - plan.tgt_spans[-1][1]} tokens after the last separator; "
        f"the prompt spec (which the predictor builds every call) {spec_ms:.3f} ms on the host")
    if len(plan.src_spans) < 3:
        raise AssertionError(f"open-vocab: the prompt split into {len(plan.src_spans)} chunks, "
                             f"expected at least 3")

    rng = np.random.RandomState(SEED + 3)
    images = [rng.randint(0, 256, R50_IMAGE + (3,)).astype(np.uint8) for _ in range(calls)]
    n_msda = msda_per_call(mc)
    shapes, results, rows = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with timing_msda(shapes), recording_results(predictor_module, "hipie_inference", results), \
            timing_calls(model, "encode_text") as bert_ev, \
            timing_calls(model.detr, "forward") as det_ev, \
            timing_calls(scorer.maskclip, "forward") as clip_ev, \
            timing_calls(scorer.text, "forward") as text_ev, \
            timing_calls(clip_module.CLIPAttention, "forward") as attn_ev:
        for i, img in enumerate(images):
            n_clip, n_text, n_attn = len(clip_ev), len(text_ev), len(attn_ev)
            kernels.reset_launch_counts()
            t = time.perf_counter()
            out = pred(img, test_categories=names, test_is_thing=is_thing)
            torch.cuda.synchronize()
            ms = 1000.0 * (time.perf_counter() - t)
            launches = dict(kernels.LAUNCHES)
            want = predictor_launches(n_msda)
            if launches != want:
                raise AssertionError(f"open-vocab call {i}: kernel launches {launches} != {want}")
            if len(clip_ev) - n_clip != 2:
                raise AssertionError(f"open-vocab call {i}: the CLIP visual tower ran "
                                     f"{len(clip_ev) - n_clip} times, expected 2")
            check_inference_finite(f"open-vocab call {i}", results[-1], len(names))
            if out["sem_seg"].shape != R50_IMAGE or not np.isfinite(out["instances"]["scores"]).all():
                raise AssertionError(f"open-vocab call {i}: malformed output")
            ev = lambda e, a, b: sum(x.elapsed_time(y) for x, y in e[a:b])
            rows.append({"ms": ms, "bert_ms": ev(bert_ev, i, i + 1), "detector_ms": ev(det_ev, i, i + 1),
                         "clip_fg_ms": clip_ev[n_clip][0].elapsed_time(clip_ev[n_clip][1]),
                         "clip_all_ms": clip_ev[n_clip + 1][0].elapsed_time(clip_ev[n_clip + 1][1]),
                         "clip_text_ms": ev(text_ev, n_text, len(text_ev)),
                         "text_calls": len(text_ev) - n_text,
                         "clip_attention_ms": ev(attn_ev, n_attn, len(attn_ev)),
                         "clip_attention_calls": len(attn_ev) - n_attn})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if rows[0]["text_calls"] == 0 or any(r["text_calls"] for r in rows[1:]) \
            or len(scorer._text_cache) != 1:
        raise AssertionError(f"open-vocab: text tower calls per call {[r['text_calls'] for r in rows]}"
                             f", {len(scorer._text_cache)} cached label sets; expected one build")
    for i, r in enumerate(rows):
        log(f"[open-vocab] call {i}: {r['ms']:.3f} ms (host clock, pre- and post-processing "
            f"included); by CUDA events: chunked BERT {r['bert_ms']:.3f}, detector "
            f"{r['detector_ms']:.3f}, MaskCLIP fg pass ({mc.transformer.num_queries} masks) "
            f"{r['clip_fg_ms']:.3f}, all pass ({mc.transformer.num_queries} + "
            f"{mc.maskdino.num_queries} masks) {r['clip_all_ms']:.3f}, CLIP text embedding "
            f"{r['clip_text_ms']:.3f} ({r['text_calls']} text-tower calls); CLIP's attention "
            f"(SDPA with the mask, and its projections) {r['clip_attention_ms']:.3f} over "
            f"{r['clip_attention_calls']} calls")
    log(f"[open-vocab] peak memory {peak:.2f} GiB; K-B {n_msda} launches a call; "
        f"{len(results[-1].scores)} instances; card {card}")

    root = tempfile.mkdtemp(prefix="hipie_openvocab_")
    old_root = os.environ.get("HIPIE_DATASETS")
    try:
        import hipie_torch.data.datasets as datasets
        from hipie_torch.tools import eval_net, make_tiny_coco, train_net

        with contextlib.redirect_stdout(sys.stderr):
            make_tiny_coco.main(["--root", root, "--n-train", "1", "--n-val", "4", "--size",
                                 str(PIPE_SIZE)])
        os.environ["HIPIE_DATASETS"] = root
        datasets._register_builtin()
        config = str(Path(__file__).resolve().parent / SMOKE_CONFIG)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr), timing_msda(shapes):
            results = eval_net.main(["--config-file", config, "--dataset", "coco_panoptic_val",
                                     "--device", str(dev), "model.clip.enabled", "True"])
        eval_s = time.perf_counter() - t0
        eval_launches = kernels.LAUNCHES["ms_deform_attn"]
    finally:
        if old_root is None:
            os.environ.pop("HIPIE_DATASETS", None)
        else:
            os.environ["HIPIE_DATASETS"] = old_root
        shutil.rmtree(root, ignore_errors=True)
    bad = [k for k in PIPE_METRICS if not np.isfinite(results.get(k, float("nan")))]
    if bad or eval_launches != msda_per_call(train_net.build_config(config, "", ()).model) \
            * results["images"]:
        raise AssertionError(f"open-vocab eval_net: metrics {bad} not finite, or K-B launched "
                             f"{eval_launches} times for {results['images']} images")
    log(f"[open-vocab] eval_net coco_panoptic_val with model.clip.enabled ({results['images']} "
        f"images, f32, random CLIP towers, {eval_s:.1f} s): "
        f"{ {k: round(float(results[k]), 4) for k in PIPE_METRICS} }")
    del pred, model, scorer
    return shapes, {"calls": rows, "peak_gib": peak, "kb_per_call": n_msda,
                    "chunks": len(plan.src_spans), "spec_ms": spec_ms}


def swin_attention_library(calls, card) -> dict:
    """Swin's windowed attention over one call's blocks (their recorded
    inputs), the module's plain ops against the library call that computes the
    same function: scaled_dot_product_attention with the relative-position
    bias and the shift mask folded into one additive bf16 mask (built
    beforehand and not timed, as K-A's yardstick's mask), with the qkv and
    output projections on both sides; each summed over the blocks by
    ``cuda_time_ms``, and the largest relative norm error between the two."""
    import torch.nn.functional as F

    plain_ms = sdpa_ms = err = 0.0
    with torch.inference_mode():
        for mod, x, m in calls:
            b, n, c = x.shape
            h = mod.num_heads
            d = c // h
            mask = mod.relative_position_bias_table[mod.relative_position_index].reshape(
                n, n, h).permute(2, 0, 1).float()[None]
            if m is not None:
                mask = (mask + m[:, None]).repeat(b // m.shape[0], 1, 1, 1)
            mask = mask.to(x.dtype).contiguous()

            def sdpa(mod=mod, x=x, mask=mask, b=b, n=n, c=c, h=h, d=d):
                q, k, v = mod.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
                o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                return mod.proj(o.transpose(1, 2).reshape(b, n, c))

            plain = lambda mod=mod, x=x, m=m: mod(x, m)
            err = max(err, rel_norm_err(sdpa(), plain()))
            plain_ms += cuda_time_ms(plain, 5)
            sdpa_ms += cuda_time_ms(sdpa, 5)
    if not err < 2e-2:
        raise AssertionError(f"Swin attention: SDPA with the folded mask is {err} from the "
                             f"plain ops")
    log(f"[backbones] Swin-L windowed attention over {len(calls)} blocks of one call (qkv and "
        f"output projections included, CUDA graphs): plain ops {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention with the bias and shift mask folded into one bf16 mask "
        f"{sdpa_ms:.3f} ms; relative norm error {err:.2e}; card {card}")
    return {"plain_ms": plain_ms, "sdpa_ms": sdpa_ms, "rel_err": err, "blocks": len(calls)}


def phase_backbones(dev, card, calls: int = 2):
    """HIPIEPredictor over swin_large_coco_panoptic() and
    convnext_large_coco_panoptic() at full width in bf16 with seeded random
    weights: ``calls`` panoptic calls each over the 133 COCO labels on distinct
    480x640 images. Returns K-B's shapes and a record per backbone."""
    import re

    import hipie_torch.models.backbone.swin as swin_module
    import hipie_torch.predictor as predictor_module
    from hipie_torch import kernels
    from hipie_torch.data.label_spaces import COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.presets import convnext_large_coco_panoptic, swin_large_coco_panoptic
    from hipie_torch.utils.weights import random_init_

    labels = [n if thing else f"{n}:stuff"
              for n, thing in zip(COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING)]
    words = {w for text in COCO_PANOPTIC_133 for w in re.split(r"[^a-z0-9]+", text) if w}
    tok = WordPieceTokenizer.toy(words=sorted(words))
    rng = np.random.RandomState(SEED + 4)
    shapes, records = [], {}
    for preset in (swin_large_coco_panoptic, convnext_large_coco_panoptic):
        cfg = preset()
        mc = cfg.model
        t0 = time.perf_counter()
        with torch.device(dev):
            model = HIPIEModel(mc).eval()
        random_init_(model, torch.Generator(device=dev).manual_seed(SEED))
        model.to(torch.bfloat16)
        pred = HIPIEPredictor(cfg, model, tok, bucket=R50_BUCKET, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        backbone = model.detr.detr.backbone[0].backbone
        n_backbone = sum(p.numel() for p in backbone.parameters())
        n_params = sum(p.numel() for p in model.parameters())
        n_msda = msda_per_call(mc)
        torch.cuda.reset_peak_memory_stats()
        times, results, attn_inputs = [], [], []
        last_call = lambda: len(times) == calls - 1
        record = lambda mod, x, m=None: attn_inputs.append((mod, x, m)) if last_call() else None
        with timing_msda(shapes), recording_results(predictor_module, "hipie_inference", results), \
                timing_calls(backbone, "forward") as bb_ev, \
                timing_calls(swin_module.SwinAttention, "forward", record) as attn_ev:
            for i in range(calls):
                img = rng.randint(0, 256, R50_IMAGE + (3,)).astype(np.uint8)
                kernels.reset_launch_counts()
                t = time.perf_counter()
                res = pred(img, test_categories=labels)
                torch.cuda.synchronize()
                times.append(1000.0 * (time.perf_counter() - t))
                launches = dict(kernels.LAUNCHES)
                want = predictor_launches(n_msda)
                if launches != want:
                    raise AssertionError(f"{mc.backbone.name} call {i}: kernel launches "
                                         f"{launches} != {want}")
                check_inference_finite(f"{mc.backbone.name} call {i}", results[-1], N_CLASSES)
                _check_prediction(res, "detection")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bb_ms = [a.elapsed_time(b) for a, b in bb_ev]
        per_call = len(attn_ev) // calls
        attn_ms = [sum(a.elapsed_time(b) for a, b in attn_ev[i * per_call:(i + 1) * per_call])
                   for i in range(calls)]
        log(f"[backbones] {preset.__name__}: backbone {n_backbone / 1e6:.1f} M of "
            f"{n_params / 1e6:.1f} M params, bf16, built in {build_s:.1f} s; ms per call {[round(t, 3) for t in times]} (host clock, the first "
            f"includes warm-up), backbone ms by CUDA events {[round(t, 3) for t in bb_ms]}"
            + (f" (windowed attention, plain torch ops with the qkv and output projections, "
               f"{[round(t, 3) for t in attn_ms]} over {per_call} blocks a call)"
               if attn_ev else "")
            + f"; "
            f"peak memory {peak:.2f} GiB; K-B {n_msda} launches a call; card {card}")
        records[mc.backbone.name] = {"ms": times, "backbone_ms": bb_ms, "peak_gib": peak,
                                     "backbone_params": n_backbone, "kb_per_call": n_msda,
                                     "attention_ms": attn_ms}
        if attn_inputs:
            records[mc.backbone.name]["attention_library"] = swin_attention_library(
                attn_inputs, card)
            del attn_inputs[:]
        del pred, model
        torch.cuda.empty_cache()
    return shapes, records


BRANCH_CALLS = 2
BRANCH_TRAIN_STEPS = 3
# each option of the branches phase, and its predictor calls
BRANCH_VARIANTS = (
    ("bg_lang", {"model.bg_query_from_lang": True}, BRANCH_CALLS),
    ("own_encoder", {"model.maskdino.shared_encoder": False}, BRANCH_CALLS),
    ("extra_bert", {"model.transformer.use_extra_bert_layers": True}, 1),
    ("lang_content", {"model.transformer.decouple_tgt": False}, 1),
)
# the branch train step: language-derived bg queries with their criterion pass
# (at the default bg weight of 0 both packages skip it) and MaskDINO's own encoder
BRANCH_TRAIN = {"model.bg_query_from_lang": True, "model.loss.final_bg_weight": 1.0,
                "model.maskdino.shared_encoder": False}


def phase_branches(dev, card, img: int = IMG, slots: int = TRAIN_N):
    """The model's option branches at full width in bf16 with seeded random
    weights: HIPIEPredictor over r50_coco_panoptic() with each of
    BRANCH_VARIANTS, panoptic calls over the 133 COCO labels on distinct
    480x640 images (K-B exact, finite and shaped results; with bg_lang the
    decoder runs the 53 stuff labels' queries in front; the own encoder
    launches K-B 6 more times a call, at the encoder shape), then
    BRANCH_TRAIN_STEPS training steps of r50_coco_panoptic() with BRANCH_TRAIN
    through phase_train (32 bg_lang slots, K-B and K-D exact a step, its named
    ranges timed; ``img`` and ``slots`` as phase_train takes them). Returns (K-B
    shapes, K-D shapes, records)."""
    import re

    import hipie_torch.predictor as predictor_module
    from hipie_torch import kernels
    from hipie_torch.config import apply_overrides
    from hipie_torch.data.label_spaces import COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.presets import r50_coco_panoptic
    from hipie_torch.utils.weights import random_init_

    labels = [n if thing else f"{n}:stuff"
              for n, thing in zip(COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING)]
    if sum(not t for t in COCO_PANOPTIC_IS_THING) != N_STUFF:
        raise AssertionError("COCO panoptic's stuff count changed")
    words = {w for text in COCO_PANOPTIC_133 for w in re.split(r"[^a-z0-9]+", text) if w}
    tok = WordPieceTokenizer.toy(words=sorted(words))
    rng = np.random.RandomState(SEED + 5)
    kb_shapes, records = [], {}
    for name, overrides, calls in BRANCH_VARIANTS:
        cfg = apply_overrides(r50_coco_panoptic(), overrides)
        mc = cfg.model
        with torch.device(dev):
            model = HIPIEModel(mc).eval()
        random_init_(model, torch.Generator(device=dev).manual_seed(SEED))
        model.to(torch.bfloat16)
        pred = HIPIEPredictor(cfg, model, tok, bucket=R50_BUCKET, device=dev)
        n_msda = msda_per_call(mc)
        dec_q = (mc.transformer.num_queries + mc.transformer.num_bg_queries
                 + (N_STUFF if mc.bg_query_from_lang else 0))
        torch.cuda.reset_peak_memory_stats()
        times, results, shapes = [], [], []
        with timing_msda(shapes), recording_results(predictor_module, "hipie_inference", results):
            for i in range(calls):
                image = rng.randint(0, 256, R50_IMAGE + (3,)).astype(np.uint8)
                kernels.reset_launch_counts()
                before = len(shapes)
                t = time.perf_counter()
                res = pred(image, test_categories=labels)
                torch.cuda.synchronize()
                times.append(1000.0 * (time.perf_counter() - t))
                launches = dict(kernels.LAUNCHES)
                want = predictor_launches(n_msda)
                if launches != want:
                    raise AssertionError(f"branches {name} call {i}: kernel launches {launches} "
                                         f"!= {want}")
                qs = Counter(s[2] for s in shapes[before:])
                want_q = Counter({R50_S: mc.transformer.num_encoder_layers
                                  + (0 if mc.maskdino.shared_encoder else mc.maskdino.enc_layers),
                                  dec_q: mc.transformer.num_decoder_layers,
                                  mc.maskdino.num_queries: mc.maskdino.dec_layers})
                if qs != want_q:
                    raise AssertionError(f"branches {name} call {i}: K-B's queries {dict(qs)}, "
                                         f"expected {dict(want_q)}")
                check_inference_finite(f"branches {name} call {i}", results[-1], N_CLASSES)
                _check_prediction(res, "detection")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kb_shapes += shapes
        log(f"[branches] {name} ({overrides}): ms per call {[round(t, 3) for t in times]} (host "
            f"clock, the first includes warm-up); K-B {n_msda} launches a call, decoder Q "
            f"{dec_q}; peak memory {peak:.2f} GiB; card {card}")
        records[name] = {"ms": times, "kb_per_call": n_msda, "peak_gib": peak}
        del pred, model
        torch.cuda.empty_cache()

    cfg = apply_overrides(r50_coco_panoptic(), BRANCH_TRAIN)
    if cfg.model.transformer.num_bg_lang_queries != BG_LANG_SLOTS:
        raise AssertionError("the preset's bg_lang slot count changed")
    mc = cfg.model
    train, _, train_kb, train_kd, _ = phase_train(dev, card, cfg=cfg, img=img, slots=slots,
                                                  steps=BRANCH_TRAIN_STEPS, ranges=True)
    # K-B's queries over the steps: both encoders at Q = S, the decoder after the
    # CDN pad and the bg_lang slots, MaskDINO after its seg-DN pad
    dec_q = (2 * max(mc.dn.dn_number, slots) + BG_LANG_SLOTS + mc.transformer.num_bg_queries
             + mc.transformer.num_queries)
    md_q = 2 * max(mc.maskdino.dn_queries, slots) + mc.maskdino.num_queries
    got_q = Counter(s[2] for s in train_kb if s[2] != sum(h * w for h, w in s[0]))
    n_enc = len(train_kb) - sum(got_q.values())
    want_q = Counter({dec_q: mc.transformer.num_decoder_layers * BRANCH_TRAIN_STEPS,
                      md_q: mc.maskdino.dec_layers * BRANCH_TRAIN_STEPS})
    n_enc_layers = mc.transformer.num_encoder_layers + (
        0 if mc.maskdino.shared_encoder else mc.maskdino.enc_layers)
    if got_q != want_q or n_enc != BRANCH_TRAIN_STEPS * n_enc_layers:
        raise AssertionError(f"branch train step: K-B's queries {dict(got_q)} and {n_enc} at "
                             f"Q = S, expected {dict(want_q)}")
    bgl_ms = [r.get("crit_bg_lang", 0.0) for r in train["range_ms"]]
    if not all(bgl_ms):
        raise AssertionError(f"branch train step: the crit_bg_lang range did not run: {bgl_ms}")
    train["crit_bg_lang_ms"] = bgl_ms
    log(f"[branches] train step ({BRANCH_TRAIN}): ms per step "
        f"{[round(t, 1) for t in train['ms_per_step']]} (each ends in a synchronize), peak "
        f"memory {train['peak_gib']:.4f} GiB, K-B and K-D a step {train['per_step']}; device ms "
        f"between the named ranges' ends by CUDA events, per step: "
        f"{[{k: round(v, 2) for k, v in r.items()} for r in train['range_ms']]}; card {card}")
    records["train"] = train
    torch.cuda.empty_cache()
    return kb_shapes + train_kb, train_kd, records


PAR_STEPS = 2
# 13a: the plain step three times (its run-to-run spread), then under NCCL
PAR_VITH_RUNS = ("plain", "plain_again", "plain_third", "nccl")
# 13b (i): one f32 step of 2 ranks x 1 image against one process with both, on
# the same weights, keys, point picks and matches: each loss term's mean over
# the ranks within PAR_TERM_RTOL of one process's (relative), the reduced
# gradients' median relative norm error within PAR_GRAD_MEDIAN_RTOL and each
# one's within PAR_GRAD_RTOL. A batch of one and of two round apart in the
# last bits, and the step amplifies round-off where it is not smooth:
# bilinear sampling's location derivative jumps at every pixel edge, so a
# sample near one takes either cell's derivative (the MSDA sampling offsets,
# and what feeds the reference points, take the largest errors). A wrong
# normaliser or reduction moves every gradient. A gradient under 1e-5 of the
# largest carries round-off alone (a bias before a normalisation) and is
# measured against the largest instead.
PAR_TERM_RTOL = 1e-4
PAR_GRAD_MEDIAN_RTOL = 1e-4
PAR_GRAD_RTOL = 1e-2


def _cpu_snapshot(model) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def _restart(state, cfg, snapshot):
    """``state`` back at ``snapshot``'s weights with a fresh optimizer, step 0."""
    from hipie_torch.train.optimizer import GroupedAdamW

    state.model.load_state_dict(snapshot)
    state.model.zero_grad(set_to_none=True)
    state.optimizer = GroupedAdamW(cfg.solver, state.model)
    state.step = 0
    return state


def layer_major_rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a matcher's output over (layers x the global batch),
    layer-major, at one image a rank."""
    from hipie_torch.parallel.mesh import data_rank, data_size

    return x.reshape((-1, data_size()) + x.shape[1:])[:, data_rank()]


@contextlib.contextmanager
def recording_step(state, picks=None, matches=None, ref_grads=None):
    """Within the block each training step's weighted loss dicts (floats) go
    to ``rec["terms"]``, the gradients the optimizer gets (on the device) to
    ``rec["grads"]`` (with ``ref_grads``, a list a step, only each gradient's
    relative error against them, to ``rec["grad_errs"]``) and every assignment
    the criterion's losses gather by to ``rec["assign"]`` (on the host). The
    mask losses' point picks go to ``rec["picks"]`` and the matchers' outputs
    (simOTA, the auction, the encoder's Hungarian match) to ``rec["matches"]``,
    or, with ``picks`` and ``matches`` (a one-process run's, one image a rank),
    are replayed: each rank's rows of them. Both choose among near-ties (the
    most uncertain points by a top-k, the auction's bids) of values that a
    batch of one and of two round differently; the real pick still runs, so
    that the keys advance as recorded."""
    import hipie_torch.losses.criterion as criterion
    import hipie_torch.train.step as step_module
    from hipie_torch.parallel.mesh import shard_rows

    rec = {"terms": [], "grads": [], "grad_errs": [], "assign": [], "picks": [],
           "matches": []}
    named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    patched = ("uncertain_point_coords", "simota_match", "auction_assignment",
               "hungarian_vl_match", "gather_targets")
    saved = {name: getattr(criterion, name) for name in patched}
    saved_weights, saved_step = step_module.apply_weight_dict, state.optimizer.step
    picks = None if picks is None else list(picks)
    matches = None if matches is None else list(matches)

    def weights(losses, lc):
        rec["terms"].append({k: float(v) for k, v in losses.items()})
        return saved_weights(losses, lc)

    def gather(t, assign):
        rec["assign"].append(assign.detach().cpu())
        return saved["gather_targets"](t, assign)

    def pick(*a, **k):
        got = saved["uncertain_point_coords"](*a, **k)
        if picks is None:
            rec["picks"].append(got.cpu())
            return got
        return shard_rows(picks.pop(0).to(got.device))

    def matcher(name):
        def match(*a, **k):
            if matches is not None:
                return layer_major_rank_rows(matches.pop(0)).to(a[0].device)
            got = saved[name](*a, **k)
            rec["matches"].append(got.cpu())
            return got
        return match

    def optimizer_step():
        grads = {n: p.grad for n, p in named}
        if ref_grads is None:
            rec["grads"].append({n: None if g is None else g.detach().clone()
                                 for n, g in grads.items()})
        else:
            rec["grad_errs"].append(grad_rel_errors(grads, ref_grads[len(rec["grad_errs"])]))
        return saved_step()

    step_module.apply_weight_dict, state.optimizer.step = weights, optimizer_step
    criterion.gather_targets, criterion.uncertain_point_coords = gather, pick
    for name in patched[1:4]:
        setattr(criterion, name, matcher(name))
    try:
        yield rec
    finally:
        step_module.apply_weight_dict = saved_weights
        for name, fn in saved.items():
            setattr(criterion, name, fn)
        del state.optimizer.step


def grad_rel_errors(got: dict, want: dict) -> dict:
    """Each gradient's relative norm error against ``want``'s (on the device);
    a tensor under 1e-5 of the largest reference norm relative to the largest."""
    largest = max(float(w.float().norm()) for w in want.values() if w is not None)
    out = {}
    for name, w in want.items():
        g = got[name]
        if (g is None) != (w is None):
            raise AssertionError(f"parallel: {name} has a gradient on one side only")
        if w is None:
            continue
        w = w.to(g.device).float()
        norm = float(w.norm())
        out[name] = float((g.float() - w).norm()) / (norm if norm >= 1e-5 * largest else largest)
    return out


def term_rel_errors(got: list, want: list) -> dict:
    """Each loss term's relative error, over a step's weighted dicts."""
    out = {}
    for i, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            raise AssertionError(f"parallel: loss dict {i} has terms {sorted(set(g) ^ set(w))} "
                                 f"on one side only")
        out.update({f"{i}.{k}": abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for k in w
                    if k.startswith("loss")})
    return out


def phase_parallel_vith(dev, card):
    """13a: vit_huge_coco_panoptic() at full width and depth, bf16, PAR_STEPS
    steps on phase 8's batches through the data-parallel step under NCCL at
    world size 1, against the plain step from the same state and keys, run
    three times (the step is not bitwise repeatable: K-D's and grid_sample's
    backward add with atomics). The distributed step's largest loss-term and
    gradient differences from the first plain run must stay within twice the
    largest of the other two plain runs' at the first step (the second's are
    reported); each kernel's launches a step exact."""
    import hipie_torch.models.msda_module as msda_module
    import hipie_torch.ops.ms_deform_attn as msda_ops
    import hipie_torch.ops.vit_attention as vit_ops
    import hipie_torch.train.step as step_module
    from hipie_torch import kernels
    from hipie_torch.parallel import mesh
    from hipie_torch.presets import vit_huge_coco_panoptic
    from hipie_torch.train.profile import _PhaseTimer
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.synthetic import train_batches
    from hipie_torch.utils.rng import GeneratorKeys

    cfg = dataclasses.replace(vit_huge_coco_panoptic(),
                              output_dir=tempfile.mkdtemp(prefix="hipie_par_"))
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=SEED, device=dev)
    snapshot = _cpu_snapshot(state.model)
    want = train_launches(cfg, state.model)
    batches = train_batches(cfg, PAR_STEPS, SEED, img=IMG, slots=TRAIN_N, batch=TRAIN_B)
    log(f"[parallel] 13a: ViT-H training state built and copied to the host in "
        f"{time.perf_counter() - t0:.1f} s")
    ref, errs, out = None, {}, {}
    ka_shapes, kb_shapes, kd_shapes, ke_shapes = [], [], [], []
    for run in PAR_VITH_RUNS:
        if run == "nccl":
            mesh.init_distributed("nccl", mesh.local_url(), rank=0, world_size=1)
        try:
            _restart(state, cfg, snapshot)
            step = make_train_step(cfg, state, device=dev)
            keys = GeneratorKeys(torch.Generator(device=dev).manual_seed(SEED))
            timer = _PhaseTimer() if run == "nccl" else None
            scope_fn = step_module.scope
            torch.cuda.reset_peak_memory_stats()
            # the first run's gradients, held for the comparison, are not the step's
            held = 0 if ref is None else sum(g.numel() * g.element_size() for step_grads in
                                             ref["grads"] for g in step_grads.values()
                                             if g is not None)
            per_step = []
            with recording_step(state, ref_grads=ref and ref["grads"]) as rec, \
                    timing_vit_kernel(ka_shapes), \
                    timing_calls(msda_module, "ms_deform_attn",
                                 lambda *a, **k: kb_shapes.append(msda_shape(*a, **k)),
                                 timed=False), \
                    timing_calls(msda_ops, "ms_deform_attn_backward",
                                 lambda *a: kd_shapes.append(msda_shape(*a[:4])), timed=False), \
                    timing_calls(vit_ops, "vit_attention_backward",
                                 lambda *a: ke_shapes.append(vit_shape(a[0], a[3], a[4])),
                                 timed=False):
                if timer is not None:
                    step_module.scope = timer
                try:
                    for batch in batches:
                        kernels.reset_launch_counts()
                        mesh.COLLECTIVES.clear()
                        t = time.perf_counter()
                        step(state, batch, keys)
                        torch.cuda.synchronize()
                        per_step.append({"ms": 1e3 * (time.perf_counter() - t),
                                         "launches": dict(kernels.LAUNCHES),
                                         "collectives": sum(mesh.COLLECTIVES.values()),
                                         "ranges": timer.take() if timer else {}})
                finally:
                    step_module.scope = scope_fn
        finally:
            mesh.shutdown_distributed()
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        for i, s in enumerate(per_step):
            if s["launches"] != want:
                raise AssertionError(f"parallel 13a ({run}): step {i} launched {s['launches']}, "
                                     f"expected {want}")
        if ref is None:
            ref = rec
        else:
            terms = [term_rel_errors(rec["terms"][2 * i:2 * i + 2], ref["terms"][2 * i:2 * i + 2])
                     for i in range(PAR_STEPS)]
            top = lambda d: [(k, float(f"{v:.3e}")) for k, v in
                             sorted(d.items(), key=lambda kv: -kv[1])[:2]]
            errs[run] = {"terms": [max(t.values()) for t in terms],
                         "grads": [max(g.values()) for g in rec["grad_errs"]],
                         "top_terms": [top(t) for t in terms],
                         "top_grads": [top(g) for g in rec["grad_errs"]]}
        out[run] = {"per_step": per_step, "peak_gib": peak}
        log(f"[parallel] 13a {run}: ms per step {[round(s['ms'], 1) for s in per_step]}, "
            f"collectives a step {[s['collectives'] for s in per_step]}, allreduce device ms "
            f"{[round(s['ranges'].get('allreduce', 0.0), 3) for s in per_step]}, launches a step "
            f"{per_step[-1]['launches']}, peak memory {peak:.2f} GiB"
            + (" (with the run's first-step gradients kept)" if run == "plain" else "")
            + (f"; largest relative difference from the first plain run, a step: loss terms "
               f"{[f'{e:.3e}' for e in errs[run]['terms']]} (largest {errs[run]['top_terms']}), "
               f"gradients {[f'{e:.3e}' for e in errs[run]['grads']]} (largest "
               f"{errs[run]['top_grads']})" if run in errs else ""))
    # held at the first step: from the second on, the runs start from states
    # that the first step's atomics left apart, and discrete choices (the
    # two-stage top-k, the matchers) flip between them
    plain = [errs[r] for r in PAR_VITH_RUNS[1:-1]]
    bound_terms = 2 * max(e["terms"][0] for e in plain)
    bound_grads = 2 * max(e["grads"][0] for e in plain)
    nccl_terms, nccl_grads = errs["nccl"]["terms"][0], errs["nccl"]["grads"][0]
    if nccl_terms > bound_terms or nccl_grads > bound_grads:
        raise AssertionError(f"parallel 13a: at the first step the NCCL run differs from the "
                             f"first plain one by {nccl_terms} (loss terms) and {nccl_grads} "
                             f"(gradients), over twice the other plain runs' own {plain}")
    nccl = out["nccl"]["per_step"]
    log(f"[parallel] 13a: ViT-H step under NCCL at world size 1 within twice the plain step's "
        f"run-to-run difference at the first step (loss terms {nccl_terms:.3e} <= "
        f"{bound_terms:.3e}, gradients {nccl_grads:.3e} <= {bound_grads:.3e}); ms per step "
        f"{[round(s['ms'], 1) for s in nccl]}, allreduce {[round(s['ranges']['allreduce'], 3) for s in nccl]} "
        f"device ms, {nccl[-1]['collectives']} collectives a step, peak "
        f"{out['nccl']['peak_gib']:.2f} GiB; card {card}")
    del state, snapshot, ref
    torch.cuda.empty_cache()
    return ({"errors": errs, "runs": out, "launches_per_step": want},
            ka_shapes, kb_shapes, kd_shapes, ke_shapes)


def pair_batches(cfg, n: int = PAR_STEPS):
    """Phase 7's synthetic batches of 2 with the second image's GTs all stuff
    in the first: the two images' GT counts differ and one holds no thing."""
    from hipie_torch.train.synthetic import train_batches

    batches = train_batches(cfg, n, SEED, img=IMG, slots=TRAIN_N, batch=TRAIN_B)
    t = batches[0].targets
    batches[0] = batches[0]._replace(targets=t._replace(
        is_thing=torch.stack([t.is_thing[0], torch.zeros_like(t.is_thing[1])])))
    counts = batches[0].targets.valid.sum(-1).tolist()
    if counts[0] == counts[1] or not batches[0].targets.is_thing[0].any():
        raise AssertionError(f"parallel 13b: the batch's GT counts {counts} must differ and "
                             f"image 0 must hold things")
    return batches


def rank_batch(batch, rank: int):
    from hipie_torch.losses.criterion import Targets
    from hipie_torch.train.step import TrainBatch

    take = lambda x: x[rank:rank + 1].contiguous()
    return TrainBatch(*(take(x) for x in batch[:5]), Targets(*(take(x) for x in batch.targets)))


class GtPredictor:
    """A predictor that answers from each image's ground truth, imperfectly, so
    that the sharded evaluation's metrics lie strictly between 0 and 100:
    image k's instances are its GT segments shifted k + 1 pixels right at
    seeded scores plus 3k spurious ones (the images' detection counts
    differ), its panoptic map the GT's shifted alike, without its first
    segment on odd k, its semantic map the GT's with a band relabelled
    (``exact``: the GT's as it is). A record without a panoptic GT (a
    semantic-segmentation dataset's) gets the semantic map alone. Images are
    told apart by their bytes."""

    def __init__(self, records, exact: bool = False):
        self.digest = lambda img: hashlib.sha1(np.ascontiguousarray(img).tobytes()).hexdigest()
        self.records = {self.digest(r["image"]): (k, r) for k, r in enumerate(records)}
        self.exact = exact

    def __call__(self, img, task="detection", test_categories=None, test_is_thing=None,
                 score_thresh=0.0):
        k, rec = self.records[self.digest(img)]
        sem = np.where(rec["sem_seg_gt"] == 255, 0, rec["sem_seg_gt"])
        if not self.exact:
            sem[:, :8 * (k + 1)] = (sem[:, :8 * (k + 1)] + 1) % len(rec["class_names"])
        if "pan_seg_gt" not in rec:
            return {"sem_seg": sem}
        r = np.random.RandomState(k)
        h, w = img.shape[:2]
        shift = lambda m: np.roll(m, k + 1, axis=1)
        masks = [shift(a["segmentation"] > 0) for a in rec["annotations"]]
        classes = [a["category_id"] for a in rec["annotations"]]
        for _ in range(3 * k):
            m = np.zeros((h, w), bool)
            y, x = r.randint(0, h - 16), r.randint(0, w - 16)
            m[y:y + r.randint(4, 16), x:x + r.randint(4, 16)] = True
            masks.append(m)
            classes.append(classes[r.randint(len(classes))])
        boxes = [[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                 for ys, xs in (np.nonzero(m) for m in masks)]
        pan, segs = shift(rec["pan_seg_gt"]), list(rec["pan_segments"])
        if k % 2:
            pan = np.where(pan == segs[0]["id"], 0, pan)
            segs = segs[1:]
        return {"instances": {"boxes": np.array(boxes, np.float64), "masks": np.stack(masks),
                              "scores": r.uniform(0.05, 1.0, len(masks)),
                              "classes": np.array(classes)},
                "panoptic_seg": (pan, segs), "sem_seg": sem}


GT_EVAL_KEYS = ("bbox/AP", "segm/AP", "panoptic/PQ", "sem_seg/mIoU")


def gt_eval(pipe_data: str) -> dict:
    """evaluate_detection_dataset with GtPredictor over phase 9's fixture val
    split (box and mask AP, PQ, mIoU); each rank predicts its share."""
    import hipie_torch.data.datasets as datasets
    from hipie_torch.evaluation.evaluator import evaluate_detection_dataset

    old_root = os.environ.get("HIPIE_DATASETS")
    os.environ["HIPIE_DATASETS"] = pipe_data
    try:
        datasets._register_builtin()
        records = [datasets.materialize_record(r)
                   for r in datasets.get_dataset("coco_panoptic_val")]
    finally:
        if old_root is None:
            os.environ.pop("HIPIE_DATASETS", None)
        else:
            os.environ["HIPIE_DATASETS"] = old_root
        datasets._register_builtin()
    pred = GtPredictor(records)
    out = evaluate_detection_dataset(pred, records, len(records[0]["class_names"]),
                                     records[0]["class_is_thing"],
                                     tasks=("bbox", "segm", "panoptic", "sem_seg"))
    out.pop("sec_per_image")
    out["detections"] = [len(pred(r["image"])["instances"]["scores"]) for r in records]
    return out


def _pair_rank(rank: int, work: str, pipe_config: str, pipe_ckpt: str, pipe_data: str):
    """One of 13b's two gloo ranks on cuda:0; writes its record to ``work``."""
    import hipie_torch.models.msda_module as msda_module
    import hipie_torch.ops.ms_deform_attn as msda_ops
    from hipie_torch import kernels
    from hipie_torch.config import apply_overrides
    from hipie_torch.parallel import mesh
    from hipie_torch.parallel.dryrun import state_digest, tensor_digest
    from hipie_torch.presets import r50_coco_panoptic
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.trainer import Trainer
    from hipie_torch.utils.rng import GeneratorKeys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.init_distributed("gloo", f"file://{work}/rendezvous", rank=rank, world_size=2,
                                device=torch.device("cuda", 0))
    out = {"rank": rank, "kb_shapes": [], "kd_shapes": []}
    try:
        with timing_calls(msda_module, "ms_deform_attn",
                          lambda *a, **k: out["kb_shapes"].append(msda_shape(*a, **k)),
                          timed=False), \
                timing_calls(msda_ops, "ms_deform_attn_backward",
                             lambda *a: out["kd_shapes"].append(msda_shape(*a[:4])), timed=False):
            # (i) one f32 step against the one-process step: with the ranks'
            # own matching, then with the one-process run's matches replayed
            one = torch.load(os.path.join(work, "one.pt"), weights_only=False)
            want = torch.load(os.path.join(work, "grads.pt"), weights_only=True)
            weights = torch.load(os.path.join(work, "weights.pt"), weights_only=True)
            cfg = apply_overrides(r50_coco_panoptic(), {"model.dtype": "float32"})
            state = create_train_state(cfg, seed=SEED, device=dev)
            batch = rank_batch(pair_batches(cfg)[0], rank)
            step = make_train_step(cfg, state, device=dev)
            torch.cuda.reset_peak_memory_stats()
            for run, matches in (("own", None), ("replayed", one["matches"])):
                _restart(state, cfg, weights)
                with recording_step(state, one["picks"], matches, ref_grads=[want]) as rec:
                    step(state, batch, GeneratorKeys(torch.Generator(device=dev).manual_seed(SEED)))
                torch.cuda.synchronize()
                out[run] = {"terms": rec["terms"], "grad_errs": rec["grad_errs"][0],
                            "assign_mismatch": sum(int(not torch.equal(g, w[rank:rank + 1]))
                                                   for g, w in zip(rec["assign"], one["assign"])),
                            "n_assign": (len(rec["assign"]), len(one["assign"]))}
            out["f32_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            out["grad_digest"] = tensor_digest(p.grad for p in state.optimizer.params
                                               if p.grad is not None)
            del state, step, rec, want, weights
            torch.cuda.empty_cache()

            # (ii) two bf16 steps through the Trainer: ranks bit-identical after each
            cfg = dataclasses.replace(r50_coco_panoptic(), output_dir=os.path.join(
                work, f"run{rank}"))
            state = create_train_state(cfg, seed=SEED, device=dev)
            inner = make_train_step(cfg, state, device=dev)
            digests, per_step = [], []

            def train_step(st, batch, keys):
                kernels.reset_launch_counts()
                mesh.COLLECTIVES.clear()
                t = time.perf_counter()
                st, metrics = inner(st, batch, keys)
                torch.cuda.synchronize()
                per_step.append({"ms": 1e3 * (time.perf_counter() - t),
                                 "launches": dict(kernels.LAUNCHES),
                                 "collectives": sum(mesh.COLLECTIVES.values())})
                digests.append(state_digest(st))
                return st, metrics

            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(cfg, state, train_step,
                              iter([rank_batch(b, rank) for b in pair_batches(cfg)]),
                              log_period=1, device=dev, checkpoints=False)
            trainer.train(max_iter=PAR_STEPS)
            out.update(digests=digests, per_step=per_step,
                       bf16_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       total_loss=[h["total_loss"] for h in trainer.history])
            del state, inner, trainer
            torch.cuda.empty_cache()

            # (iii) sharded evaluation of phase 9's checkpoint on its fixture
            from hipie_torch.tools import eval_net

            os.environ["HIPIE_DATASETS"] = pipe_data
            import hipie_torch.data.datasets as datasets

            datasets._register_builtin()
            with contextlib.redirect_stdout(sys.stderr):
                out["eval"] = eval_net.evaluate(eval_net.parse_args([
                    "--config-file", pipe_config, "--dataset", "coco_panoptic_val",
                    "--weights", pipe_ckpt, "--device", "cuda:0"]), dev)
            out["eval_gt"] = gt_eval(pipe_data)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        mesh.shutdown_distributed()


def phase_parallel_pair(dev, card, pipe_root: str, pipe_eval: dict):
    """13b: r50_coco_panoptic() at full width on two gloo ranks on the one card
    (NCCL refuses two ranks on one device), each with one image of phase 7's
    batch of 2 (GT counts differ, one image all stuff): (i) one f32 step (TF32
    off) against the one-process batch-2 step from the same weights and keys:
    with the one-process run's point picks and matches replayed (they choose
    among near-ties, which a batch of one and of two round apart), each loss
    term's mean over the ranks within PAR_TERM_RTOL, the reduced gradients'
    median relative error within PAR_GRAD_MEDIAN_RTOL and each's within
    PAR_GRAD_RTOL; the ranks' own matching, a second one-process run and one
    from weights nudged by one ulp (the step's own sensitivity: its discrete
    choices flip) are reported beside it; (ii) two bf16 steps through the Trainer, ranks
    bit-identical after each and K-B and K-D 21 a step a rank; (iii)
    evaluate_detection_dataset sharded over phase 9's fixture val split with
    phase 9's checkpoint, every metric equal to phase 9's eval_net numbers
    (all 0 after its few steps), and with GtPredictor, every metric strictly
    between 0 and 100 and equal to one process's.
    Returns the record and K-B's and K-D's shapes."""
    import torch.multiprocessing as mp

    import hipie_torch.models.msda_module as msda_module
    import hipie_torch.ops.ms_deform_attn as msda_ops
    from hipie_torch.config import apply_overrides
    from hipie_torch.presets import r50_coco_panoptic
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.utils.rng import GeneratorKeys

    work = tempfile.mkdtemp(prefix="hipie_pair_")
    kb_shapes, kd_shapes = [], []
    try:
        cfg = apply_overrides(r50_coco_panoptic(), {"model.dtype": "float32"})
        state = create_train_state(cfg, seed=SEED, device=dev)
        weights = _cpu_snapshot(state.model)
        torch.save(weights, os.path.join(work, "weights.pt"))
        batch = pair_batches(cfg)[0]
        step = make_train_step(cfg, state, device=dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording_step(state) as rec, \
                timing_calls(msda_module, "ms_deform_attn",
                             lambda *a, **k: kb_shapes.append(msda_shape(*a, **k)), timed=False), \
                timing_calls(msda_ops, "ms_deform_attn_backward",
                             lambda *a: kd_shapes.append(msda_shape(*a[:4])), timed=False):
            step(state, batch, GeneratorKeys(torch.Generator(device=dev).manual_seed(SEED)))
        torch.cuda.synchronize()
        one_ms, one_peak = 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated()
        # the one-process step again, from the same weights (then from the
        # weights nudged by one ulp), keys, picks and matches
        controls = {}
        nudged = {k: torch.nextafter(v, torch.full_like(v, float("inf")))
                  if v.is_floating_point() else v for k, v in weights.items()}
        for name, start in (("one-process again", weights),
                            ("one-process, weights nudged by one ulp", nudged)):
            _restart(state, cfg, start)
            with recording_step(state, rec["picks"], rec["matches"],
                                ref_grads=rec["grads"]) as again:
                step(state, batch, GeneratorKeys(torch.Generator(device=dev).manual_seed(SEED)))
            torch.cuda.synchronize()
            controls[name] = (again["terms"], again["grad_errs"][0])
        del nudged
        torch.save({k: (None if v is None else v.cpu()) for k, v in rec["grads"][0].items()},
                   os.path.join(work, "grads.pt"))
        torch.save({k: rec[k] for k in ("picks", "matches", "assign")},
                   os.path.join(work, "one.pt"))
        one_terms = rec["terms"]
        del state, step, rec, weights
        torch.cuda.empty_cache()
        one_gt_eval = gt_eval(os.path.join(pipe_root, "data"))
        t0 = time.perf_counter()
        mp.start_processes(_pair_rank, args=(work, str(Path(__file__).resolve().parent /
                                                       SMOKE_CONFIG),
                                             os.path.join(pipe_root, "run",
                                                          f"model_{PIPE_STEPS:07d}.pth"),
                                             os.path.join(pipe_root, "data")),
                           nprocs=2, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def summary(terms, grads):
        top = lambda d: [(k, float(f"{v:.3e}")) for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:3]]
        return {"term": max(terms.values()), "grad": max(grads.values()),
                "grad_median": float(np.median(list(grads.values()))),
                "grads_over_1e-4": sum(v > 1e-4 for v in grads.values()), "n_grads": len(grads),
                "top_terms": top(terms), "top_grads": top(grads)}

    runs = {name: summary(term_rel_errors(terms, one_terms), grads)
            for name, (terms, grads) in controls.items()}
    for run in ("own", "replayed"):
        mean = [{k: float(np.mean([r[run]["terms"][i][k] for r in ranks]))
                 for k in ranks[0][run]["terms"][i]} for i in range(len(one_terms))]
        runs[f"2 ranks, {run} matches"] = {
            **summary(term_rel_errors(mean, one_terms), ranks[0][run]["grad_errs"]),
            "assignments differing": [r[run]["assign_mismatch"] for r in ranks],
            "of": ranks[0][run]["n_assign"]}
    for name, r in runs.items():
        log(f"[parallel] 13b (i) {name}: largest relative error of a loss term {r['term']:.3e}, "
            f"of a gradient {r['grad']:.3e} (median {r['grad_median']:.3e}, "
            f"{r['grads_over_1e-4']} of {r['n_grads']} over 1e-4); largest {r['top_terms']} "
            f"{r['top_grads']}"
            + (f"; assignments differing from one process's {r['assignments differing']} of "
               f"{r['of']}" if "of" in r else ""))
    held = runs["2 ranks, replayed matches"]
    log(f"[parallel] 13b (i): one f32 step (TF32 off), 2 gloo ranks x 1 image against one "
        f"process x 2 ({one_ms:.1f} ms, peak {one_peak / 2 ** 30:.2f} GiB), point picks and "
        f"matches replayed: loss terms {held['term']:.3e} (limit {PAR_TERM_RTOL:.0e}), "
        f"gradients' median {held['grad_median']:.3e} (limit {PAR_GRAD_MEDIAN_RTOL:.0e}) and "
        f"largest {held['grad']:.3e} (limit {PAR_GRAD_RTOL:.0e})")
    if ranks[0]["grad_digest"] != ranks[1]["grad_digest"]:
        raise AssertionError("parallel 13b (i): the ranks' reduced gradients differ")
    if (held["term"] > PAR_TERM_RTOL or held["grad_median"] > PAR_GRAD_MEDIAN_RTOL
            or held["grad"] > PAR_GRAD_RTOL or any(held["assignments differing"])):
        raise AssertionError(f"parallel 13b (i): past the limits {PAR_TERM_RTOL}, "
                             f"{PAR_GRAD_MEDIAN_RTOL} and {PAR_GRAD_RTOL}: {held}")
    for i in range(PAR_STEPS):
        if ranks[0]["digests"][i] != ranks[1]["digests"][i]:
            raise AssertionError(f"parallel 13b (ii): the ranks' states differ after step {i}")
    for r in ranks:
        for i, s in enumerate(r["per_step"]):
            got = {k: s["launches"][k] for k in ("ms_deform_attn", "ms_deform_attn_bwd")}
            if got != {"ms_deform_attn": 21, "ms_deform_attn_bwd": 21}:
                raise AssertionError(f"parallel 13b (ii): rank {r['rank']} step {i} launched "
                                     f"{got}, expected 21 and 21")
    log(f"[parallel] 13b (ii): 2 bf16 steps, ranks bit-identical after each; total loss (mean "
        f"over the ranks) {[round(x, 4) for x in ranks[0]['total_loss']]}; ms per step "
        f"{[[round(s['ms'], 1) for s in r['per_step']] for r in ranks]}; collectives a step "
        f"{[s['collectives'] for s in ranks[0]['per_step']]} (gloo, tensors on the card); K-B "
        f"and K-D a step a rank 21 and 21")
    same = lambda a, b: a == b or (isinstance(a, float) and isinstance(b, float)
                                   and np.isnan(a) and np.isnan(b))
    diff = {(r["rank"], k): (r["eval"].get(k), v) for r in ranks for k, v in pipe_eval.items()
            if k != "sec_per_image" and not same(r["eval"].get(k), v)}
    if diff or any(set(r["eval"]) != set(pipe_eval) for r in ranks):
        raise AssertionError(f"parallel 13b (iii): sharded metrics differ from phase 9's: {diff}")
    log(f"[parallel] 13b (iii): sharded evaluate_detection_dataset over coco_panoptic_val "
        f"({ranks[0]['eval']['images']} images, 2 ranks): every metric equal to phase 9's "
        f"eval_net ({len(pipe_eval) - 1} keys)")
    gt_diff = {(r["rank"], k): (r["eval_gt"].get(k), v) for r in ranks
               for k, v in one_gt_eval.items() if not same(r["eval_gt"].get(k), v)}
    if (gt_diff or any(set(r["eval_gt"]) != set(one_gt_eval) for r in ranks)
            or not all(0 < one_gt_eval[k] < 100 for k in GT_EVAL_KEYS)
            or len(set(one_gt_eval["detections"])) != len(one_gt_eval["detections"])):
        raise AssertionError(f"parallel 13b (iii): with GtPredictor the sharded metrics "
                             f"{gt_diff} differ from one process's {one_gt_eval}, or a metric "
                             f"of {GT_EVAL_KEYS} is not strictly between 0 and 100, or two "
                             f"images have as many detections")
    log(f"[parallel] 13b (iii): with GtPredictor (detections an image "
        f"{one_gt_eval['detections']}), sharded over 2 ranks: every metric equal to one "
        f"process's ({len(one_gt_eval)} keys): "
        f"{ {k: one_gt_eval[k] for k in GT_EVAL_KEYS} }")
    log(f"[parallel] 13b: peak memory a process (GiB): one-process f32 step "
        f"{one_peak / 2 ** 30:.2f}; ranks f32 {[round(r['f32_peak_gib'], 2) for r in ranks]}, "
        f"bf16 {[round(r['bf16_peak_gib'], 2) for r in ranks]}; spawn to join "
        f"{spawn_s:.1f} s; card {card}")
    record = {"f32": runs,
              "ms_per_step": [[s["ms"] for s in r["per_step"]] for r in ranks],
              "peak_gib": [r["peak_gib"] for r in ranks], "one_ms": one_ms,
              "per_step": ranks[0]["per_step"][-1]["launches"]}
    return (record, kb_shapes + [s for r in ranks for s in r["kb_shapes"]],
            kd_shapes + [s for r in ranks for s in r["kd_shapes"]])


LAST_TRAIN_STEPS = 3
VITH_BF16_STEPS = 2
VITH_BF16_MIN_DROP_GIB = 1.2
JPEG_DIR = "tests/data/jpeg"
JPEG_SIZE = (480, 640)
JPEG_REPS = 20
BOXINST = dict(n=100, hw=256, kernel_size=3, dilation=2, iteration=5000)
DEMO_EXPRESSION = "the circle"


def _train_record(rec) -> dict:
    return {k: rec[k] for k in ("per_step", "ms_per_step", "peak_gib", "step_peaks_gib", "syncs",
                                "unmoved", "trainable", "mu_dtypes")}


def _jpeg_checks(card) -> dict:
    """The committed JPEGs (tests/data/jpeg/) decoded on this machine against
    cv2's decodes committed beside them (max |diff| <= 1, mean <= 0.01); then
    decode and encode ms of one 640x480 JPEG written here (load_image and
    write_jpeg, host clock, the median of JPEG_REPS)."""
    import glob

    from hipie_torch import native
    from hipie_torch.data.image_io import load_image, read_png, write_jpeg
    from hipie_torch.native import jpeg

    here = Path(__file__).resolve().parent
    files = sorted(glob.glob(str(here / JPEG_DIR / "*.jpg")))
    if len(files) < 10:
        raise AssertionError(f"jpeg: {len(files)} committed files under {JPEG_DIR}")
    worst = {}
    for path in files:
        got, want = load_image(path), read_png(path[:-4] + ".png")
        d = np.abs(got.astype(np.int32) - want.astype(np.int32)) if got.shape == want.shape else None
        if d is None or d.max() > 1 or d.mean() > 0.01:
            raise AssertionError(f"jpeg: {path} decodes to {got.shape} against cv2's "
                                 f"{want.shape}" + ("" if d is None else
                                                    f", max |diff| {d.max()}, mean {d.mean()}"))
        worst[os.path.basename(path)] = (int(d.max()), float(d.mean()))
    h, w = JPEG_SIZE
    y, x = np.mgrid[0:h, 0:w]
    r = np.random.RandomState(SEED)
    img = np.stack([128 + 100 * np.sin(x / 23.0 + c) * np.cos(y / 17.0 - c) for c in range(3)], -1)
    img = np.clip(img + r.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)
    work = tempfile.mkdtemp(prefix="hipie_jpeg_")
    try:
        path = os.path.join(work, "img.jpg")
        enc, dec = [], []
        for _ in range(JPEG_REPS):
            t = time.perf_counter()
            write_jpeg(path, img)
            enc.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            back = load_image(path)
            dec.append(1e3 * (time.perf_counter() - t))
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    err = float(np.abs(back.astype(np.int32) - img).mean())
    if back.shape != img.shape or err > 8.0:
        raise AssertionError(f"jpeg: a 640x480 round trip gave {back.shape}, mean |diff| {err}")
    rec = {"committed": worst, "decode_ms": float(np.median(dec)), "encode_ms": float(np.median(enc)),
           "bytes": size, "round_trip_mean_abs": err, "lib": os.path.basename(native.library_path(jpeg._SRC))}
    log(f"[14e] JPEG: {len(files)} committed files decode within one level of cv2's "
        f"(max, mean |diff| {worst}); a 640x480 image ({size} bytes at quality 95): decode "
        f"{rec['decode_ms']:.3f} ms, encode {rec['encode_ms']:.3f} ms (median of {JPEG_REPS}, "
        f"host clock), round-trip mean |diff| {err:.3f}; card {card}")
    return rec


def _boxinst_check(dev, card) -> dict:
    """boxinst_losses forward and backward at N = 100 slots of 256x256 mask
    logits, a 3x3 neighbourhood at dilation 2, on the card in f32, against the
    same call on the CPU (losses 1e-4 relative, the logits' gradient 1e-4 of
    its largest value); ms by CUDA events (median of 5 after a warm-up)."""
    from hipie_torch.losses.boxinst import boxinst_losses, images_color_similarity

    n, hw, k, dil = BOXINST["n"], BOXINST["hw"], BOXINST["kernel_size"], BOXINST["dilation"]
    g = torch.Generator().manual_seed(SEED)
    logits = torch.randn(n, hw, hw, generator=g) * 3
    boxes = torch.zeros(n, hw, hw)
    corners = torch.randint(0, hw // 2, (n, 2), generator=g)
    sizes = torch.randint(16, hw // 2, (n, 2), generator=g)
    for i in range(n):
        (y, x), (bh, bw) = corners[i].tolist(), sizes[i].tolist()
        boxes[i, y:y + bh, x:x + bw] = 1
    lab = torch.rand(hw, hw, 3, generator=g) * torch.tensor([100.0, 50.0, 50.0])
    valid = torch.arange(n) < 80

    def run(device):
        ml = logits.to(device, copy=True).requires_grad_(True)
        sim = images_color_similarity(lab.to(device), k, dil)[None].expand(n, -1, -1, -1)
        out = boxinst_losses(ml, boxes.to(device), sim, valid.to(device), BOXINST["iteration"],
                             kernel_size=k, dilation=dil)
        (out["loss_prj"] + out["loss_pairwise"]).backward()
        return {kk: float(v.detach()) for kk, v in out.items()}, ml.grad

    want, want_grad = run("cpu")
    got, grad = run(dev)
    times = []
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(dev)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    rel = {kk: abs(got[kk] - want[kk]) / max(abs(want[kk]), 1e-30) for kk in want}
    grad_err = float((grad.cpu() - want_grad).abs().max() / want_grad.abs().max())
    if any(not np.isfinite(v) for v in got.values()) or max(rel.values()) > 1e-4 \
            or grad_err > 1e-4:
        raise AssertionError(f"boxinst: card {got} against CPU {want} (relative {rel}), "
                             f"logit gradient error {grad_err}")
    ms = float(np.median(times[1:]))
    log(f"[14f] BoxInst at N={n}, {hw}x{hw}, K={k}, dilation {dil}: losses {got} (CPU "
        f"{want}, relative {rel}), logit gradient within {grad_err:.2e} of the CPU's; forward "
        f"and backward {ms:.3f} ms (CUDA events, median of 5); card {card}")
    return {"losses": got, "ms": ms, "grad_rel_err": grad_err}


def plain_path_bounds(card) -> dict:
    """The bounds of two plain-PyTorch paths of PERF.md's table, from their
    shapes, bf16 on the tensor cores, each with its qkv and output projections:
    CLIP's attention layers in one open-vocab call (24 layers of width 1024
    over 1 + 576 + 900 and 1 + 576 + 1200 tokens, the fg and all passes) and
    Swin-L's windowed attention in one call of phase 11 (the 800x1216 bucket:
    stage maps 200x304 to 25x38, padded to whole 12x12 windows). Operations:
    8 T C^2 for the projections and 4 T n C for the two products (n tokens a
    window, or T); bytes: the bf16 weights and the block's input and output."""
    from hipie_torch.models.backbone.swin import SWIN_VARIANTS

    flops = nbytes_ = 0.0
    width = 1024
    for t in (1 + 576 + 900, 1 + 576 + 1200):
        flops += 24 * (8 * t * width ** 2 + 4 * t * t * width)
        nbytes_ += 24 * (2 * 4 * width ** 2 + 2 * 2 * t * width)
    out = {"clip_attention": bound(flops, nbytes_, PEAK_BF16_TENSOR, "tensor cores")}
    embed, depths, _, ws = SWIN_VARIANTS["swin_large"]
    flops = nbytes_ = 0.0
    h, w = R50_BUCKET[0] // 4, R50_BUCKET[1] // 4
    for s_, depth in enumerate(depths):
        c = embed * 2 ** s_
        tokens = -(-h // ws) * ws * -(-w // ws) * ws
        flops += depth * (8 * tokens * c * c + 4 * tokens * ws * ws * c)
        nbytes_ += depth * (2 * 4 * c * c + 2 * 2 * tokens * c)
        h, w = -(-h // 2), -(-w // 2)
    out["swin_attention"] = bound(flops, nbytes_, PEAK_BF16_TENSOR, "tensor cores")
    log("[bounds] " + "; ".join(
        f"{k} a call: {v['bound_ms']:.4f} ms by {v['bound_by']} ({v['bound_flops']:.4g} "
        f"FLOP, {v['bound_bytes']:.4g} bytes)" for k, v in out.items()) + f"; card {card}")
    return out


def phase_last_modules(dev, card, pipe_root: str, vit_f32: dict):
    """14: the modules of the port's last slice at full width on the card.
    (a) LAST_TRAIN_STEPS training steps each of swin_large_coco_panoptic() and
    convnext_large_coco_panoptic() through phase_train (R50's training cell's
    shapes: batch 2 at 1024x1024, 256-token prompt, 100 GT slots, bf16
    autocast; K-B and K-D exact a step); (b) VITH_BF16_STEPS ViT-H steps with
    ``solver.mu_dtype`` bfloat16, the first moment stored in bf16 and the
    peak of the steps after the first (the moments exist from the first update
    on) at least VITH_BF16_MIN_DROP_GIB under phase 8's f32 steps'; (c)
    make_tiny_coco --ade-semseg (its val split is phase 9's), eval_net on
    ade20k_sem_seg_val with phase 9's checkpoint (mIoU finite) and with
    GtPredictor answering the GT (mIoU 100); (d) the demo CLI on one of those
    JPEGs with phase 9's config and checkpoint, detection and grounding, its
    files read back; (e) ``_jpeg_checks``; (f) ``_boxinst_check``. Returns the
    record and the K-A, K-B, K-D and K-E shapes of (a) and (b)."""
    import hipie_torch.data.datasets as datasets
    import hipie_torch.data.datasets_extra as datasets_extra
    from hipie_torch.config import apply_overrides
    from hipie_torch.data.image_io import load_image, read_png
    from hipie_torch.evaluation.evaluator import evaluate_semseg_dataset, load_sem_seg_gt
    from hipie_torch.presets import (convnext_large_coco_panoptic, swin_large_coco_panoptic,
                                     vit_huge_coco_panoptic)
    from hipie_torch.tools import demo, eval_net, make_tiny_coco

    out, shapes = {}, ([], [], [], [])
    for preset in (swin_large_coco_panoptic, convnext_large_coco_panoptic):
        gc.collect()          # earlier phases' models held by reference cycles
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        rec, *sh = phase_train(dev, card, cfg=preset(), steps=LAST_TRAIN_STEPS,
                               require_moved=False)
        for acc, got in zip(shapes, sh):
            acc.extend(got)
        out[preset.__name__] = {**_train_record(rec), "resident_gib": resident}
        log(f"[14a] {preset.__name__}: ms per step {[round(t, 1) for t in rec['ms_per_step']]}, "
            f"peak {rec['peak_gib']:.2f} GiB ({resident:.3f} resident before; by step "
            f"{[round(x, 3) for x in rec['step_peaks_gib']]}), K-B "
            f"{rec['per_step']['ms_deform_attn']} and K-D "
            f"{rec['per_step']['ms_deform_attn_bwd']} launches a step, {rec['unmoved']} of "
            f"{rec['trainable']} trainable tensors unmoved; card {card}")
        torch.cuda.empty_cache()

    # the f32 and bf16-moment steps back to back, each from the same resident
    # memory (earlier phases' models freed first): the moments exist from the
    # first update on, so the second step's peak is the one they weigh on
    runs = {}
    for mu in ("float32", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        cfg = apply_overrides(vit_huge_coco_panoptic(), {"solver.mu_dtype": mu})
        rec, *sh = phase_train(dev, card, cfg=cfg, steps=VITH_BF16_STEPS, ranges=True)
        for acc, got in zip(shapes, sh):
            acc.extend(got)
        runs[mu] = {**_train_record(rec), "resident_gib": resident,
                    "optimizer_ms": [r.get("optimizer") for r in rec["range_ms"]]}
    f32, bf16 = runs["float32"], runs["bfloat16"]
    drop = f32["step_peaks_gib"][1] - bf16["step_peaks_gib"][1]
    out["vit_huge_bf16_mu"] = {**bf16, "f32": f32, "peak_drop_gib": drop,
                               "phase8_step_peaks_gib": vit_f32["step_peaks_gib"]}
    log(f"[14b] ViT-H, first moment f32 then bf16, {VITH_BF16_STEPS} steps each from "
        f"{f32['resident_gib']:.3f} and {bf16['resident_gib']:.3f} GiB resident: ms per step "
        f"{[round(t, 1) for t in f32['ms_per_step']]} and "
        f"{[round(t, 1) for t in bf16['ms_per_step']]}; peak by step "
        f"{[round(x, 3) for x in f32['step_peaks_gib']]} and "
        f"{[round(x, 3) for x in bf16['step_peaks_gib']]} GiB (phase 8's f32 steps "
        f"{[round(x, 3) for x in vit_f32['step_peaks_gib']]}): the second step's {drop:.3f} GiB "
        f"less with bf16 (predicted 1.48); the optimizer range's device ms "
        f"{f32['optimizer_ms']} and {bf16['optimizer_ms']}; moments {bf16['mu_dtypes']}; "
        f"card {card}")
    if bf16["mu_dtypes"] != ["torch.bfloat16"] or f32["mu_dtypes"] != ["torch.float32"] \
            or drop < VITH_BF16_MIN_DROP_GIB:
        raise AssertionError(f"ViT-H moments {f32['mu_dtypes']}, {bf16['mu_dtypes']}, peak drop "
                             f"{drop:.2f} GiB "
                             f"(at least {VITH_BF16_MIN_DROP_GIB} expected)")
    torch.cuda.empty_cache()

    config = str(Path(__file__).resolve().parent / SMOKE_CONFIG)
    ckpt = os.path.join(pipe_root, "run", f"model_{PIPE_STEPS:07d}.pth")
    ade_root = tempfile.mkdtemp(prefix="hipie_ade_")
    old_root = os.environ.get("HIPIE_DATASETS")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            make_tiny_coco.main(["--root", ade_root, "--n-train", "1", "--n-val", "4",
                                 "--size", str(PIPE_SIZE), "--ade-semseg"])
        fixture_s = time.perf_counter() - t0
        os.environ["HIPIE_DATASETS"] = ade_root
        datasets_extra.register_benchmark_datasets()   # binds its root when called
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            model_eval = eval_net.main(["--config-file", config, "--dataset",
                                        "ade20k_sem_seg_val", "--weights", ckpt,
                                        "--device", str(dev)])
        eval_s = time.perf_counter() - t0
        records = [datasets.materialize_record(r)
                   for r in datasets.get_dataset("ade20k_sem_seg_val")]
        for r in records:
            r["sem_seg_gt"] = load_sem_seg_gt(r["sem_seg_file_name"])
        gt_results = evaluate_semseg_dataset(GtPredictor(records, exact=True), records,
                                             datasets.DATASET_METADATA["ade20k_sem_seg_val"])
        img_path = records[0]["file_name"]
        demo_out = {}
        for task, extra in (("detection", []), ("grounding", ["--expression", DEMO_EXPRESSION])):
            src = os.path.join(ade_root, f"demo_{task}.jpg")
            shutil.copy(img_path, src)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                res = demo.main(["--input", src, "--config-file", config, "--weights", ckpt,
                                 "--device", str(dev), "--task", task, *extra])
            secs = time.perf_counter() - t0
            vis = load_image(res["written"]["vis"])
            pan = read_png(res["written"]["pan"]) if "pan" in res["written"] else None
            if vis.shape != load_image(src).shape or (pan is not None
                                                      and pan.shape != vis.shape):
                raise AssertionError(f"demo {task}: wrote {vis.shape}, "
                                     f"{None if pan is None else pan.shape}")
            demo_out[task] = {"s": secs, "instances": len(res["result"]["instances"]["scores"]),
                              "files": sorted(os.path.basename(f)
                                              for f in res["written"].values())}
    finally:
        if old_root is None:
            os.environ.pop("HIPIE_DATASETS", None)
        else:
            os.environ["HIPIE_DATASETS"] = old_root
        datasets_extra.register_benchmark_datasets()
        shutil.rmtree(ade_root, ignore_errors=True)
    if model_eval["images"] != 4 or not np.isfinite(model_eval["sem_seg/mIoU"]) \
            or gt_results["sem_seg/mIoU"] != 100.0:
        raise AssertionError(f"ADE mirror: eval_net {model_eval}, GtPredictor {gt_results}")
    out["ade"] = {"model": model_eval, "gt": gt_results, "fixture_s": fixture_s,
                  "eval_s": eval_s}
    out["demo"] = demo_out
    log(f"[14c] make_tiny_coco --ade-semseg ({fixture_s:.2f} s), eval_net ade20k_sem_seg_val "
        f"with phase 9's checkpoint: { {k: round(float(v), 4) for k, v in model_eval.items()} } "
        f"({eval_s:.1f} s); GtPredictor: mIoU {gt_results['sem_seg/mIoU']}; card {card}")
    log(f"[14d] demo on a fixture JPEG: {demo_out}; card {card}")
    out["jpeg"] = _jpeg_checks(card)
    out["boxinst"] = _boxinst_check(dev, card)
    out["bounds"] = plain_path_bounds(card)
    return out, shapes


TP = 2
TP_BF16_REQUESTS = 2
TP_R50_STEPS = 2
TP_VITH_BATCH = 2                 # the recipe's per-card batch, on each of the two ranks
# 15 (a): the f32 ViT-H request at tp = 2 against one process's. The two differ
# by the order of float adds alone (the row-parallel sums of two partial
# products, cuBLAS's tiling of half-width matrices), which near-ties turn into
# discrete differences: the two-stage top-900 of 21760 proposals takes
# near-tied tokens in another order, so that a slot's learned content meets
# another box (on an H100 without the replay: the decoder's states 0.73
# apart with all 910 references present). So the run replays the one-process
# run's two-stage choices (``two_stage_choices``, as 13b replays the
# matches); then the dense
# outputs (the encoder memory, the encoder's class logits, the semantic map)
# and the decoder's outputs on the slots whose initial references align (as
# tests/test_torch_slice.py aligns them: the nearest one-process slot, within
# TP_ALIGN_TOL in box units) are held within TP_SERVE_REL of each tensor's
# largest magnitude, and at least TP_ALIGNED of the 910 slots must align; the
# detections sorted by score, which near-tied scores may still swap, are
# reported beside them, not held.
TP_SERVE_REL = 1e-4
TP_ALIGN_TOL = 1e-4
TP_ALIGNED = 0.99
# 15 (c): the f32 ViT-H step at tp = 2 against one process's. Its 32 f32 blocks
# carry round-off far: the one-process step itself, repeated on images scaled
# by TP_TWIN_SCALE (two ulps), moved its gradients by a median 3.9e-4 and at
# most 9.9e-3 (on an NVIDIA H100 80GB HBM3, 700 W), past 13b's median limit,
# while the tp = 2 step's moved by 3.5e-4 and 8.1e-3. So (c) repeats that twin
# in the same run and holds the tp = 2 step's gradients' median and largest
# error, and the rel-pos tables' largest, within TP_TWIN_FACTOR of the twin's
# (a rank's heads' part of a rel-pos gradient alone is ~0.5 off); its loss terms
# at 13b's limit.
TP_TWIN_SCALE = 1 + 2 ** -22
TP_TWIN_FACTOR = 2.0
TP_F32_KEYS = ("memory", "enc_outputs_class", "init_reference", "hs", "pred_logits",
               "pred_boxes")


@contextlib.contextmanager
def two_stage_choices(ks, replay=None):
    """Within the block each two-stage top-k (a ``Tensor.topk`` over dim 1
    taking k in ``ks``: the encoder's proposals and MaskDINO's) appends its
    indices (on the host) to the yielded list or, with ``replay`` (another
    run's list), takes them from it in order. Two runs that round apart put
    near-tied proposals in another order, and a slot's learned content then
    meets another reference box; replaying the choice, as 13b replays the
    matches, leaves the comparison continuous."""
    inner = torch.Tensor.topk
    chosen, queue = [], None if replay is None else list(replay)

    def topk(self, k, dim=-1, largest=True, sorted=True):
        if dim != 1 or k not in ks:
            return inner(self, k, dim, largest, sorted)
        if queue is None:
            res = inner(self, k, dim, largest, sorted)
            chosen.append(res.indices.cpu())
            return res
        idx = queue.pop(0).to(self.device)
        return torch.return_types.topk((self.gather(1, idx), idx))

    torch.Tensor.topk = topk
    try:
        yield chosen
    finally:
        torch.Tensor.topk = inner
    if queue:
        raise AssertionError(f"two_stage_choices: {len(queue)} recorded choices left unused")


def two_stage_ks(cfg):
    return {cfg.model.transformer.two_stage_num_proposals, cfg.model.maskdino.num_queries}


def tp_f32_cells():
    """Phase 15's f32 steps (TF32 off) held against one process's: (name,
    config, batch): (b) the R50 step on 13b's pair batch, (c) the ViT-H step
    on its first image (batch 1: two ranks' f32 ViT-H steps share the card)."""
    from hipie_torch.config import apply_overrides
    from hipie_torch.presets import r50_coco_panoptic, vit_huge_coco_panoptic

    f32 = {"model.dtype": "float32"}
    r50 = apply_overrides(r50_coco_panoptic(), f32)
    vith = apply_overrides(vit_huge_coco_panoptic(), f32)
    return [("r50", r50, pair_batches(r50)[0]),
            ("vith", vith, rank_batch(pair_batches(vith)[0], 0))]


def one_process_f32_step(dev, work: str, name: str, cfg, batch) -> list:
    """One process's f32 step of a ``tp_f32_cells`` cell: its weights,
    gradients, point picks, matches, assignments and two-stage choices written
    to ``work`` under ``name``; returns its loss terms."""
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.utils.rng import GeneratorKeys

    state = create_train_state(cfg, seed=SEED, device=dev)
    torch.save(_cpu_snapshot(state.model), os.path.join(work, f"{name}_weights.pt"))
    step = make_train_step(cfg, state, device=dev)
    with recording_step(state) as rec, two_stage_choices(two_stage_ks(cfg)) as choices:
        step(state, batch, GeneratorKeys(torch.Generator(device=dev).manual_seed(SEED)))
    torch.cuda.synchronize()
    torch.save({k: (None if v is None else v.cpu()) for k, v in rec["grads"][0].items()},
               os.path.join(work, f"{name}_grads.pt"))
    torch.save({**{k: rec[k] for k in ("picks", "matches", "assign")}, "choices": choices},
               os.path.join(work, f"{name}_one.pt"))
    terms = rec["terms"]
    del state, step, rec
    torch.cuda.empty_cache()
    return terms


def tp_f32_step(dev, work: str, name: str, cfg, batch) -> dict:
    """This rank's f32 step of a ``tp_f32_cells`` cell at tp = 2 with
    shard_tokens, from the one-process step's weights with its point picks,
    matches and two-stage choices replayed: its loss terms, each gradient's
    relative error against the one-process one (this rank's shard of it) and
    the assignments that differ."""
    from hipie_torch.config import apply_overrides
    from hipie_torch.parallel import mesh
    from hipie_torch.parallel.tensor import shard_state_dict, take_shard, tp_plan
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.utils.rng import GeneratorKeys

    one = torch.load(os.path.join(work, f"{name}_one.pt"), weights_only=False)
    want = torch.load(os.path.join(work, f"{name}_grads.pt"), weights_only=True)
    weights = torch.load(os.path.join(work, f"{name}_weights.pt"), weights_only=True)
    cfg = apply_overrides(cfg, {"model.transformer.shard_tokens": True})
    state = create_train_state(cfg, seed=SEED, device=dev)
    plan = tp_plan(state.model)
    state.model.load_state_dict(shard_state_dict(weights, plan))
    mine = {n: (None if g is None else take_shard(g, *plan[n], mesh.model_rank(), TP)
                if n in plan else g) for n, g in want.items()}
    del weights, want
    step = make_train_step(cfg, state, device=dev)
    with recording_step(state, one["picks"], one["matches"], ref_grads=[mine]) as rec, \
            two_stage_choices(two_stage_ks(cfg), one["choices"]):
        step(state, batch, GeneratorKeys(torch.Generator(device=dev).manual_seed(SEED)))
    torch.cuda.synchronize()
    out = {"terms": rec["terms"], "grad_errs": rec["grad_errs"][0],
           "assign_mismatch": sum(int(not torch.equal(g, w)) for g, w in
                                  zip(rec["assign"], one["assign"]))}
    del state, step, rec, mine
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, work: str):
    """One of phase 15's two gloo ranks on cuda:0 at tp = 2 (dp = 1); writes
    its record to ``work``."""
    import hipie_torch.models.msda_module as msda_module
    import hipie_torch.ops.ms_deform_attn as msda_ops
    import hipie_torch.ops.vit_attention as vit_ops
    from hipie_torch import kernels
    from hipie_torch.config import apply_overrides
    from hipie_torch.parallel import mesh
    from hipie_torch.parallel.dryrun import state_digest, tensor_digest
    from hipie_torch.parallel.tensor import tp_plan
    from hipie_torch.presets import r50_coco_panoptic, vit_huge_coco_panoptic
    from hipie_torch.train.checkpoint import save_checkpoint
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.synthetic import train_batches
    from hipie_torch.train.trainer import Trainer
    from hipie_torch.utils.rng import GeneratorKeys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.init_distributed("gloo", f"file://{work}/rendezvous", rank=rank, world_size=TP,
                                device=torch.device("cuda", 0))
    out = {"rank": rank, "ka": [], "kb": [], "kd": [], "ke": []}
    sp = {"model.transformer.shard_tokens": True}
    try:
        mesh.create_mesh(tp=TP)
        with timing_vit_kernel(out["ka"]), \
                timing_calls(msda_module, "ms_deform_attn",
                             lambda *a, **k: out["kb"].append(msda_shape(*a, **k)), timed=False), \
                timing_calls(msda_ops, "ms_deform_attn_backward",
                             lambda *a: out["kd"].append(msda_shape(*a[:4])), timed=False), \
                timing_calls(vit_ops, "vit_attention_backward",
                             lambda *a: out["ke"].append(vit_shape(a[0], a[3], a[4])),
                             timed=False):
            # (a) ViT-H serving at tp = 2 with shard_tokens: f32, then bf16
            got = {}
            cfg, model, request = vit_huge_server(dev, dtype=torch.float32, overrides=sp,
                                                  out=got)
            img = serve_images(1)[0]
            choices = torch.load(os.path.join(work, "serve_choices.pt"), weights_only=True)
            with torch.inference_mode(), two_stage_choices(two_stage_ks(cfg), choices):
                res = request(img)
            torch.cuda.synchronize()
            out["f32"] = {**{k: got[k].cpu() for k in TP_F32_KEYS},
                          **{k: getattr(res, k).cpu() for k in ("scores", "boxes", "sem_seg")}}
            del model, request, got, res
            torch.cuda.empty_cache()
            cfg, model, request = vit_huge_server(dev, overrides=sp)
            n_global = sum(1 for b in model.detr.detr.backbone[0].backbone.blocks
                           if b.window_size == 0)
            out["serve"] = []
            for img in serve_images(TP_BF16_REQUESTS):
                kernels.reset_launch_counts()
                mesh.COLLECTIVES.clear()
                with torch.inference_mode(), timing_vit_attention() as ka_ev, \
                        timing_msda() as kb_ev:
                    t0 = time.perf_counter()
                    res = request(img)
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0)
                check_result(res, cfg)
                out["serve"].append({"ms": ms, "launches": dict(kernels.LAUNCHES),
                                     "ka_ms": sum(a.elapsed_time(b) for a, b in ka_ev),
                                     "kb_ms": sum(a.elapsed_time(b) for a, b in kb_ev),
                                     "collectives": dict(mesh.COLLECTIVES)})
            out["n_global"], out["n_msda"] = n_global, msda_per_call(cfg.model)
            out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            del model, request, res
            torch.cuda.empty_cache()

            # (a') the R50 predictor under shard_tokens: 20197 tokens split unevenly
            from hipie_torch.data.label_spaces import COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING
            from hipie_torch.models.hipie import HIPIEModel
            from hipie_torch.models.text.tokenizer import WordPieceTokenizer
            from hipie_torch.predictor import HIPIEPredictor
            from hipie_torch.utils.weights import random_init_

            rcfg = apply_overrides(r50_coco_panoptic(), sp)
            with torch.device(dev):
                rmodel = HIPIEModel(rcfg.model).eval()
            random_init_(rmodel, torch.Generator(device=dev).manual_seed(SEED))
            rmodel.to(torch.bfloat16)
            pred = HIPIEPredictor(rcfg, rmodel, WordPieceTokenizer.toy(), bucket=R50_BUCKET,
                                  device=dev)
            labels = [n if thing else f"{n}:stuff"
                      for n, thing in zip(COCO_PANOPTIC_133, COCO_PANOPTIC_IS_THING)]
            image = np.random.RandomState(SEED + 2).randint(0, 256, R50_IMAGE + (3,)).astype(
                np.uint8)
            n_kb = len(out["kb"])
            res = pred(image, test_categories=labels)
            _check_prediction(res, "detection")
            out["r50_encoder_q"] = max(s[2] for s in out["kb"][n_kb:])
            del rmodel, pred, res
            torch.cuda.empty_cache()

            # (b) the R50 step and (c) the ViT-H step at tp = 2 with shard_tokens:
            # f32 (TF32 off) against the one-process step, picks, matches and
            # two-stage choices replayed
            out["train_f32"] = {name: tp_f32_step(dev, work, name, cfg, batch)
                                for name, cfg, batch in tp_f32_cells()}

            # (b) two bf16 steps through the Trainer, then a checkpoint at tp = 2
            cfg = dataclasses.replace(apply_overrides(r50_coco_panoptic(), sp),
                                      output_dir=os.path.join(work, "run"))
            state = create_train_state(cfg, seed=SEED, device=dev)
            plan = tp_plan(state.model)
            inner = make_train_step(cfg, state, device=dev)
            per_step, replicated = [], []

            def train_step(st, batch, keys):
                kernels.reset_launch_counts()
                mesh.COLLECTIVES.clear()
                t = time.perf_counter()
                st, metrics = inner(st, batch, keys)
                torch.cuda.synchronize()
                per_step.append({"ms": 1e3 * (time.perf_counter() - t),
                                 "launches": dict(kernels.LAUNCHES),
                                 "collectives": dict(mesh.COLLECTIVES)})
                replicated.append(tensor_digest(p for n, p in st.model.named_parameters()
                                                if n not in plan))
                return st, metrics

            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(cfg, state, train_step, iter(pair_batches(cfg, TP_R50_STEPS)),
                              log_period=1, device=dev, checkpoints=False)
            trainer.train(max_iter=TP_R50_STEPS)
            out.update(r50_per_step=per_step, r50_replicated=replicated,
                       r50_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       r50_total_loss=[h["total_loss"] for h in trainer.history],
                       r50_n_sharded=len(plan))
            save_checkpoint(work, state, TP_R50_STEPS, name="tp2")
            out["r50_digest"] = state_digest(state)
            del state, inner, trainer
            torch.cuda.empty_cache()

            # (c) one bf16 ViT-H step at tp = 2 with shard_tokens
            cfg = apply_overrides(vit_huge_coco_panoptic(), sp)
            state = create_train_state(cfg, seed=SEED, device=dev)
            want_launches = train_launches(cfg, state.model)
            step = make_train_step(cfg, state, device=dev)
            batch = train_batches(cfg, 1, SEED, img=IMG, slots=TRAIN_N, batch=TP_VITH_BATCH)[0]
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t = time.perf_counter()
            _, metrics = step(state, batch, GeneratorKeys(torch.Generator(device=dev)
                                                          .manual_seed(SEED)))
            torch.cuda.synchronize()
            out["vith"] = {"ms": 1e3 * (time.perf_counter() - t),
                           "launches": dict(kernels.LAUNCHES), "want": want_launches,
                           "loss": float(metrics["total_loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "replicated": tensor_digest(
                               p for n, p in state.model.named_parameters()
                               if n not in tp_plan(state.model))}
            del state, step
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        mesh.shutdown_distributed()


def phase_tensor_parallel(dev, card):
    """15: tensor parallelism (tp = 2) with shard_tokens on two gloo ranks on
    the one card (NCCL refuses two ranks on one device; the times say nothing
    of TP across cards): (a) the ViT-H request at full width, f32 (TF32 off)
    with the one-process request's two-stage choices replayed, against it
    within TP_SERVE_REL, then TP_BF16_REQUESTS bf16
    requests timed by the host and K-A and K-B by CUDA events, launches exact;
    (a') an R50 predictor call, whose 20197 encoder tokens split 10099 and
    10098; (b) the R50 step, f32, against the one-process step with its point
    picks, matches and two-stage choices replayed (13b's limits), then
    TP_R50_STEPS bf16 steps
    through the Trainer with the ranks' replicated parameters bit-identical
    after each and K-B and K-D 21 a step, then the checkpoint written at tp = 2
    restored at tp = 1 bit for bit; (c) the ViT-H step, f32 at batch 1, against
    the one-process step alike, within TP_TWIN_FACTOR of the one-process step's
    own round-off twin (the 64 rel-pos tables, whose gradient each rank takes
    from its own heads, among those held), then one
    bf16 step at batch TP_VITH_BATCH: each rank's peak memory and exact K-A,
    K-E, K-B and K-D launches. Returns the record and the K-A, K-B, K-D and
    K-E shapes."""
    import torch.multiprocessing as mp

    from hipie_torch.parallel.dryrun import state_digest
    from hipie_torch.presets import r50_coco_panoptic
    from hipie_torch.train.checkpoint import restore_checkpoint
    from hipie_torch.train.step import create_train_state

    work = tempfile.mkdtemp(prefix="hipie_tp_")
    try:
        # one process: the f32 ViT-H request, then the f32 R50 and ViT-H steps
        got = {}
        cfg, model, request = vit_huge_server(dev, dtype=torch.float32, out=got)
        with torch.inference_mode(), two_stage_choices(two_stage_ks(cfg)) as choices:
            res = request(serve_images(1)[0])
        torch.save(choices, os.path.join(work, "serve_choices.pt"))
        one_serve = {**{k: got[k].cpu() for k in TP_F32_KEYS},
                     **{k: getattr(res, k).cpu() for k in ("scores", "boxes", "sem_seg")}}
        del model, request, got, res
        torch.cuda.empty_cache()
        cells = tp_f32_cells()
        one_terms = {name: one_process_f32_step(dev, work, name, cfg, batch)
                     for name, cfg, batch in cells}
        # (c)'s round-off twin: the one-process ViT-H step on images two ulps off
        _, cfg, batch = cells[1]
        twin = tp_f32_step(dev, work, "vith", cfg,
                           batch._replace(images=batch.images.float() * TP_TWIN_SCALE))
        twin["term"] = max(term_rel_errors(twin.pop("terms"), one_terms["vith"]).values())
        del cells, cfg, batch
        t0 = time.perf_counter()
        mp.start_processes(_tp_rank, args=(work,), nprocs=TP, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP)]
        # the tp = 2 checkpoint at tp = 1
        state = create_train_state(r50_coco_panoptic(), seed=SEED + 1, device=dev)
        restore_checkpoint(os.path.join(work, "tp2.pth"), state)
        tp1_digest = state_digest(state)
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    failures = []

    def fail(msg):
        failures.append(msg)
        log(f"[tp] FAILED {msg}")

    # (a)
    rel = lambda got, want: (float((got.float() - want.float()).abs().max())
                             / max(float(want.float().abs().max()), 1e-30))
    errs, aligned = {}, {}
    for r in ranks:
        t = r["f32"]
        want_ref, got_ref = one_serve["init_reference"][0], t["init_reference"][0]
        dist = (want_ref[:, None, :] - got_ref[None, :, :]).abs().amax(-1)
        near, perm = dist.min(1)
        ok = near <= TP_ALIGN_TOL
        ok &= torch.bincount(perm[ok], minlength=len(perm))[perm] == 1   # one to one
        aligned[r["rank"]] = float(ok.float().mean())
        e = {k: rel(t[k], one_serve[k]) for k in ("memory", "enc_outputs_class", "sem_seg")}
        e["hs"] = rel(t["hs"][:, :, perm][:, :, ok], one_serve["hs"][:, :, ok])
        for k in ("pred_logits", "pred_boxes"):
            e[k] = rel(t[k][:, perm][:, ok], one_serve[k][:, ok])
        shown = {k: rel(t[k], one_serve[k]) for k in ("scores", "boxes")}
        errs[r["rank"]] = e
        log(f"[tp] 15 (a): rank {r['rank']}, the f32 ViT-H request at tp = 2 with shard_tokens "
            f"(TF32 off) against one process's, largest error over the largest magnitude: "
            f"{ {k: float(f'{v:.3e}') for k, v in e.items()} } (limit {TP_SERVE_REL:.0e}; the "
            f"decoder's on the {int(ok.sum())} of {len(ok)} slots that align, limit "
            f"{TP_ALIGNED:.0%}); not held, the detections sorted by score: "
            f"{ {k: float(f'{v:.3e}') for k, v in shown.items()} }")
        if aligned[r["rank"]] < TP_ALIGNED or any(v > TP_SERVE_REL for v in e.values()):
            fail(f"tp 15 (a): rank {r['rank']} past {TP_SERVE_REL} or under {TP_ALIGNED} "
                 f"aligned ({aligned[r['rank']]:.4f}): {e}")
    for r in ranks:
        want = {"vit_attention": r["n_global"], "ms_deform_attn": r["n_msda"], "msda_reduce": 0,
                "ms_deform_attn_bwd": 0, "vit_attention_bwd": 0, "nms": 1}
        for i, s in enumerate(r["serve"]):
            if s["launches"] != want:
                fail(f"tp 15 (a): rank {r['rank']} request {i} launched "
                     f"{s['launches']}, expected {want}")
    log(f"[tp] 15 (a): bf16 requests at tp = 2 (2 gloo ranks on one card), ms by rank "
        f"{[[round(s['ms'], 1) for s in r['serve']] for r in ranks]} (first includes warm-up); "
        f"K-A ms a request by CUDA events "
        f"{[[round(s['ka_ms'], 4) for s in r['serve']] for r in ranks]} "
        f"({ranks[0]['n_global']} launches at BH = 8), K-B "
        f"{[[round(s['kb_ms'], 4) for s in r['serve']] for r in ranks]} "
        f"({ranks[0]['n_msda']} launches); collectives a request "
        f"{ranks[0]['serve'][-1]['collectives']}; peak "
        f"{[round(r['serve_peak_gib'], 2) for r in ranks]} GiB; card {card}")
    # (a')
    qs = [r["r50_encoder_q"] for r in ranks]
    if qs != [R50_S - R50_S // 2, R50_S // 2]:
        fail(f"tp 15 (a'): the R50 encoder's queries by rank {qs}, expected "
             f"{R50_S - R50_S // 2} and {R50_S // 2}")
    log(f"[tp] 15 (a'): the R50 predictor under shard_tokens: encoder queries by rank {qs} of "
        f"{R50_S}")
    # (b) and (c): the f32 steps
    def worst_errs(g: dict) -> dict:
        rel_pos = [v for k, v in g.items() if ".attn.rel_pos_" in k]
        out = {"grad": max(g.values()), "grad_median": float(np.median(list(g.values())))}
        return {**out, "rel_pos_grad": max(rel_pos)} if rel_pos else out

    twin_worst = worst_errs(twin["grad_errs"])
    limits = {"r50": {"term": PAR_TERM_RTOL, "grad_median": PAR_GRAD_MEDIAN_RTOL,
                      "grad": PAR_GRAD_RTOL},
              "vith": {"term": PAR_TERM_RTOL,
                       **{k: TP_TWIN_FACTOR * v for k, v in twin_worst.items()}}}
    log(f"[tp] 15 (c): the round-off twin, one process's f32 ViT-H step on images scaled by "
        f"1 + 2^-22 against one process's: loss terms {twin['term']:.3e}, gradients' median "
        f"{twin_worst['grad_median']:.3e} and largest {twin_worst['grad']:.3e}, the rel-pos "
        f"tables' largest {twin_worst['rel_pos_grad']:.3e}; assignments differing "
        f"{twin['assign_mismatch']}")
    f32_worst = {"vith_twin": twin_worst}
    for name, part, what in (("r50", "b", "R50 step"), ("vith", "c", "ViT-H step at batch 1")):
        for r in ranks:
            tr = r["train_f32"][name]
            g = tr["grad_errs"]
            worst = {"term": max(term_rel_errors(tr["terms"], one_terms[name]).values()),
                     **worst_errs(g)}
            f32_worst.setdefault(name, []).append(worst)
            lim = limits[name]
            log(f"[tp] 15 ({part}): rank {r['rank']}, one f32 {what} at tp = 2 with "
                f"shard_tokens (TF32 off) against one process's, picks, matches and two-stage "
                f"choices replayed: loss terms {worst['term']:.3e} (limit {lim['term']:.0e}), "
                f"gradients' median {worst['grad_median']:.3e} (limit {lim['grad_median']:.2e}) "
                f"and largest {worst['grad']:.3e} (limit {lim['grad']:.2e}) over {len(g)} tensors"
                + (f", the {sum('.attn.rel_pos_' in k for k in g)} rel-pos tables' largest "
                   f"{worst['rel_pos_grad']:.3e} (limit {lim['rel_pos_grad']:.2e})"
                   if "rel_pos_grad" in worst else "")
                + f"; assignments differing {tr['assign_mismatch']}")
            over = {k: v for k, v in worst.items() if v > lim.get(k, float("inf"))}
            if over or tr["assign_mismatch"]:
                fail(f"tp 15 ({part}): past its limits {lim}: {over}, "
                     f"{tr['assign_mismatch']} assignments differing")
            if name == "vith" and sum(".attn.rel_pos_" in k for k in g) != 2 * VITH_BLOCKS:
                fail(f"tp 15 (c): {sum('.attn.rel_pos_' in k for k in g)} rel-pos tables' "
                     f"gradients held, expected {2 * VITH_BLOCKS}")
    for r in ranks:
        for i, s in enumerate(r["r50_per_step"]):
            got = {k: s["launches"][k] for k in ("ms_deform_attn", "ms_deform_attn_bwd")}
            if got != {"ms_deform_attn": 21, "ms_deform_attn_bwd": 21}:
                fail(f"tp 15 (b): rank {r['rank']} step {i} launched {got}")
    if ranks[0]["r50_replicated"] != ranks[1]["r50_replicated"]:
        fail("tp 15 (b): the ranks' replicated parameters differ")
    if ranks[0]["r50_digest"] != ranks[1]["r50_digest"] or tp1_digest != ranks[0]["r50_digest"]:
        fail(f"tp 15 (b): the tp = 2 state's whole tensors "
             f"{[r['r50_digest'][:12] for r in ranks]} and their checkpoint "
             f"restored at tp = 1 ({tp1_digest[:12]}) differ")
    log(f"[tp] 15 (b): {TP_R50_STEPS} bf16 R50 steps at tp = 2, ms a step by rank "
        f"{[[round(s['ms'], 1) for s in r['r50_per_step']] for r in ranks]}, total loss "
        f"{[round(x, 4) for x in ranks[0]['r50_total_loss']]}, collectives a step "
        f"{ranks[0]['r50_per_step'][-1]['collectives']}, {ranks[0]['r50_n_sharded']} sharded "
        f"tensors; replicated parameters bit-identical after each step; K-B and K-D 21 a step "
        f"a rank; the checkpoint written at tp = 2 restores at tp = 1 bit for bit; peak "
        f"{[round(r['r50_peak_gib'], 2) for r in ranks]} GiB")
    # (c)
    for r in ranks:
        v = r["vith"]
        got = {k: v["launches"][k] for k in v["want"]}
        if got != v["want"] or not np.isfinite(v["loss"]):
            fail(f"tp 15 (c): rank {r['rank']} launched {got}, expected "
                 f"{v['want']}; loss {v['loss']}")
    if ranks[0]["vith"]["replicated"] != ranks[1]["vith"]["replicated"]:
        fail("tp 15 (c): the ranks' replicated parameters differ")
    log(f"[tp] 15 (c): one ViT-H step at tp = 2 with shard_tokens, batch {TP_VITH_BATCH} on "
        f"each rank: ms by rank "
        f"{[round(r['vith']['ms'], 1) for r in ranks]} (the first step), peak "
        f"{[round(r['vith']['peak_gib'], 2) for r in ranks]} GiB a rank, launches a rank "
        f"{ranks[0]['vith']['launches']} (exact), loss {ranks[0]['vith']['loss']:.4f}, "
        f"grad norm {ranks[0]['vith']['grad_norm']:.4f}; spawn to join {spawn_s:.1f} s; "
        f"card {card}")
    record = {"serve_ms": [[s["ms"] for s in r["serve"]] for r in ranks],
              "serve_ka_ms": [[s["ka_ms"] for s in r["serve"]] for r in ranks],
              "serve_kb_ms": [[s["kb_ms"] for s in r["serve"]] for r in ranks],
              "serve_launches": ranks[0]["serve"][-1]["launches"],
              "serve_f32_rel_err": errs, "serve_f32_aligned": aligned,
              "train_f32_worst": f32_worst,
              "r50_ms_per_step": [[s["ms"] for s in r["r50_per_step"]] for r in ranks],
              "r50_launches": ranks[0]["r50_per_step"][-1]["launches"],
              "vith_launches": ranks[0]["vith"]["launches"],
              "vith_peak_gib": [r["vith"]["peak_gib"] for r in ranks],
              "vith_ms": [r["vith"]["ms"] for r in ranks]}
    if failures:
        raise AssertionError(f"phase 15: {len(failures)} checks failed: {failures}")
    return (record, [s for r in ranks for s in r["ka"]], [s for r in ranks for s in r["kb"]],
            [s for r in ranks for s in r["kd"]], [s for r in ranks for s in r["ke"]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    started = time.perf_counter()
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
    pipe_root = tempfile.mkdtemp(prefix="hipie_pipeline_")
    pipe, pipe_kb, pipe_kd = phase_pipeline(dev, card, root=pipe_root)
    missing = [k for k, n in pipe["launches"].items() if n == 0]
    if missing:
        raise AssertionError(f"the pipeline phase never launched {missing}: {pipe['launches']}")
    torch.cuda.empty_cache()
    ov_kb, open_vocab = phase_open_vocab(dev, card)
    torch.cuda.empty_cache()
    bb_kb, backbones = phase_backbones(dev, card)
    torch.cuda.empty_cache()
    br_kb, br_kd, branches = phase_branches(dev, card)
    torch.cuda.empty_cache()
    par_vith, par_ka, par_kb, par_kd, par_ke = phase_parallel_vith(dev, card)
    try:
        par_pair, pair_kb, pair_kd = phase_parallel_pair(dev, card, pipe_root, pipe["eval"])
        torch.cuda.empty_cache()
        last, (last_ka, last_kb, last_kd, last_ke) = phase_last_modules(
            dev, card, pipe_root, vit_train)
    finally:
        shutil.rmtree(pipe_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    tp_rec, tp_ka, tp_kb, tp_kd, tp_ke = phase_tensor_parallel(dev, card)
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
    check_coverage("K-A", vit_cases, serve_ka + train_ka + vit_ka + par_ka + last_ka + tp_ka)
    check_msda_coverage(msda_cases, [s for s in list(kb_per_request) + predict_shapes + train_kb
                                     + vit_kb + pipe_kb + ov_kb + bb_kb + br_kb + par_kb
                                     + pair_kb + last_kb + tp_kb if s])
    check_coverage("K-D", bwd_cases, train_kd + vit_kd + pipe_kd + br_kd + par_kd + pair_kd
                   + last_kd + tp_kd)
    check_coverage("K-E", vit_bwd_cases, vit_ke + par_ke + last_ke + tp_ke)
    # every K-E launch of the ViT-H step on the wgmma design
    from hipie_torch.ops.vit_attention import vit_attention_bwd_design

    ke_designs = {vit_attention_bwd_design(n, hd, kh, kw) for _, n, hd, kh, kw, _ in vit_ke}
    if ke_designs != {"wgmma"}:
        raise AssertionError(f"the ViT-H train step launched K-E on the designs {ke_designs}, "
                             f"expected only the wgmma one")
    kd_designs = check_kd_designs(train_kd + vit_kd + br_kd,
                                  [train["kd_designs"], vit_train["kd_designs"],
                                   branches["train"]["kd_designs"]])
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
    kb["launches_per_open_vocab_call"] = open_vocab["kb_per_call"]
    for name, rec in backbones.items():
        kb[f"launches_per_{name}_call"] = rec["kb_per_call"]
    for name in ("bg_lang", "own_encoder"):
        kb[f"launches_per_{name}_call"] = branches[name]["kb_per_call"]
    for r in (kb, kd):
        r["launches_per_branch_train_step"] = branches["train"]["per_step"][r["name"]]
    kd["branch_train_ms_per_step"] = branches["train"]["ms_per_step"]
    kd["branch_train_peak_gib"] = branches["train"]["peak_gib"]
    kd["branch_train_crit_bg_lang_ms"] = branches["train"]["crit_bg_lang_ms"]
    for r in records:
        if r["name"] in par_vith["launches_per_step"]:
            r["launches_per_nccl_vit_huge_step"] = (
                par_vith["runs"]["nccl"]["per_step"][-1]["launches"][r["name"]])
        if r["name"] in par_pair["per_step"]:
            r["launches_per_gloo_rank_step"] = par_pair["per_step"][r["name"]]
    for r in records:
        if r["name"] in tp_rec["serve_launches"]:
            r["launches_per_tp2_rank_request"] = tp_rec["serve_launches"][r["name"]]
            r["launches_per_tp2_rank_r50_step"] = tp_rec["r50_launches"][r["name"]]
            r["launches_per_tp2_rank_vit_huge_step"] = tp_rec["vith_launches"][r["name"]]
    for name in ("swin_large_coco_panoptic", "convnext_large_coco_panoptic", "vit_huge_bf16_mu"):
        for r in records:
            if r["name"] in last[name]["per_step"]:
                r[f"launches_per_{name}_train_step"] = last[name]["per_step"][r["name"]]
    kb["ms_per_request"] = msda_ms_per_request(msda_cases, kb_per_request)
    kb["ms_per_request_local"] = msda_ms_per_request(msda_cases, kb_per_request, local=True)
    log(f"[serve] K-B ms per ViT-H request from the shape times and the counted launches "
        f"{kb['launches_per_request_by_case']}: {kb['ms_per_request']:.4f} "
        f"({kb['ms_per_request_local']:.4f} with local encoder locations); card {card}")
    log(f"[smoke] all phases in {time.perf_counter() - started:.1f} s (the kernels' build "
        f"included); card {card}")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
