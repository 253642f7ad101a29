"""Serving cells: a closed loop of one client over ``HIPIEModel.forward(...,
lang_hidden=...)`` and ``hipie_inference`` for each image of a request.

Set-up builds the program's model on the card, draws its weights from the
seed in the served dtype, encodes the prompt once, puts the request batches
in pinned host memory and warms the request's one shape. A request copies
its batch to the card (pinned, asynchronous), runs the model and the
post-processing of each image, and ends in one synchronize; its latency is
the host clock's from the copy to the synchronize.

``correct``: a sample of the window's requests, drawn from the seed before the
window opens, keeps what the program produced (the prompt's features, the
model's outputs, its two-stage choices, each image's result). Once the window
has closed and the program is freed, the plain reference (f32, TF32 off) works
the same requests out again and ``judge`` compares (see PERF.md):

* ``text_err``: the prompt's features, relative L2 error;
* ``choice_gap``: each two-stage choice against the reference's own scores;
* ``raw_err``: the largest relative L2 error of the model's outputs (token
  logits, boxes, IoU logits, masks; MaskDINO's logits and masks), the
  reference following the program's choices;
* ``post_err`` / ``post_flips``: each image's result against the reference's
  post-processing of the program's own outputs (``harness.postcheck``): the
  largest error relative to the largest magnitude (the shared instances'
  scores, boxes and mask logits; the semantic map), and the count of discrete
  answers that differ (instances, panoptic pixels, segments) where no
  near-tie within a stated margin could explain them.
"""

from __future__ import annotations

import contextlib
import math
import random
import statistics
import time
from typing import Any, Dict, List

import torch

from harness import common, postcheck, traffic
from harness.choices import Record, Replay

RAW_KEYS = ("pred_logits", "pred_boxes", "pred_boxious", "pred_masks")
MD_KEYS = ("pred_logits", "pred_masks")


def trim(out: Dict[str, Any]) -> Dict[str, Any]:
    """What post-processing reads of the model's outputs."""
    got = {k: out[k] for k in RAW_KEYS if out.get(k) is not None}
    if out.get("maskdino") is not None:
        got["maskdino"] = {k: out["maskdino"][k] for k in MD_KEYS}
    return got


def flat(raw: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    got = {k: v for k, v in raw.items() if k != "maskdino"}
    got.update({f"maskdino.{k}": v for k, v in raw.get("maskdino", {}).items()})
    return got


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


class Side:
    """A served model and its request: the program, the reference or, as the
    control, the reference in lower precision."""

    def __init__(self, mc, test_cfg, model, hipie_inference, maps, mix, dev):
        self.mc, self.test_cfg, self.model = mc, test_cfg, model
        self.hipie_inference, self.maps = hipie_inference, maps
        b = mix["batch"]
        h, w = mix["image"]
        L = mc.text.max_query_len
        self.ids1 = common.prompt_ids(L, mc.text.vocab_size).to(dev)
        self.am1 = torch.ones(1, L, dtype=torch.long, device=dev)
        self.ids, self.am = self.ids1.expand(b, L), self.am1.expand(b, L)
        self.pad = torch.zeros(b, h, w, dtype=torch.bool, device=dev)
        self.pad_s4 = self.pad[0][::4, ::4]
        self.sizes = torch.tensor([[h, w]] * b, device=dev)
        self.b = b
        self.lang = None
        self.lang_b = None

    def encode(self):
        self.lang = self.model.encode_text(self.ids1, self.am1)
        self.lang_b = self.lang.expand(self.b, -1, -1).contiguous()

    def forward(self, x):
        return self.model(x, self.pad, self.ids, self.am, self.sizes, lang_hidden=self.lang_b)

    def post(self, out):
        return [self.hipie_inference(out, self.maps, self.test_cfg, self.mc, image_index=i,
                                     pad_mask_s4=self.pad_s4) for i in range(self.b)]


def program_side(cell, seed: int, dev, marks=None) -> Side:
    from hipie_torch.models import postprocess
    from hipie_torch.models.hipie import HIPIEModel, hipie_inference

    cfg = common.program_config(cell.config)
    mc = cfg.model
    dtype = getattr(torch, cell.config["serve_dtype"])
    with torch.device(dev):
        model = HIPIEModel(mc).eval()
    model.to(dtype)
    if marks is not None:
        marks.append(("model built", time.perf_counter()))
    common.fill_weights_(model, common.weight_seed(cell.config), dtype)
    mix = cell.traffic
    maps = common.class_maps(postprocess, mix["classes"], mix["things"], mc.text.max_query_len,
                             dev)
    return Side(mc, cfg.test, model, hipie_inference, maps, mix, dev)


def reference_side(cell, seed: int, dev) -> Side:
    """The plain reference in f32, its weights drawn again from the seed (in
    the served dtype, so that both sides start from the same numbers)."""
    from hipie_plain.models import postprocess
    from hipie_plain.models.hipie import HIPIEModel, hipie_inference

    cfg = common.reference_config(cell.config)
    mc = cfg.model
    with torch.device(dev):
        model = HIPIEModel(mc).eval()
    model.float()
    common.fill_weights_(model, common.weight_seed(cell.config), getattr(torch, cell.config["serve_dtype"]))
    mix = cell.traffic
    maps = common.class_maps(postprocess, mix["classes"], mix["things"], mc.text.max_query_len,
                             dev)
    return Side(mc, cfg.test, model, hipie_inference, maps, mix, dev)


def request_batches(mix, pool) -> List[torch.Tensor]:
    """The distinct request batches, in pinned host memory where the pool is."""
    n = mix["pool"] // math.gcd(mix["pool"], mix["batch"])
    out = []
    for r in range(n):
        t = pool[traffic.serve_request_images(mix, r)]
        out.append(t.pin_memory() if pool.is_pinned() else t)
    return out


def sample_requests(mix, seed: int) -> List[int]:
    rng = random.Random(int(seed) * 7 + 11)
    return sorted(rng.sample(range(mix["sample_from_first"]), mix["sample_requests"]))


class Served:
    """What one kept request produced."""

    def __init__(self, k: int, raw, choices, results):
        self.k, self.raw, self.choices, self.results = k, raw, choices, results


def run_program(cell, seed: int, seconds: float, dev, t0: float, run, trace=None) -> Dict[str, Any]:
    """Set-up, warm-up and the window; returns the window's numbers and, under
    "kept", the sampled requests' outputs (the program is freed)."""
    from hipie_torch import kernels
    from hipie_torch.models import postprocess as post_mod

    mix = cell.traffic
    marks = [("start", time.perf_counter())]
    side = program_side(cell, seed, dev, marks)
    marks.append(("weights drawn", time.perf_counter()))
    pool = traffic.serve_pool(mix, seed, pin=dev.type == "cuda")
    batches = request_batches(mix, pool)
    marks.append(("pool", time.perf_counter()))
    ks = common.two_stage_ks(side.mc)
    keep = set(sample_requests(mix, seed))
    nms_kept: List[torch.Tensor] = []
    inner_nms = post_mod.nms_keep_mask

    def counting_nms(*a, **kw):
        got = inner_nms(*a, **kw)
        nms_kept.append(got.sum())
        return got

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    kept: List[Served] = []
    with torch.inference_mode(), Record(ks) as rec:
        side.encode()
        sync()
        marks.append(("prompt encoded", time.perf_counter()))

        def request(k: int, keep_it: bool):
            chosen: List[torch.Tensor] = []
            rec.active = chosen
            x = batches[k % len(batches)].to(dev, non_blocking=True)
            out = side.forward(x)
            rec.active = None
            res = side.post(out)
            for cb in run.on_request_end:
                cb()
            sync()
            if keep_it:
                kept.append(Served(k, trim(out), chosen, res))

        for k in range(mix["warmup_requests"]):
            request(len(batches) - 1 - k % len(batches), False)
        sync()
        marks.append(("warm-up requests", time.perf_counter()))
        common.log_marks(marks, t0)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run.model = side.model
        for reader in run.shared.get("readers", []):
            if hasattr(reader, "setup"):
                reader.setup(run)
        post_mod.nms_keep_mask = counting_nms
        kernels.reset_launch_counts()
        smi_start = common.smi() if dev.type == "cuda" else "cpu"
        use0 = common.usage()
        lat: List[float] = []
        k = 0
        ctx = trace if trace is not None else contextlib.nullcontext()
        with ctx:
            with torch.profiler.record_function("bench.window"):
                start = time.perf_counter()
                while True:
                    t = time.perf_counter()
                    if t - start >= seconds:
                        break
                    request(k, k in keep)
                    lat.append(time.perf_counter() - t)
                    k += 1
                end = time.perf_counter()
        post_mod.nms_keep_mask = inner_nms
        run.undo()
    smi_end = common.smi() if dev.type == "cuda" else "cpu"
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    survivors = [int(n) for n in nms_kept]
    launches = dict(kernels.LAUNCHES)
    b = mix["batch"]
    run.images, run.requests, run.window_s = k * b, k, end - start
    run.counters = {"launches": launches, "nms_kept": survivors}
    lang = side.lang.clone()
    del side, batches
    run.model = None
    common.log(f"[work] requests {k} of {b} images {tuple(pool.shape[1:])} uint8; kernel launches "
               f"per image {({n: c / max(k * b, 1) for n, c in launches.items()})}; NMS "
               f"survivors per image: mean {sum(survivors) / max(len(survivors), 1):.2f}, "
               f"first {survivors[:8]}, min {min(survivors, default=0)}, max "
               f"{max(survivors, default=0)}")
    common.log(f"[work] card at the window's start: {smi_start}; at its end: {smi_end}")
    common.log(f"[work] latency ms: median {1e3 * statistics.median(lat) if lat else 0:.3f}, "
               f"quartiles {[round(1e3 * q, 3) for q in statistics.quantiles(lat, n=4)] if len(lat) > 1 else []}, "
               f"max {1e3 * max(lat, default=0):.3f}; {common.usage(use0)}")
    return {"requests": k, "images": k * b, "window_s": end - start, "latencies_s": lat,
            "setup_s": start - t0, "peak": peak, "kept": kept, "lang": lang, "pool": pool}


def judge(cell, seed: int, dev, served: List[Served], lang: torch.Tensor, pool,
          run=None) -> Dict[str, float]:
    """The numbers compared, for what a side served (see the module's doc)."""
    mix = cell.traffic
    batches = request_batches(mix, pool)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference_side(cell, seed, dev)
        ks = common.two_stage_ks(ref.mc)
        vals = {"text_err": 0.0, "choice_gap": 0.0, "raw_err": 0.0, "post_err": 0.0,
                "post_flips": 0.0, "look.post_ties": 0.0}
        with torch.no_grad():
            ref.encode()
            vals["text_err"] = rel_l2(lang, ref.lang)
            for i, s in enumerate(served):
                x = batches[s.k % len(batches)].to(dev)
                with Replay(ks, s.choices) as rp:
                    if i == 0 and run is not None:
                        from torch.utils.flop_counter import FlopCounterMode

                        with FlopCounterMode(display=False) as fc:
                            out = ref.forward(x)
                        run.flops_per_image = fc.get_total_flops() / mix["batch"]
                    else:
                        out = ref.forward(x)
                vals["choice_gap"] = max([vals["choice_gap"], *rp.gaps])
                want = flat(trim(out))
                got = flat(s.raw)
                if set(got) != set(want):
                    vals["raw_err"] = float("inf")
                for key in want:
                    if key in got:
                        vals["raw_err"] = max(vals["raw_err"], rel_l2(got[key], want[key]))
                del out, want
                # the post-processing stage on the side's own outputs
                for img, res in enumerate(s.results):
                    exp = ref.hipie_inference(s.raw, ref.maps, ref.test_cfg, ref.mc,
                                              image_index=img, pad_mask_s4=ref.pad_s4)
                    e, f, t = postcheck.compare(res, exp, s.raw, img, ref)
                    vals["post_err"] = max(vals["post_err"], e)
                    vals["post_flips"] += f
                    vals["look.post_ties"] += t
        return vals
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def control(cell, seed: int, dev, n_requests: int) -> Dict[str, float]:
    """The control's readings: the reference in fp8 (``harness.lowp``) in the
    program's place, serving the first ``n_requests`` sampled requests, judged
    as the program is."""
    from harness.lowp import Fp8Mode

    mix = cell.traffic
    pool = traffic.serve_pool(mix, seed, pin=False)
    batches = request_batches(mix, pool)
    side = reference_side(cell, seed, dev)
    ks = common.two_stage_ks(side.mc)
    served = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad(), Fp8Mode(), Record(ks) as rec:
            side.encode()
            for k in sample_requests(mix, seed)[:n_requests]:
                chosen: List[torch.Tensor] = []
                rec.active = chosen
                out = side.forward(batches[k % len(batches)].to(dev))
                rec.active = None
                served.append(Served(k, trim(out), chosen, side.post(out)))
        lang = side.lang
        del side
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return judge(cell, seed, dev, served, lang, pool)
