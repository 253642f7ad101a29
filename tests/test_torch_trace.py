"""The port's spans and counters (hipie_torch/utils/trace.py), on the CPU.

  * with no profiler, ``span`` is one shared null context;
  * a tiny request (``HIPIEModel.forward`` over two images, then
    ``hipie_inference`` of each) under torch.profiler shows every serving span,
    each inside the one it belongs to: the model's parts inside
    ``model.forward``, ``post.nms_scan`` inside ``post.nms`` inside
    ``post.image``, ``post.panoptic`` inside ``post.image``;
  * a tiny training step with ``transformer.remat`` shows ``model.remat``
    inside ``forward`` and again, for the recompute, inside ``backward``;
  * a tiny request's ``host_sync.*`` counts are those of the sites on its
    path, and a step's ``host_sync.matcher_done`` is the matchers' own count;
  * the outputs under the profiler equal those without it, bit for bit.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import contextlib
import dataclasses
import tempfile
import timeit

import pytest
import torch

from hipie_torch.config import apply_overrides, tiny_test_config
from hipie_torch.models.hipie import HIPIEModel, hipie_inference
from hipie_torch.models.postprocess import ClassMaps
from hipie_torch.utils import trace
from hipie_torch.utils.weights import random_init_

B, HW, C = 2, 64, 5
MODEL_SPANS = ("model.backbone", "model.transformer", "model.masks", "model.maskdino")
POST_SPANS = ("post.nms", "post.panoptic")


@pytest.fixture(scope="module")
def served():
    cfg = tiny_test_config()
    model = HIPIEModel(cfg.model).eval()
    random_init_(model, torch.Generator().manual_seed(0))
    L = cfg.model.text.max_query_len
    maps = ClassMaps(torch.eye(C, L), torch.eye(C, L, dtype=torch.bool), torch.arange(C) < 3)
    ids = (torch.arange(L)[None] % 16).expand(B, L)
    am = torch.ones(B, L, dtype=torch.long)
    pad = torch.zeros(B, HW, HW, dtype=torch.bool)
    pad[1, :, HW * 3 // 4:] = True
    sizes = torch.tensor([[HW, HW], [HW, HW * 3 // 4]])
    img = torch.randint(0, 256, (B, HW, HW, 3), generator=torch.Generator().manual_seed(1),
                        dtype=torch.uint8)
    with torch.inference_mode():
        hidden = model.encode_text(ids, am)

    def request():
        with torch.inference_mode():
            out = model(img, pad, ids, am, sizes, lang_hidden=hidden)
            res = [hipie_inference(out, maps, cfg.test, cfg.model, image_index=i,
                                   pad_mask_s4=pad[i][::4, ::4]) for i in range(B)]
        return out, res

    return cfg, model, request, (ids, am)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = fn()
    spans = {}
    for e in prof.events():
        if e.name.startswith(("model.", "post.")) or e.name in ("forward", "backward"):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return got, spans


def _inside(inner, outer):
    return all(any(o0 <= s and e <= o1 for o0, o1 in outer) for s, e in inner)


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("model.forward"), trace.span("post.nms")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass
    us = min(timeit.repeat(lambda: trace.span("x"), number=20000, repeat=3)) / 20000 * 1e6
    print(f"span with no profiler: {us:.3f} us a call")


def test_serving_spans_nest_as_the_request_does(served):
    cfg, model, request, (ids, am) = served
    (_, res), spans = _profiled(request)
    forward = spans["model.forward"]
    assert len(forward) == 1
    for name in MODEL_SPANS:
        assert len(spans[name]) == 1 and _inside(spans[name], forward), name
    image = spans["post.image"]
    assert len(image) == B and not _inside(image, forward)
    for name in POST_SPANS:
        assert len(spans[name]) == B and _inside(spans[name], image), name
    assert len(spans["post.nms_scan"]) == B and _inside(spans["post.nms_scan"], spans["post.nms"])
    assert "model.remat" not in spans          # no checkpointing when serving
    _, text = _profiled(lambda: model.encode_text(ids, am))
    assert len(text["model.text"]) == 1


def test_request_outputs_equal_with_the_profiler_on(served):
    _, _, request, _ = served
    out0, res0 = request()
    (out1, res1), _ = _profiled(request)
    flat0 = {k: v for k, v in out0.items() if torch.is_tensor(v)}
    assert flat0 and all(torch.equal(v, out1[k]) for k, v in flat0.items())
    for k in ("pred_logits", "pred_masks"):
        assert torch.equal(out0["maskdino"][k], out1["maskdino"][k])
    for r0, r1 in zip(res0, res1):
        for a, b in zip(r0, r1):
            assert (a is None and b is None) or torch.equal(a, b)


def test_request_host_syncs_are_its_sites(served):
    cfg, _, request, _ = served
    t = cfg.model.transformer
    before = dict(trace.COUNTS)
    request()
    got = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items()
           if k.startswith("host_sync.") and v != before.get(k, 0)}
    assert got == {
        "host_sync.normalize": 2,                          # pixel mean and std
        "host_sync.proposal_wh": t.num_feature_levels,     # a level's (w, h)
        "host_sync.msda_normalizer": t.num_encoder_layers,  # 2-d reference points
        "host_sync.nms_to_host": B,                        # an image's IoU matrix
        "host_sync.nms_to_device": B,                      # its keep mask back
    }


def test_remat_spans_in_the_forward_and_the_recompute():
    from hipie_torch.losses import matcher
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.synthetic import train_batches
    from hipie_torch.utils.rng import GeneratorKeys

    cfg = apply_overrides(tiny_test_config(), {"model.transformer.remat": True})
    cfg = dataclasses.replace(cfg, output_dir=tempfile.mkdtemp())
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, state, device="cpu")
    batch = train_batches(cfg, 1, 0, img=HW, slots=6, batch=B)[0]
    keys = GeneratorKeys(torch.Generator().manual_seed(0))
    s0, c0 = matcher.HOST_SYNCS[0], trace.COUNTS["host_sync.matcher_done"]
    (_, metrics), spans = _profiled(lambda: step(state, batch, keys))
    assert torch.isfinite(metrics["total_loss"])
    t = cfg.model.transformer
    layers = t.num_encoder_layers + t.num_decoder_layers
    remat = spans["model.remat"]
    in_forward = [sp for sp in remat if _inside([sp], spans["forward"])]
    in_backward = [sp for sp in remat if _inside([sp], spans["backward"])]
    assert len(in_forward) == layers and len(in_backward) == layers
    assert len(remat) == 2 * layers
    assert trace.COUNTS["host_sync.matcher_done"] - c0 == matcher.HOST_SYNCS[0] - s0 > 0
