"""The model's option branches in the port against the JAX package, on the CPU
in f32 at tiny_test_config (a ResNet-18):

  * the inference forward with all four branch options on at once:
    language-derived bg queries (``bg_lang_weights``, 2 stuff classes),
    MaskDINO's own encoder (``maskdino.shared_encoder=False``), the in-encoder
    BERT layers (``transformer.use_extra_bert_layers``, weights through
    ``export_lang_layers``) and the non-decoupled content queries
    (``transformer.decouple_tgt=False``); one JAX compile serves all four, and
    each option is shown to change the port's outputs, so that the comparison
    covers it. The canvas is 64x96 with the image in the first 80 columns.
    Limits: the two-stage top-k indices equal; every output within 1e-4 of its
    largest magnitude (f32 round-off through the stacks);
  * ``hipie_inference(n_bg_lang=)`` on those outputs, and on synthetic outputs
    without MaskDINO (the bg branch then reads the bg_lang block) in both
    panoptic modes: scores and boxes 1e-4, mask logits 1e-3 of their scale,
    classes and maps exact, as tests/test_torch_predictor.py;
  * C-6, ``text.remat``: the BERT encoder's outputs and gradients equal with
    and without it, its layers recomputed in the backward under it;
  * C-7, ``backbone.frozen_stages``: the ResNet's gradients against
    ``jax.grad`` of JAX's at 0, 1 and 2 (1e-4 relative L2; exactly zero
    where JAX stops the gradient), and the optimizer's decay of a stage that
    the stop-gradient reaches but the frozen group does not.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hipie_tpu.config as jconfig
import hipie_torch.config as tconfig
from test_torch_train_common import _fill, to_numpy_tree

BRANCHES = {"model.bg_query_from_lang": True, "model.maskdino.shared_encoder": False,
            "model.transformer.use_extra_bert_layers": True,
            "model.transformer.decouple_tgt": False}
BASE = {"model.backbone.resnet_depth": 18}
# XLA's cheaper CPU pipeline: the compiles are most of this file's time
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
B, H, W, L = 1, 64, 96, 16
VALID_W = 80


def run_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def branch_config(pkg=tconfig, **extra):
    return pkg.apply_overrides(pkg.tiny_test_config(), {**BASE, **BRANCHES, **extra})


def _inputs():
    r = np.random.RandomState(0)
    img = r.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    pad = np.zeros((B, H, W), bool)
    pad[:, :, VALID_W:] = True
    ids = (np.arange(L)[None] * 7 % 100 + 1).astype(np.int32)
    am = np.ones((B, L), np.int32)
    am[:, 13:] = 0
    sizes = np.array([[H, VALID_W]], np.int32)
    # two stuff classes: one token, and two tokens half each
    blw = np.zeros((2, L), np.float32)
    blw[0, 3] = 1.0
    blw[1, 5:7] = 0.5
    return (img, pad, ids, am, sizes), blw


def _maps(pkg_maps, n_cls=4):
    """4 classes over the prompt's tokens, the last two stuff (the bg_lang rows)."""
    mw = np.zeros((n_cls, L), np.float32)
    tm = np.zeros((n_cls, L), bool)
    for c, toks in enumerate(([1], [8, 9], [3], [5, 6])):
        mw[c, toks] = 1.0 / len(toks)
        tm[c, toks] = True
    return pkg_maps(mw, tm, np.arange(n_cls) < 2)


def _port(cfg, params_np, inputs, blw, strict=True):
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.utils.export import export_hipie_checkpoint, export_lang_layers

    model = HIPIEModel(cfg.model).eval()
    sd = {**export_hipie_checkpoint(params_np, cfg), **export_lang_layers(params_np, cfg)}
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=strict)
    img, pad, ids, am, sizes = (torch.from_numpy(x) for x in inputs)
    with torch.no_grad():
        out = model(img, pad, ids.long(), am, sizes,
                    bg_lang_weights=None if blw is None else torch.from_numpy(blw))
    return model, out


@pytest.fixture(scope="module")
def forward():
    from hipie_tpu.models.hipie import HIPIEModel as JModel

    jcfg, cfg = branch_config(jconfig), branch_config()
    inputs, blw = _inputs()
    jm = JModel(jcfg.model)
    args = tuple(jnp.asarray(x) for x in inputs)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            bg_lang_weights=jnp.asarray(blw)))
    r = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, s: _fill("/".join(str(getattr(k, "key", k)) for k in kp), s.shape, r), shapes)
    want = run_jit(lambda p, *a: jm.apply(p, *a, bg_lang_weights=jnp.asarray(blw)), params, *args)
    params_np = to_numpy_tree(params["params"])
    model, got = _port(cfg, params_np, inputs, blw)
    return cfg, jcfg, params_np, inputs, blw, model, got, want


def test_strict_load_covers_every_branch_parameter(forward):
    """The own encoder's projections, level embedding and layers, and the
    in-encoder BERT layers load strictly under the names the docstrings give."""
    cfg, _, _, _, _, model, _, _ = forward
    keys = set(model.state_dict())
    pix = "detr.mask_dino.pixel_decoder"
    for key in (f"{pix}.transformer.level_embed", f"{pix}.input_proj.0.0.weight",
                f"{pix}.input_proj.2.1.bias", f"{pix}.input_proj.3.0.weight",
                f"{pix}.transformer.encoder.layers.1.self_attn.sampling_offsets.weight",
                "detr.detr.transformer.encoder.lang_layers.1.attention.self.query.weight",
                "detr.detr.transformer.encoder.lang_layers.0.output.LayerNorm.bias"):
        assert key in keys, key
    n_lang = {k.split(".")[5] for k in keys if ".encoder.lang_layers." in k}
    assert n_lang == {str(i) for i in range(cfg.model.transformer.num_encoder_layers)}


def _top_k(cls, coord_unact, k, lib):
    """The two-stage top-k over valid proposals (invalid ones carry ~1e9 coords)."""
    if lib is torch:
        valid = coord_unact.abs().amax(-1) < 1e8
        return cls[..., 0].masked_fill(~valid, torch.finfo(torch.float32).min).topk(k).indices
    valid = jnp.abs(coord_unact).max(-1) < 1e8
    return jax.lax.top_k(jnp.where(valid, cls[..., 0], jnp.finfo(jnp.float32).min), k)[1]


def test_forward_matches_jax(forward):
    cfg, _, _, _, blw, _, got, want = forward
    tc = cfg.model.transformer
    q = blw.shape[0] + tc.num_bg_queries + tc.num_queries
    assert got["pred_logits"].shape[1] == q == want["pred_logits"].shape[1]
    k = tc.two_stage_num_proposals
    np.testing.assert_array_equal(
        _top_k(got["enc_outputs_class"], got["enc_outputs_coord_unact"], k, torch).numpy(),
        np.asarray(_top_k(want["enc_outputs_class"], want["enc_outputs_coord_unact"], k, jnp)))
    pairs = [(n, got[n], want[n]) for n in ("pred_logits", "pred_boxes", "pred_masks",
                                            "pred_boxious", "enc_outputs_class",
                                            "init_reference", "lang_hidden")]
    pairs += [(f"maskdino {n}", got["maskdino"][n], want["maskdino"][n])
              for n in ("pred_logits", "pred_masks", "pred_boxes")]
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    # the bg_lang slots' references are zero boxes
    assert not np.asarray(want["init_reference"])[:, :blw.shape[0]].any()
    assert not got["init_reference"][:, :blw.shape[0]].any()


@pytest.mark.parametrize("option", sorted(BRANCHES))
def test_each_option_changes_the_output(forward, option):
    """Each option, turned off alone (its own weights left out), moves the
    port's outputs: the comparison above covers every branch."""
    cfg, _, params_np, inputs, blw, _, got, _ = forward
    off = {"model.bg_query_from_lang": False, "model.maskdino.shared_encoder": True,
           "model.transformer.use_extra_bert_layers": False,
           "model.transformer.decouple_tgt": True}[option]
    cfg_off = branch_config(**{option: off})
    no_blw = option == "model.bg_query_from_lang"
    _, other = _port(cfg_off, params_np, inputs, None if no_blw else blw, strict=False)
    key = "maskdino" if option == "model.maskdino.shared_encoder" else "pred_logits"
    a = got[key]["pred_masks"] if key == "maskdino" else got[key]
    b = other[key]["pred_masks"] if key == "maskdino" else other[key]
    if no_blw:
        assert b.shape[1] == a.shape[1] - blw.shape[0]
        a = a[:, blw.shape[0]:]
    assert not torch.allclose(a, b, atol=1e-3), option


def _jax_maps():
    from hipie_tpu.models.postprocess import ClassMaps

    return _maps(lambda *a: ClassMaps(*(jnp.asarray(x) for x in a)))


def _port_maps():
    from hipie_torch.models.postprocess import ClassMaps

    return _maps(lambda *a: ClassMaps(*(torch.from_numpy(np.asarray(x)) for x in a)))


def _compare_results(got, want, detection=True):
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-4)
    wm = np.asarray(want.mask_logits)
    np.testing.assert_allclose(got.mask_logits.numpy(), wm, rtol=0, atol=1e-3 * np.abs(wm).max())
    if detection:
        np.testing.assert_allclose(got.sem_seg.numpy(), np.asarray(want.sem_seg), rtol=1e-4,
                                   atol=1e-4)
        for name in ("panoptic", "segment_valid", "segment_classes", "segment_isthing"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)


def test_inference_with_bg_lang_matches_jax(forward):
    """hipie_inference(n_bg_lang=2) on the forward's outputs: fg from slot
    2 + num_bg_queries on, panoptic and semantic maps from MaskDINO."""
    from hipie_tpu.models.hipie import hipie_inference as jinference
    from hipie_torch.models.hipie import hipie_inference

    cfg, jcfg, _, inputs, blw, _, got, want = forward
    pad4 = inputs[1][0][::4, ::4]
    jres = run_jit(lambda o, m, p: jinference(o, m, jcfg.test, jcfg.model, pad_mask_s4=p,
                                              n_bg_lang=2), want, _jax_maps(), pad4)
    tres = hipie_inference(got, _port_maps(), cfg.test, cfg.model,
                           pad_mask_s4=torch.from_numpy(pad4), n_bg_lang=blw.shape[0])
    _compare_results(tres, jres)


@pytest.mark.parametrize("use_bg_for_pano", [False, True])
def test_inference_reads_the_bg_lang_block_without_maskdino(use_bg_for_pano):
    """Synthetic outputs, no MaskDINO: the bg branch reads the bg_lang block
    (3 queries in front) and the fg queries start after both bg blocks."""
    from hipie_tpu.models.hipie import hipie_inference as jinference
    from hipie_torch.models.hipie import hipie_inference

    over = {"test.use_bg_for_pano": use_bg_for_pano, "model.maskdino.enabled": False}
    cfg, jcfg = branch_config(**over), branch_config(jconfig, **over)
    n_bgl, q = 3, 3 + cfg.model.transformer.num_bg_queries + cfg.model.transformer.num_queries
    r = np.random.RandomState(5)
    out = {"pred_logits": r.randn(1, q, L).astype(np.float32) * 3,
           "pred_boxes": r.uniform(0.1, 0.9, (1, q, 4)).astype(np.float32),
           "pred_masks": r.randn(1, q, H // 4, W // 4).astype(np.float32) * 4,
           "pred_boxious": r.randn(1, q, 1).astype(np.float32)}
    jres = run_jit(lambda o, m: jinference(o, m, jcfg.test, jcfg.model, n_bg_lang=n_bgl),
                   {k: jnp.asarray(v) for k, v in out.items()}, _jax_maps())
    tres = hipie_inference({k: torch.from_numpy(v) for k, v in out.items()}, _port_maps(),
                           cfg.test, cfg.model, n_bg_lang=n_bgl)
    _compare_results(tres, jres)


def test_text_remat_recomputes_each_bert_layer():
    """C-6: text.remat reaches the BERT encoder, which then runs each layer under
    torch.utils.checkpoint: the same outputs and gradients, and every layer's
    attention runs again in the backward (the recomputation stops once it has
    rebuilt what the backward needs, so it is counted at the layer's first
    submodule)."""
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.models.text.bert import BertModel

    cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), {**BASE, "model.text.remat": True})
    assert HIPIEModel(cfg.model).text_encoder.model.remat
    t = cfg.model.text
    geometry = dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size, num_layers=3,
                    num_heads=t.num_heads, intermediate_size=t.intermediate_size,
                    max_position_embeddings=t.max_position_embeddings)
    torch.manual_seed(0)
    plain = BertModel(**geometry)
    remat = BertModel(**geometry, remat=True)
    remat.load_state_dict(plain.state_dict(), strict=True)
    ids = torch.from_numpy((np.arange(2 * L).reshape(2, L) * 5 % t.vocab_size))
    mask = torch.ones(2, L, dtype=torch.long)
    mask[1, 11:] = 0
    cot = torch.randn(2, L, t.hidden_size)
    runs = {}
    for name, m in (("plain", plain), ("remat", remat)):
        calls = []
        hooks = [layer.attention.register_forward_hook(lambda *a, i=i: calls.append(i))
                 for i, layer in enumerate(m.encoder.layer)]
        out = m(ids, mask)
        n_forward = len(calls)
        (out * cot).sum().backward()
        for h in hooks:
            h.remove()
        runs[name] = (out.detach(), {k: p.grad for k, p in m.named_parameters()},
                      n_forward, len(calls))
    (out_p, grads_p, fwd_p, all_p), (out_r, grads_r, fwd_r, all_r) = runs["plain"], runs["remat"]
    assert fwd_p == fwd_r == all_p == 3 and all_r == 6
    torch.testing.assert_close(out_r, out_p, rtol=0, atol=0)
    for k, g in grads_p.items():
        torch.testing.assert_close(grads_r[k], g, rtol=1e-6, atol=1e-7, msg=k)


@pytest.fixture(scope="module")
def resnet_grads():
    """(JAX gradients, port gradients) of <ResNet-18 maps, cotangents> by
    frozen_stages, the backbone built by each package's build_backbone."""
    from hipie_tpu.models.backbone import build_backbone as jbuild
    from hipie_tpu.utils import export as ex
    from hipie_torch.models.backbone import build_backbone

    img = np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32)
    out = {}
    for frozen in (0, 1, 2):
        over = {"model.backbone.frozen_stages": frozen}
        jcfg = jconfig.apply_overrides(jconfig.tiny_test_config(), {**BASE, **over})
        cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), {**BASE, **over})
        jm, _ = jbuild(jcfg.model.backbone, jnp.float32)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img))
        r = np.random.RandomState(4)
        params = jax.tree_util.tree_map_with_path(
            lambda kp, s: _fill("/".join(str(getattr(k, "key", k)) for k in kp), s.shape, r),
            shapes)
        feats = jax.eval_shape(lambda: jm.apply(params, img))
        cot = {k: np.random.RandomState(len(k)).randn(*v.shape).astype(np.float32)
               for k, v in feats.items()}
        loss = lambda p: sum(jnp.vdot(v, cot[k]) for k, v in jm.apply(p, img).items())
        jgrads = to_numpy_tree(run_jit(jax.grad(loss), params)["params"])
        want, sd = {}, {}
        ex.inv_d2_resnet(jgrads, "", want)
        ex.inv_d2_resnet(to_numpy_tree(params["params"]), "", sd)
        tm, _ = build_backbone(cfg.model.backbone)
        assert tm.freeze_at == frozen + 1
        tm.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=True)
        feats_t = tm(torch.from_numpy(img))
        sum((v * torch.from_numpy(cot[k])).sum() for k, v in feats_t.items()).backward()
        out[frozen] = (want, {k: p.grad for k, p in tm.named_parameters()})
    return out


@pytest.mark.parametrize("frozen", [0, 1, 2])
def test_frozen_stages_stop_the_gradient_as_jax(resnet_grads, frozen):
    """C-7: every convolution's gradient against jax.grad (1e-4 relative L2);
    where JAX's stop-gradient zeroes it, the port's is None (no gradient flowed)."""
    want, got = resnet_grads[frozen]
    stopped = ["stem"] + [f"res{k}" for k in range(2, frozen + 2)]
    for name, g in got.items():
        w = want[name].astype(np.float64)
        if name.split(".")[0] in stopped:
            assert g is None and not w.any(), name
            continue
        assert g is not None and np.linalg.norm(w) > 0, name
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= 1e-4, (name, err)
    if frozen == 2:
        assert got["res3.0.conv1.weight"] is None and got["res4.0.conv1.weight"].any()


def test_frozen_stage_past_res2_keeps_weight_decay():
    """At frozen_stages=2, res3 is detached but not in the frozen group (which
    is the stem and res2 by name, as JAX's optimizer): its zero gradient still
    takes AdamW's decoupled decay, as optax applies it; res2 does not move."""
    from hipie_torch.models.backbone import build_backbone
    from hipie_torch.train.optimizer import GroupedAdamW

    cfg = tconfig.apply_overrides(tconfig.tiny_test_config(),
                                  {**BASE, "model.backbone.frozen_stages": 2,
                                   "solver.warmup_iters": 0})
    holder = torch.nn.Module()
    holder.detr = torch.nn.Module()
    holder.detr.backbone, _ = build_backbone(cfg.model.backbone)
    opt = GroupedAdamW(cfg.solver, holder)
    before = {k: p.detach().clone() for k, p in holder.named_parameters()}
    feats = holder.detr.backbone(torch.randn(1, 64, 64, 3))
    sum(v.square().mean() for v in feats.values()).backward()
    assert holder.detr.backbone.res3[0].conv1.weight.grad is None
    opt.step()
    lr = cfg.solver.base_lr * cfg.solver.backbone_lr_mult
    res3 = "detr.backbone.res3.0.conv1.weight"
    assert opt.labels[res3] == "backbone" and opt.labels["detr.backbone.res2.0.conv1.weight"] == "frozen"
    torch.testing.assert_close(dict(holder.named_parameters())[res3],
                               before[res3] * (1 - lr * cfg.solver.weight_decay))
    torch.testing.assert_close(dict(holder.named_parameters())["detr.backbone.res2.0.conv1.weight"],
                               before["detr.backbone.res2.0.conv1.weight"], rtol=0, atol=0)
