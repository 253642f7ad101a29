"""ViT training in the port against the JAX package, on the CPU.

  * ``vit_attention_bwd_plain`` (the plain version of kernel K-E) against the
    JAX package's backward of ``vit_global_attention`` (``_bwd_rule``: the
    ``jax.vjp`` of ``_attention_xla``), f32, relative norm 1e-5;
  * ``ViTAttentionFunction`` (the autograd the card runs K-A and K-E through)
    against autograd of ``vit_attention_plain``;
  * ``use_kernel_attention`` against the condition under which JAX's
    ``ViTAttention`` takes its Pallas kernel (its backend term faked to TPU,
    the kernel replaced by a recorder), over dtypes and token counts;
  * drop path: a block with given keep masks, and the narrow ``ViTDet`` in
    train mode (outputs and every parameter's gradient by ``jax.grad``) with
    the masks JAX draws replaced by the same numpy masks (``jax.random.bernoulli``
    patched for the test), with activation checkpointing on and off, 3e-5;
  * one CPU ``make_train_step`` step with the narrow ViT, drop path and remat:
    every trainable parameter gets a finite gradient.

Inputs come from numpy seeds; f32 unless a test says otherwise. Nothing in the
JAX package changes: the tests patch its module attributes for their duration.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import dataclasses
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hipie_tpu.models.backbone.vit as jvit
import hipie_torch.models.backbone.vit as tvit
from hipie_tpu.ops.pallas import vit_attention_kernel as K
from hipie_tpu.utils import export as ex
from hipie_torch.ops.vit_attention import (ViTAttentionFunction, vit_attention_bwd_plain,
                                           vit_attention_forward, vit_attention_plain)

NARROW = (64, 4, 4, 0.5)           # embed_dim, depth, heads, drop path: blocks 0, 1, 3 windowed


@pytest.fixture(autouse=True)
def _no_trace_overrides(monkeypatch):
    for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
        monkeypatch.delenv(var, raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _attention_inputs(bh, kh, kw, hd, seed):
    r = np.random.RandomState(seed)
    n = kh * kw
    return (r.randn(bh, n, hd).astype(np.float32), r.randn(bh, n, hd).astype(np.float32),
            r.randn(bh, n, hd).astype(np.float32), 0.5 * r.randn(bh, n, kh).astype(np.float32),
            0.5 * r.randn(bh, n, kw).astype(np.float32), r.randn(bh, n, hd).astype(np.float32))


@pytest.mark.parametrize("kh,kw", [(8, 8), (4, 8)])
@pytest.mark.parametrize("hd", [16, 80])
def test_bwd_plain_matches_jax_bwd_rule(kh, kw, hd):
    q, k, v, rh, rw, g = _attention_inputs(2, kh, kw, hd, seed=hd + kh)
    scale = hd ** -0.5
    want = K._bwd_rule(scale, tuple(map(jnp.asarray, (q, k, v, rh, rw))), jnp.asarray(g))
    tq, tk, tv, trh, trw, tg = map(torch.from_numpy, (q, k, v, rh, rw, g))
    out, lse = vit_attention_forward(tq, tk, tv, trh, trw, scale)
    got = vit_attention_bwd_plain(tq, tk, tv, trh, trw, out, lse, tg, scale)
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _rel(a.numpy(), b) <= 1e-5, (name, _rel(a.numpy(), b))


@pytest.mark.parametrize("bh,kh,kw,hd", [(2, 4, 8, 16), (3, 5, 5, 80)])
def test_autograd_function_matches_plain_autograd(bh, kh, kw, hd):
    arrays = _attention_inputs(bh, kh, kw, hd, seed=7)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    g = torch.from_numpy(arrays[5])
    scale = hd ** -0.5
    out = ViTAttentionFunction.apply(*leaves, scale)
    got = torch.autograd.grad(out, leaves, g)
    want_out = vit_attention_plain(*leaves, scale)
    want = torch.autograd.grad(want_out, leaves, g)
    torch.testing.assert_close(out, want_out, rtol=1e-6, atol=1e-6)
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5, name


def _jax_takes_kernel(monkeypatch, dtype, h, w, use_rel_pos=True):
    """Whether JAX's ViTAttention, traced on a TPU backend, calls its kernel."""
    calls = []

    def recorder(q, k, v, rel_h, rel_w, scale):
        calls.append(q.shape)
        return K._attention_xla(q, k, v, rel_h, rel_w, scale)

    monkeypatch.setattr(K, "vit_global_attention", recorder)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    mod = jvit.ViTAttention(32, 2, use_rel_pos=use_rel_pos, input_size=(h, w), dtype=dtype)
    jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.zeros((1, h, w, 32), dtype))
    return bool(calls)


@pytest.mark.parametrize("h,w", [(16, 16), (30, 40), (32, 32), (32, 40), (16, 80), (64, 64)])
def test_kernel_dispatch_matches_jax(monkeypatch, h, w):
    for jdtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = _jax_takes_kernel(monkeypatch, jdtype, h, w)
        assert tvit.use_kernel_attention(tdtype, True, h * w) == want, (jdtype, h, w)
    assert not _jax_takes_kernel(monkeypatch, jnp.bfloat16, h, w, use_rel_pos=False)
    assert not tvit.use_kernel_attention(torch.bfloat16, False, h * w)


class _Masks:
    """Stands in for jax.random.bernoulli in ViTBlock._drop_path: returns the
    given keep masks (depth, 2, B), the block found from the rate JAX passes
    (1 - keep, linear in the block index) and the branch from the call order
    (attention, then MLP, in every trace of a block)."""

    def __init__(self, masks, rate, depth):
        self.masks = jnp.asarray(masks)
        self.rate, self.depth = rate, depth
        self.calls = 0

    def __call__(self, rng, keep, shape):
        branch = self.calls % 2
        self.calls += 1
        if self.depth == 1:
            idx = 0
        else:
            idx = jnp.round((1.0 - keep) * (self.depth - 1) / self.rate).astype(jnp.int32)
        return self.masks[idx, branch].reshape(shape).astype(bool)


def _block_sd(params, prefix=""):
    sd = {}
    ex.inv_norm(params["norm1"], f"{prefix}norm1", sd)
    ex.inv_norm(params["norm2"], f"{prefix}norm2", sd)
    ex.inv_linear(params["attn"]["qkv"], f"{prefix}attn.qkv", sd)
    ex.inv_linear(params["attn"]["proj"], f"{prefix}attn.proj", sd)
    sd[f"{prefix}attn.rel_pos_h"] = np.asarray(params["attn"]["rel_pos_h"])
    sd[f"{prefix}attn.rel_pos_w"] = np.asarray(params["attn"]["rel_pos_w"])
    ex.inv_linear(params["mlp_fc1"], f"{prefix}mlp.fc1", sd)
    ex.inv_linear(params["mlp_fc2"], f"{prefix}mlp.fc2", sd)
    return sd


def _random_params(module, *args, seed, std=0.2):
    """The module's parameter tree, shaped by tracing its init (not running
    it), filled from a numpy seed."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda x: (std * r.randn(*x.shape)).astype(np.float32), shapes)


def _to_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_drop_path_block_matches_jax(monkeypatch, rate):
    """One global ViTBlock in train mode: JAX's _drop_path formula with its
    Bernoulli draw replaced by the masks the port's block is given."""
    b, h, w, dim = 3, 8, 8, 32
    x = np.random.RandomState(1).randn(b, h, w, dim).astype(np.float32)
    masks = np.array([[[1, 0, 1], [0, 1, 1]]], np.float32)       # (1 block, 2 branches, B)
    jb = jvit.ViTBlock(dim, 2, input_size=(h, w))
    params = _random_params(jb, x, seed=2)
    monkeypatch.setattr(jax.random, "bernoulli", _Masks(masks, rate, 1))
    want = np.asarray(jb.apply({"params": params}, x, False, rate,
                               rngs={"dropout": jax.random.PRNGKey(3)}))
    tb = tvit.ViTBlock(dim, 2, input_size=(h, w), drop_path=rate)
    tb.load_state_dict(_to_torch(_block_sd(params)), strict=True)
    with torch.no_grad():
        got = tb(torch.from_numpy(x), torch.from_numpy(masks[0])).numpy()
        ident = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if rate > 0:                          # the masks matter; None is eval's identity
        assert np.abs(got - ident).max() > 1e-2


def test_drop_path_rates_match_jax(monkeypatch):
    """ViT-H's schedule (depth 32, rate 0.5, linear from 0) at a tiny width:
    a forward in train mode with per-block random keep masks against JAX's.
    The stand-in for JAX's draw finds each block from the keep JAX passes, so
    a schedule that differed would scale other blocks than the port's."""
    # all blocks global: one scanned run, so JAX compiles one body
    kw = dict(img_size=64, patch_size=16, embed_dim=16, depth=32, num_heads=2, window_size=2,
              window_block_indexes=(), drop_path_rate=0.5)
    r = np.random.RandomState(4)
    img = r.randn(1, 64, 64, 3).astype(np.float32)
    masks = (r.uniform(size=(32, 2, 1)) < 0.6).astype(np.float32)
    jm = jvit.ViTDet(**kw)
    params = _random_params(jm, img, seed=5, std=0.1)
    monkeypatch.setattr(jax.random, "bernoulli", _Masks(masks, 0.5, 32))
    want = jm.apply({"params": params}, img, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(1)})["res4"]
    sd = {}
    ex.inv_vit(params, "", sd)
    tm = tvit.ViTDet(**kw)
    tm.load_state_dict(_to_torch(sd), strict=True)
    assert [blk.drop_path for blk in tm.blocks] == tvit.drop_path_rates(0.5, 32)
    with torch.no_grad():
        got = tm(torch.from_numpy(img), drop_masks=torch.from_numpy(masks))["res4"].numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-5, atol=3e-5)


@pytest.fixture(scope="module")
def narrow_vit():
    """The narrow ViTDet (4 blocks: 0, 1, 3 windowed at 4, block 2 global, 8x8
    tokens), drop path 0.5, JAX parameters from a numpy seed, an image batch of
    2, fixed keep masks and output weights for a scalar loss."""
    kw = dict(img_size=128, patch_size=16, embed_dim=64, depth=4, num_heads=4, window_size=4,
              drop_path_rate=0.5)
    r = np.random.RandomState(0)
    img = r.randn(2, 128, 128, 3).astype(np.float32)
    params = _random_params(jvit.ViTDet(**kw), img, seed=1)
    masks = np.array([[[1, 1], [1, 1]], [[0, 1], [1, 0]], [[1, 0], [0, 1]], [[0, 1], [1, 1]]],
                     np.float32)
    shapes = {"res3": (2, 16, 16, 32), "res4": (2, 8, 8, 64), "res5": (2, 4, 4, 64)}
    weights = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return kw, img, params, masks, weights


def _jax_loss_and_grads(kw, img, params, masks, weights, remat, monkeypatch):
    jm = jvit.ViTDet(**kw, remat=remat)
    monkeypatch.setattr(jax.random, "bernoulli", _Masks(masks, kw["drop_path_rate"], kw["depth"]))

    def loss(p):
        out = jm.apply({"params": p}, img, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(5)})
        return sum((out[k] * weights[k]).sum() for k in weights), out

    (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(value), jax.device_get(out), jax.device_get(grads)


@pytest.mark.parametrize("remat", [False, True])
def test_narrow_vitdet_train_matches_jax(narrow_vit, monkeypatch, remat):
    kw, img, params, masks, weights = narrow_vit
    value, jout, jgrads = _jax_loss_and_grads(kw, img, params, masks, weights, remat,
                                              monkeypatch)
    sd, want_grads = {}, {}
    ex.inv_vit(params, "", sd)
    ex.inv_vit(jgrads, "", want_grads)
    tm = tvit.ViTDet(**kw, remat=remat)
    tm.load_state_dict(_to_torch(sd), strict=True)
    out = tm(torch.from_numpy(img), drop_masks=torch.from_numpy(masks))
    loss = sum((out[k] * torch.from_numpy(w)).sum() for k, w in weights.items())
    loss.backward()
    for k in weights:
        np.testing.assert_allclose(out[k].detach().numpy(), jout[k], rtol=3e-5, atol=3e-5,
                                   err_msg=k)
    assert abs(loss.item() - value) <= 3e-5 * max(1.0, abs(value))
    names = dict(tm.named_parameters())
    assert set(names) == set(want_grads)
    for name, p in names.items():
        want = want_grads[name]
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(p.grad.numpy() - want).max() / scale
        assert err <= 3e-5, (name, err)
    # the global block's rel-pos tables get a gradient where its attention was kept
    assert np.abs(names["blocks.2.attn.rel_pos_h"].grad.numpy()).max() > 0


def test_narrow_vit_train_step_gives_every_parameter_a_gradient(monkeypatch):
    """One CPU make_train_step step with the narrow ViT (drop path 0.5,
    backbone and transformer remat): every trainable parameter gets a finite
    gradient, frozen ones none, and the drop masks are drawn."""
    import hipie_torch.config as tconfig
    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.train.synthetic import train_batches
    from hipie_torch.utils.rng import GeneratorKeys

    monkeypatch.setitem(tvit.VIT_VARIANTS, "vit_narrow", NARROW)
    cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), {
        "model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 128,
        "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True,
        "model.backbone.vit_remat": True, "model.transformer.remat": True})
    cfg = dataclasses.replace(cfg, output_dir=tempfile.mkdtemp())
    state = create_train_state(cfg, seed=0, device="cpu")
    backbone = state.model.detr.detr.backbone[0].backbone
    drawn = []
    draw = backbone.draw_drop_masks
    backbone.draw_drop_masks = lambda *a: drawn.append(draw(*a)) or drawn[-1]
    step = make_train_step(cfg, state, device="cpu")
    batch = train_batches(cfg, 1, 0, img=128, slots=6, batch=2)[0]
    state, metrics = step(state, batch, GeneratorKeys(torch.Generator().manual_seed(0)))
    assert torch.isfinite(metrics["total_loss"])
    assert len(drawn) == 1 and drawn[0].shape == (4, 2, 2)
    for name, p in state.model.named_parameters():
        if state.optimizer.labels[name] == "frozen":
            assert p.grad is None, name
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
