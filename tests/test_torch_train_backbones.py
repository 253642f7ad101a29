"""Swin and ConvNeXt training against the JAX package on the CPU.

The narrow variants of tests/test_torch_backbones.py (inserted into both
packages' variant tables), f32, drop path 0 (JAX ``deterministic=True``, the
port without keep masks): the backbone's VJP, the gradients of
sum_k <features_k, cotangent_k> with respect to the input and every parameter
(JAX's through the exporter's inverse maps, which are linear, onto the port's
names), each within 1e-4 of the tensor's largest JAX value. The per-block
drop-path rates equal JAX's lists (recorded from its blocks at init). JAX's
drop path draws a key per block through flax's ``make_rng`` and the port one
batch of uniforms for all blocks (ROADMAP), so the draws are held to their
rates, not replayed. Then one CPU step of each through ``make_train_step``
(Swin's drop path on), the backbone's parameters moved.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_torch_backbones import (JAX_VARS, SWIN_NARROW, CONVNEXT_NARROW, _backbones,
                                  fill_params)


@pytest.fixture(autouse=True, scope="module")
def narrow_variants():
    import hipie_tpu.models.backbone.convnext as jconvnext
    import hipie_tpu.models.backbone.swin as jswin
    import hipie_torch.models.backbone.convnext as tconvnext
    import hipie_torch.models.backbone.swin as tswin

    with pytest.MonkeyPatch.context() as mp:
        for var in JAX_VARS:
            mp.delenv(var, raising=False)
        for mod in (jswin, tswin):
            mp.setitem(mod.SWIN_VARIANTS, "swin_narrow", SWIN_NARROW)
        for mod in (jconvnext, tconvnext):
            mp.setitem(mod.CONVNEXT_VARIANTS, "narrow", CONVNEXT_NARROW)
        yield


def _jax_block_rates(jmod, x):
    """Each block's drop-path rate, in block order, as JAX's module sets it."""
    import flax.linen as nn

    rates = []

    def record(next_fun, args, kwargs, context):
        m = context.module
        if context.method_name == "__call__" and type(m).__name__ in ("SwinBlock",
                                                                      "ConvNeXtBlock"):
            rates.append(m.drop_path)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    return rates


@pytest.mark.parametrize("name", ["swin_narrow", "convnext_narrow"])
def test_backbone_vjp_matches_jax(name):
    from hipie_torch.utils.export import inv_convnext, inv_swin

    inv = inv_swin if name.startswith("swin") else inv_convnext
    jmod, mod = _backbones(name)
    mod.train()
    r = np.random.RandomState(2)
    x = r.randn(2, 66, 90, 3).astype(np.float32)
    params = fill_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    sd = {}
    inv(params["params"], "", sd)
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)

    f = lambda p, xx: jmod.apply(p, xx, deterministic=True)
    shapes = jax.eval_shape(f, params, jnp.asarray(x))
    cot = {k: r.randn(*v.shape).astype(np.float32) for k, v in shapes.items()}
    jgrad_p, jgrad_x = jax.device_get(jax.jit(lambda p, xx, c: jax.vjp(f, p, xx)[1](c))(
        params, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cot.items()}))
    want = {}
    inv(jgrad_p["params"], "", want)

    xt = torch.from_numpy(x).requires_grad_(True)
    got = mod(xt)
    assert sorted(got) == sorted(cot) == ["res3", "res4", "res5"]
    sum((got[k] * torch.from_numpy(cot[k])).sum() for k in cot).backward()
    grads = {n: p.grad for n, p in mod.named_parameters()}
    assert set(grads) == set(want) and all(g is not None for g in grads.values())

    def close(g, w, what):
        w = np.asarray(w, np.float64)
        err = float(np.abs(g.numpy().astype(np.float64) - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (what, err, float(np.abs(w).max()))

    close(xt.grad, jgrad_x, "input")
    for n in want:
        close(grads[n], want[n], n)


@pytest.mark.parametrize("name", ["swin_narrow", "convnext_narrow", "swin_large",
                                  "convnext_large"])
def test_drop_path_rates_equal_jax(name):
    """Swin: linear from 0 to 0.2 over every block, as JAX's; ConvNeXt: JAX's
    build_backbone gives it rate 0 (every block's 0.0), and the port's has no
    drop path. Large variants: their lists too, from shapes alone."""
    jmod, mod = _backbones(name)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    want = _jax_block_rates(jmod, x)
    if name.startswith("swin"):
        got = [blk.drop_path for stage in mod.layers for blk in stage.blocks]
        assert got == want and want[-1] == pytest.approx(0.2) and want[0] == 0.0
    else:
        assert len(want) == sum(len(s) for s in mod.stages) and not any(want)
        assert not hasattr(mod.stages[0][0], "drop_path")


@pytest.mark.parametrize("name", ["swin_narrow", "convnext_narrow"])
def test_training_step_on_the_cpu(name, tmp_path):
    """One make_train_step step of the tiny config on each backbone (Swin with
    its drop-path masks drawn): finite loss, every backbone parameter given a
    finite gradient, most of them moved (not all: a norm weight at its init of
    1.0 steps below f32 resolution under the warmup's backbone lr, and behind
    ConvNeXt's layer scales of 1e-6 some gradients are below AdamW's eps)."""
    from test_torch_train_common import batch_arrays, torch_batch, train_config

    from hipie_torch.train.step import create_train_state, make_train_step
    from hipie_torch.utils.rng import GeneratorKeys

    cfg = dataclasses.replace(train_config(**{"model.backbone.name": name}),
                              output_dir=str(tmp_path))
    state = create_train_state(cfg, seed=0, device="cpu")
    backbone = state.model.detr.detr.backbone[0].backbone
    if name.startswith("swin"):
        assert backbone.draw_drop_masks(GeneratorKeys(torch.Generator().manual_seed(0)),
                                        2) is not None
    start = {n: p.detach().clone() for n, p in backbone.named_parameters()}
    step = make_train_step(cfg, state, device="cpu")
    state, metrics = step(state, torch_batch(batch_arrays(0)),
                          GeneratorKeys(torch.Generator().manual_seed(1)))
    assert torch.isfinite(metrics["total_loss"])
    moved = 0
    for n, p in backbone.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        moved += not torch.equal(p.detach(), start[n])
    assert moved > len(start) // 2, (moved, len(start))
