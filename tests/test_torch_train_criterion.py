"""The training step's losses, JAX against the port on the CPU, from numpy
seeds in f32: point sampling and the uncertainty pick, the criterion passes
(every matcher, both mask heads) with fixed point coordinates, the encoder
pass, and the loss merge and weights. Tolerances are stated per check: the same f32
arithmetic in another order gives ~1e-6 relative; assignments and integer
outputs must be equal.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_torch_train_common import JaxKeys, train_config
import hipie_tpu.config as jconfig

T = lambda x: torch.from_numpy(np.asarray(x))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def rand_boxes(r, *shape):
    c = r.uniform(0.2, 0.8, shape + (2,))
    wh = r.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


# ---------------------------------------------------------- point sampling

def test_point_sample_values_and_grads_match_bilinear_sample():
    """Values and both gradients (images and coords) of the port's
    point_sample against JAX's bilinear_sample, coords past the edges included."""
    from hipie_tpu.ops.bilinear import bilinear_sample
    from hipie_torch.losses.point_features import point_sample

    r = np.random.RandomState(1)
    img = r.randn(3, 9, 13).astype(np.float32)
    coords = r.uniform(-0.2, 1.2, (3, 40, 2)).astype(np.float32)
    gout = r.randn(3, 40).astype(np.float32)
    out, vjp = jax.vjp(bilinear_sample, jnp.asarray(img), jnp.asarray(coords))
    gi, gc = vjp(jnp.asarray(gout))
    ti, tc = T(img).requires_grad_(True), T(coords).requires_grad_(True)
    got = point_sample(ti, tc)
    got.backward(T(gout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5)
    assert rel(ti.grad, gi) <= 1e-5 and rel(tc.grad, gc) <= 1e-5
    from hipie_tpu.losses.point_features import point_sample_pair as jpair
    from hipie_torch.losses.point_features import point_sample_pair

    other = (r.rand(3, 9, 13) > 0.5).astype(np.float32)
    for g, w in zip(point_sample_pair(T(img), T(other), T(coords)),
                    jpair(jnp.asarray(img), jnp.asarray(other), jnp.asarray(coords))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_uncertain_point_coords_match_jax_exact_topk():
    """The same keys and logits give the same picks as JAX's exact_topk=True."""
    from hipie_tpu.losses.point_features import uncertain_point_coords as juc
    from hipie_torch.losses.point_features import uncertain_point_coords

    r = np.random.RandomState(2)
    logits = (r.randn(4, 12, 12) * 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = juc(key, jnp.asarray(logits), 48, 3.0, 0.75, exact_topk=True)
    got = uncertain_point_coords(JaxKeys(key), T(logits), 48, 3.0, 0.75)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- criterion

def _fixed_coords(monkeypatch, coords):
    """Both packages' criteria sample the mask losses at ``coords``."""
    import hipie_tpu.losses.criterion as jcrit
    import hipie_torch.losses.criterion as tcrit

    monkeypatch.setattr(jcrit, "uncertain_point_coords",
                        lambda *a, **k: jnp.asarray(coords))
    monkeypatch.setattr(tcrit, "uncertain_point_coords", lambda *a, **k: T(coords))


def _targets(r, b=2, n=5, lt=12, hm=16, valid=((1, 1, 1, 0, 0), (1, 1, 0, 0, 0))):
    boxes = rand_boxes(r, b, n)
    masks = (r.rand(b, n, hm, hm) > 0.6).astype(np.float32)
    pm = np.zeros((b, n, lt), np.float32)
    for i in range(b):
        for j in range(n):
            pm[i, j, r.randint(lt)] = 1.0
    return dict(labels=r.randint(0, 5, (b, n)).astype(np.int32), boxes=boxes, masks=masks,
                positive_map=pm, is_thing=r.rand(b, n) > 0.3, valid=np.array(valid, bool))


@pytest.mark.parametrize("matcher", ["ota", "hungarian", "fixed", "embed"])
def test_criterion_pass_matches_jax(monkeypatch, matcher):
    """Every loss of a criterion pass (dynamic-conv masks or MaskDINO's mask
    embeddings) with the same point coordinates and JAX's matching draws:
    1e-5 relative (f32, another summation order)."""
    import hipie_tpu.losses.criterion as jcrit
    import hipie_torch.losses.criterion as tcrit
    from hipie_tpu.models.mask_head import dynamic_conv_param_sizes

    r = np.random.RandomState(11)
    n_layers, b, q, lt, k = 2, 2, 16, 12, 8
    t = _targets(r)
    wn, bn = dynamic_conv_param_sizes(8, 4, 3, True)
    lo = {"classes": r.randn(n_layers, b, q, lt).astype(np.float32),
          "boxes": rand_boxes(r, n_layers, b, q)}
    if matcher == "embed":
        lo["mask_embeds"] = r.randn(n_layers, b, q, 8).astype(np.float32)
        pixel = r.randn(b, 16, 16, 8).astype(np.float32)
    else:
        lo["ious"] = r.randn(n_layers, b, q, 1).astype(np.float32)
        lo["ctrl"] = (r.randn(n_layers, b, q, sum(wn) + sum(bn)) * 0.3).astype(np.float32)
        lo["refs"] = rand_boxes(r, n_layers, b, q)
        pixel = None
    mask_feats = r.randn(b, 8, 8, 8).astype(np.float32)
    sizes = np.array([[32, 32], [32, 24]], np.int32)
    text_mask = np.ones((b, lt), np.int32)
    text_mask[1, 9:] = 0
    fixed = np.where(np.array(t["valid"]), np.arange(5)[None], -1)
    fixed = np.concatenate([fixed, -np.ones((b, q - 5), np.int64)], 1).astype(np.int32)
    _fixed_coords(monkeypatch, r.uniform(0, 1, (b * k, 64, 2)).astype(np.float32))
    lc = train_config(jconfig).model.loss
    kw = dict(cfg=lc, weight_nums=wn, bias_nums=bn, dyn_channels=4, max_matched=k,
              matcher="hungarian" if matcher == "embed" else matcher)
    key = jax.random.PRNGKey(2)
    jt = jcrit.Targets(**{kk: jnp.asarray(v) for kk, v in t.items()})
    want = jcrit.criterion_pass(
        key, {kk: jnp.asarray(v) for kk, v in lo.items()}, jt, jnp.asarray(text_mask),
        jnp.asarray(mask_feats), jnp.asarray(sizes), fixed_assign=jnp.asarray(fixed),
        pixel_feats=None if pixel is None else jnp.asarray(pixel), **kw)
    tt = tcrit.Targets(**{kk: T(v) for kk, v in t.items()})
    got = tcrit.criterion_pass(
        JaxKeys(key), {kk: T(v) for kk, v in lo.items()}, tt, T(text_mask), T(mask_feats),
        T(sizes), fixed_assign=T(fixed).long(), pixel_feats=None if pixel is None else T(pixel),
        **kw)
    assert set(got) == set(want) and len(want) >= 10
    for name in want:
        assert abs(float(got[name]) - float(want[name])) <= 1e-5 * max(1.0, abs(float(want[name]))), name


def test_encoder_loss_pass_matches_jax():
    import hipie_tpu.losses.criterion as jcrit
    import hipie_torch.losses.criterion as tcrit

    r = np.random.RandomState(12)
    t = _targets(r)
    enc_class = r.randn(2, 40, 1).astype(np.float32)
    enc_boxes = rand_boxes(r, 2, 40)
    lc = train_config(jconfig).model.loss
    want = jcrit.encoder_loss_pass(jnp.asarray(enc_class), jnp.asarray(enc_boxes),
                                   jcrit.Targets(**{k: jnp.asarray(v) for k, v in t.items()}),
                                   jnp.ones((2, 12), jnp.int32), lc)
    got = tcrit.encoder_loss_pass(T(enc_class), T(enc_boxes),
                                  tcrit.Targets(**{k: T(v) for k, v in t.items()}),
                                  torch.ones(2, 12, dtype=torch.int32), lc)
    assert set(got) == set(want)
    for name in want:
        assert abs(float(got[name]) - float(want[name])) <= 1e-5 * max(1.0, abs(float(want[name]))), name


def test_select_matched_and_weights_match_jax():
    import hipie_tpu.losses.criterion as jcrit
    import hipie_torch.losses.criterion as tcrit

    r = np.random.RandomState(13)
    assign = np.where(r.rand(3, 20) > 0.6, r.randint(0, 5, (3, 20)), -1).astype(np.int32)
    for k in (4, 8, 20):
        want = jcrit.select_matched(jnp.asarray(assign), k)
        got = tcrit.select_matched(T(assign), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    losses = {"loss_ce": 1.0, "loss_ce_0": 2.0, "loss_bbox_enc": 3.0, "loss_mask_dn": 4.0,
              "loss_boxiou": 5.0, "matchdrop": 7.0, "loss_dice_interm": 6.0}
    lc = train_config(jconfig).model.loss
    assert float(tcrit.apply_weight_dict(losses, lc)) == pytest.approx(
        float(jcrit.apply_weight_dict(losses, lc)))
    merged = tcrit.merge_loss_dicts([losses, {"loss_ce": 3.0}], [0.5, 2.0])
    assert merged == jcrit.merge_loss_dicts([losses, {"loss_ce": 3.0}], [0.5, 2.0])
