"""The training step's matching inputs, JAX against the port on the CPU, from
numpy seeds in f32: box ops, the matchers (equal assignments on seeded cost
matrices, invalid GTs included) and the CDN queries with JAX's draws replayed. Tolerances are stated per check: the same f32
arithmetic in another order gives ~1e-6 relative; assignments and integer
outputs must be equal.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_torch_train_common import JaxKeys

T = lambda x: torch.from_numpy(np.asarray(x))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def rand_boxes(r, *shape):
    c = r.uniform(0.2, 0.8, shape + (2,))
    wh = r.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


# ---------------------------------------------------------------- box ops

def test_box_ops_match_jax():
    import hipie_tpu.ops.box_ops as jb
    import hipie_torch.ops.box_ops as tb

    r = np.random.RandomState(0)
    a, b = rand_boxes(r, 7), rand_boxes(r, 5)
    ax, bx = np.asarray(jb.box_cxcywh_to_xyxy(a)), np.asarray(jb.box_cxcywh_to_xyxy(b))
    np.testing.assert_allclose(tb.box_xyxy_to_cxcywh(T(ax)).numpy(),
                               np.asarray(jb.box_xyxy_to_cxcywh(ax)), atol=1e-6)
    np.testing.assert_allclose(tb.generalized_box_iou(T(ax), T(bx)).numpy(),
                               np.asarray(jb.generalized_box_iou(ax, bx)), atol=1e-6)
    np.testing.assert_allclose(tb.box_iou(T(ax), T(bx)).numpy(),
                               np.asarray(jb.box_iou(ax, bx)[0]), atol=1e-6)
    np.testing.assert_allclose(tb.elementwise_box_iou(T(ax[:5]), T(bx)).numpy(),
                               np.asarray(jb.elementwise_box_iou(ax[:5], bx)), atol=1e-6)
    np.testing.assert_allclose(tb.elementwise_generalized_box_iou(T(ax[:5]), T(bx)).numpy(),
                               np.asarray(jb.elementwise_generalized_box_iou(ax[:5], bx)),
                               atol=1e-6)
    masks = (r.rand(4, 9, 11) > 0.7).astype(np.float32)
    masks[2] = 0.0
    np.testing.assert_array_equal(tb.masks_to_boxes(T(masks)).numpy(),
                                  np.asarray(jb.masks_to_boxes(masks)))


# ---------------------------------------------------------------- matchers

def _match_inputs(seed, g=6, q=30, n=7, lt=12):
    r = np.random.RandomState(seed)
    prob = r.uniform(0, 1, (g, q, lt)).astype(np.float32)
    pb, gb = rand_boxes(r, g, q), rand_boxes(r, g, n)
    pm = np.zeros((g, n, lt), np.float32)
    for i in range(g):
        for j in range(n):
            toks = r.choice(lt, r.randint(1, 3), replace=False)
            pm[i, j, toks] = 1.0 / len(toks)
    valid = r.rand(g, n) > 0.3
    valid[0] = False                 # an image without any valid GT
    valid[1] = True
    return prob, pb, gb, pm, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_assignments_equal_jax(seed):
    from hipie_tpu.losses.matcher import simota_match as jsimota
    from hipie_torch.losses.matcher import simota_match

    prob, pb, gb, pm, valid = _match_inputs(seed)
    want = jax.vmap(jsimota)(*(jnp.asarray(x) for x in (prob, pb, gb, pm, valid)))
    got = simota_match(*(T(x) for x in (prob, pb, gb, pm, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0] == -1).all() and (got >= 0).any()


@pytest.mark.parametrize("seed,q,n", [(0, 30, 7), (1, 12, 12), (2, 50, 3)])
def test_auction_assignments_equal_jax(seed, q, n):
    """Seeded cost matrices with invalid GT columns: the same owner per query,
    every valid GT owning exactly one query."""
    from hipie_tpu.losses.matcher import auction_assignment as jauction
    from hipie_torch.losses.matcher import auction_assignment

    r = np.random.RandomState(seed)
    cost = r.randn(5, q, n).astype(np.float32) * 3
    valid = r.rand(5, n) > 0.25
    valid[0] = True
    want = jax.vmap(jauction)(jnp.asarray(cost), jnp.asarray(valid))
    got = auction_assignment(T(cost), T(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(5):
        owners = got[i][got[i] >= 0]
        assert sorted(owners.tolist()) == np.flatnonzero(valid[i]).tolist()


def test_hungarian_and_mask_costs_match_jax():
    """Cost matrices (class, L1, GIoU, point-sampled mask CE + dice; dense and
    embedding heads) with JAX's point draws: 1e-5 relative; equal assignments."""
    import hipie_tpu.losses.matcher as jm
    import hipie_torch.losses.matcher as tm

    prob, pb, gb, pm, valid = _match_inputs(3, g=2)
    r = np.random.RandomState(4)
    ml = (r.randn(2, 30, 16, 16) * 2).astype(np.float32)
    gm = (r.rand(2, 7, 16, 16) > 0.6).astype(np.float32)
    emb = r.randn(2, 30, 8).astype(np.float32)
    pf = r.randn(2, 16, 16, 8).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    jmc = jax.vmap(lambda k, a, b: jm.mask_match_costs(k, a, b, 64))(keys, ml, gm)
    tmc = tm.mask_match_costs([JaxKeys(k) for k in keys], T(ml), T(gm), 64)
    assert rel(tmc, jmc) <= 1e-5
    jme = jax.vmap(lambda k, a, f, b: jm.mask_match_costs_embed(k, a, f, b, 64))(keys, emb, pf, gm)
    tme = tm.mask_match_costs_embed([JaxKeys(k) for k in keys], T(emb), T(pf), T(gm), 64)
    assert rel(tme, jme) <= 1e-5
    jc = jax.vmap(lambda *a: jm.hungarian_vl_costs(*a, mask_cost=None))(prob, pb, gb, pm)
    tc = tm.hungarian_vl_costs(T(prob), T(pb), T(gb), T(pm), mask_cost=None)
    assert rel(tc, jc) <= 1e-5
    jassign = jax.vmap(jm.hungarian_vl_match)(prob, pb, gb, pm, valid)
    np.testing.assert_array_equal(
        tm.hungarian_vl_match(T(prob), T(pb), T(gb), T(pm), T(valid)).numpy(),
        np.asarray(jassign))


def test_convergence_checks_are_few():
    """The solvers ask the host for convergence once every CHECK_EVERY
    iterations, not once an iteration."""
    from hipie_torch.losses import matcher

    r = np.random.RandomState(6)
    cost = T(r.randn(4, 300, 100).astype(np.float32))
    before = matcher.HOST_SYNCS[0]
    assign = matcher.auction_assignment(cost, torch.ones(4, 100, dtype=torch.bool))
    syncs = matcher.HOST_SYNCS[0] - before
    assert (assign >= 0).sum() == 400 and 1 <= syncs <= 2000 // matcher.CHECK_EVERY + 1


# ------------------------------------------------------------------ CDN

@pytest.mark.parametrize("n_valid,dn_number", [((4, 2), 4), ((6, 1), 2), ((0, 0), 4)])
def test_prepare_cdn_matches_jax(n_valid, dn_number):
    """Every field, with JAX's draws replayed through the port's key interface."""
    from hipie_tpu.models.dn import prepare_cdn as jcdn
    from hipie_torch.models.dn import prepare_cdn

    r = np.random.RandomState(7)
    b, n = 2, 6
    labels = r.randint(0, 20, (b, n)).astype(np.int32)
    boxes = rand_boxes(r, b, n)
    valid = np.arange(n)[None] < np.array(n_valid)[:, None]
    key = jax.random.PRNGKey(3)
    want = jcdn(key, jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid), 20, 9,
                dn_number=dn_number, label_noise_ratio=0.5, box_noise_scale=1.0)
    got = prepare_cdn(JaxKeys(key), T(labels), T(boxes), T(valid), 20, 9, dn_number=dn_number,
                      label_noise_ratio=0.5, box_noise_scale=1.0)
    assert got.pad_size == want.pad_size
    for name in ("noised_labels", "slot_valid", "attn_mask", "gt_assign"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.refs_unact.numpy(), np.asarray(want.refs_unact), atol=1e-5)


