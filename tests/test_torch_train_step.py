"""The whole training loss, JAX against the port, on the CPU in f32 at the tiny
training config (test_torch_train_common.py).

The JAX ``loss_fn`` runs under jax.value_and_grad; the port's ``loss_fn`` under
autograd, from the same parameters and batch. The CDN noise and the matchers'
point draws replay JAX's keys through the port's key interface; the mask
losses' point coordinates (picked by uncertainty from mask logits that the two
compute with f32 round-off, so that a near-tied pick could differ) are recorded
from the JAX run and replayed. JAX's mask loss samples predictions through
``bilinear_sample_fastgrad``, whose image gradient takes bf16 operands (~0.4%
relative); the comparison swaps in its f32 twin ``bilinear_sample`` (the same
forward), so that both sides differentiate exactly.

Limits: every matcher assignment identical; the total and every loss term
within 1e-4 relative (f32 through the stacks and passes); each parameter's
gradient within 1e-3 relative L2. A parameter whose gradient vanishes in exact
arithmetic (a convolution bias followed by a GroupNorm of one channel per
group, BERT's key bias under the softmax) carries round-off alone on both
sides; those, with a reference gradient under 1e-5 of the largest, are held to
an absolute limit of 1e-5 of the largest instead.
"""

import numpy as np
import pytest
import jax
import torch

from test_torch_train_common import (JaxKeys, batch_arrays, jax_batch, jax_train_state,
                                     port_model_from_jax, to_numpy_tree, torch_batch,
                                     train_config)


@pytest.fixture(scope="module")
def runs():
    """(JAX record, port record) of one loss and gradient from the same state."""
    import hipie_tpu.losses.criterion as jcrit
    import hipie_tpu.ops.bilinear as jbil
    import hipie_tpu.train.step as jstep
    import hipie_torch.losses.criterion as tcrit
    import hipie_torch.train.step as tstep
    from hipie_torch.train.optimizer import freeze_
    from hipie_torch.utils.export import export_hipie_checkpoint

    arrays = batch_arrays()
    jmodel, params, jcfg = jax_train_state(arrays)
    rec = {"coords": [], "terms": [], "assign": []}
    saved = (jcrit.uncertain_point_coords, jcrit.gather_targets, jstep.apply_weight_dict,
             jbil.bilinear_sample_fastgrad)
    cb = lambda name: (lambda x: rec[name].append(jax.tree_util.tree_map(np.asarray, x)))

    def coords(*a, **k):
        c = saved[0](*a, **k)
        jax.debug.callback(cb("coords"), c, ordered=True)
        return c

    def gather(t, assign):
        jax.debug.callback(cb("assign"), assign, ordered=True)
        return saved[1](t, assign)

    def weights(losses, cfg):
        jax.debug.callback(cb("terms"), losses, ordered=True)
        return saved[2](losses, cfg)

    jcrit.uncertain_point_coords, jcrit.gather_targets, jstep.apply_weight_dict = (
        coords, gather, weights)
    jbil.bilinear_sample_fastgrad = jbil.bilinear_sample
    try:
        key = jax.random.PRNGKey(1)
        args = (params, jax_batch(arrays), key)
        # XLA's cheaper CPU pipeline halves the compile, the bulk of this file's time
        (total, _), grads = jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(jmodel, jcfg), has_aux=True)).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})(*args)
        jax.effects_barrier()
    finally:
        (jcrit.uncertain_point_coords, jcrit.gather_targets, jstep.apply_weight_dict,
         jbil.bilinear_sample_fastgrad) = saved
    want = {"total": float(total), "grads": export_hipie_checkpoint(
        to_numpy_tree(grads)["params"], train_config()), **rec}

    model, cfg = port_model_from_jax(params)
    labels = freeze_(model)
    got = {"coords": [], "terms": [], "assign": []}
    replay = list(want["coords"])
    tsaved = (tcrit.uncertain_point_coords, tcrit.gather_targets, tstep.apply_weight_dict)

    def tgather(t, assign):
        got["assign"].append(assign.numpy().copy())
        return tsaved[1](t, assign)

    def tweights(losses, c):
        got["terms"].append({k: float(v.detach()) for k, v in losses.items()})
        return tsaved[2](losses, c)

    tcrit.uncertain_point_coords = lambda *a, **k: torch.from_numpy(replay.pop(0))
    tcrit.gather_targets, tstep.apply_weight_dict = tgather, tweights
    try:
        total, _ = tstep.make_loss_fn(model, cfg)(torch_batch(arrays), JaxKeys(key))
        total.backward()
    finally:
        tcrit.uncertain_point_coords, tcrit.gather_targets, tstep.apply_weight_dict = tsaved
    got.update(total=float(total.detach()), replayed=len(want["coords"]) - len(replay),
               grads={n: p.grad for n, p in model.named_parameters()}, labels=labels)
    return want, got


def test_assignments_are_identical(runs):
    want, got = runs
    assert len(got["assign"]) == len(want["assign"]) > 20
    for i, (g, w) in enumerate(zip(got["assign"], want["assign"])):
        np.testing.assert_array_equal(g, w, err_msg=f"assignment {i}")
    assert got["replayed"] == len(want["coords"]) > 0


def test_total_and_every_loss_term_match(runs):
    want, got = runs
    assert abs(got["total"] - want["total"]) <= 1e-4 * abs(want["total"])
    assert len(got["terms"]) == len(want["terms"]) == 2       # main passes, MaskDINO passes
    for g, w in zip(got["terms"], want["terms"]):
        assert set(g) == set(w) and len(w) >= 15
        for k in w:
            wk = float(w[k])
            assert abs(g[k] - wk) <= 1e-4 * max(abs(wk), 1e-6), (k, g[k], wk)


def test_every_parameter_gradient_matches(runs):
    want, got = runs
    largest = max(np.linalg.norm(w) for w in want["grads"].values())
    checked = 0
    for name, g in got["grads"].items():
        w = want["grads"][name].astype(np.float64)
        if got["labels"][name] == "frozen":
            assert g is None and not w.any(), name
            continue
        g = np.zeros_like(w) if g is None else g.numpy().astype(np.float64)
        if np.linalg.norm(w) < 1e-5 * largest:
            assert np.linalg.norm(g - w) <= 1e-5 * largest, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= 1e-3, (name, err)
        checked += 1
    assert checked > 200
