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

from test_torch_train_common import batch_arrays, loss_records


@pytest.fixture(scope="module")
def runs():
    """(JAX record, port record) of one loss and gradient from the same state."""
    return loss_records(batch_arrays())


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
