"""BoxInst's losses (hipie_torch/losses/boxinst.py) against JAX's
(hipie_tpu/losses/boxinst.py) in f32 on the CPU: the neighbour stack, the color
similarity, the projection and pairwise terms, and both losses with their
gradient with respect to the mask logits, with and without valid slots, at
warm-up 0, 1/2 and past 1. Limit: 1e-5 of each output's scale.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

N, H, W, K, DIL = 3, 20, 17, 3, 2


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max())


@pytest.fixture(scope="module")
def inputs():
    r = np.random.RandomState(0)
    logits = (r.randn(N, H, W) * 3).astype(np.float32)
    boxes = np.zeros((N, H, W), np.float32)
    for n in range(N):
        y0, x0 = r.randint(0, H // 2), r.randint(0, W // 2)
        boxes[n, y0:y0 + r.randint(3, H // 2), x0:x0 + r.randint(3, W // 2)] = 1
    lab = (r.rand(N, H, W, 3) * [100, 50, 50]).astype(np.float32)
    # neighbouring colors near each other in places, so both sides of 0.3 occur
    lab[:, 5:12] = lab[:, 5:6]
    return logits, boxes, lab


def test_shift_stack_and_color_similarity_match_jax(inputs):
    from hipie_tpu.losses import boxinst as jb
    from hipie_torch.losses import boxinst as tb

    logits, _, lab = inputs
    for k, d in ((3, 2), (3, 1), (5, 2)):
        _close(tb.shift_stack(torch.from_numpy(logits), k, d),
               jb.shift_stack(jnp.asarray(logits), k, d))
    got = tb.images_color_similarity(torch.from_numpy(lab[0]), K, DIL)
    want = jb.images_color_similarity(jnp.asarray(lab[0]), K, DIL)
    _close(got, want)
    assert 0 < float((np.asarray(want) >= 0.3).mean()) < 1


def test_project_and_pairwise_terms_match_jax(inputs):
    from hipie_tpu.losses import boxinst as jb
    from hipie_torch.losses import boxinst as tb

    logits, boxes, _ = inputs
    _close(tb.pairwise_term(torch.from_numpy(logits), K, DIL),
           jb.pairwise_term(jnp.asarray(logits), K, DIL))
    probs = 1 / (1 + np.exp(-logits))
    for valid in ([True, False, True], [False] * N):
        _close(tb.project_term(torch.from_numpy(probs), torch.from_numpy(boxes),
                               torch.tensor(valid)),
               jb.project_term(jnp.asarray(probs), jnp.asarray(boxes), jnp.asarray(valid)))


@pytest.mark.parametrize("valid", [(True, False, True), (False, False, False)])
@pytest.mark.parametrize("iteration", [0, 5000, 25000])
def test_losses_and_logit_gradient_match_jax(inputs, valid, iteration):
    """Both losses and d(loss_prj + loss_pairwise)/d logits (warmup_iters
    10000: iteration 0 -> warm-up 0, 5000 -> 1/2, 25000 -> 1)."""
    from hipie_tpu.losses import boxinst as jb
    from hipie_torch.losses import boxinst as tb

    logits, boxes, lab = inputs
    sim = np.stack([np.asarray(jb.images_color_similarity(jnp.asarray(x), K, DIL)) for x in lab])
    v = np.asarray(valid)

    def jloss(ml):
        out = jb.boxinst_losses(ml, jnp.asarray(boxes), jnp.asarray(sim), jnp.asarray(v),
                                jnp.asarray(iteration))
        return out["loss_prj"] + out["loss_pairwise"], out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    ml = torch.from_numpy(logits).requires_grad_(True)
    got = tb.boxinst_losses(ml, torch.from_numpy(boxes), torch.from_numpy(sim),
                            torch.from_numpy(v), iteration)
    (got["loss_prj"] + got["loss_pairwise"]).backward()
    for k in ("loss_prj", "loss_pairwise"):
        _close(got[k].detach(), want[k])
    if iteration == 0:
        assert float(got["loss_pairwise"]) == 0.0
    if not any(valid):
        assert float(got["loss_prj"]) == 0.0 and not ml.grad.any()
    else:
        assert float(want["loss_pairwise"]) > 0 or iteration == 0
        _close(ml.grad, jgrad)
