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

The same loss runs data-parallel too: two gloo ranks on the host (spawned,
one thread each, ``file://`` rendezvous), each with one image of the batch,
the JAX keys (each rank keeps its images' rows of every batch-shaped draw) and
its rows of JAX's point coordinates, then the gradient all-reduce. The ranks'
mean loss terms and reduced gradients are held against JAX's at the
single-process limits, and each rank's assignments against its image's rows
of JAX's.

Limits: every matcher assignment identical; the total and every loss term
within 1e-4 relative (f32 through the stacks and passes); each parameter's
gradient within 1e-3 relative L2. A parameter whose gradient vanishes in exact
arithmetic (a convolution bias followed by a GroupNorm of one channel per
group, BERT's key bias under the softmax) carries round-off alone on both
sides; those, with a reference gradient under 1e-5 of the largest, are held to
an absolute limit of 1e-5 of the largest instead.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_train_common import (JaxKeys, batch_arrays, loss_records, rank_rows,
                                     torch_batch, train_config)

WORLD = 2
# the data-parallel ranks' work directory and their launch (a future)
DP = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX record, port record) of one loss and gradient from the same state.
    The data-parallel ranks are launched first, so that their start-up runs
    beside JAX's compile; they wait for the port's state and JAX's point
    coordinates, which this writes for them."""
    from hipie_torch.parallel.mesh import launch

    work = tmp_path_factory.mktemp("dp")
    with ThreadPoolExecutor(1) as pool:
        DP.update(work=work, ranks=pool.submit(launch, _dp_rank, WORLD,
                                               f"file://{work / 'rendezvous'}", "cpu",
                                               str(work)))
        try:
            want, got = loss_records(batch_arrays())
            torch.save({"state": got["model"].state_dict(), "coords": want["coords"],
                        "trainable": [n for n, p in got["model"].named_parameters()
                                      if p.requires_grad]}, work / "in.tmp")
            os.replace(work / "in.tmp", work / "in.pt")
        except BaseException:
            (work / "abort").touch()        # the ranks stop waiting for in.pt
            raise
        yield want, got


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


def grad_errors(want, grads, labels):
    """Check every gradient in ``grads`` (the port's names, None where none
    flowed) against JAX's at the limits above; returns how many were held to
    the relative limit."""
    largest = max(np.linalg.norm(w) for w in want["grads"].values())
    checked = 0
    for name, g in grads.items():
        w = want["grads"][name].astype(np.float64)
        if labels[name] == "frozen":
            assert g is None and not w.any(), name
            continue
        g = np.zeros_like(w) if g is None else g.numpy().astype(np.float64)
        if np.linalg.norm(w) < 1e-5 * largest:
            assert np.linalg.norm(g - w) <= 1e-5 * largest, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= 1e-3, (name, err)
        checked += 1
    return checked


def test_every_parameter_gradient_matches(runs):
    want, got = runs
    assert grad_errors(want, got["grads"], got["labels"]) > 200


def _dp_rank(work, dev):
    """One of the data-parallel ranks: the loss on its image with JAX's keys
    and its rows of JAX's point coordinates, the backward and the gradient
    all-reduce; writes its terms, assignments and gradients to ``work``."""
    import jax
    import torch.distributed as dist

    import hipie_torch.losses.criterion as tcrit
    import hipie_torch.train.step as tstep
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.parallel.mesh import reduce_gradients, shard_rows

    torch.set_num_threads(1)
    rank = dist.get_rank()
    cfg = train_config()
    model = HIPIEModel(cfg.model, train=True)
    batch = torch_batch(rank_rows(batch_arrays(), rank))
    # while the single-process side runs: the same loss from the initial
    # weights, so that JAX compiles its draws (seconds, eagerly) before the
    # state comes
    with torch.no_grad():
        tstep.make_loss_fn(model, cfg)(batch, JaxKeys(jax.random.PRNGKey(1)))
    path, waited = os.path.join(work, "in.pt"), 0.0
    while not os.path.exists(path):
        if os.path.exists(os.path.join(work, "abort")) or waited > 900:
            raise RuntimeError("the single-process side failed")
        time.sleep(0.1)
        waited += 0.1
    inp = torch.load(path, weights_only=False)
    model.load_state_dict(inp["state"])
    for name, p in model.named_parameters():
        p.requires_grad_(name in inp["trainable"])
    rec = {"terms": [], "assign": []}
    replay = list(inp["coords"])
    saved = (tcrit.uncertain_point_coords, tcrit.gather_targets, tstep.apply_weight_dict)

    def gather(t, assign):
        rec["assign"].append(assign.numpy().copy())
        return saved[1](t, assign)

    def weights(losses, c):
        rec["terms"].append({k: float(v.detach()) for k, v in losses.items()})
        return saved[2](losses, c)

    tcrit.uncertain_point_coords = lambda *a, **k: shard_rows(
        torch.from_numpy(np.array(replay.pop(0))))
    tcrit.gather_targets, tstep.apply_weight_dict = gather, weights
    try:
        total, _ = tstep.make_loss_fn(model, cfg)(batch, JaxKeys(jax.random.PRNGKey(1)))
        total.backward()
    finally:
        tcrit.uncertain_point_coords, tcrit.gather_targets, tstep.apply_weight_dict = saved
    reduce_gradients([p for p in model.parameters() if p.requires_grad])
    rec.update(replayed=len(inp["coords"]) - len(replay),
               grads={n: p.grad for n, p in model.named_parameters()})
    torch.save(rec, os.path.join(work, f"rank{rank}.pt"))


def test_two_ranks_match_jax(runs):
    """Two ranks with one image each against JAX's loss over both: the ranks'
    mean of every loss term and their reduced gradients at the limits above,
    each rank's assignments its image's rows of JAX's, the ranks' gradients
    bit-identical, and None on the parameters the optimizer freezes."""
    want, got = runs
    DP["ranks"].result(timeout=900)
    ranks = [torch.load(DP["work"] / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r, rec in enumerate(ranks):
        assert rec["replayed"] == len(want["coords"]) > 0
        assert len(rec["assign"]) == len(want["assign"])
        for i, (g, w) in enumerate(zip(rec["assign"], want["assign"])):
            np.testing.assert_array_equal(g, np.take(w, [r], axis=-2),
                                          err_msg=f"rank {r} assignment {i}")
    assert len(ranks[0]["terms"]) == len(want["terms"]) == 2
    for i, w in enumerate(want["terms"]):
        assert set(ranks[0]["terms"][i]) == set(w)
        for k in w:
            mean = float(np.mean([rec["terms"][i][k] for rec in ranks]))
            wk = float(w[k])
            assert abs(mean - wk) <= 1e-4 * max(abs(wk), 1e-6), (k, mean, wk)
    grads = ranks[0]["grads"]
    for name, g in grads.items():
        other = ranks[1]["grads"][name]
        assert (g is None) == (other is None) and (g is None or torch.equal(g, other)), name
    assert grad_errors(want, grads, got["labels"]) > 200
