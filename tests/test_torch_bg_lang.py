"""Language-derived bg queries in training: the port's
``hipie_torch.train.bg_lang.prepare_bg_lang_queries`` against JAX's, and one
training loss with every branch option on against JAX's ``make_loss_fn``.

``prepare_bg_lang_queries`` is held EXACTLY (weights, assignment, negative
slots) on seeded batches with a stuff class twice in one image and across
images, absent classes, invalid GTs, padded tokens, more classes than slots,
no stuff at all and every real token covered; the Gumbel draw of the
negatives replays JAX's key through ``JaxKeys``.

The loss runs at the tiny training config (test_torch_train_common.py) cut to
one encoder and one MaskDINO layer of each kind, with
``model.bg_query_from_lang`` (32 slots), ``model.loss.final_bg_weight`` 1.0
(so the bg_lang criterion pass runs: at the default 0.0 both packages skip
it), ``maskdino.shared_encoder=False``, the in-encoder BERT layers and
``decouple_tgt=False``: one JAX compile (about 50 s, most of this file's time)
covers every branch of the training forward and both new criterion paths.
Limits: every matcher assignment identical (the bg_lang pass's fixed one
included); the total and every loss term within 1e-5 relative; every
parameter's gradient within 3e-5 relative L2, or, where JAX's is under 1e-5
of the largest (round-off alone: a bias under a GroupNorm of one channel a
group, BERT's key bias under the softmax), within 1e-5 of the largest.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_torch_train_common import JaxKeys, batch_arrays, loss_records

N_CLASSES = 12


def _batch(seed, b=2, n=7, L=12, stuff_frac=0.5, cover_all=False):
    """labels, positive_map, is_thing, valid, lang_mask as numpy, with the
    special cases the module docstring lists."""
    r = np.random.RandomState(seed)
    labels = r.randint(0, N_CLASSES, (b, n)).astype(np.int32)
    is_thing = r.uniform(size=(b, n)) > stuff_frac
    valid = r.uniform(size=(b, n)) > 0.15
    lang = np.ones((b, L), np.int32)
    lang[1:, L - 3:] = 0                                     # padded tokens
    pm = np.zeros((b, n, L), np.float32)
    for i in range(b):
        for j in range(n):
            toks = r.choice(np.arange(1, L - 3), r.randint(1, 4), replace=False)
            pm[i, j, toks] = r.uniform(0.5, 2.0, len(toks))
    if stuff_frac >= 0 and b > 1:
        # one stuff class twice in image 0, and again in image 1
        labels[0, 1] = labels[0, 4] = labels[1, 2] = 3
        is_thing[0, [1, 4]] = is_thing[1, 2] = False
        valid[0, [1, 4]] = valid[1, 2] = True
    if cover_all:
        for i in range(b):
            pm[i, 0, :] = 1.0
            valid[i, 0] = True
    return labels, pm, is_thing, valid, lang


CASES = {
    "duplicates_and_padding": dict(seed=0, slots=8),
    "more_classes_than_slots": dict(seed=1, slots=2),
    "no_stuff": dict(seed=2, slots=5, stuff_frac=-1.0),
    "every_token_covered": dict(seed=3, slots=6, cover_all=True),
    "one_image": dict(seed=4, slots=4, b=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_bg_lang_queries_equals_jax(case):
    from hipie_tpu.train.bg_lang import prepare_bg_lang_queries as jprepare
    from hipie_torch.train.bg_lang import prepare_bg_lang_queries

    kw = dict(CASES[case])
    slots = kw.pop("slots")
    arrays = _batch(**kw)
    key = jax.random.PRNGKey(10 + kw["seed"])
    want = jprepare(key, *(jnp.asarray(a) for a in arrays), N_CLASSES, slots)
    got = prepare_bg_lang_queries(JaxKeys(key), *(torch.from_numpy(a) for a in arrays),
                                  N_CLASSES, slots)
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    labels, _, is_thing, valid, _ = arrays
    stuff = valid & ~is_thing
    n_cls = len(set(labels[stuff].tolist()))
    has_class = got.weights.flatten(1).sum(1).round() > 0
    if case == "duplicates_and_padding":
        # slot 0 is class 3's, first seen at (0, 1); image 0 keeps its last GT of it
        assert got.assign[0, 0] == 4 and got.assign[1, 0] == 2
        assert (got.assign >= 0).sum() < stuff.sum()
    if case == "no_stuff":
        assert (got.assign == -1).all() and n_cls == 0
    # each negative slot is one real, uncovered token (while any is left)
    neg = got.weights[min(n_cls, slots):]
    assert ((neg == 0) | (neg == 1)).all() and (neg.flatten(1).sum(1) == 1).all()
    assert int(has_class.sum()) == slots


BRANCHES = {"model.bg_query_from_lang": True, "model.loss.final_bg_weight": 1.0,
            "model.maskdino.shared_encoder": False,
            "model.transformer.use_extra_bert_layers": True,
            "model.transformer.decouple_tgt": False,
            "model.transformer.num_encoder_layers": 1, "model.maskdino.dec_layers": 1,
            "model.maskdino.enc_layers": 1, "model.text.num_layers": 1}


def branch_arrays():
    """The shared batch with three stuff GTs over two classes: image 0's slots
    2 and 5 and image 1's slot 2, the last with image 0's slot-5 class."""
    arrays = batch_arrays(n_valid=(6, 4))
    t = arrays["targets"]
    t["labels"][1, 2] = t["labels"][0, 5]
    return arrays


@pytest.fixture(scope="module")
def runs():
    return loss_records(branch_arrays(), **BRANCHES)


def test_branch_assignments_are_identical(runs):
    """Every matcher assignment equal, and the bg_lang pass took the port's
    fixed assignment at every decoder layer (the class and box losses each
    gather the targets by it)."""
    from hipie_torch.train.bg_lang import prepare_bg_lang_queries
    from test_torch_train_common import torch_batch, train_config

    want, got = runs
    assert len(got["assign"]) == len(want["assign"]) > 15
    for i, (g, w) in enumerate(zip(got["assign"], want["assign"])):
        np.testing.assert_array_equal(g, w, err_msg=f"assignment {i}")
    cfg = train_config(**BRANCHES)
    batch = torch_batch(branch_arrays())
    t = batch.targets
    k_bgl = JaxKeys(jax.random.PRNGKey(1)).split(6)[5]
    bgl = prepare_bg_lang_queries(k_bgl, t.labels, t.positive_map, t.is_thing, t.valid,
                                  batch.lang_mask, cfg.model.num_classes,
                                  cfg.model.transformer.num_bg_lang_queries)
    assert (bgl.assign >= 0).sum() == 3
    n_dec = cfg.model.transformer.num_decoder_layers
    assert sum(a.shape == bgl.assign.shape and (a == bgl.assign.numpy()).all()
               for a in got["assign"]) == 2 * n_dec


def test_branch_total_and_every_loss_term_match(runs):
    want, got = runs
    assert abs(got["total"] - want["total"]) <= 1e-5 * abs(want["total"])
    assert len(got["terms"]) == len(want["terms"]) == 2
    for g, w in zip(got["terms"], want["terms"]):
        assert set(g) == set(w) and len(w) >= 15
        for k in w:
            wk = float(w[k])
            assert abs(g[k] - wk) <= 1e-5 * max(abs(wk), 1e-6), (k, g[k], wk)


def test_branch_every_parameter_gradient_matches(runs):
    want, got = runs
    largest = max(np.linalg.norm(w) for w in want["grads"].values())
    checked = set()
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
        assert err <= 3e-5, (name, err)
        checked.add(name)
    assert len(checked) > 200
    # the branches' own parameters are among those held
    for part in (".encoder.lang_layers.0.", "pixel_decoder.transformer.encoder.layers.0.",
                 "pixel_decoder.input_proj.0.", "transformer.resizer."):
        assert any(part in n for n in checked), part
