"""Data parallelism on the CPU: two gloo ranks with one image each against one
process with both.

One spawn of two ranks (module fixture: ``dryrun_multigpu(2)``, whose ranks take
its one full dryrun step, then run these checks with the group still up;
``file://`` rendezvous, one thread a rank), on test_torch_train_common.py's tiny
training config:

  * two training steps through ``make_train_step`` (the step
    test_torch_train_step.py holds against JAX), rank r on image r of
    ``batch_arrays(n_valid=(4, 2))`` with the second image's GTs all stuff (the
    ranks then differ in GT counts and one holds no thing, so that CDN's group
    count, every normaliser and the things re-weighting differ per rank), then
    of the batch as it is, with one ``GeneratorKeys`` stream over both steps,
    as the Trainer keeps it; and the first step with language-derived bg
    queries (slots shared by the global batch: built from every rank's
    targets, pooled from every rank's prompts, the pool's gradient summed back);
  * the loss alone at the initial state with each fix of the data-parallel
    step reverted in turn (CDN's global group count, the global normalisers,
    the global batch's draws);
  * CDN's queries and the mask losses' point picks from GeneratorKeys;
  * ``reduce_gradients`` on parameters with a gradient on both ranks, on one
    rank and on none, and the same with every missing gradient taken as zero;
  * the dataset evaluators (detection, semantic, RefCOCO) over make_tiny_coco's
    4 val images with a predictor that answers from the ground truth,
    imperfectly (``GtPredictor``), each rank its share;
  * ``multihost``'s functions at world size 2.

This process runs the one-process side (the ranks replay its point picks:
they wait for its steps), and holds the draws of JAX's keys (the keys the JAX
parity tests replay through ``JaxKeys``) as each rank takes them, with the
rank and world faked. Both sides run PyTorch's native
convolutions (oneDNN off): oneDNN picks its convolution algorithm by batch
size, so a batch of one and of two round differently and a ReLU gate within
round-off of zero flips (2% on the mask head's gradients); the native ones
compute each image alone. The mask losses' point picks (the most uncertain of
the sampled points, by an exact top-k over logits with round-off) are the
one-process run's, replayed.

Limits: at the first step the ranks' mean of every loss term within 1e-5
relative of one process's and every reduced gradient within 1e-5 relative
norm (a gradient that vanishes in exact arithmetic carries round-off alone:
below 1e-5 of the largest reference gradient it is held to 1e-5 of the
largest, as test_torch_train_step.py holds it), the same parameters without a
gradient; at the second, the terms within 1e-4 (AdamW's first update is close
to +-lr, so a gradient near zero may flip an update's sign); the ranks'
parameters and AdamW state bit-identical after each step; the draws and the
sharded metrics equal to one process's. Each reverted fix must break its
check.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import copy
import os
import time

import numpy as np
import pytest
import torch

from test_torch_train_common import (JaxKeys, batch_arrays, rank_rows, torch_batch,
                                     train_config)

WORLD = 2
STEP_SEED = 1
REVERTS = ("dn_groups", "normalisers", "draws")
# language-derived bg queries, their pass at weight 1: slots shared by the
# global batch, pooled from every rank's prompts
BG_LANG = {"model.bg_query_from_lang": True, "model.loss.final_bg_weight": 1.0}


def step_batches():
    """The two steps' batches: the stuff-only variant, then batch_arrays()."""
    plain = batch_arrays(n_valid=(4, 2))
    stuff = copy.deepcopy(plain)
    stuff["targets"]["is_thing"][1] = False
    return [stuff, plain]


def jax_keys(seed):
    import jax

    return JaxKeys(jax.random.PRNGKey(seed))


def generator_keys(seed=STEP_SEED):
    from hipie_torch.utils.rng import GeneratorKeys

    return GeneratorKeys(torch.Generator().manual_seed(seed))


def point_picks(coords):
    """The patch of the mask losses' point picks: with ``coords`` None, one
    that records each pick (global batch) into a new list, else one that
    replays ``coords`` in order, this rank's rows of each. The picks take the
    most uncertain of the sampled points by an exact top-k, so logits that
    differ by round-off between a batch of one and of two could swap a
    near-tied point; the comparison holds the step, not the ties."""
    import hipie_torch.losses.criterion as criterion
    from hipie_torch.parallel.mesh import shard_rows

    if coords is None:
        coords, pick = [], criterion.uncertain_point_coords
        return coords, (criterion, "uncertain_point_coords",
                        lambda *a, **k: coords.append(pick(*a, **k)) or coords[-1])
    # the replay still draws, so that GeneratorKeys' stream advances as recorded
    replay, pick = list(coords), criterion.uncertain_point_coords
    return coords, (criterion, "uncertain_point_coords", lambda *a, **k: (
        pick(*a, **k), shard_rows(replay.pop(0)))[1])


def recorded_steps(batches, coords=None, **overrides):
    """The training state from seed 0 through one step a batch, at the
    training config with ``overrides``: each step's weighted loss dicts, its
    gradients as the optimizer gets them, the state's digest after it, and the
    mask losses' point picks (``point_picks``)."""
    import hipie_torch.train.step as step_module
    from hipie_torch.parallel.dryrun import state_digest

    cfg = train_config(**overrides)
    state = step_module.create_train_state(cfg, seed=0, device="cpu")
    step = step_module.make_train_step(cfg, state, device="cpu")
    named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    coords, (module, name, picks) = point_picks(coords)
    rec = {"terms": [], "grads": [], "digests": [], "coords": coords}
    apply_weights, opt_step, real_picks = (step_module.apply_weight_dict, state.optimizer.step,
                                           getattr(module, name))

    def weights(losses, lc):
        rec["terms"][-1].append({k: float(v) for k, v in losses.items()})
        return apply_weights(losses, lc)

    def optimizer_step():
        rec["grads"].append({n: None if p.grad is None else p.grad.detach().clone()
                             for n, p in named})
        return opt_step()

    state.optimizer.step = optimizer_step
    step_module.apply_weight_dict = weights
    setattr(module, name, picks)
    keys = generator_keys()
    try:
        for arrays in batches:
            rec["terms"].append([])
            step(state, torch_batch(arrays), keys)
            rec["digests"].append(state_digest(state))
    finally:
        step_module.apply_weight_dict = apply_weights
        setattr(module, name, real_picks)
    return rec


def loss_terms(arrays, keys, coords, patches=()):
    """The weighted loss dicts of one loss at the initial state (no backward),
    with ``patches`` ((module, name, value), ...) in place and the point picks
    ``coords`` replayed."""
    import hipie_torch.train.step as step_module

    cfg = train_config()
    state = step_module.create_train_state(cfg, seed=0, device="cpu")
    terms = []
    coords, picks = point_picks(coords)
    patches = list(patches) + [picks, (step_module, "apply_weight_dict", lambda losses, lc: (
        terms.append({k: float(v) for k, v in losses.items()}),
        apply_weights(losses, lc))[1])]
    apply_weights = step_module.apply_weight_dict
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, v in patches:
        setattr(m, n, v)
    try:
        with torch.no_grad():
            step_module.make_loss_fn(state.model, cfg)(torch_batch(arrays), keys)
    finally:
        for m, n, v in saved:
            setattr(m, n, v)
    return terms


def revert_patches(name):
    """The patches that undo one fix of the data-parallel step."""
    import hipie_torch.losses.criterion as criterion
    import hipie_torch.losses.matcher as matcher
    import hipie_torch.models.dn as dn
    import hipie_torch.utils.rng as rng

    same = lambda x, *a, **k: x
    return {"dn_groups": [(dn, "global_max", same)],
            "normalisers": [(criterion, "global_count", same),
                            (criterion, "count_unit", lambda: 1.0)],
            "draws": [(rng, "_global", lambda shape, axis: list(shape)),
                      (rng, "shard_rows", same), (matcher, "shard_rows", same),
                      (criterion, "data_size", lambda: 1)]}[name]


class GtPredictor:
    """A predictor that answers from each image's ground truth, imperfectly, so
    that every metric lies between 0 and 100: image k's instances are its GT
    segments shifted k + 1 pixels right at seeded scores, plus 3k spurious ones
    (the images' detection counts differ); its panoptic map is the GT's shifted
    alike, without its first segment on odd k; its semantic map the GT's with
    a band relabelled; a grounding answer the shifted GT mask of the segment
    the expression names. Images are told apart by their bytes."""

    def __init__(self, records):
        import hashlib

        self.digest = lambda img: hashlib.sha1(np.ascontiguousarray(img).tobytes()).hexdigest()
        self.records = {self.digest(r["image"]): (k, r) for k, r in enumerate(records)}

    def __call__(self, img, task="detection", expressions=None, test_categories=None,
                 test_is_thing=None, score_thresh=0.0):
        k, rec = self.records[self.digest(img)]
        r = np.random.RandomState(k)
        h, w = img.shape[:2]
        shift = lambda m: np.roll(m, k + 1, axis=1)
        anns = rec["annotations"]
        if task == "grounding":
            anns = [anns[int(expressions.split()[-1])]]
        masks = [shift(a["segmentation"] > 0) for a in anns]
        classes = [a["category_id"] for a in anns]
        for _ in range(0 if task == "grounding" else 3 * k):
            m = np.zeros((h, w), bool)
            y, x = r.randint(0, h - 16), r.randint(0, w - 16)
            m[y:y + r.randint(4, 16), x:x + r.randint(4, 16)] = True
            masks.append(m)
            classes.append(classes[r.randint(len(classes))])
        boxes = [[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                 for ys, xs in (np.nonzero(m) for m in masks)]
        out = {"instances": {"boxes": np.array(boxes, np.float64), "masks": np.stack(masks),
                             "scores": r.uniform(0.05, 1.0, len(masks)),
                             "classes": np.array(classes)}}
        if task == "grounding":
            return out
        pan, segs = shift(rec["pan_seg_gt"]), list(rec["pan_segments"])
        if k % 2:
            pan = np.where(pan == segs[0]["id"], 0, pan)
            segs = segs[1:]
        sem = np.where(rec["sem_seg_gt"] == 255, 0, rec["sem_seg_gt"])
        sem[:, :8 * (k + 1)] = (sem[:, :8 * (k + 1)] + 1) % len(rec["class_names"])
        out.update(panoptic_seg=(pan, segs), sem_seg=sem)
        return out


def sharded_eval():
    """The dataset evaluators over make_tiny_coco's 4 val images with
    ``GtPredictor``: the detection one (box and mask AP, PQ, mIoU), the
    semantic one with a merged label group, and RefCOCO's over two expressions
    an image. Each rank predicts its share."""
    from hipie_torch.data.datasets import get_dataset, materialize_record
    from hipie_torch.evaluation import evaluator

    records = [materialize_record(r) for r in get_dataset("coco_panoptic_val")]
    pred = GtPredictor(records)
    n_cls, is_thing = len(records[0]["class_names"]), records[0]["class_is_thing"]
    out = {"detection": evaluator.evaluate_detection_dataset(
        pred, records, n_cls, is_thing, tasks=("bbox", "segm", "panoptic", "sem_seg")),
        "semseg": evaluator.evaluate_semseg_dataset(pred, records, {
            "ignore_label": 255, "label_group": {c + 1: c % 3 + 1 for c in range(n_cls)},
            "n_merged": 3}),
        "refcoco": evaluator.evaluate_refcoco_dataset(pred, [
            {**r, "expression": f"segment {j}", "annotations": [r["annotations"][j]]}
            for r in records for j in (-2, -1)])}
    for v in out.values():
        v.pop("sec_per_image", None)
    out["detections"] = [len(pred(r["image"])["instances"]["scores"]) for r in records]
    return out


def toy_gradients(rank, reduce):
    """Three linear layers: ``a`` used on rank 0 only, ``b`` on every rank, ``c``
    on none; their gradients after ``reduce``."""
    torch.manual_seed(0)
    a, b, c = (torch.nn.Linear(3, 2) for _ in range(3))
    x = torch.full((1, 3), 1.0 + rank)
    loss = b(x).sum() + (a(x).sum() if rank == 0 else 0.0)
    loss.backward()
    params = [p for m in (a, b, c) for p in m.parameters()]
    reduce(params)
    return [None if p.grad is None else p.grad.clone() for p in params]


def reduce_zero_filled(params):
    """The gradient all-reduce without the has-gradient flags: every missing
    gradient taken as zero."""
    import torch.distributed as dist

    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad)
        p.grad /= dist.get_world_size()


def multihost_checks(rank):
    from hipie_torch.parallel import multihost

    payload = [{"rank": rank, "rows": np.arange(1000 * rank)}] * (rank + 1)
    gathered = multihost.all_gather_objects(payload)
    metrics = multihost.reduce_metrics({"b": 2.0, "a": float(rank)})
    multihost.sync()
    return {"gathered": gathered, "metrics": metrics, "main": multihost.is_main_process(),
            "n": multihost.num_processes()}


def draws(keys, rank=None, cdn=True):
    """CDN's queries for the first step's batch (image ``rank``, or both), the
    point picks of seeded mask logits (2 images x 8 masks) and the matchers'
    mask-cost points (a key an image), from ``keys``."""
    from hipie_torch.losses.matcher import _match_coords
    from hipie_torch.losses.point_features import uncertain_point_coords
    from hipie_torch.models.dn import prepare_cdn
    from hipie_torch.parallel.mesh import data_size, shard_rows

    out = []
    if cdn:
        arrays = step_batches()[0]
        t = torch_batch(arrays if rank is None else rank_rows(arrays, rank)).targets
        q = prepare_cdn(keys, t.labels, t.boxes, t.valid, 80, 20, dn_number=4)
        out = [q.noised_labels, q.refs_unact, q.slot_valid]
    logits = torch.randn(16, 24, 24, generator=torch.Generator().manual_seed(0))
    return out + [uncertain_point_coords(keys, shard_rows(logits), 64),
                  _match_coords(keys.split((2 if rank is None else 1) * data_size()), 32, "cpu")]


def _rank(rank, out_dir):
    """A rank's checks, run by dryrun_multigpu after its step (the group up)."""
    import hipie_torch.data.datasets as datasets
    from hipie_torch.parallel.mesh import COLLECTIVES, reduce_gradients

    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    datasets._register_builtin()
    out = {"draws": draws(generator_keys(3), rank),
           "toy": toy_gradients(rank, reduce_gradients),
           "toy_zero_filled": toy_gradients(rank, reduce_zero_filled),
           "eval": sharded_eval(), "multihost": multihost_checks(rank)}
    path, waited = os.path.join(out_dir, "one.pt"), 0.0
    while not os.path.exists(path) and waited < 600:
        if os.path.exists(os.path.join(out_dir, "abort")):
            raise RuntimeError("the one-process side failed")
        time.sleep(0.1)
        waited += 0.1
    one = torch.load(path, weights_only=False)
    batches = [rank_rows(a, rank) for a in step_batches()]
    COLLECTIVES.clear()
    out["steps"] = recorded_steps(batches, one["steps"]["coords"])
    out["collectives"] = dict(COLLECTIVES)
    out["bg_lang"] = recorded_steps(batches[:1], one["bg_lang"]["coords"], **BG_LANG)
    picks = one["steps"]["coords"][:len(one["steps"]["coords"]) // 2]
    out["reverted"] = {name: loss_terms(batches[0], generator_keys(), picks,
                                        revert_patches(name)) for name in REVERTS}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' records, this process's records, dryrun_multigpu's record
    and what it printed). The one spawn is dryrun_multigpu's: its ranks run
    ``_rank`` after their dryrun step."""
    import contextlib
    import functools
    import io
    from concurrent.futures import ThreadPoolExecutor

    import hipie_torch.data.datasets as datasets
    from hipie_torch.parallel.dryrun import dryrun_multigpu
    from hipie_torch.tools import make_tiny_coco

    tmp = tmp_path_factory.mktemp("parallel")
    root = str(tmp / "data")
    make_tiny_coco.main(["--root", root, "--n-train", "1", "--n-val", "4", "--size", "128"])
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp_env, contextlib.redirect_stdout(printed), \
            ThreadPoolExecutor(1) as pool:
        mp_env.setenv("HIPIE_DATASETS", root)
        datasets._register_builtin()
        dryrun = pool.submit(dryrun_multigpu, WORLD, functools.partial(_rank, out_dir=str(tmp)))
        try:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                with torch.backends.mkldnn.flags(enabled=False):
                    one = {"steps": recorded_steps(step_batches()),
                           "bg_lang": recorded_steps(step_batches()[:1], **BG_LANG)}
            finally:
                torch.set_num_threads(threads)
            torch.save(one, tmp / "one.tmp")
            os.replace(tmp / "one.tmp", tmp / "one.pt")
            one["draws"] = draws(generator_keys(3))
            one["eval"] = sharded_eval()
        except BaseException:
            (tmp / "abort").touch()        # the ranks stop waiting for one.pt
            raise
        finally:
            dry = dryrun.result(timeout=900)
    datasets._register_builtin()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, one, (dry, printed.getvalue())


def mean_terms(per_rank):
    """The ranks' mean of each weighted loss dict's terms."""
    return [{k: float(np.mean([r[i][k] for r in per_rank])) for k in per_rank[0][i]}
            for i in range(len(per_rank[0]))]


def term_errors(got, want):
    """The largest relative error of the loss terms of ``got`` (dicts) against
    ``want``, with the number of terms compared."""
    worst, n = 0.0, 0
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k.startswith("loss"):
                worst = max(worst, abs(g[k] - w[k]) / max(abs(w[k]), 1e-6))
                n += 1
    return worst, n


@pytest.mark.parametrize("run", ["steps", "bg_lang"])
def test_first_step_loss_terms_equal_one_process(runs, run):
    ranks, one, _ = runs
    worst, n = term_errors(mean_terms([r[run]["terms"][0] for r in ranks]),
                           one[run]["terms"][0])
    assert n > 40 and worst <= 1e-5, worst


@pytest.mark.parametrize("run", ["steps", "bg_lang"])
def test_first_step_reduced_gradients_equal_one_process(runs, run):
    ranks, one, _ = runs
    want = one[run]["grads"][0]
    got = ranks[0][run]["grads"][0]
    assert {k for k, v in got.items() if v is None} == {k for k, v in want.items() if v is None}
    largest = max(float(w.norm()) for w in want.values() if w is not None)
    checked = 0
    for name, w in want.items():
        if w is None:
            continue
        for r in ranks:
            assert torch.equal(r[run]["grads"][0][name], got[name]), name
        err = float((got[name].double() - w.double()).norm())
        if float(w.norm()) < 1e-5 * largest:
            assert err <= 1e-5 * largest, name
            continue
        assert err <= 1e-5 * float(w.norm()), (name, err / float(w.norm()))
        checked += 1
    assert checked > 200


def test_second_step_loss_terms_and_ranks_in_lockstep(runs):
    ranks, one, _ = runs
    worst, n = term_errors(mean_terms([r["steps"]["terms"][1] for r in ranks]),
                           one["steps"]["terms"][1])
    assert n > 40 and worst <= 1e-4, worst
    for i in range(2):
        assert len({r["steps"]["digests"][i] for r in ranks}) == 1, f"ranks differ after step {i}"
    # CDN's group count (the CDN and MaskDINO's seg-DN queries), one a
    # criterion pass, the gradient flags, the gradient buckets
    n_coll = ranks[0]["collectives"]["all_reduce"] / 2
    assert 8 <= n_coll <= 16, ranks[0]["collectives"]


def test_draws_are_the_global_batch_rows(runs):
    """CDN's label and box noise, the mask losses' oversampled and random
    points and the matchers' points: each rank's are one process's rows for its
    image (GeneratorKeys: every rank advances the stream alike)."""
    ranks, one, _ = runs
    for want, got in zip(one["draws"], zip(*(r["draws"] for r in ranks))):
        assert torch.equal(torch.cat(got), want)


def test_jax_keys_give_each_rank_its_rows(monkeypatch):
    """The keys that replay JAX's draws, as rank 0 and rank 1 of two (the rank
    and world faked, the draws need no collective): the rows one process gets."""
    import hipie_torch.parallel.mesh as mesh
    import hipie_torch.utils.rng as rng

    want = draws(jax_keys(3), cdn=False)
    got = []
    for rank in range(WORLD):
        with monkeypatch.context() as m:
            for module in (mesh, rng):
                m.setattr(module, "data_size", lambda: WORLD)
            m.setattr(mesh, "data_rank", lambda: rank)
            got.append(draws(jax_keys(3), rank, cdn=False))
    for w, g in zip(want, zip(*got)):
        assert torch.equal(torch.cat(g), w)


@pytest.mark.parametrize("fix", REVERTS)
def test_each_fix_is_needed(runs, fix):
    """With one fix reverted the ranks' mean loss moves off one process's."""
    ranks, one, _ = runs
    worst, _ = term_errors(mean_terms([r["reverted"][fix] for r in ranks]),
                           one["steps"]["terms"][0])
    assert worst > 1e-3, (fix, worst)


def test_gradients_stay_none_where_no_rank_has_one(runs):
    ranks, _, _ = runs
    a_w, a_b, b_w, b_b, c_w, c_b = ranks[0]["toy"]
    for r in ranks:
        got = r["toy"]
        assert all(torch.equal(g, w) for g, w in zip(got[:4], ranks[0]["toy"][:4]))
        assert got[4] is None and got[5] is None
    # a: rank 0's gradient (x = 1) over 2; b: the mean of x = 1 and x = 2
    torch.testing.assert_close(a_w, torch.full((2, 3), 0.5), rtol=0, atol=0)
    torch.testing.assert_close(b_w, torch.full((2, 3), 1.5), rtol=0, atol=0)
    # without the has-gradient flags the unused layer gets a zero gradient
    assert ranks[0]["toy_zero_filled"][4] is not None


def check_sharded_evaluation(runs, evaluation):
    """Every metric of two ranks, each predicting its share, equal to one
    process's; the metrics lie strictly between 0 and 100, and the images'
    detection counts differ, so that a share out of order could show."""
    ranks, one, _ = runs
    assert len(set(one["eval"]["detections"])) == 4
    want = one["eval"][evaluation]
    assert want["images"] == (8 if evaluation == "refcoco" else 4)
    key = {"detection": ("bbox/AP", "segm/AP", "panoptic/PQ", "sem_seg/mIoU"),
           "semseg": ("sem_seg/mIoU", "sem_seg/mIoU_parts"),
           "refcoco": ("mask/oIoU", "mask/mIoU", "box/mIoU")}[evaluation]
    assert all(0 < want[k] < 100 for k in key), want
    for r in ranks:
        assert r["eval"][evaluation] == want


def test_sharded_evaluation_equals_one_process(runs):
    check_sharded_evaluation(runs, "detection")


@pytest.mark.parametrize("evaluation", ["semseg", "refcoco"])
def test_sharded_dataset_evaluators_equal_one_process(runs, evaluation):
    check_sharded_evaluation(runs, evaluation)


def test_multihost_at_two_processes(runs):
    ranks, _, _ = runs
    want = [[{"rank": r, "rows": np.arange(1000 * r)}] * (r + 1) for r in range(WORLD)]
    for rank, r in enumerate(ranks):
        got = r["multihost"]
        assert [len(p) for p in got["gathered"]] == [1, 2]
        for g, w in zip(got["gathered"], want):
            assert [x["rank"] for x in g] == [x["rank"] for x in w]
            assert all(np.array_equal(x["rows"], y["rows"]) for x, y in zip(g, w))
        assert got["metrics"] == {"a": 0.5, "b": 2.0}
        assert got["main"] == (rank == 0) and got["n"] == WORLD


def test_loader_shards_take_one_task_a_step():
    """At num_shards 2 both shards draw the same datasets (hence tasks and
    batch sizes) and their own records; with the dataset drawn from the
    shard's own stream, as JAX's sampler draws it, they would not. At
    num_shards 1 the draws are JAX's."""
    from hipie_tpu.data.loader import MultiDatasetSampler as JSampler
    from hipie_torch.data.loader import MultiDatasetSampler

    def draws(sampler, n=50):
        it = iter(sampler)
        return [next(it) for _ in range(n)]

    shards = [MultiDatasetSampler([5, 7, 9], [1.0, 2.0, 1.0], seed=3, shard_rank=r,
                                  num_shards=2) for r in range(2)]
    d0, d1 = (draws(s) for s in shards)
    assert [d for d, _ in d0] == [d for d, _ in d1] and len({d for d, _ in d0}) == 3
    assert [i for _, i in d0] != [i for _, i in d1]
    shards = [MultiDatasetSampler([5, 7, 9], [1.0, 2.0, 1.0], seed=3, shard_rank=r,
                                  num_shards=2) for r in range(2)]
    for s in shards:
        s.task_rng = s.rng
    d0, d1 = (draws(s) for s in shards)
    assert [d for d, _ in d0] != [d for d, _ in d1]
    rf = [None, np.arange(1.0, 8.0), None]
    assert draws(MultiDatasetSampler([5, 7, 9], [1.0, 2.0, 1.0], seed=3, repeat_factors=rf)) \
        == draws(JSampler([5, 7, 9], [1.0, 2.0, 1.0], seed=3, repeat_factors=rf))


def test_world_size_one_passthroughs_equal_jax():
    """Without a process group the port's multihost functions pass through as
    JAX's do on one host, and the mesh's helpers are the identity."""
    from hipie_tpu.parallel import multihost as jmh
    from hipie_torch.parallel import mesh
    from hipie_torch.parallel import multihost as tmh

    obj = {"x": [1, 2], "y": np.arange(3)}
    assert tmh.all_gather_objects(obj)[0] is obj and jmh.all_gather_objects(obj)[0] is obj
    m = {"loss": 1.5, "ap": 0.25}
    assert tmh.reduce_metrics(m) == jmh.reduce_metrics(m) == m
    assert tmh.is_main_process() == jmh.is_main_process() is True
    assert tmh.num_processes() == jmh.num_processes() == 1
    assert tmh.sync() is None and jmh.sync() is None
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.global_count(x) is x and mesh.global_max(x) is x and mesh.global_sum(x) is x
    assert mesh.gather_batch(x) is x and mesh.shard_rows(x) is x and mesh.count_unit() == 1.0
    assert mesh.reduce_gradients([torch.nn.Parameter(x)]) == 0
    assert mesh.create_mesh() is None and mesh.create_mesh(dp=1) is None


def test_no_fallback_hides_the_card_or_the_group(monkeypatch):
    """tp > 1 without a process group raises, as do a tp that does not divide
    the ranks, more ranks than cards, NCCL without a card and a rendezvous
    that cannot be reached."""
    from hipie_torch.parallel import mesh
    from hipie_torch.tools import eval_net, train_net

    with pytest.raises(RuntimeError, match="tp=2 needs a process group"):
        mesh.create_mesh(tp=2)
    with pytest.raises(ValueError, match="tp=2 does not divide the 1 ranks"):
        train_net.main(["--device", "cpu", "--tp", "2"])
    with pytest.raises(ValueError, match="tp=3 does not divide the 2 ranks"):
        eval_net.main(["--device", "cpu", "--num-gpus", "2", "--tp", "3"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need as many cards"):
        train_net.main(["--num-gpus", "2"])
    with pytest.raises(RuntimeError, match="2 ranks need as many cards"):
        eval_net.main(["--num-gpus", "2"])
    with pytest.raises(RuntimeError, match="2 NCCL ranks on this node need as many cards"):
        mesh.init_distributed("nccl", "tcp://127.0.0.1:1", rank=0, world_size=2)
    monkeypatch.undo()
    with pytest.raises(RuntimeError):
        mesh.init_distributed("gloo", "tcp://127.0.0.1:1", rank=1, world_size=2, timeout_s=1)
    assert not torch.distributed.is_initialized()


def test_dryrun_multigpu_prints_its_ok_line(runs):
    """One full train step at dryrun_config() on 2 gloo ranks: finite loss,
    bit-identical rank states (the ranks check), the OK line; at 2 ranks JAX's
    grid is tp = 2, so the SP leg (the loss within 1e-3 of the dense step's)
    and the sharded-inference leg (against the whole model) run too."""
    _, _, (rec, printed) = runs
    assert np.isfinite(rec["loss"]) and rec["collectives"] > 0
    assert "dryrun_multigpu OK: 2 ranks (gloo, dp=1, tp=2)" in printed
    assert (rec["dp"], rec["tp"]) == (1, 2) and np.isfinite(rec["sp_loss"])
    assert "dryrun_multigpu SP OK" in printed and "inference OK" in printed
