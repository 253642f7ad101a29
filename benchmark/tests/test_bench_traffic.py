"""Every seed asks the same work of the program: the traffic's counts."""

import pytest
import torch

from harness import common, traffic


def _train_counts(mix, seed):
    pool = traffic.train_pool(mix, seed, 256, 30522, 80, torch.device("cpu"))
    return [traffic.work_counts(mix, b) for b in pool]


def test_train_work_counts_are_the_same_for_seeds_0_to_11():
    mix = dict(common.load_cell("vith_train_coco").traffic, image=128, widths=[128, 112])
    want = _train_counts(mix, 0)
    for seed in range(1, 12):
        assert _train_counts(mix, seed) == want
    # every step of the pool's cycle has the same number of valid GTs
    assert len({sum(c["valid"]) for c in want}) == 1
    assert [c["valid"] for c in want] == traffic.valid_counts(mix)


def test_train_pool_draws_differ_between_seeds_and_batches():
    mix = dict(common.load_cell("vith_train_coco").traffic, image=128, widths=[128, 112])
    a = traffic.train_pool(mix, 0, 256, 30522, 80, torch.device("cpu"))
    b = traffic.train_pool(mix, 1, 256, 30522, 80, torch.device("cpu"))
    assert not torch.equal(a[0]["images"], b[0]["images"])
    assert not torch.equal(a[0]["images"], a[1]["images"])
    assert not torch.equal(a[0]["boxes"], b[0]["boxes"])
    again = traffic.train_pool(mix, 0, 256, 30522, 80, torch.device("cpu"))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, again) for k in x)
    # pad columns are zero and masks stay inside the valid width
    assert not a[0]["images"][1, :, 112:].any()
    assert not a[0]["masks"][1, :, :, 28:].any()


@pytest.mark.parametrize("seed", range(12))
def test_serve_requests_are_the_same_work_for_every_seed(seed):
    mix = dict(common.load_cell("vith_serve_coco").traffic, image=[32, 32])
    pool = traffic.serve_pool(mix, seed, pin=False)
    assert tuple(pool.shape) == (mix["pool"], 32, 32, 3) and pool.dtype == torch.uint8
    reqs = [traffic.serve_request_images(mix, k) for k in range(mix["pool"])]
    assert all(len(set(r)) == mix["batch"] for r in reqs)
    assert {i for r in reqs for i in r} == set(range(mix["pool"]))
    assert len({bytes(pool[i].numpy()) for i in range(mix["pool"])}) == mix["pool"]
