"""The traffic is a function of the seed: the same seed gives the same
requests and micro-batches, another seed other ones; an open loop's arrival
schedule is the same for every seed, its gaps the exponential's quantiles,
its bursts as many requests at once as the mix says."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import traffic
from benchmark.reference.engine import CHARSET
from benchmark.run import load_cell
from benchmark.tests.tiny import ROOT

SEEDS = (2**31 + 7, 5)


def _reqs(seed):
    mix = load_cell(ROOT, "serve-saturated").traffic
    return traffic.requests(dict(mix, pool=6), seed, 64, CHARSET)


def test_requests_follow_the_seed():
    a, b, c = _reqs(SEEDS[0]), _reqs(SEEDS[0]), _reqs(SEEDS[1])
    for x, y in zip(a, b):
        assert np.array_equal(x.image, y.image) and np.array_equal(x.mask, y.mask)
        assert x.text == y.text
    assert any(not np.array_equal(x.image, z.image) or x.text != z.text for x, z in zip(a, c))
    for r in a:
        assert 1 <= len(r.text) <= 12 and r.image.dtype == np.uint8 and r.mask.max() == 255


def test_arrivals_are_one_schedule():
    mix = load_cell(ROOT, "serve-poisson").traffic
    a, b = traffic.arrival_gaps(mix, 50.0), traffic.arrival_gaps(mix, 50.0)
    assert np.array_equal(a, b) and not np.array_equal(a, np.sort(a))
    assert len(a) == int(np.ceil(mix["rate_per_s"] * 50.0)) + 1
    assert abs(a.mean() * mix["rate_per_s"] - 1.0) < 0.05
    # a longer schedule has the same number of gaps a second
    assert abs(len(traffic.arrival_gaps(mix, 100.0)) / len(a) - 2.0) < 0.05


def test_bursts_keep_the_rate():
    mix = dict(load_cell(ROOT, "serve-poisson").traffic, burst=4)
    gaps = traffic.arrival_gaps(mix, 50.0).reshape(-1, 4)
    assert np.all(gaps[:, 1:] == 0.0) and np.all(gaps[:, 0] > 0.0)
    assert abs(gaps.size / gaps.sum() / mix["rate_per_s"] - 1.0) < 0.05
    # one request an event is the Poisson schedule itself
    assert np.array_equal(traffic.arrival_gaps(dict(mix, burst=1), 50.0),
                          traffic.arrival_gaps(load_cell(ROOT, "serve-poisson").traffic, 50.0))


def _micro_batch(mix, seed, step, index):
    cpu = torch.device("cpu")
    return dict(traffic.train_rows(mix, seed, step, index, 64, 12, CHARSET, cpu),
                **traffic.loss_draws(mix, seed, step, index, 8, 0.1, 1000, cpu))


def test_micro_batches_follow_the_seed():
    mix = dict(load_cell(ROOT, "finetune-b16x4").traffic, micro_batch=3)
    a = _micro_batch(mix, SEEDS[0], 0, 1)
    b = _micro_batch(mix, SEEDS[0], 0, 1)
    c = _micro_batch(mix, SEEDS[1], 0, 1)
    d = _micro_batch(mix, SEEDS[0], 1, 1)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["image"], c["image"]) and not torch.equal(a["noise"], d["noise"])
    assert not torch.equal(a["image"], d["image"])
    # every row differs, and the masks and character maps agree
    assert len({tuple(r.flatten()[:64].tolist()) for r in a["image"]}) == 3
    assert torch.equal(a["mask"][..., 0], a["seg"].amax(-1))
    assert torch.equal((a["label_ids"] > 0).float(), a["seg_mask"])
