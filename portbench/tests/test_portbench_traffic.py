"""Seeded inputs and traffic repeat exactly, and a seed changes the order and
the cases, not the work."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import inputs, manifest as mf, traffic

SEED = 2 ** 31 + 4321


def test_inputs_repeat_and_follow_the_frozen_generator():
    foam2d = mf.plugin("datasets", "foam2d")
    a = foam2d.make_batch(3, 24, 16, 8, inputs.rng(SEED, inputs.DATA))
    b = foam2d.make_batch(3, 24, 16, 8, inputs.rng(SEED, inputs.DATA))
    assert np.array_equal(a[0], b[0])
    assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
    # the program's own generator at commit 4a0a8ad draws the same cases
    from porous_cfd_tpu_torch.data.synthetic import make_foam_batch
    theirs = make_foam_batch(3, 24, 16, 8, rng=inputs.rng(SEED, inputs.DATA))
    assert np.array_equal(theirs.data.numpy(), a[0])
    assert [k for k, v in theirs.labels if v is None] == list(foam2d.COLUMNS)


def test_train_schedule_repeats():
    mix = mf.traffic("train_b52")
    a, b = traffic.epochs(mix, SEED, 5), traffic.epochs(mix, SEED, 5)
    assert np.array_equal(a, b) and a.shape == (5, 4, 52)
    for epoch in a:          # the rows of an epoch all differ
        assert len(set(epoch.ravel())) == epoch.size
    assert not np.array_equal(a, traffic.epochs(mix, SEED + 1, 5))


@pytest.mark.parametrize("mix_name,seconds", [("serve", 1), ("serve", 10),
                                              ("serve_saturated", 1)])
def test_serve_schedule_repeats_with_the_same_work(mix_name, seconds):
    mix = mf.traffic(mix_name)
    a, b = traffic.requests(mix, SEED, seconds), traffic.requests(mix, SEED, seconds)
    assert [d for d, _ in a] == [d for d, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    other = traffic.requests(mix, SEED + 1, seconds)
    assert sorted(len(i) for _, i in a) == sorted(len(i) for _, i in other)
    assert [len(i) for _, i in a] != [len(i) for _, i in other]
    assert len(a) == round(mix["rate_rps"] * seconds)
    for _, ids in a:
        assert mix["min_cases"] <= len(ids) <= mix["max_cases"]
        assert len(set(ids)) == len(ids) and ids.max() < mix["pool"]


def test_any_whole_blocks_from_the_start_are_the_same_work():
    """A window above capacity finishes a prefix of the schedule: every
    prefix of whole blocks sends each size once a block, whatever the seed."""
    mix = mf.traffic("serve_saturated")
    k = mix["max_cases"] - mix["min_cases"] + 1
    for seed in (SEED, SEED + 1):
        sizes = [len(i) for _, i in traffic.requests(mix, seed, 0.5)]
        for b in range(0, len(sizes) - k + 1, k):
            assert sorted(sizes[b:b + k]) == list(range(mix["min_cases"], mix["max_cases"] + 1))
