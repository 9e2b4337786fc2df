"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and a run's seed, and gives the schedule.

A ``train`` mix: a pool of ``cases`` cases, batches of ``batch`` drawn by a
seeded permutation each epoch, the last short batch dropped.

A ``serve`` mix: requests due at a fixed rate ``rate_rps`` from the
window's start (one every 1 / rate seconds), each of ``min_cases`` to
``max_cases`` cases of a seeded pool of ``pool`` cases. The sizes run
through ``min_cases`` .. ``max_cases`` in blocks, each block in a seeded
order: every seed sends the same multiset of sizes, and so does every run of
whole blocks from the start (what a window above capacity finishes), so that
seeds change the order and the cases, not the work.
"""
from __future__ import annotations

import numpy as np

from portbench.inputs import TRAFFIC, rng


def epochs(mix: dict, seed: int, n_epochs: int) -> np.ndarray:
    """(n_epochs, steps, batch) case indices."""
    r = rng(seed, TRAFFIC)
    steps = mix["cases"] // mix["batch"]
    return np.stack([r.permutation(mix["cases"])[:steps * mix["batch"]]
                     .reshape(steps, mix["batch"]) for _ in range(n_epochs)])


def requests(mix: dict, seed: int, seconds: float, stream: int = 0):
    """[(due seconds from the window's start, case indices)] of the
    requests due in ``seconds``; ``stream`` gives another schedule of the
    same mix (the traced stretch's)."""
    n = max(1, int(round(mix["rate_rps"] * seconds)))
    lo, hi = mix["min_cases"], mix["max_cases"]
    r = rng(seed, TRAFFIC * 1000 + stream)
    k = hi - lo + 1
    base = lo + np.arange(n) % k
    sizes = np.concatenate([r.permutation(base[s:s + k]) for s in range(0, n, k)])
    return [(i / mix["rate_rps"], np.sort(r.choice(mix["pool"], size=int(s), replace=False)))
            for i, s in enumerate(sizes)]
