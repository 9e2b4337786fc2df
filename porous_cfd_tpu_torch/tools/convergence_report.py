"""The manufactured-solutions verification run, in the port (the counterpart
of ``tools/convergence_report.py``): train the zoo's models for the
reference envelope and score them against the ANALYTIC ground truth, which
no solver or dataset can skew.

  * data: 26 cases of ``make_manufactured_batch(rng(8421), 26, 1000, 200)``
    in batches of 13, two steps an epoch, cases permuted per epoch by a
    host rng of seed 8421; 4 held-out cases drawn next from the same rng;
  * ``pipn``: ``pipn_manufactured`` on its max-pool-coupled analytic path
    (the JAX tool's model); ``pipn-pp``: ``pipn_manufactured_pp`` at the
    zoo's widths on its analytic path;
  * 3000 epochs; then the rel-L2 of U and p on the first 4 trained cases
    and on the 4 held-out ones, predicted in f32.

It prints one JSON line per model: the trained and held-out rel-L2, the
final total loss, the total loss every LOG_EVERY epochs, the wall
time of the training loop (ending in a device sync), steps/s, and the
card's name and power limit. It writes no file.

    python -m porous_cfd_tpu_torch.tools.convergence_report [--epochs 3000]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from porous_cfd_tpu_torch.bench import card_label
from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.manufactured_solutions.train import (D, F, N_BOUNDARY_IDS,
                                                                        N_DIM, NU, SEED,
                                                                        get_model)
from porous_cfd_tpu_torch.models.pipn import pipn_manufactured
from porous_cfd_tpu_torch.train.engine import (gather_cases, make_optimizer,
                                               make_predict_functions, make_train_functions)
from porous_cfd_tpu_torch.utils import profiling

# the bar, on both splits: rel-L2 of U and p below 5%
BAR = 0.05
# the envelope: the JAX tool's 26 cases of 1000 internal and 200 boundary
# points in batches of 13, 4 cases scored a split; the total loss read (a
# device sync) every LOG_EVERY epochs
MODELS = ("pipn", "pipn-pp")
CASES, BATCH, POINTS, SCORED_CASES = 26, 13, (1000, 200), 4
LOG_EVERY = 250


def rel_l2(pred, ref) -> float:
    return float(np.linalg.norm(pred - ref) / np.linalg.norm(ref))


def build_model(name: str, device):
    """``pipn`` on its coupled analytic path (the zoo's widths), or the
    zoo's ``pipn-pp``."""
    if name == "pipn":
        return pipn_manufactured(NU, D, F, fe_local_layers=[N_DIM, 64, 64],
                                 fe_global_layers=[64 + N_BOUNDARY_IDS + 1, 64, 128, 1024],
                                 seg_layers=[1024 + 64, 512, 256, 128, 3],
                                 fast_derivatives=True, coupled_context=True,
                                 generator=torch.Generator().manual_seed(SEED), device=device)
    return get_model(name, D, F, device)


def train_and_score(name: str, epochs: int, data, val, device) -> dict:
    """Train ``name`` on ``data`` (stacked cases on the host) and score it."""
    model = build_model(name, device)
    ds = model.attach_neighbors(data.to(device))
    vb = model.attach_neighbors(val.to(device))
    n_cases = ds.data.shape[0]
    steps_per_epoch = n_cases // BATCH
    fns = make_train_functions(model, make_optimizer(model, steps_per_epoch))
    state = fns.init_state(seed=SEED)
    host = np.random.default_rng(SEED)
    losses = []
    profiling.sync(device)
    t0 = time.perf_counter()
    for epoch in range(epochs):
        perm = host.permutation(n_cases)[:steps_per_epoch * BATCH]
        state, m = fns.train_epoch(state, ds, perm.reshape(steps_per_epoch, BATCH))
        if (epoch + 1) % LOG_EVERY == 0:
            losses.append([epoch + 1, float(m[0])])
    profiling.sync(device)
    wall = time.perf_counter() - t0
    final_loss = float(m[0])

    predict = make_predict_functions(model)
    scores = {}
    for split, stacked in (("train", ds), ("val", vb)):
        b = gather_cases(stacked, torch.arange(SCORED_CASES, device=device))
        pred = predict.predict_batch(b, False).numpy()
        ref = b.numpy()
        scores[split] = {k: rel_l2(np.asarray(pred[k]), np.asarray(ref[k]))
                         for k in ("U", "p")}
    steps = epochs * steps_per_epoch
    return {"model": name, "epochs": epochs, "steps": steps, "wall_s": wall,
            "steps_per_s": steps / wall, "final_loss": final_loss, **scores,
            "bar_met": all(max(s.values()) < BAR for s in scores.values()),
            "loss_curve": losses}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3000)
    return ap


def main(argv=None, device=None) -> list[dict]:
    """Run the verification on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for); returns the per-model lines it printed."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    rng = np.random.default_rng(SEED)
    data = make_manufactured_batch(rng, CASES, *POINTS, NU, D, F)
    val = make_manufactured_batch(rng, SCORED_CASES, *POINTS, NU, D, F)
    card = card_label(device)
    out = []
    for name in MODELS:
        res = train_and_score(name, args.epochs, data, val, device)
        res = {**res, "card": card, "device": str(device)}
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main()
