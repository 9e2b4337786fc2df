"""The port's training benchmark (the counterpart of ``bench.py``): steps/s
of the training step at the reference envelope, batch 13 of
``make_foam_batch(52, 1500, 1000, 700, seed 8421)``, for the headline
``pipn`` (the duct_fixed_boundary model on its decoupled analytic path)
and the other model families.

    python -m porous_cfd_tpu_torch.bench [--runs 5] [--epochs 10]

It prints ONE JSON line: the headline steps/s under ``value``, each
family's steps/s under ``families`` (the U-Nets ``pipn_pp_full`` and
``pi_gano_pp_full`` among them), every run's steps/s under ``runs``, the
envelope, and the card's name and power limit as ``nvidia-smi`` gives them.
Timing: after a warm-up epoch, the median of ``--runs`` runs of
``--epochs`` whole epochs (4 steps each at the envelope), each run between
two device syncs. Weights come from seed 8421 and the models are the
examples' zoo at full width, trained with the examples' fixed loss weights.
Any error fails the run. It runs on the CUDA card; ``run(argv,
device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed
from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as variable
from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions
from porous_cfd_tpu_torch.utils import profiling

SEED = 8421
# the envelope: make_foam_batch(CASES, *POINTS, seed=SEED) in batches of BATCH
CASES, BATCH = 52, 13
POINTS = (1500, 1000, 700)  # internal, boundary, observation
# family -> (example, --model, extra flags)
FAMILIES = {
    "pipn": (fixed, "pipn", []),
    "pipn_coupled": (fixed, "pipn", ["--coupled-context"]),
    "pipn_exact": (fixed, "pipn", ["--exact-derivatives"]),
    "pipn_pp": (fixed, "pipn-pp", []),
    "pipn_pp_mrg": (fixed, "pipn-pp-mrg", []),
    "pi_gano": (variable, "pi-gano", []),
    "pi_gano_full": (variable, "pi-gano-full", []),
    "pi_gano_pp": (variable, "pi-gano-pp", []),
    "pipn_pp_full": (fixed, "pipn-pp-full", []),
    "pi_gano_pp_full": (variable, "pi-gano-pp-full", []),
}


def make_model(family: str, device):
    """The family's model at full width with its example's fixed loss
    scaler."""
    example, model_type, flags = FAMILIES[family]
    args = example.build_arg_parser().parse_args(["--model", model_type, *flags])
    return example.get_model(args, make_scalers(), device), example.get_loss_scaler(args)


def measure_family(family: str, data, device, batch: int, runs: int, epochs: int) -> list:
    """steps/s of each of ``runs`` runs of ``epochs`` whole epochs (the
    cases shuffled each epoch, the last short batch dropped), after one
    warm-up epoch; every run starts and ends in a device sync."""
    model, scaler = make_model(family, device)
    dataset = model.attach_neighbors(data.to(device))
    n_cases = len(dataset)
    steps = n_cases // batch
    fns = make_train_functions(model, make_optimizer(model, steps), scaler)
    state = fns.init_state(seed=SEED)
    host_rng = np.random.default_rng(0)

    def perms(k):
        return np.stack([host_rng.permutation(n_cases)[:steps * batch].reshape(steps, batch)
                         for _ in range(k)])

    state, m = fns.train_epochs(state, dataset, perms(1))
    rates, totals = [], [float(m[0, 0])]
    for _ in range(runs):
        p = perms(epochs)
        profiling.sync(device)
        t0 = time.perf_counter()
        state, m = fns.train_epochs(state, dataset, p)
        profiling.sync(device)
        rates.append(epochs * steps / (time.perf_counter() - t0))
        totals.append(float(m[-1, 0]))
    if not np.isfinite(totals).all():
        raise FloatingPointError(f"{family}: non-finite loss {totals}")
    return rates


def card_label(device) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them; None
    on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(device.index or 0)], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--epochs", type=int, default=10)
    return p


def run(argv=None, device=None) -> dict:
    """Benchmark on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for); prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = make_foam_batch(CASES, *POINTS, seed=SEED)
    steps = {}
    runs = {}
    for family in FAMILIES:
        rates = measure_family(family, data, device, BATCH, args.runs, args.epochs)
        steps[family] = statistics.median(rates)
        runs[family] = rates
        if device.type == "cuda":
            torch.cuda.empty_cache()
    metric = (f"train_steps_per_sec (2D duct PIPN, batch {BATCH}, "
              f"{POINTS[0] + POINTS[1]} pts)")
    out = {"metric": metric, "value": steps["pipn"],
           "unit": "steps/s", "families": steps, "runs": runs,
           "timing": f"median of {args.runs} runs of {args.epochs} epochs of "
                     f"{CASES // BATCH} steps, each between two device syncs",
           "envelope": {"cases": CASES, "batch": BATCH, "points": list(POINTS), "seed": SEED},
           "device": str(device), "card": card_label(device),
           "torch": torch.__version__}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()
