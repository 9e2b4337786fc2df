"""The golden-duct accuracy run of the duct_fixed_boundary experiment, in
the port (the counterpart of ``tools/train_golden_duct.py``):

  1. solves 13 training and 4 held-out duct cases with the port's
     finite-volume solver (``datagen/fvm.py``) and writes them in the case
     layout, with their ``meta.json`` and ``min_points.json``;
  2. trains ``pipn`` on its decoupled analytic path through the port's
     training CLI (``examples/duct_fixed_boundary/train.py``) at batch 13,
     1500/350/700 internal/boundary/observation points (the grid exposes
     2 * (nx + ny) boundary faces), validation every 25 epochs;
  3. scores the checkpoint: denormalised rel-L2 of U and p against the CFD
     fields on both splits, predicted in f32;
  4. runs the evaluate CLI on the held-out split.

It writes ``<root>/golden_scores.json`` and prints it.

    python -m porous_cfd_tpu_torch.tools.train_golden_duct [--epochs 3000]
        [--root data/golden_duct] [--reuse-data] [--coupled] [--exact]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.datagen import fvm
from porous_cfd_tpu_torch.datagen.meta import generate_meta, generate_min_points
from porous_cfd_tpu_torch.datagen.synthetic_case import write_data_config
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate as fixed_evaluate
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
from porous_cfd_tpu_torch.train.trainer import load_checkpoint
from porous_cfd_tpu_torch.utils import profiling

# the deterministic geometry zoo: 13 training cases (one batch), 4 held out
TRAIN_CASES = [
    ("circle", 0.10, 0.00, 0.12, 0.0),
    ("ellipse", 0.05, 0.02, 0.14, 0.4),
    ("rectangle", 0.12, -0.03, 0.11, 0.2),
    ("triangle", 0.08, 0.00, 0.13, 0.0),
    ("rhombus", 0.10, 0.04, 0.12, 0.6),
    ("circle", 0.20, -0.05, 0.10, 0.0),
    ("rectangle", 0.00, 0.00, 0.12, 0.8),
    ("ellipse", 0.15, -0.02, 0.12, 1.2),
    ("triangle", 0.05, 0.05, 0.11, 0.5),
    ("rhombus", 0.18, -0.04, 0.13, 0.3),
    ("circle", 0.10, 0.06, 0.13, 0.0),
    ("rectangle", 0.07, 0.02, 0.10, 1.1),
    ("ellipse", 0.02, -0.04, 0.13, 0.9),
]
VAL_CASES = [
    ("circle", 0.14, 0.03, 0.11, 0.0),
    ("triangle", 0.12, -0.02, 0.12, 0.9),
    ("rectangle", 0.16, 0.01, 0.12, 0.5),
    ("rhombus", 0.06, -0.03, 0.11, 0.0),
]
# the bar: trained rel-L2 of both U and p below 5%
BAR = 0.05
# each derivative path: (run name, training CLI flags)
PATHS = {"decoupled": ("golden-pipn-decoupled", []),
         "coupled": ("golden-pipn-coupled", ["--coupled-context"]),
         "exact": ("golden-pipn-exact", ["--exact-derivatives"])}


def generate(root: Path, nx: int, ny: int, train_cases=TRAIN_CASES,
             val_cases=VAL_CASES) -> dict:
    """Solve and write both splits; returns the solve's seconds per split."""
    seconds = {}
    for split, cases in (("train", train_cases), ("val", val_cases)):
        print(f"solving {len(cases)} {split} cases at {nx}x{ny} ...", flush=True)
        t0 = time.perf_counter()
        fvm.write_golden_split(root / split, cases, nx=nx, ny=ny)
        seconds[split] = time.perf_counter() - t0
        print(f"  done in {seconds[split]:.1f} s", flush=True)
        write_data_config(root / split, ["C", "U", "p", "cellToRegion"], {},
                          {"Scale": [], "Standardize": ["C", "U", "p"]}, ["x", "y"])
        generate_meta(root / split, "C", "U", "p", "cellToRegion", max_dim=2)
    generate_min_points(root)
    return seconds


def rel_l2(pred, ref) -> float:
    return float(np.linalg.norm(pred - ref) / np.linalg.norm(ref))


def score_checkpoint(root: Path, ckpt: Path, flags, points, device) -> dict:
    """Denormalised rel-L2 of U and p against the CFD fields on the trained
    and held-out splits, every case of a split in one f32 batch."""
    n_int, n_bnd, n_obs = points
    train_ds = FoamDataset(str(root / "train"), n_int, n_bnd, n_obs,
                           np.random.default_rng(fixed_train.SEED))
    args = fixed_train.build_arg_parser().parse_args(["--model", "pipn", *flags])
    model = fixed_train.get_model(args, train_ds.normalizers, device)
    load_checkpoint(str(ckpt), model)
    fns = make_predict_functions(model)
    u_s, p_s = (train_ds.normalizers[k].to("cpu") for k in ("U", "p"))
    scores = {}
    for split in ("train", "val"):
        ds = FoamDataset(str(root / split), n_int, n_bnd, n_obs,
                         np.random.default_rng(fixed_train.SEED), meta_dir=str(root / "train"))
        stacked = model.attach_neighbors(ds.stacked().to(device))
        batch = gather_cases(stacked, torch.arange(len(ds), device=device))
        pred = fns.predict_batch(batch, False).numpy()
        ref = batch.numpy()

        def denorm(scaler, x):
            return scaler.inverse_transform(torch.as_tensor(np.asarray(x))).numpy()

        scores[split] = {"U": rel_l2(denorm(u_s, pred["U"]), denorm(u_s, ref["U"])),
                         "p": rel_l2(denorm(p_s, pred["p"]), denorm(p_s, ref["p"]))}
    return scores


def train_and_score(root: Path, path: str, epochs: int, points, logs_dir: Path,
                    device) -> dict:
    """Train one derivative path through the CLI, then score it."""
    name, flags = PATHS[path]
    ckpt = logs_dir / "lightning_logs" / name / "model.ckpt"
    n_int, n_bnd, n_obs = points
    argv = ["--model", "pipn", "--name", name, "--epochs", str(epochs),
            "--train-dir", str(root / "train"), "--val-dir", str(root / "val"),
            "--n-internal", str(n_int), "--n-boundary", str(n_bnd),
            "--n-observations", str(n_obs), "--batch-size", str(len(TRAIN_CASES)),
            "--logs-dir", str(logs_dir), "--log-every", "25", *flags]
    t0 = time.perf_counter()
    fixed_train.run(argv, device=device)
    profiling.sync(device)
    wall = time.perf_counter() - t0
    # one step an epoch: the training split is one batch; the wall time
    # includes the CLI's loading of both splits
    return {"wall_s": wall, "epochs": epochs, "steps_per_s": epochs / wall,
            **score_checkpoint(root, ckpt, flags, points, device), "ckpt": str(ckpt)}


def run_evaluation(root: Path, ckpt: str, points, device) -> dict:
    n_int, n_bnd, n_obs = points
    return fixed_evaluate.run([
        "--data-dir", str(root / "val"), "--meta-dir", str(root / "train"),
        "--checkpoint", ckpt, "--n-internal", str(n_int), "--n-boundary", str(n_bnd),
        "--n-observations", str(n_obs)], device=device)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_duct")
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--nx", type=int, default=120)
    ap.add_argument("--ny", type=int, default=72)
    ap.add_argument("--n-internal", type=int, default=1500)
    ap.add_argument("--n-boundary", type=int, default=350,
                    help="boundary sample count; the grid exposes 2*(nx+ny) boundary "
                         "faces, so keep it below that")
    ap.add_argument("--n-observations", type=int, default=700)
    ap.add_argument("--reuse-data", action="store_true",
                    help="train on the splits already under --root instead of solving them "
                         "again")
    ap.add_argument("--coupled", action="store_true",
                    help="also train and score the max-pool-coupled analytic path")
    ap.add_argument("--exact", action="store_true",
                    help="also train and score the exact autodiff path")
    return ap


def main(argv=None, device=None) -> dict:
    """Run the golden duct on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for); returns the scores written to ``<root>/golden_scores.json``."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    root = Path(args.root).resolve()
    points = (args.n_internal, args.n_boundary, args.n_observations)
    results: dict = {"grid": [args.nx, args.ny], "points": list(points),
                     "train_cases": len(TRAIN_CASES), "val_cases": len(VAL_CASES)}
    if not args.reuse_data or not (root / "train").exists():
        results["solve_s"] = generate(root, args.nx, args.ny)
    logs_dir = root / "logs"
    paths = ["decoupled"] + ["coupled"] * args.coupled + ["exact"] * args.exact
    for path in paths:
        results[path] = train_and_score(root, path, args.epochs, points, logs_dir, device)
    results["bar_met"] = all(max(results[p]["train"]["U"], results[p]["train"]["p"]) < BAR
                             for p in paths)
    results["evaluate_val"] = run_evaluation(root, results["decoupled"]["ckpt"], points,
                                             device)
    (root / "golden_scores.json").write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
