"""The 3D golden run of the abc experiment, in the port (the counterpart of
``tools/train_golden_3d.py``):

  1. solves 8 training and 3 held-out 3D duct cases (porous sphere, box and
     cylinder obstacles, variable inlet speed: the abc protocol) with the
     batched solver on the device (``datagen/fvm3d_batch.py``), and writes
     them in the case layout (4,000 internal points and 500 a patch a case)
     with their ``meta.json`` and ``min_points.json``;
  2. trains ``pipn`` on its decoupled analytic path through the port's abc
     training CLI (``examples/abc/train.py``) at batch 8, 1500/1000/700
     internal/boundary/observation points, seed 8421, validation every 25
     epochs;
  3. scores the checkpoint: denormalised rel-L2 of U and p against the
     solved fields on both splits, predicted in f32;
  4. runs the abc evaluate CLI on the held-out split.

It writes ``<root>/golden_3d_scores.json`` and prints it as one JSON line.

    python -m porous_cfd_tpu_torch.tools.train_golden_3d [--epochs 1500]
        [--root data/golden_3d] [--reuse-data] [--zoo N]

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
from porous_cfd_tpu_torch.datagen import fvm3d
from porous_cfd_tpu_torch.datagen.fvm3d_batch import solve_duct3_batch
from porous_cfd_tpu_torch.datagen.meta import generate_meta, generate_min_points
from porous_cfd_tpu_torch.datagen.synthetic_case import write_data_config
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.abc import evaluate as abc_evaluate
from porous_cfd_tpu_torch.examples.abc import train as abc_train
from porous_cfd_tpu_torch.tools.train_golden_duct import rel_l2
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
from porous_cfd_tpu_torch.train.trainer import load_checkpoint
from porous_cfd_tpu_torch.utils import profiling

# (shape, center, size, u_inlet): the reference's hand-written cases
TRAIN_CASES = [
    ("sphere", (0.10, 0.00, 0.00), 0.14, 0.20),
    ("sphere", (0.05, 0.04, -0.03), 0.12, 0.15),
    ("box", (0.12, -0.03, 0.02), 0.12, 0.20),
    ("box", (0.00, 0.00, 0.00), 0.14, 0.175),
    ("cylinder", (0.10, 0.02, 0.00), 0.10, 0.20),
    ("cylinder", (0.18, -0.04, 0.00), 0.12, 0.15),
    ("sphere", (0.15, -0.02, 0.04), 0.13, 0.175),
    ("box", (0.08, 0.04, -0.04), 0.11, 0.15),
]
VAL_CASES = [
    ("sphere", (0.12, 0.03, 0.02), 0.13, 0.175),
    ("cylinder", (0.06, -0.02, 0.00), 0.11, 0.20),
    ("box", (0.16, 0.00, -0.02), 0.12, 0.20),
]
FIELDS = ["C", "U", "p", "cellToRegion", "d", "f"]
# the march: the reference driver's tolerance, step limit and cases a march
TOL, MAX_STEPS, CHUNK = 2e-4, 12000, 30
# internal points and boundary faces a patch written a case (all of them
# where the grid has fewer)
CASE_INTERNAL, CASE_PER_PATCH = 4000, 500


def zoo_cases(n_train: int, n_val: int, seed: int = 8421):
    """A random 3D case zoo over the hand-written cases' envelope (shape x
    center x size x inlet speed)."""
    rng = np.random.default_rng(seed)
    shapes = ["sphere", "box", "cylinder"]

    def draw():
        return (shapes[int(rng.integers(3))],
                (float(rng.uniform(0.0, 0.18)), float(rng.uniform(-0.04, 0.04)),
                 float(rng.uniform(-0.04, 0.04))),
                float(rng.uniform(0.10, 0.14)),
                float(rng.uniform(0.15, 0.20)))

    return [draw() for _ in range(n_train)], [draw() for _ in range(n_val)]


def generate(root: Path, nx: int, ny: int, nz: int, train_cases=TRAIN_CASES,
             val_cases=VAL_CASES, device=None) -> dict:
    """Solve (CHUNK cases a march) and write both splits; returns each
    split's solve: seconds, steps marched and the cases' largest step count
    and residual."""
    stats = {}
    for split, cases in (("train", train_cases), ("val", val_cases)):
        print(f"[{split}] solving {len(cases)} 3D cases at {nx}x{ny}x{nz} "
              f"(batched march, chunk {CHUNK})", flush=True)
        split_stats = {"cases": len(cases), "solve_s": 0.0, "steps_marched": 0,
                       "max_case_steps": 0, "max_residual": 0.0}
        for c0 in range(0, len(cases), CHUNK):
            chunk = cases[c0:c0 + CHUNK]
            march: dict = {}
            sols = solve_duct3_batch(chunk, nx=nx, ny=ny, nz=nz, nu=abc_train.NU,
                                     d=abc_train.D, f=abc_train.F, tol=TOL,
                                     max_steps=MAX_STEPS, device=device, stats=march)
            per_case = int(march["seconds"] * 1e9) // len(chunk)
            split_stats["solve_s"] += march["seconds"]
            split_stats["steps_marched"] += march["steps"]
            for j, ((shape, _, _, u_in), sol) in enumerate(zip(chunk, sols)):
                i = c0 + j
                if sol.residual > 2e-3:
                    print(f"  WARNING case_{i}_{shape}: residual {sol.residual:.2e} after "
                          f"{sol.steps} steps", flush=True)
                split_stats["max_case_steps"] = max(split_stats["max_case_steps"], sol.steps)
                split_stats["max_residual"] = max(split_stats["max_residual"], sol.residual)
                fvm3d.solution_to_case3(sol, root / split / f"case_{i}_{shape}",
                                        n_internal=CASE_INTERNAL,
                                        rng=np.random.default_rng(8421 + i), d=abc_train.D,
                                        f=abc_train.F, nu=abc_train.NU, u_inlet=u_in,
                                        n_per_patch=CASE_PER_PATCH, elapsed_ns=per_case)
        print(f"  done in {split_stats['solve_s']:.1f} s ({split_stats['steps_marched']} "
              f"steps marched)", flush=True)
        write_data_config(root / split, FIELDS, {"Ux": "inlet"},
                          {"Scale": ["d", "f"], "Standardize": ["C", "U", "p"]},
                          ["x", "y", "z"])
        generate_meta(root / split, *FIELDS, max_dim=3)
        stats[split] = split_stats
    generate_min_points(root)
    return stats


def score_checkpoint(root: Path, ckpt: Path, model_name: str, points, device) -> dict:
    """Denormalised rel-L2 of U and p against the solved fields on the
    trained and held-out splits, every case of a split in one f32 batch."""
    n_int, n_bnd, n_obs = points
    train_ds = FoamDataset(str(root / "train"), n_int, n_bnd, n_obs,
                           np.random.default_rng(abc_train.SEED))
    args = abc_train.build_arg_parser().parse_args(["--model", model_name])
    model = abc_train.get_model(args, train_ds.normalizers, device)
    load_checkpoint(str(ckpt), model)
    fns = make_predict_functions(model)
    u_s, p_s = (train_ds.normalizers[k].to("cpu") for k in ("U", "p"))
    scores = {}
    for split in ("train", "val"):
        ds = FoamDataset(str(root / split), n_int, n_bnd, n_obs,
                         np.random.default_rng(abc_train.SEED), meta_dir=str(root / "train"))
        stacked = model.attach_neighbors(ds.stacked().to(device))
        batch = gather_cases(stacked, torch.arange(len(ds), device=device))
        pred = fns.predict_batch(batch, False).numpy()
        ref = batch.numpy()

        def denorm(scaler, x):
            return scaler.inverse_transform(torch.as_tensor(np.asarray(x))).numpy()

        scores[split] = {"U": rel_l2(denorm(u_s, pred["U"]), denorm(u_s, ref["U"])),
                         "p": rel_l2(denorm(p_s, pred["p"]), denorm(p_s, ref["p"]))}
    return scores


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_3d")
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--ny", type=int, default=28)
    ap.add_argument("--nz", type=int, default=28)
    ap.add_argument("--n-internal", type=int, default=1500)
    ap.add_argument("--n-boundary", type=int, default=1000)
    ap.add_argument("--n-obs", type=int, default=700)
    ap.add_argument("--zoo", type=int, default=0,
                    help="solve a random zoo of this many training cases (and a quarter, at "
                         "least 3, held out) instead of the hand-written 8 + 3")
    ap.add_argument("--resample-every", type=int, default=0)
    ap.add_argument("--model", default="pipn")
    ap.add_argument("--name", default="golden3d-pipn")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--reuse-data", action="store_true",
                    help="train on the splits already under --root instead of solving them "
                         "again")
    return ap


def main(argv=None, device=None) -> dict:
    """Run the 3D golden run on ``device`` (the CUDA card unless ``"cpu"``
    is asked for); returns the scores written to
    ``<root>/golden_3d_scores.json``."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    root = Path(args.root).resolve()
    points = (args.n_internal, args.n_boundary, args.n_obs)
    train_cases, val_cases = (zoo_cases(args.zoo, max(3, args.zoo // 4)) if args.zoo
                              else (TRAIN_CASES, VAL_CASES))
    results: dict = {"grid": [args.nx, args.ny, args.nz], "points": list(points),
                     "train_cases": len(train_cases), "val_cases": len(val_cases),
                     "model": args.model, "epochs": args.epochs, "batch": args.batch_size}
    if not args.reuse_data or not (root / "train").exists():
        results["solve"] = generate(root, args.nx, args.ny, args.nz, train_cases, val_cases,
                                    device=device)
    logs_dir = root / "logs"
    ckpt = logs_dir / "lightning_logs" / args.name / "model.ckpt"
    argv_train = ["--model", args.model, "--name", args.name, "--epochs", str(args.epochs),
                  "--train-dir", str(root / "train"), "--val-dir", str(root / "val"),
                  "--n-internal", str(args.n_internal), "--n-boundary", str(args.n_boundary),
                  "--n-observations", str(args.n_obs), "--batch-size", str(args.batch_size),
                  "--resample-every", str(args.resample_every), "--logs-dir", str(logs_dir),
                  "--log-every", "25"]
    t0 = time.perf_counter()
    abc_train.run(argv_train, device=device)
    profiling.sync(device)
    wall = time.perf_counter() - t0
    steps = args.epochs * -(-len(train_cases) // args.batch_size)
    # the wall time includes the CLI's loading of both splits
    results.update(wall_s=wall, steps=steps, steps_per_s=steps / wall,
                   **score_checkpoint(root, ckpt, args.model, points, device),
                   ckpt=str(ckpt))
    results["evaluate_val"] = abc_evaluate.run([
        "--data-dir", str(root / "val"), "--meta-dir", str(root / "train"),
        "--checkpoint", str(ckpt), "--n-internal", str(args.n_internal),
        "--n-boundary", str(args.n_boundary), "--n-observations", str(args.n_obs)],
        device=device)
    (root / "golden_3d_scores.json").write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
