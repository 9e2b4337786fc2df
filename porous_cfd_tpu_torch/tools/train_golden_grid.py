"""The accuracy north star at reference data scale, in the port (the
counterpart of ``tools/train_golden_grid.py``): train the duct model on the
FVM transform grid (``golden_transform_grid fixed``: the 11-primitive zoo x
rotations x scales, held-out geometry variants in val and test) through the
port's duct_fixed_boundary training CLI, then score the denormalised rel-L2
of U and p on train, val and test (``scoring_util.split_rel_l2``, chunked)
and run the evaluate CLI on the test split.

Each derivative path trains and scores on its own (``--paths``):
``analytic`` is the model family's fast path coupled through the max-pool
(``--coupled-context`` for plain pipn), ``decoupled`` the decoupled one, and
``exact`` the exact autodiff operator (``--skip-exact`` leaves it out). The
recipe is the reference envelope: batch 13, 1500 / 350 / 700 internal /
boundary / observation points, validation every 25 epochs, trainer seed
8421.

It writes ``<root>/logs/<tag>_scores.json`` and prints it; it writes no
other record.

    python -m porous_cfd_tpu_torch.tools.train_golden_grid --paths analytic \\
        --resample-every 100 [--root data/golden_grid] [--epochs 3000]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate as fixed_evaluate
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
from porous_cfd_tpu_torch.tools.scoring_util import load_split, score_splits
from porous_cfd_tpu_torch.train.trainer import load_checkpoint
from porous_cfd_tpu_torch.utils import profiling

# the north star: rel-L2 of U and p below 5% on the held-out splits
BAR = 0.05
BATCH = 13
# each derivative path: (fast, decoupled)
PATHS = {"analytic": (True, False), "decoupled": (True, True), "exact": (False, False)}


def path_flags(fast: bool, decoupled: bool) -> list[str]:
    return ([] if fast else ["--exact-derivatives"]) + \
        (["--coupled-context"] if fast and not decoupled else [])


def count_cases(split_dir: Path) -> int:
    return sum(1 for d in split_dir.iterdir() if d.is_dir())


def point_args(points) -> list[str]:
    n_int, n_bnd, n_obs = points
    return ["--n-internal", str(n_int), "--n-boundary", str(n_bnd),
            "--n-observations", str(n_obs)]


def train(root: Path, name: str, epochs: int, flags, logs_dir: Path, points, model: str,
          resample_every: int, device) -> dict:
    """Train one path through the CLI; returns its wall, steps and steps/s
    (the wall includes the CLI's loading of both splits)."""
    argv = ["--model", model, "--name", name, "--epochs", str(epochs),
            "--train-dir", str(root / "train"), "--val-dir", str(root / "val"),
            *point_args(points), "--batch-size", str(BATCH),
            "--logs-dir", str(logs_dir), "--log-every", "25",
            "--resample-every", str(resample_every), *flags]
    t0 = time.perf_counter()
    fixed_train.run(argv, device=device)
    profiling.sync(device)
    wall = time.perf_counter() - t0
    steps = epochs * math.ceil(count_cases(root / "train") / BATCH)
    return {"wall_s": wall, "epochs": epochs, "steps": steps, "steps_per_s": steps / wall}


def score(root: Path, ckpt: Path, model_name: str, flags, points, device) -> dict:
    """The checkpoint's U and p rel-L2 on train, val and test."""
    train_ds = load_split(root, "train", points)
    args = fixed_train.build_arg_parser().parse_args(["--model", model_name, *flags])
    model = fixed_train.get_model(args, train_ds.normalizers, device)
    load_checkpoint(str(ckpt), model)
    return score_splits(model, root, points)


def run_evaluation(root: Path, ckpt: Path, points, split: str, device) -> dict:
    """The evaluate CLI on ``split`` (its plots are not ported, so no
    ``--save-plots``)."""
    return fixed_evaluate.run([
        "--data-dir", str(root / split), "--meta-dir", str(root / "train"),
        "--checkpoint", str(ckpt), *point_args(points)], device=device)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_grid")
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--model", default="pipn")
    ap.add_argument("--n-internal", type=int, default=1500)
    ap.add_argument("--n-boundary", type=int, default=350)
    ap.add_argument("--n-obs", type=int, default=700)
    ap.add_argument("--skip-exact", action="store_true")
    ap.add_argument("--resample-every", type=int, default=0)
    ap.add_argument("--tag", default="grid")
    ap.add_argument("--reuse-ckpt", action="store_true",
                    help="score a path's existing checkpoint instead of training it again")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--paths", default="",
                    help="comma list of derivative paths to run (analytic,decoupled,exact); "
                         "empty = all (minus --skip-exact)")
    return ap


def main(argv=None, device=None) -> dict:
    """Train and score on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for); returns the scores written to ``<root>/logs/<tag>_scores.json``."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    root = Path(args.root).resolve()
    logs_dir = root / "logs"
    points = (args.n_internal, args.n_boundary, args.n_obs)
    paths = [p for p in PATHS if not (p == "exact" and args.skip_exact)]
    if args.paths:
        wanted = set(args.paths.split(","))
        unknown = wanted - set(PATHS)
        if unknown:
            raise ValueError(f"unknown derivative paths {sorted(unknown)}: {list(PATHS)}")
        paths = [p for p in paths if p in wanted]
    results: dict = {"model": args.model, "epochs": args.epochs, "batch": BATCH,
                     "points": list(points),
                     "resample_every": args.resample_every,
                     "cases": {s: count_cases(root / s) for s in ("train", "val", "test")}}
    for key in paths:
        name = f"{args.tag}-{args.model}-{key}"
        ckpt = logs_dir / "lightning_logs" / name / "model.ckpt"
        flags = path_flags(*PATHS[key])
        run: dict = {"wall_s": float("nan")}
        if not (args.reuse_ckpt and ckpt.exists()):
            run = train(root, name, args.epochs, flags, logs_dir, points, args.model,
                        args.resample_every, device)
        results[key] = {**run, **score(root, ckpt, args.model, flags, points, device),
                        "ckpt": str(ckpt)}
        print(json.dumps({key: results[key]}), flush=True)
    held = [max(results[k][s][f] for s in ("val", "test") for f in ("U", "p")) for k in paths]
    results["north_star_met"] = bool(held) and all(h < BAR for h in held)
    if not args.skip_eval and paths:
        results["evaluate_test"] = run_evaluation(root, Path(results[paths[0]]["ckpt"]),
                                                  points, "test", device)
    logs_dir.mkdir(parents=True, exist_ok=True)
    (logs_dir / f"{args.tag}_scores.json").write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
