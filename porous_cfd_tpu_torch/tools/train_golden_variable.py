"""The variable-coefficient accuracy run, in the port (the counterpart of
``tools/train_golden_variable.py``): train PI-GANO on the solved
variable-boundary grid (``golden_transform_grid variable``: the (d, f)
coefficient grid x 5 inlet speeds x random inlet angle over the transformed
zoo, held-out combinations in val and test) through the port's
duct_variable_boundary training CLI, score the denormalised rel-L2 of U and
p on train, val and test (``scoring_util.split_rel_l2``, chunked), then run
the evaluate CLI on the test split: the pressure drop and the MAE by inlet
angle and by (d, inlet speed), as numbers (the plots are not ported).

It writes ``<root>/logs/<tag>_scores.json`` and prints it; it writes no
other record.

    python -m porous_cfd_tpu_torch.tools.train_golden_variable \\
        --resample-every 100 [--root data/golden_variable] [--epochs 3000]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_variable_boundary import evaluate as variable_evaluate
from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as variable_train
from porous_cfd_tpu_torch.tools.scoring_util import load_split, score_splits
from porous_cfd_tpu_torch.tools.train_golden_grid import BATCH, count_cases
from porous_cfd_tpu_torch.train.trainer import load_checkpoint
from porous_cfd_tpu_torch.utils import profiling


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_variable")
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--model", default="pi-gano")
    ap.add_argument("--n-internal", type=int, default=1500)
    ap.add_argument("--n-boundary", type=int, default=350)
    ap.add_argument("--n-obs", type=int, default=700)
    ap.add_argument("--reuse-ckpt", action="store_true",
                    help="score the existing checkpoint instead of training again")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--resample-every", type=int, default=0)
    ap.add_argument("--tag", default="goldenvar")
    return ap


def main(argv=None, device=None) -> dict:
    """Train and score on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for); returns the scores written to ``<root>/logs/<tag>_scores.json``."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    root = Path(args.root).resolve()
    logs_dir = root / "logs"
    name = f"{args.tag}-{args.model}"
    ckpt = logs_dir / "lightning_logs" / name / "model.ckpt"
    points = (args.n_internal, args.n_boundary, args.n_obs)
    scores: dict = {"model": args.model, "epochs": args.epochs, "batch": BATCH,
                    "points": list(points), "resample_every": args.resample_every,
                    "cases": {s: count_cases(root / s) for s in ("train", "val", "test")},
                    "wall_s": float("nan"), "ckpt": str(ckpt)}
    if not (args.reuse_ckpt and ckpt.exists()):
        t0 = time.perf_counter()
        variable_train.run([
            "--model", args.model, "--name", name, "--epochs", str(args.epochs),
            "--train-dir", str(root / "train"), "--val-dir", str(root / "val"),
            "--n-internal", str(args.n_internal), "--n-boundary", str(args.n_boundary),
            "--n-observations", str(args.n_obs), "--batch-size", str(BATCH),
            "--logs-dir", str(logs_dir), "--log-every", "25",
            "--resample-every", str(args.resample_every)], device=device)
        profiling.sync(device)
        wall = time.perf_counter() - t0
        steps = args.epochs * math.ceil(scores["cases"]["train"] / BATCH)
        scores.update(wall_s=wall, steps=steps, steps_per_s=steps / wall)

    train_ds = load_split(root, "train", points)
    model = variable_train.get_model(argparse.Namespace(model=args.model),
                                     train_ds.normalizers, device)
    load_checkpoint(str(ckpt), model)
    scores.update(score_splits(model, root, points))
    if not args.skip_eval:
        scores["evaluate_test"] = variable_evaluate.run([
            "--data-dir", str(root / "test"), "--meta-dir", str(root / "train"),
            "--checkpoint", str(ckpt), "--n-internal", str(args.n_internal),
            "--n-boundary", str(args.n_boundary), "--n-observations", str(args.n_obs)],
            device=device)
    logs_dir.mkdir(parents=True, exist_ok=True)
    (logs_dir / f"{args.tag}_scores.json").write_text(json.dumps(scores, indent=2) + "\n")
    print(json.dumps(scores), flush=True)
    return scores


if __name__ == "__main__":
    main()
