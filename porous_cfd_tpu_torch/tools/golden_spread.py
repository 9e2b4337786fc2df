"""The golden duct's run-to-run spread in the port: the decoupled ``pipn``
recipe of ``train_golden_duct`` trained once for each dropout seed, and once
more with the decoder's dropout off, on one solved split; every checkpoint
scored as the golden run scores it (denormalised rel-L2 of U and p on the
trained and held-out splits, predicted in f32).

    python -m porous_cfd_tpu_torch.tools.golden_spread [--root data/golden_duct]
        [--reuse-data] [--seeds 8421 1 2 3 4] [--epochs 3000]

A seed is the trainer's (``TrainerConfig.seed``), from which every step's
dropout masks are folded. The weights stay drawn from seed 8421 and the
points from the CLI's rng, so the runs differ in their masks (and in the
order of the 13 cases inside the one batch an epoch). Seed 8421 with dropout
on is the golden run itself. It writes ``<root>/golden_spread.json`` and
prints it. It runs on the CUDA card; ``main(argv, device="cpu")`` runs on
the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
from porous_cfd_tpu_torch.tools import train_golden_duct as golden
from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig
from porous_cfd_tpu_torch.utils import profiling

# the golden recipe's internal / boundary / observation points
POINTS = (1500, 350, 700)


def train_and_score(root: Path, seed: int, dropout: bool, epochs: int, points,
                    logs_dir: Path, device) -> dict:
    """The golden recipe with the trainer's seed ``seed``, its decoder
    dropout on or off, trained and scored."""
    name = f"spread-seed{seed}" + ("" if dropout else "-nodropout")
    n_int, n_bnd, n_obs = points
    args = fixed_train.build_arg_parser().parse_args([
        "--model", "pipn", "--train-dir", str(root / "train"), "--val-dir", str(root / "val"),
        "--n-internal", str(n_int), "--n-boundary", str(n_bnd),
        "--n-observations", str(n_obs)])
    train_data, val_data = fixed_train.make_datasets(args)
    model = fixed_train.get_model(args, train_data.normalizers, device)
    if not dropout:
        # the analytic path reads the rates at every call
        model.module.seg_dropout = None
    cfg = TrainerConfig(epochs=epochs, batch_size=len(golden.TRAIN_CASES),
                        logs_dir=str(logs_dir), name=name, log_every=25, seed=seed)
    trainer = Trainer(model.with_precision(args.precision), train_data.stacked(),
                      val_data.stacked(), cfg, fixed_train.get_loss_scaler(args),
                      model_type=args.model)
    t0 = time.perf_counter()
    trainer.fit()
    profiling.sync(device)
    wall = time.perf_counter() - t0
    ckpt = logs_dir / "lightning_logs" / name / "model.ckpt"
    return {"seed": seed, "dropout": dropout, "wall_s": wall,
            **golden.score_checkpoint(root, ckpt, [], points, device)}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_duct")
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--nx", type=int, default=120)
    ap.add_argument("--ny", type=int, default=72)
    ap.add_argument("--seeds", type=int, nargs="+", default=[8421, 1, 2, 3, 4])
    ap.add_argument("--reuse-data", action="store_true",
                    help="train on the splits already under --root instead of solving them "
                         "again")
    return ap


def main(argv=None, device=None) -> dict:
    """Train and score every seed with dropout on, then the first seed with
    dropout off, on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for); returns what it writes to ``<root>/golden_spread.json``."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    root = Path(args.root).resolve()
    points = POINTS
    if not args.reuse_data or not (root / "train").exists():
        golden.generate(root, args.nx, args.ny)
    logs_dir = root / "logs"
    runs = [train_and_score(root, s, True, args.epochs, points, logs_dir, device)
            for s in args.seeds]
    runs.append(train_and_score(root, args.seeds[0], False, args.epochs, points, logs_dir,
                                device))
    with_dropout = runs[:-1]
    spread = {}
    for split in ("train", "val"):
        for field in ("U", "p"):
            vals = [r[split][field] for r in with_dropout]
            spread[f"{split}_{field}"] = [min(vals), float(np.mean(vals)), max(vals)]
    results = {"grid": [args.nx, args.ny], "points": list(points), "epochs": args.epochs,
               "runs": runs, "min_mean_max_with_dropout": spread,
               "bar_met": [max(r["train"]["U"], r["train"]["p"]) < golden.BAR for r in runs]}
    (root / "golden_spread.json").write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
