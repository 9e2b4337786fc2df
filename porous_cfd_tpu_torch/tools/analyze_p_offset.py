"""Split a checkpoint's held-out pressure error into a gauge offset and the
field's shape, in the port (the counterpart of ``tools/analyze_p_offset.py``).

Pressure in incompressible flow is defined up to a constant; the duct cases
fix it with p = 0 on the outlet. If a model's p error is mostly a constant
a case, anchoring its predicted field to the known outlet condition (part
of the case's specification, not of its solution) recovers most of it.
Per split this reports the p rel-L2 raw, after outlet anchoring (the
prediction less its mean on the outlet rows, plus the outlet's value, read
from the case's outlet rows) and after removing each case's oracle mean
offset (the least any constant shift can reach), pooled and as the mean
and largest over the cases.

    python -m porous_cfd_tpu_torch.tools.analyze_p_offset \\
        [--root data/golden_grid] [--name grid-pipn-analytic] \\
        [--example duct_fixed_boundary]

The model comes from the ``model_meta.json`` beside the checkpoint. It runs
on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import importlib
import json
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools.analyze_grid_errors import SPLITS, load_model
from porous_cfd_tpu_torch.tools.scoring_util import denormalize, load_split, predict_split
from porous_cfd_tpu_torch.tools.train_golden_duct import rel_l2


def split_offsets(model, root: Path, split: str, points, p_scaler) -> dict:
    """The split's raw, outlet-anchored and oracle-centred p rel-L2."""
    ds = load_split(root, split, points)
    p_pred, p_ref, anchored = [], [], []
    for _, pred, ref in predict_split(model, ds.stacked(), len(ds)):
        pp, pr = denormalize(p_scaler, pred["p"])[..., 0], denormalize(p_scaler, ref["p"])[..., 0]
        out_p = denormalize(p_scaler, pred["outlet"]["p"])[..., 0]
        out_r = denormalize(p_scaler, ref["outlet"]["p"])[..., 0]
        anchored.append(pp - out_p.mean(axis=1, keepdims=True) + out_r.mean(axis=1, keepdims=True))
        p_pred.append(pp)
        p_ref.append(pr)
    p_pred, p_ref, anchored = (np.concatenate(a) for a in (p_pred, p_ref, anchored))
    centred = p_pred - (p_pred - p_ref).mean(axis=1, keepdims=True)
    out = {"cases": len(p_pred)}
    for key, field in (("raw", p_pred), ("outlet_anchored", anchored),
                       ("oracle_centred", centred)):
        per = [rel_l2(field[i], p_ref[i]) for i in range(len(field))]
        out[key] = {"pooled": rel_l2(field.ravel(), p_ref.ravel()),
                    "per_case_mean": float(np.mean(per)), "per_case_max": float(np.max(per))}
    return out


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_grid")
    ap.add_argument("--name", default="grid-pipn-analytic")
    ap.add_argument("--example", default="duct_fixed_boundary",
                    help="the port's experiment whose get_model builds the checkpoint's model")
    ap.add_argument("--n-internal", type=int, default=1500)
    ap.add_argument("--n-boundary", type=int, default=350)
    ap.add_argument("--n-obs", type=int, default=700)
    return ap


def main(argv=None, device=None) -> dict:
    """Analyse on ``device`` (the CUDA card unless ``"cpu"`` is asked for);
    returns {split: numbers}."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    train_mod = importlib.import_module(f"porous_cfd_tpu_torch.examples.{args.example}.train")
    root = Path(args.root).resolve()
    points = (args.n_internal, args.n_boundary, args.n_obs)
    model, scalers = load_model(root, args.name, points, train_mod.get_model, device)
    report = {}
    for split in SPLITS:
        r = report[split] = split_offsets(model, root, split, points, scalers["p"])
        print(f"[{split}] n={r['cases']} pooled relp raw={r['raw']['pooled']:.3%} "
              f"outlet-anchored={r['outlet_anchored']['pooled']:.3%} "
              f"oracle-centred={r['oracle_centred']['pooled']:.3%}; per case mean raw="
              f"{r['raw']['per_case_mean']:.3%} centred={r['oracle_centred']['per_case_mean']:.3%}"
              f", max raw={r['raw']['per_case_max']:.3%} "
              f"centred={r['oracle_centred']['per_case_max']:.3%}")
    print(json.dumps({"p_offset": report}), flush=True)
    return report


if __name__ == "__main__":
    main()
