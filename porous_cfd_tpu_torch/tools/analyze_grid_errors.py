"""Per-case error analysis of a transform-grid checkpoint, in the port (the
counterpart of ``tools/analyze_grid_errors.py``): each case's rel-L2 of U
and p on every split (not pooled), beside the shape, rotation and scale
that its directory name carries, to show whether the held-out pressure
error is broad or held in a few transform variants.

It writes ``<root>/per_case_errors.json`` (one row a case) and prints, per
split, the median, mean and largest p rel-L2, the 8 worst cases and the
mean p rel-L2 by shape and by (sx, sy).

    python -m porous_cfd_tpu_torch.tools.analyze_grid_errors \\
        [--root data/golden_grid] [--name grid-pipn-analytic]

The model comes from the ``model_meta.json`` beside the checkpoint. It runs
on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import re
from argparse import Namespace
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data.parser import parse_model_type
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
from porous_cfd_tpu_torch.tools.scoring_util import denormalize, load_split, predict_split
from porous_cfd_tpu_torch.tools.train_golden_duct import rel_l2
from porous_cfd_tpu_torch.train.trainer import load_checkpoint

SPLITS = ("train", "val", "test")


def parse_case(name: str) -> dict:
    """The transform a case's directory name carries, e.g.
    case_000_ellipse_r90_s1-0.75 -> ellipse, 90 degrees, (1, 0.75)."""
    m = re.match(r"case_\d+_(.+)_r([\d.+-]+)_s([\d.]+)-([\d.]+)$", name)
    if not m:
        return {"shape": name, "rot": 0.0, "sx": 1.0, "sy": 1.0}
    return {"shape": m.group(1), "rot": float(m.group(2)), "sx": float(m.group(3)),
            "sy": float(m.group(4))}


def load_model(root: Path, name: str, points, get_model, device):
    """The checkpoint ``<root>/logs/lightning_logs/<name>/model.ckpt`` in the
    model its ``model_meta.json`` names, over the train split's
    normalizers."""
    ckpt = root / "logs" / "lightning_logs" / name / "model.ckpt"
    train_ds = load_split(root, "train", points)
    model = get_model(Namespace(model=parse_model_type(str(ckpt))), train_ds.normalizers,
                      device)
    load_checkpoint(str(ckpt), model)
    return model, train_ds.normalizers


def per_case_rows(model, root: Path, split: str, points, scalers) -> list[dict]:
    ds = load_split(root, split, points)
    names = [Path(c).name for c in ds.samples]
    rows = []
    for c0, pred, ref in predict_split(model, ds.stacked(), len(ds)):
        u_p, u_r = denormalize(scalers["U"], pred["U"]), denormalize(scalers["U"], ref["U"])
        p_p, p_r = denormalize(scalers["p"], pred["p"]), denormalize(scalers["p"], ref["p"])
        for j in range(len(u_p)):
            name = names[c0 + j]
            rows.append({"split": split, "case": name, **parse_case(name),
                         "relU": rel_l2(u_p[j], u_r[j]), "relp": rel_l2(p_p[j], p_r[j]),
                         "p_range": float(p_r[j].max() - p_r[j].min()),
                         "p_mean_err": float(np.mean(p_p[j] - p_r[j])),
                         "p_rms": float(np.sqrt(np.mean(p_r[j] ** 2)))})
    return rows


def summarize(rows: list[dict]) -> dict:
    """Per split: the p rel-L2's median, mean and largest, and its mean by
    shape and by (sx, sy)."""
    out = {}
    for split in SPLITS:
        sub = [r for r in rows if r["split"] == split]
        if not sub:
            continue
        pv = np.array([r["relp"] for r in sub])

        def mean_by(key):
            groups: dict = {}
            for r in sub:
                groups.setdefault(key(r), []).append(r["relp"])
            return {str(k): float(np.mean(v)) for k, v in sorted(groups.items())}

        out[split] = {"cases": len(sub), "median_relp": float(np.median(pv)),
                      "mean_relp": float(pv.mean()), "max_relp": float(pv.max()),
                      "relp_by_shape": mean_by(lambda r: r["shape"]),
                      "relp_by_scale": mean_by(lambda r: f"{r['sx']:g}-{r['sy']:g}")}
    return out


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_grid")
    ap.add_argument("--name", default="grid-pipn-analytic")
    ap.add_argument("--n-internal", type=int, default=1500)
    ap.add_argument("--n-boundary", type=int, default=350)
    ap.add_argument("--n-obs", type=int, default=700)
    return ap


def main(argv=None, device=None) -> dict:
    """Analyse on ``device`` (the CUDA card unless ``"cpu"`` is asked for);
    returns {"rows": [...], "summary": {...}}."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    root = Path(args.root).resolve()
    points = (args.n_internal, args.n_boundary, args.n_obs)
    model, scalers = load_model(root, args.name, points, fixed_train.get_model, device)
    rows = [r for split in SPLITS for r in per_case_rows(model, root, split, points, scalers)]
    out = root / "per_case_errors.json"
    out.write_text(json.dumps(rows, indent=1))
    print(f"wrote {out} ({len(rows)} cases)")
    summary = summarize(rows)
    for split, s in summary.items():
        print(f"\n[{split}] n={s['cases']} median relp={s['median_relp']:.3%} "
              f"mean={s['mean_relp']:.3%} max={s['max_relp']:.3%}")
        for r in sorted((r for r in rows if r["split"] == split), key=lambda r: -r["relp"])[:8]:
            print(f"  {r['case']:45s} relp={r['relp']:.2%} relU={r['relU']:.2%} "
                  f"p_range={r['p_range']:.4g} mean_err={r['p_mean_err']:+.4g}")
        print("  by shape: " + ", ".join(f"{k} {v:.2%}" for k, v in s["relp_by_shape"].items()))
        print("  by scale: " + ", ".join(f"{k} {v:.2%}" for k, v in s["relp_by_scale"].items()))
    print(json.dumps({"per_case_summary": summary}), flush=True)
    return {"rows": rows, "summary": summary}


if __name__ == "__main__":
    main()
