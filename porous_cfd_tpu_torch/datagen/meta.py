"""Dataset metadata generation: streaming field statistics + subdomain counts
(the port's own copy of ``porous_cfd_tpu/datagen/meta.py``, numpy only).

Port of ``datagen/data_generator.py:289-386`` (``generate_meta`` /
``generate_min_points``): per-field Min/Max/Mean/Std over all points of all
cases (internal + boundary rows concatenated), per-subdomain point-count
statistics (internal / porous / fluid / each patch), OpenFOAM timing stats —
written to ``meta.json`` per split and ``min_points.json`` at the data root.

Mean/variance use Welford's streaming algorithm (the reference uses the
``welford`` pypi package), so arbitrarily many cases stream through constant
memory.
"""
from __future__ import annotations

import glob
import json
import sys
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data import parser


class Welford:
    """Streaming mean/population-variance over rows."""

    def __init__(self):
        self.count = 0
        self.mean = None
        self.m2 = None

    def add_all(self, rows: np.ndarray):
        for row in np.atleast_2d(rows):
            self.count += 1
            if self.mean is None:
                self.mean = row.astype(np.float64).copy()
                self.m2 = np.zeros_like(self.mean)
                continue
            delta = row - self.mean
            self.mean += delta / self.count
            self.m2 += delta * (row - self.mean)

    @property
    def var_p(self):
        return self.m2 / self.count


class MinMaxTracker:
    """Columnwise running min/max (data_generator.py:39-54)."""

    def __init__(self):
        self.min = None
        self.max = None

    def update(self, rows: np.ndarray):
        lo, hi = rows.min(axis=0), rows.max(axis=0)
        self.min = lo if self.min is None else np.minimum(self.min, lo)
        self.max = hi if self.max is None else np.maximum(self.max, hi)


def case_dirs(data_dir: str | Path) -> list[str]:
    return sorted(glob.glob(f"{data_dir}/*/"))


def generate_meta(data_dir: str | Path, *fields: str, max_dim: int = 3,
                  with_timing: bool = True) -> dict:
    """Compute and write ``<data_dir>/meta.json`` (data_generator.py:289-362)."""
    field_minmax, count_minmax = MinMaxTracker(), MinMaxTracker()
    field_stats, count_stats = Welford(), Welford()
    widths: dict[str, int] | None = None
    boundary_names: list[str] | None = None
    elapsed = []

    for case in case_dirs(data_dir):
        internal = parser.parse_internal_fields(case, *fields, max_dim=max_dim)
        patches = parser.parse_boundary_fields(case, *fields, max_dim=max_dim)
        if widths is None:
            widths = {f: v.shape[1] for f, v in internal.items()}
            boundary_names = sorted(patches.keys())

        int_rows = np.concatenate(list(internal.values()), axis=1)
        bnd_rows = np.concatenate(
            [np.concatenate([patches[p][f] for f in fields], axis=1)
             for p in patches])
        data = np.concatenate([int_rows, bnd_rows])
        field_minmax.update(data)
        field_stats.add_all(data)

        if with_timing:
            elapsed.append(parser.parse_elapsed_time(case) / 1e6)

        zone = internal["cellToRegion"][:, 0] if "cellToRegion" in internal \
            else np.zeros(len(int_rows))
        counts = [len(int_rows),
                  int(np.count_nonzero(zone > 0)),
                  int(np.count_nonzero(zone == 0))]
        counts += [len(patches[p]["C" if "C" in patches[p] else fields[0]])
                   for p in boundary_names]
        counts = np.asarray([counts], np.float64)
        count_minmax.update(counts)
        count_stats.add_all(counts)

    std = np.sqrt(field_stats.var_p)
    fields_meta = {}
    off = 0
    for f, w in widths.items():
        sl = slice(off, off + w)
        fields_meta[f] = {
            "Min": field_minmax.min[sl].tolist(),
            "Max": field_minmax.max[sl].tolist(),
            "Mean": field_stats.mean[sl].tolist(),
            "Std": std[sl].tolist(),
        }
        off += w

    count_names = ["internal", "porous", "fluid", *boundary_names]
    counts_std = np.sqrt(count_stats.var_p)
    points_meta = {
        name: {"Min": float(count_minmax.min[i]),
               "Max": float(count_minmax.max[i]),
               "Mean": float(count_stats.mean[i]),
               "Std": float(counts_std[i])}
        for i, name in enumerate(count_names)
    }

    timing = {"Total": float(np.sum(elapsed)) if elapsed else 0.0,
              "Average": float(np.mean(elapsed)) if elapsed else 0.0}

    meta = {"Points": points_meta, "Stats": fields_meta, "Timing": timing}
    with open(Path(data_dir) / "meta.json", "w") as f:
        f.write(json.dumps(meta, indent=4))
    return meta


def generate_min_points(splits_parent: str | Path) -> dict:
    """Cross-split per-subdomain minimum counts -> ``min_points.json``
    (data_generator.py:369-386)."""
    metas = []
    for split in sorted(glob.glob(f"{splits_parent}/*/")):
        if Path(split).name == "plots":
            continue
        meta_path = Path(split) / "meta.json"
        if meta_path.exists():
            with open(meta_path) as f:
                metas.append(json.load(f)["Points"])
    out = dict.fromkeys(metas[0].keys(), sys.float_info.max)
    for d in metas:
        out = {k: int(min(out[k], d[k]["Min"])) for k in d}
    with open(Path(splits_parent) / "min_points.json", "w") as f:
        f.write(json.dumps(out))
    return out
