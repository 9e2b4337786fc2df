"""Synthetic foam-style batches with the full dataset schema (counterpart of
``porous_cfd_tpu/data/synthetic.py``; the same numpy generator gives the same
batch in both packages).

The schema matches what the dataset loader produces for the
duct_variable_boundary experiment: 4 patches, U-inlet variable columns, d/f
coefficient fields, SDF + one-hot boundaryId features.
"""
from __future__ import annotations

import numpy as np
import torch

from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.data.scalers import Normalizer, StandardScaler

FOAM_LABELS = {
    "Cx": None, "Cy": None,
    "cellToRegion": None,
    "dx": None, "dy": None,
    "fx": None, "fy": None,
    "Ux": None, "Uy": None,
    "p": None,
    "U-inletx": None, "U-inlety": None,
    "sdf": None,
    "boundaryIdinlet": None, "boundaryIdinterface": None,
    "boundaryIdoutlet": None, "boundaryIdwalls": None,
    "C": ["Cx", "Cy"],
    "d": ["dx", "dy"],
    "f": ["fx", "fy"],
    "U": ["Ux", "Uy"],
    "U-inlet": ["U-inletx", "U-inlety"],
    "boundaryId": ["boundaryIdinlet", "boundaryIdinterface",
                   "boundaryIdoutlet", "boundaryIdwalls"],
}

# the branch-net inputs of the duct_variable_boundary PI-GANO models
VARIABLE_BOUNDARIES = {"Subdomains": ["inlet", "internal"],
                       "Features": ["U-inlet", "d", "f"]}

N_COLS = sum(1 for v in FOAM_LABELS.values() if v is None)

PATCHES = ["inlet", "interface", "outlet", "walls"]


def make_foam_batch(batch_size=2, n_internal=24, n_boundary=16, n_obs=8,
                    seed=0, rng=None) -> FoamData:
    """Random batch (CPU tensors) with the duct_variable_boundary-style
    schema. Boundary points are split evenly over the 4 patches; variable-BC
    columns are zero outside their patch."""
    rng = rng or np.random.default_rng(seed)
    if n_boundary % 4:
        raise ValueError("n_boundary must split evenly over the 4 patches")
    per_patch = n_boundary // 4
    n = n_internal + n_boundary

    def one_case():
        data = np.zeros((n, N_COLS), np.float32)
        cols = [k for k, v in FOAM_LABELS.items() if v is None]
        ix = {c: i for i, c in enumerate(cols)}
        pts = rng.uniform(-1, 1, size=(n, 2))
        data[:, ix["Cx"]], data[:, ix["Cy"]] = pts[:, 0], pts[:, 1]
        zone = (pts[:, 0] > 0.3).astype(np.float32)
        zone[n_internal:] = 0
        data[:, ix["cellToRegion"]] = zone
        data[:, ix["dx"]] = data[:, ix["dy"]] = zone * 0.7
        data[:, ix["fx"]] = data[:, ix["fy"]] = zone * 0.4
        data[:, ix["Ux"]] = rng.normal(size=n)
        data[:, ix["Uy"]] = rng.normal(size=n)
        data[:, ix["p"]] = rng.normal(size=n)
        data[:, ix["sdf"]] = rng.uniform(0, 1, size=n)
        for pi, patch in enumerate(PATCHES):
            rows = slice(n_internal + pi * per_patch,
                         n_internal + (pi + 1) * per_patch)
            data[rows, ix[f"boundaryId{patch}"]] = 1.0
        inlet_rows = slice(n_internal, n_internal + per_patch)
        data[inlet_rows, ix["U-inletx"]] = data[inlet_rows, ix["Ux"]]
        data[inlet_rows, ix["U-inlety"]] = data[inlet_rows, ix["Uy"]]

        domain = {
            "internal": np.arange(n_internal),
            "boundary": np.arange(n_boundary) + n_internal,
            "obs": rng.choice(n_internal, size=n_obs, replace=False),
        }
        for pi, patch in enumerate(PATCHES):
            domain[patch] = np.arange(per_patch) + n_internal + pi * per_patch
        return data, domain

    cases = [one_case() for _ in range(batch_size)]
    data = np.stack([c[0] for c in cases])
    domain = {k: torch.from_numpy(np.stack([c[1][k] for c in cases]))
              for k in cases[0][1]}
    return FoamData(torch.from_numpy(data), FOAM_LABELS, domain)


def make_scalers() -> dict:
    """Plausible scaler statistics for the synthetic schema (CPU tensors)."""
    return {
        "U": StandardScaler([1.2, 0.8], [0.1, -0.1]),
        "p": StandardScaler([2.0], [0.5]),
        "C": StandardScaler([1.5, 1.1], [0.0, 0.0]),
        "d": Normalizer([0.0, 0.0], [20000.0, 20000.0]),
        "f": Normalizer([0.0, 0.0], [100.0, 100.0]),
    }


# the 3D experiments' patches: abc's four, windbreaks' five (its house, solid)
PATCHES_3D = {"abc": PATCHES, "windbreaks": ["inlet", "interface", "outlet", "solid", "walls"]}
# windbreaks' branch-net inputs: the inlet's Ux, d and f
VARIABLE_BOUNDARIES_3D = {"Subdomains": ["inlet", "internal"],
                          "Features": ["Ux-inlet", "d", "f"]}


def make_foam_batch_3d(batch_size=2, n_internal=24, n_boundary=16, n_obs=8,
                       patches=PATCHES, seed=0, rng=None) -> FoamData:
    """Random batch (CPU tensors) of the 3D experiments' schema: C, d, f, U
    with a z axis, p, sdf, the zone, one boundary id a patch of ``patches``
    (the boundary points split evenly over them, the first the inlet) and
    the inlet's Ux as the variable column ``Ux-inlet`` (windbreaks' branch
    feature)."""
    rng = rng or np.random.default_rng(seed)
    n_patch = len(patches)
    if n_boundary % n_patch:
        raise ValueError(f"n_boundary must split evenly over the {n_patch} patches")
    per_patch = n_boundary // n_patch
    axes = ["x", "y", "z"]
    labels = {**{f"{k}{a}": None for k in ("C", "d", "f", "U") for a in axes},
              "cellToRegion": None, "p": None, "Ux-inlet": None, "sdf": None,
              **{f"boundaryId{p}": None for p in patches},
              **{k: [f"{k}{a}" for a in axes] for k in ("C", "d", "f", "U")},
              "boundaryId": [f"boundaryId{p}" for p in patches]}
    cols = [k for k, v in labels.items() if v is None]
    ix = {c: i for i, c in enumerate(cols)}
    n = n_internal + n_boundary
    data = np.zeros((batch_size, n, len(cols)), np.float32)
    domains = []
    for b in range(batch_size):
        case = data[b]
        for a in axes:
            case[:, ix[f"C{a}"]] = rng.uniform(-1, 1, size=n)
        zone = (case[:, ix["Cx"]] > 0.3).astype(np.float32)
        zone[n_internal:] = 0
        case[:, ix["cellToRegion"]] = zone
        for a in axes:
            case[:, ix[f"d{a}"]] = zone * 0.7
            case[:, ix[f"f{a}"]] = zone * 0.4
            case[:, ix[f"U{a}"]] = rng.normal(size=n)
        case[:, ix["p"]] = rng.normal(size=n)
        case[:, ix["sdf"]] = rng.uniform(0, 1, size=n)
        domain = {"internal": np.arange(n_internal),
                  "boundary": np.arange(n_boundary) + n_internal,
                  "obs": rng.choice(n_internal, size=n_obs, replace=False)}
        for pi, patch in enumerate(patches):
            rows = np.arange(per_patch) + n_internal + pi * per_patch
            case[rows, ix[f"boundaryId{patch}"]] = 1.0
            domain[patch] = rows
        inlet = domain[patches[0]]
        case[inlet, ix["Ux-inlet"]] = case[inlet, ix["Ux"]]
        domains.append(domain)
    domain = {k: torch.from_numpy(np.stack([d[k] for d in domains])) for k in domains[0]}
    return FoamData(torch.from_numpy(data), labels, domain)


def make_scalers_3d() -> dict:
    """``make_scalers``' statistics with a z axis."""
    return {
        "U": StandardScaler([1.2, 0.8, 0.9], [0.1, -0.1, 0.0]),
        "p": StandardScaler([2.0], [0.5]),
        "C": StandardScaler([1.5, 1.1, 1.3], [0.0, 0.0, 0.0]),
        "d": Normalizer([0.0] * 3, [20000.0] * 3),
        "f": Normalizer([0.0] * 3, [100.0] * 3),
    }
