"""The ``foam2d`` inputs: synthetic 2D foam cases in the duct_variable_boundary
schema, found by a configuration's ``dataset`` key.

``make_batch`` and ``SCALERS`` are frozen copies of
``porous_cfd_tpu_torch/data/synthetic.py`` (``make_foam_batch``,
``make_scalers``) at commit 4a0a8ad: the same numpy draws in the same order,
so one seed gives the same cases as the program's own generator did there,
and a later change to the program cannot move them. The cases follow the
duct_variable_boundary schema: 4 patches, U-inlet columns, d/f coefficient
fields, the sdf and one-hot boundary ids. There is no OpenFOAM on the card's
machine; the matmul work does not depend on the geometry.

A dataset module gives ``DIMS``, ``COLUMNS``, ``LABELS`` (the program's
``FoamData`` labels), ``PATCHES``, ``SCALERS`` ((std, mean) of the
``STANDARDIZED`` fields, (min, max) of the others), ``cols`` and
``make_batch(cases, n_internal, n_boundary, n_obs, rng)``.
"""
from __future__ import annotations

import numpy as np

DIMS = 2
COLUMNS = ("Cx", "Cy", "cellToRegion", "dx", "dy", "fx", "fy", "Ux", "Uy", "p",
           "U-inletx", "U-inlety", "sdf", "boundaryIdinlet", "boundaryIdinterface",
           "boundaryIdoutlet", "boundaryIdwalls")
GROUPS = {"C": ["Cx", "Cy"], "d": ["dx", "dy"], "f": ["fx", "fy"], "U": ["Ux", "Uy"],
          "U-inlet": ["U-inletx", "U-inlety"],
          "boundaryId": ["boundaryIdinlet", "boundaryIdinterface", "boundaryIdoutlet",
                         "boundaryIdwalls"]}
LABELS = {**{c: None for c in COLUMNS}, **GROUPS}
PATCHES = ("inlet", "interface", "outlet", "walls")
# (std, mean) of the standardized fields, (min, max) of the scaled ones
SCALERS = {"U": ([1.2, 0.8], [0.1, -0.1]), "p": ([2.0], [0.5]), "C": ([1.5, 1.1], [0.0, 0.0]),
           "d": ([0.0, 0.0], [20000.0, 20000.0]), "f": ([0.0, 0.0], [100.0, 100.0])}
STANDARDIZED, SCALED = ("U", "p", "C"), ("d", "f")


def cols(name: str) -> list[int]:
    """The column indices of a field or group."""
    return [COLUMNS.index(c) for c in GROUPS.get(name, [name])]


def make_batch(batch_size, n_internal, n_boundary, n_obs, rng):
    """``batch_size`` cases of ``n_internal`` + ``n_boundary`` rows (internal
    first; the boundary split evenly over the 4 patches): the data (B, N, 17)
    float32 and the domain index arrays (B, K) by subdomain, numpy."""
    if n_boundary % 4:
        raise ValueError("n_boundary must split evenly over the 4 patches")
    per_patch = n_boundary // 4
    n = n_internal + n_boundary
    ix = {c: i for i, c in enumerate(COLUMNS)}

    def one_case():
        data = np.zeros((n, len(COLUMNS)), np.float32)
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
            rows = slice(n_internal + pi * per_patch, n_internal + (pi + 1) * per_patch)
            data[rows, ix[f"boundaryId{patch}"]] = 1.0
        inlet_rows = slice(n_internal, n_internal + per_patch)
        data[inlet_rows, ix["U-inletx"]] = data[inlet_rows, ix["Ux"]]
        data[inlet_rows, ix["U-inlety"]] = data[inlet_rows, ix["Uy"]]
        domain = {"internal": np.arange(n_internal),
                  "boundary": np.arange(n_boundary) + n_internal,
                  "obs": rng.choice(n_internal, size=n_obs, replace=False)}
        for pi, patch in enumerate(PATCHES):
            domain[patch] = np.arange(per_patch) + n_internal + pi * per_patch
        return data, domain

    cases = [one_case() for _ in range(batch_size)]
    data = np.stack([c[0] for c in cases])
    domain = {k: np.stack([c[1][k] for c in cases]) for k in cases[0][1]}
    return data, domain
