"""Recompute and write the NS-Darcy momentum residual field from OpenFOAM
function-object gradients (the port's own copy of
``porous_cfd_tpu/datagen/momentum_error.py``, numpy over the port's
``data/foam_io.py`` and ``data/parser.py``).

The reference recomputes ``momentError`` because "the openfoam momentum
calculation seems to not take into account the porous material"
(momentum_error.py:37) — the residual uses the same formula as the training
loss, making it a physics consistency check of the whole pipeline. The math
is numpy; file IO is the port's OpenFOAM writer.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data import foam_io, parser

JAC_LABELS = [f"grad(U){i}{j}" for i in "xyz" for j in "xyz"]
LAP_LABELS = [f"grad(grad(U){i}{j})" for i in "xyz" for j in "xyz"]


def momentum_error(nu: float, d, f, u, u_jac, u_laplace, p_grad, zone_id):
    """NS-Darcy-Forchheimer momentum residual (momentum_error.py:13-31).
    All arrays (n_points, 3) except jacobians (n_points, 3, 3)."""
    source = u * (d * nu + 0.5 * np.linalg.norm(u, axis=-1, keepdims=True) * f)
    convection = np.einsum("nij,nj->ni", u_jac, u)
    viscosity = nu * np.sum(u_laplace, axis=-1)
    return convection - viscosity + p_grad + source * zone_id


def _stack_tables(internal: dict, patches: dict, field: str) -> np.ndarray:
    return np.concatenate([internal[field]]
                          + [t[field] for t in patches.values()])


def write_momentum_error(case_path: str) -> None:
    """Compute momentError from the case's gradient function-object fields and
    write it as a volume field + per-patch postProcessing dumps
    (momentum_error.py:34-103)."""
    fields = ["U", "grad(p)", *JAC_LABELS, *LAP_LABELS, "d", "f",
              "cellToRegion"]
    internal, patches = parser.parse_case_fields(case_path, *fields, max_dim=3)

    def table_error(t: dict) -> np.ndarray:
        u = t["U"]
        grad_p = t["grad(p)"]
        zone = t["cellToRegion"]
        d, f = t["d"], t["f"]
        jac = np.stack([np.concatenate(
            [t[f"grad(U){i}{j}"] for j in "xyz"], axis=-1) for i in "xyz"],
            axis=-2)  # (N, 3, 3); each grad(U)ij is a scalar column
        # grad(grad(U)ij) is a vector; only the jj component enters the
        # laplacian diagonal (momentum_error.py:58-61)
        lap = np.stack([np.concatenate(
            [t[f"grad(grad(U){i}{j})"][:, ["xyz".index(j)]] for j in "xyz"],
            axis=-1) for i in "xyz"], axis=-2)  # (N, 3, 3)
        nu = parser.parse_nu(case_path)
        return momentum_error(nu, d, f, u, jac, lap, grad_p, zone)

    internal_err = table_error(internal)
    patch_errs = {name: table_error(t) for name, t in patches.items()}

    last = foam_io.latest_time(case_path)
    boundary = {name: {"type": "extrapolatedCalculated", "value": err}
                for name, err in patch_errs.items()}
    # empty patches for 2D cases (momentum_error.py:100-103)
    try:
        u0 = foam_io.read_field_file(Path(case_path) / "0" / "U")
        for pname, spec in u0["boundary"].items():
            if isinstance(spec, dict) and spec.get("type") == "empty":
                boundary[pname] = {"type": "empty"}
    except (FileNotFoundError, ValueError):
        pass  # no 0/U (synthetic geometry-only case)
    foam_io.write_field_file(Path(case_path) / last / "momentError",
                             "volVectorField", "momentError", internal_err,
                             boundary=boundary,
                             dimensions="[0 1 -2 0 0 0 0]")

    pp = Path(case_path) / "postProcessing"
    for name, err in patch_errs.items():
        step_dir = pp / name / "surface" / str(int(float(last)))
        patch_dir = step_dir / os.listdir(step_dir)[0]
        foam_io.write_postprocess_field(patch_dir / "vectorField" /
                                        "momentError", err)
