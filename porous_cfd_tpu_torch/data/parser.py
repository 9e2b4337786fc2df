"""OpenFOAM case parsing (reference-parity API, numpy-native): the port's
own copy of ``porous_cfd_tpu/data/parser.py``.

Counterpart of ``dataset/data_parser.py`` in the reference, built on the
dependency-free ``foam_io`` module instead of foamlib/pandas. Field tables are
plain ``dict[field_name -> (N, d) float array]`` in the requested field order;
boundary data is an ordered ``dict[patch -> field table]`` with patches sorted
by name (the reference sorts ``os.listdir(postProcessing)``,
data_parser.py:76).

Conventions mirrored from the reference:
  * ``C`` comes from the latest time's cell-centres field / the patch
    ``faceCentres`` file (data_parser.py:46-48, 131-132);
  * ``cellToRegion`` comes from time 0 on the internal mesh and is zero on
    boundaries (data_parser.py:59-60, 134-136);
  * ``d``/``f`` are ``cellToRegion * fvOptions coefficient`` internally and
    zero on boundaries (data_parser.py:61-62, 147-148);
  * vector fields are truncated to ``max_dim`` components.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data import foam_io

DIM_LABELS = ["x", "y", "z"]


def _as_table_column(values: np.ndarray, max_dim: int) -> np.ndarray:
    v = np.asarray(values, np.float64)
    if v.ndim == 1:
        return v[:, None]
    return v[:, :max_dim]


def parse_coef(case_dir: str, coef: str) -> np.ndarray:
    """Porosity coefficient vector from fvOptions (data_parser.py:96-101)."""
    fv = foam_io.read_dict(Path(case_dir) / "system" / "fvOptions")
    return np.asarray(fv["porousFilter"]["explicitPorositySourceCoeffs"][coef])


def parse_nu(case_dir: str) -> float:
    """Kinematic viscosity from constant/transportProperties."""
    tp = foam_io.read_dict(Path(case_dir) / "constant" / "transportProperties")
    return foam_io.dimensioned_value(tp["nu"])


def parse_internal_fields(case_dir: str, *fields: str, max_dim: int = 3
                          ) -> dict[str, np.ndarray]:
    """Internal (cell) fields at the latest time (data_parser.py:119-152)."""
    case = Path(case_dir)
    last = foam_io.latest_time(case)
    out: dict[str, np.ndarray] = {}

    cell_to_region = None
    if {"cellToRegion", "d", "f"} & set(fields):
        cell_to_region = _as_table_column(
            foam_io.read_field_file(case / "0" / "cellToRegion")["internal"], 1)

    for f in fields:
        if f == "C":
            out["C"] = _as_table_column(
                foam_io.read_field_file(case / last / "C")["internal"], max_dim)
        elif f == "cellToRegion":
            out["cellToRegion"] = cell_to_region
        elif f in ("d", "f"):
            coef = parse_coef(case_dir, f)[:max_dim]
            out[f] = cell_to_region * coef[None, :]
        else:
            out[f] = _as_table_column(
                foam_io.read_field_file(case / last / f)["internal"], max_dim)
    return out


def parse_boundary_patch(patch_dir: str, *fields: str, max_dim: int = 3
                         ) -> dict[str, np.ndarray]:
    """One patch's surfaceFieldValue dump directory (data_parser.py:37-65)."""
    patch = Path(patch_dir)
    face_centres = foam_io.read_list_file(patch / "faceCentres")
    n = len(face_centres)
    out: dict[str, np.ndarray] = {}
    for f in fields:
        if f == "C":
            out["C"] = _as_table_column(face_centres, max_dim)
        elif f == "cellToRegion":
            out["cellToRegion"] = np.zeros((n, 1))
        elif f in ("d", "f"):
            out[f] = np.zeros((n, max_dim))
        else:
            for sub in ("scalarField", "vectorField"):
                p = patch / sub / f
                if p.exists():
                    out[f] = _as_table_column(
                        foam_io.read_postprocess_field(p), max_dim)
                    break
            else:
                raise FileNotFoundError(f"field {f} not found under {patch_dir}")
    return out


def parse_boundary_fields(case_dir: str, *fields: str, max_dim: int = 3
                          ) -> dict[str, dict[str, np.ndarray]]:
    """All patches' boundary fields at the case's latest time, sorted by patch
    name (data_parser.py:68-83)."""
    last = int(float(foam_io.latest_time(case_dir)))
    pp = Path(case_dir) / "postProcessing"
    out: dict[str, dict[str, np.ndarray]] = {}
    for name in sorted(os.listdir(pp)):
        surface = pp / name / "surface"
        step_dir = surface / str(last)
        if not step_dir.exists():  # fall back to the patch's own latest dump
            step_dir = surface / foam_io.latest_time(surface)
        patch_dir = step_dir / os.listdir(step_dir)[0]
        out[name] = parse_boundary_patch(str(patch_dir), *fields, max_dim=max_dim)
    return out


def parse_case_fields(case_dir: str, *fields: str, max_dim: int = 3):
    """(internal table, boundary tables) for a case (data_parser.py:155-165)."""
    return (parse_internal_fields(case_dir, *fields, max_dim=max_dim),
            parse_boundary_fields(case_dir, *fields, max_dim=max_dim))


def parse_meta(data_dir: str) -> dict:
    with open(Path(data_dir, "meta.json")) as f:
        return json.load(f)


def parse_model_type(checkpoint_path: str) -> str:
    """Model type from model_meta.json next to the checkpoint
    (data_parser.py:176-182)."""
    with open(Path(checkpoint_path).parent / "model_meta.json") as f:
        return json.load(f)["Model type"]


def parse_elapsed_time(case_dir: str) -> int:
    """OpenFOAM solver wall-time in ns from timing.txt (data_parser.py:185-190)."""
    with open(Path(case_dir, "timing.txt")) as f:
        return int(f.readline())
