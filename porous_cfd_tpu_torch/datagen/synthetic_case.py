"""Synthetic OpenFOAM case writer: the port's own copy of
``porous_cfd_tpu/datagen/synthetic_case.py`` (numpy only), so that a machine
without JAX can make a dataset.

Fabricates complete on-disk OpenFOAM cases (field files, postProcessing
surfaceFieldValue dumps, fvOptions, transportProperties, timing) in the exact
layout the parsers and ``FoamDataset`` consume; the same rng writes the same
bytes as the JAX package's writer, the manufactured-solutions split
included.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data import foam_io


def write_case(case_dir: str | Path,
               points: np.ndarray,
               zone: np.ndarray,
               patches: dict[str, np.ndarray],
               fields: dict[str, np.ndarray] | None = None,
               patch_fields: dict[str, dict[str, np.ndarray]] | None = None,
               d=14000.0, f=17.11, nu: float = 1489.4e-6,
               time: int = 1000, elapsed_ns: int = 10 ** 9,
               solver_meta: dict | None = None) -> None:
    """Write one case.

    :param points: internal cell centres (N, D>=2); padded to 3D on disk.
    :param zone: (N,) cellToRegion ids (0 fluid, 1 porous).
    :param patches: patch name -> face centres (M, D).
    :param fields: internal volume fields, name -> (N,) or (N, D).
    :param patch_fields: patch name -> {field: values} surface dumps.
    :param d,f: Darcy/Forchheimer coefficients, scalar or 3-vector (the
        reference's anisotropic fvOptions vectors, e.g. d = [12000, 20000, 0]).
    :param solver_meta: optional provenance dict (solver name, achieved
        residual, step count, timing mode) written to ``solver.json`` so
        datasets from different solver modes stay distinguishable on disk
        (ADVICE r4).
    """
    case = Path(case_dir)
    if case.exists():
        shutil.rmtree(case)

    def pad3(v):
        v = np.asarray(v, np.float64)
        if v.ndim == 2 and v.shape[1] < 3:
            v = np.concatenate([v, np.zeros((len(v), 3 - v.shape[1]))], axis=1)
        return v

    t = str(time)
    foam_io.write_field_file(case / "0" / "cellToRegion", "volScalarField",
                             "cellToRegion", np.asarray(zone, np.float64))
    foam_io.write_field_file(case / t / "C", "volVectorField", "C", pad3(points))
    for name, vals in (fields or {}).items():
        vals = np.asarray(vals, np.float64)
        cls = "volScalarField" if vals.ndim == 1 else "volVectorField"
        foam_io.write_field_file(case / t / name, cls, name,
                                 vals if vals.ndim == 1 else pad3(vals))

    for patch, centres in patches.items():
        pdir = case / "postProcessing" / patch / "surface" / t / f"patch_{patch}"
        foam_io.write_list_file(pdir / "faceCentres", "faceCentres", pad3(centres))
        for fname, vals in (patch_fields or {}).get(patch, {}).items():
            vals = np.asarray(vals, np.float64)
            sub = "scalarField" if vals.ndim == 1 else "vectorField"
            foam_io.write_postprocess_field(
                pdir / sub / fname, vals if vals.ndim == 1 else pad3(vals))

    def coef3(v):
        a = np.atleast_1d(np.asarray(v, np.float64))
        vals = np.full(3, a[0]) if a.size == 1 else np.zeros(3)
        if a.size > 1:
            vals[:min(a.size, 3)] = a[:3]
        return " ".join(repr(float(c)) for c in vals)

    fv = f"""FoamFile
{{
    version     2.0;
    format      ascii;
    class       dictionary;
    object      fvOptions;
}}

porousFilter{{
    type explicitPorositySource;

    explicitPorositySourceCoeffs{{
        selectionMode cellZone;
        cellZone mesh;
        type DarcyForchheimer;

        d   ({coef3(d)});
        f   ({coef3(f)});

        coordinateSystem{{
            origin (0 0 0);
            rotation none;
        }}
    }}
}}
"""
    (case / "system").mkdir(parents=True, exist_ok=True)
    (case / "system" / "fvOptions").write_text(fv)

    tp = f"""FoamFile
{{
    version     2.0;
    format      ascii;
    class       dictionary;
    object      transportProperties;
}}

transportModel  Newtonian;

nu          [ 0 2 -1 0 0 0 0 ]  {nu} ;
"""
    (case / "constant").mkdir(parents=True, exist_ok=True)
    (case / "constant" / "transportProperties").write_text(tp)

    (case / "timing.txt").write_text(str(int(elapsed_ns)))
    if solver_meta is not None:
        (case / "solver.json").write_text(json.dumps(solver_meta))


def write_manufactured_split(split_dir: str | Path, n_cases: int,
                             rng: np.random.Generator,
                             n_internal: int = 200, n_per_patch: int = 40,
                             extent: float = 2 * np.pi,
                             porous_band=(0.25, 0.5)) -> None:
    """A split of geometry-only cases (fields C + cellToRegion, like the
    manufactured_solutions experiment) with patches walls/interface:
    ``n_internal`` points uniform in the square [0, extent]^2, porous inside
    the vertical band ``porous_band * extent``, ``n_per_patch`` wall points
    on the square's border and as many on the band's two edges."""
    lo, hi = porous_band[0] * extent, porous_band[1] * extent
    for i in range(n_cases):
        pts = rng.uniform(0, extent, size=(n_internal, 2))
        zone = ((pts[:, 0] >= lo) & (pts[:, 0] <= hi)).astype(np.float64)

        tw = rng.uniform(0, 4, size=n_per_patch)
        side = np.floor(tw).astype(int)
        frac = (tw - side) * extent
        walls = np.zeros((n_per_patch, 2))
        walls[side == 0] = np.stack([frac[side == 0], np.zeros((side == 0).sum())], -1)
        walls[side == 1] = np.stack([np.full((side == 1).sum(), extent), frac[side == 1]], -1)
        walls[side == 2] = np.stack([frac[side == 2], np.full((side == 2).sum(), extent)], -1)
        walls[side == 3] = np.stack([np.zeros((side == 3).sum()), frac[side == 3]], -1)
        ix = np.where(rng.uniform(size=n_per_patch) < 0.5, lo, hi)
        iface = np.stack([ix, rng.uniform(0, extent, size=n_per_patch)], -1)

        write_case(Path(split_dir) / f"case_{i}", pts, zone,
                   {"walls": walls, "interface": iface},
                   elapsed_ns=int(rng.integers(5, 50) * 1e8))


def write_foam_split(split_dir: str | Path, n_cases: int,
                     rng: np.random.Generator,
                     n_internal: int = 300, n_per_patch: int = 40,
                     dims: int = 2, d: float = 14000.0, f: float = 17.11,
                     variable: bool = False,
                     patch_names: list[str] | None = None) -> None:
    """A split of full solver-style cases (U, p + coefficient fields) with the
    duct patch set inlet/outlet/walls/interface (override ``patch_names`` for
    e.g. the windbreaks 'solid' house patch)."""
    patch_names = patch_names or ["inlet", "interface", "outlet", "walls"]
    for i in range(n_cases):
        pts = rng.uniform(-1, 1, size=(n_internal, dims))
        zone = (pts[:, 0] > 0.3).astype(np.float64)
        u = rng.normal(size=(n_internal, dims))
        p = rng.normal(size=n_internal)

        patches, patch_fields = {}, {}
        for pn in patch_names:
            centres = rng.uniform(-1, 1, size=(n_per_patch, dims))
            patches[pn] = centres
            pu = rng.normal(size=(n_per_patch, dims))
            if variable and pn == "inlet":
                pu = np.tile(rng.normal(size=(1, dims)), (n_per_patch, 1))
            patch_fields[pn] = {
                "U": pu,
                "p": rng.normal(size=n_per_patch),
                # CFD residual fields the evaluation pipeline cross-checks
                # against (evaluation.py:162-164 in the reference)
                "momentError": rng.normal(size=(n_per_patch, dims)) * 1e-3,
                "div(phi)": rng.normal(size=n_per_patch) * 1e-4,
            }

        di = d * (1 + (rng.uniform() - 0.5) * 0.2) if variable else d
        fi = f * (1 + (rng.uniform() - 0.5) * 0.2) if variable else f
        write_case(Path(split_dir) / f"case_{i}", pts, zone, patches,
                   fields={"U": u, "p": p,
                           "momentError": rng.normal(size=(n_internal, dims)) * 1e-3,
                           "div(phi)": rng.normal(size=n_internal) * 1e-4},
                   patch_fields=patch_fields,
                   d=di, f=fi, elapsed_ns=int(rng.integers(5, 50) * 1e8))


def write_data_config(data_dir: str | Path, fields, variable_boundaries,
                      normalize, dims) -> None:
    cfg = {"Fields": fields, "Variable boundaries": variable_boundaries,
           "Normalize fields": normalize, "Dims": dims}
    with open(Path(data_dir) / "data_config.json", "w") as fh:
        json.dump(cfg, fh, indent=2)
