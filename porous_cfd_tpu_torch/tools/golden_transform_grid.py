"""Reference-scale FVM golden datasets, the duct transform grid (the port's
counterpart of ``tools/golden_transform_grid.py``):

  * ``fixed``: the 11-primitive zoo x rotation grid x (x, y) scale grid of
    the duct experiment's ``transforms.json`` (rotation = linspace(start,
    stop, n), scale = linspace(0.75, 1, 2) an axis: 160 cases), shuffled
    and split 60/20/20 into train / val / test, so that val and test hold
    geometry variants no training case has. ``--scale-n 3 --rot-mult 2``
    densifies it to 621 cases (372 / 124 / 125).
  * ``variable``: the duct_variable_boundary protocol: the (d, f)
    coefficient grid (the anisotropic d = (12000, 20000) pair among them) x
    5 inlet speeds over the transformed zoo, each combination kept with
    probability ``--keep-p``, with a random inlet angle in [-30, 30] degrees
    and 0.015 m/s of inlet jitter.

Each case is solved to steady state and written in the case layout with its
solve time and a ``solver.json`` (``solver`` "numpy_f64" or "batch_f32",
``tol``, ``residual``, ``steps``, ``elapsed_mode``); then ``meta.json``,
``min_points.json``, ``data_config.json`` and ``manifest.json``, so the
experiment CLIs read the splits as they are. ``--solver numpy`` is the
port's sequential f64 solver (``datagen/fvm.py``, tol 1e-4), ``--solver
batch`` the batched f32 march on the card (``datagen/fvm_batch.py``, tol
2e-4, CHUNK cases a march; a case's ``elapsed_ns`` is its chunk's average).
The random draws, case names and splits are the JAX tool's for the same
seed.

    python -m porous_cfd_tpu_torch.tools.golden_transform_grid fixed \\
        --scale-n 3 --rot-mult 2 --solver batch [--root data/golden_grid]
    python -m porous_cfd_tpu_torch.tools.golden_transform_grid variable \\
        --keep-p 0.10 --solver batch [--root data/golden_variable]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.datagen import fvm
from porous_cfd_tpu_torch.datagen.meta import generate_meta, generate_min_points
from porous_cfd_tpu_torch.datagen.synthetic_case import write_data_config
from porous_cfd_tpu_torch.device import resolve_device

# transforms.json: shape -> rotation (start, stop, n) in degrees; the scale
# grid is linspace(0.75, 1, 2) on x and y independently for every shape
TRANSFORMS = {
    "circle": [],
    "semi_circle": [0, 315, 5],
    "circle_sector": [0, 315, 5],
    "equilateral_triangle": [30, 90, 3],
    "equilateral_hexagon": [0, 30, 2],
    "equilateral_octagon": [0, 22.5, 2],
    "trapezoid": [0, 315, 5],
    "square": [0, 85, 4],
    "star": [0, 85, 4],
    "ellipse": [0, 90, 4],
    "rectangle": [0, 135, 5],
}
BASE_SIZE = 0.14
CENTER = (0.1, 0.0)

# the duct_variable_boundary config.json's 'cfd params'
VARIABLE_COEFFS = [
    {"d": 5000.0, "f": 16.381},
    {"d": 7000.0, "f": 20.783},
    {"d": 9000.0, "f": 24.923},
    {"d": (12000.0, 20000.0), "f": 30.80},
]
VARIABLE_INLETS = [0.1, 0.125, 0.15, 0.175, 0.2]
VARIABLE_ANGLE = (-30.0, 30.0)
VARIABLE_INLET_JITTER = 0.015

SPLITS = {"train": 0.6, "val": 0.2, "test": 0.2}
SEED = 8421
# cases a batched march
CHUNK = 160
# each solver's convergence tolerance: the batched f32 march stops above its
# update norm's noise floor
TOL = {"numpy": 1e-4, "batch": 2e-4}


def rotations(spec, rot_mult=1):
    if not spec:
        return [0.0]
    n = int(spec[2]) + (int(spec[2]) - 1) * (rot_mult - 1)
    return np.linspace(spec[0], spec[1], n).tolist()


def scale_grid(scale_n=2):
    s = np.linspace(0.75, 1.0, scale_n)
    return [(float(a), float(b)) for a in s for b in s]


def enumerate_meshes(scale_n=2, rot_mult=1):
    """Every transformed geometry, {shape, rot (degrees), sx, sy}.

    ``scale_n`` points a scale axis and ``rot_mult`` (midpoints inserted
    into each rotation linspace) densify the reference grid and keep its
    corners."""
    out = []
    for shape, rot in TRANSFORMS.items():
        for r in rotations(rot, rot_mult):
            for sx, sy in scale_grid(scale_n):
                out.append({"shape": shape, "rot": float(r), "sx": sx, "sy": sy})
    return out


def split_cases(cases, rng):
    """Shuffle, then split 60/20/20 into train / val / test."""
    order = rng.permutation(len(cases))
    n_train = int(len(cases) * SPLITS["train"])
    n_val = int(len(cases) * SPLITS["val"])
    return {
        "train": [cases[i] for i in order[:n_train]],
        "val": [cases[i] for i in order[n_train:n_train + n_val]],
        "test": [cases[i] for i in order[n_train + n_val:]],
    }


def variable_cases(meshes, rng, keep_p, coeffs=VARIABLE_COEFFS, inlets=VARIABLE_INLETS):
    """Each (coefficients, inlet speed, mesh) combination kept with
    probability ``keep_p``, with its jittered inlet speed and random angle,
    drawn from ``rng`` in that order."""
    cases = []
    for c in coeffs:
        for inlet in inlets:
            for mesh in meshes:
                if rng.random() > keep_p:
                    continue
                u = inlet + rng.uniform(-VARIABLE_INLET_JITTER / 2, VARIABLE_INLET_JITTER / 2)
                angle = np.radians(rng.uniform(*VARIABLE_ANGLE))
                cases.append({**mesh, "d": c["d"], "f": c["f"], "u_x": u * np.cos(angle),
                              "u_y": u * np.sin(angle), "angle_deg": float(np.degrees(angle))})
    return cases


def _solve_params(case):
    cx, cy = CENTER
    return dict(shape=case["shape"], cx=cx, cy=cy, size=BASE_SIZE,
                theta=float(np.radians(case["rot"])), sx=case["sx"], sy=case["sy"],
                u_inlet=case.get("u_x", fvm.U_INLET), v_inlet=case.get("u_y", 0.0),
                d=case.get("d", fvm.DARCY_D), f=case.get("f", fvm.FORCH_F))


def solve_and_write(case, case_dir, nx, ny, n_internal, rng, max_steps=30000, tol=1e-4):
    """One case by the numpy solver, written to ``case_dir``."""
    p = _solve_params(case)
    t0 = time.perf_counter_ns()
    sol = fvm.solve_duct(nx=nx, ny=ny, max_steps=max_steps, tol=tol, **p)
    elapsed = time.perf_counter_ns() - t0
    fvm.solution_to_case(sol, case_dir, n_internal=n_internal, rng=rng, d=p["d"], f=p["f"],
                         u_inlet=p["u_inlet"], v_inlet=p["v_inlet"], elapsed_ns=elapsed)
    return sol


def solve_cases(cases, nx, ny, solver="numpy", chunk=CHUNK, max_steps=30000, device=None,
                marches: list | None = None):
    """Yield (index, case, DuctSolution, elapsed_ns, solver_meta) for every
    case, in order.

    ``solver="numpy"`` solves the cases one by one in f64 on the host;
    ``"batch"`` marches ``chunk`` cases at a time on ``device`` in f32, and
    a case's elapsed_ns is its chunk's average. ``marches``, if given,
    receives each batched march's cases, seconds, steps marched and the
    cases' step counts."""
    if solver == "numpy":
        for i, case in enumerate(cases):
            t0 = time.perf_counter_ns()
            sol = fvm.solve_duct(nx=nx, ny=ny, max_steps=max_steps, tol=TOL["numpy"],
                                 **_solve_params(case))
            meta = {"solver": "numpy_f64", "tol": TOL["numpy"], "residual": float(sol.residual),
                    "steps": int(sol.steps), "elapsed_mode": "per_case"}
            yield i, case, sol, time.perf_counter_ns() - t0, meta
        return
    if solver != "batch":
        raise ValueError(f"unknown solver {solver!r}: numpy or batch")
    from porous_cfd_tpu_torch.datagen.fvm_batch import solve_duct_batch
    for c0 in range(0, len(cases), chunk):
        part = cases[c0:c0 + chunk]
        march: dict = {}
        sols = solve_duct_batch([_solve_params(c) for c in part], nx=nx, ny=ny,
                                tol=TOL["batch"], max_steps=max_steps, device=device,
                                stats=march)
        if marches is not None:
            marches.append({"cases": len(part), **march,
                            "case_steps": [int(s.steps) for s in sols]})
        per_case = int(march["seconds"] * 1e9) // max(1, len(part))
        for j, (case, sol) in enumerate(zip(part, sols)):
            meta = {"solver": "batch_f32", "tol": TOL["batch"], "residual": float(sol.residual),
                    "steps": int(sol.steps), "elapsed_mode": "chunk_average"}
            yield c0 + j, case, sol, per_case, meta


def case_name(i, case):
    tag = f"{case['shape']}_r{case['rot']:g}_s{case['sx']:g}-{case['sy']:g}"
    if "u_x" in case:
        d = case["d"]
        d0 = d[0] if np.ndim(d) else d
        tag += f"_d{d0:g}_in{np.hypot(case['u_x'], case['u_y']):.4f}"
    return f"case_{i:03d}_{tag}"


def march_summary(marches) -> dict:
    """A split's batched marches: cases, seconds, steps marched, ms a step,
    the cases' largest and median step counts."""
    if not marches:
        return {}
    steps = [s for m in marches for s in m["case_steps"]]
    seconds = sum(m["seconds"] for m in marches)
    marched = sum(m["steps"] for m in marches)
    return {"cases": len(steps), "marches": len(marches), "solve_s": seconds,
            "steps_marched": marched, "ms_per_step": seconds * 1e3 / marched,
            "max_case_steps": max(steps), "median_case_steps": float(np.median(steps))}


def _write_solved(root_split, i, name, case, sol, elapsed_ns, smeta, n_internal):
    p = _solve_params(case)
    fvm.solution_to_case(sol, root_split / name, n_internal=n_internal,
                         rng=np.random.default_rng(SEED + i), d=p["d"], f=p["f"],
                         u_inlet=p["u_inlet"], v_inlet=p["v_inlet"], elapsed_ns=elapsed_ns,
                         solver_meta=smeta)
    if sol.residual > 1e-3:
        print(f"  WARNING {name}: residual {sol.residual:.2e} after {sol.steps} steps",
              flush=True)


def generate(root, splits, nx, ny, n_internal, variable, solver="numpy", device=None) -> dict:
    """Solve and write every split under ``root`` with its configs and meta,
    then ``min_points.json`` and ``manifest.json``. Returns each split's
    batched-march summary (``march_summary``; empty for the numpy
    solver)."""
    root = Path(root)
    manifest, report = {}, {}
    for split, cases in splits.items():
        print(f"[{split}] solving {len(cases)} cases at {nx}x{ny} (solver={solver}) ...",
              flush=True)
        t0 = time.time()
        marches: list = []
        for i, case, sol, elapsed_ns, smeta in solve_cases(cases, nx, ny, solver,
                                                           device=device, marches=marches):
            _write_solved(root / split, i, case_name(i, case), case, sol, elapsed_ns, smeta,
                          n_internal)
            if (i + 1) % 20 == 0:
                print(f"  {i + 1}/{len(cases)} ({time.time() - t0:.0f}s)", flush=True)
        manifest[split] = [case_name(i, c) for i, c in enumerate(cases)]
        report[split] = march_summary(marches)

        fields = ["C", "U", "p", "cellToRegion"]
        norm = {"Scale": [], "Standardize": ["C", "U", "p"]}
        var_bounds = {}
        if variable:
            fields += ["d", "f"]
            norm = {"Scale": ["d", "f"], "Standardize": ["C", "U", "p"]}
            var_bounds = {"U": "inlet"}
        write_data_config(root / split, fields, var_bounds, norm, ["x", "y"])
        generate_meta(root / split, *fields, max_dim=2)
        print(f"[{split}] done in {time.time() - t0:.0f}s", flush=True)
    generate_min_points(root)
    with open(root / "manifest.json", "w") as fh:
        json.dump({"splits": manifest, "grid": {"nx": nx, "ny": ny, "base_size": BASE_SIZE},
                   "seed": SEED}, fh, indent=2)
    return report


def patch_cases(shapes, scale_n, keep_p):
    """The train-only densification's cases: the named shapes at the
    MIDPOINT rotations of the reference linspaces only (never a base-grid
    rotation, so no held-out geometry variant enters training), over the
    whole coefficient x inlet grid with ``keep_p``, drawn from seed
    SEED + 7."""
    rng = np.random.default_rng(SEED + 7)
    base, dense = set(), []
    for shape, rot in TRANSFORMS.items():
        if shape not in shapes:
            continue
        base.update((shape, float(r)) for r in rotations(rot, 1))
        for r in rotations(rot, 2):
            if (shape, float(r)) not in base:
                for sx, sy in scale_grid(scale_n):
                    dense.append({"shape": shape, "rot": float(r), "sx": sx, "sy": sy})
    return variable_cases(dense, rng, keep_p)


def patch_train(args, device=None) -> dict:
    """Append the densification's cases (``patch_cases``) to an existing
    variable grid's train split and regenerate its meta and min_points."""
    root = Path(args.root or "data/golden_variable")
    train_dir = root / "train"
    offset = sum(1 for d in train_dir.iterdir() if d.is_dir())
    shapes = set(args.patch_shapes.split(","))
    cases = patch_cases(shapes, args.scale_n, args.keep_p)
    print(f"patch: {len(cases)} extra train cases for {sorted(shapes)} at midpoint rotations "
          f"(existing train: {offset})", flush=True)
    t0 = time.time()
    marches: list = []
    for i, case, sol, elapsed_ns, smeta in solve_cases(cases, args.nx, args.ny, args.solver,
                                                       device=device, marches=marches):
        _write_solved(train_dir, offset + i, case_name(offset + i, case), case, sol,
                      elapsed_ns, smeta, args.n_internal)
        if (i + 1) % 20 == 0:
            print(f"  {i + 1}/{len(cases)} ({time.time() - t0:.0f}s)", flush=True)
    generate_meta(train_dir, "C", "U", "p", "cellToRegion", "d", "f", max_dim=2)
    generate_min_points(root)
    print(f"patch done in {time.time() - t0:.0f}s", flush=True)
    return {"train_patch": march_summary(marches)}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["fixed", "variable"])
    ap.add_argument("--root", default=None)
    ap.add_argument("--nx", type=int, default=120)
    ap.add_argument("--ny", type=int, default=72)
    ap.add_argument("--n-internal", type=int, default=4000,
                    help="internal cell subsample per case (the full grid is nx*ny); keeps "
                         "the parse and disk cost bounded")
    ap.add_argument("--keep-p", type=float, default=0.05,
                    help="variable mode: per-combination keep probability")
    ap.add_argument("--scale-n", type=int, default=2,
                    help="points per scale axis in linspace(0.75, 1.0, n); 2 = reference grid, "
                         "3 = densified")
    ap.add_argument("--rot-mult", type=int, default=1,
                    help="rotation densification: 2 inserts midpoints into every reference "
                         "rotation linspace")
    ap.add_argument("--solver", choices=["numpy", "batch"], default="numpy",
                    help="'batch' marches CHUNK cases at a time on the card "
                         "(datagen/fvm_batch.py), minutes instead of hours for the "
                         "reference-scale grids")
    ap.add_argument("--patch-shapes", default="",
                    help="variable mode: EXTRA train-only cases for these shapes (comma list) "
                         "at rotation MIDPOINTS only, appended to an existing --root train "
                         "split; regenerates the train meta and min_points")
    return ap


def main(argv=None, device=None) -> dict:
    """Write the grid on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for); prints and returns each split's batched-march summary."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    if args.patch_shapes:
        report = patch_train(args, device)
    else:
        rng = np.random.default_rng(SEED)
        meshes = enumerate_meshes(args.scale_n, args.rot_mult)
        if args.mode == "fixed":
            root = args.root or "data/golden_grid"
            splits = split_cases(meshes, rng)
        else:
            root = args.root or "data/golden_variable"
            cases = variable_cases(meshes, rng, args.keep_p)
            print(f"variable grid: kept {len(cases)} of "
                  f"{len(VARIABLE_COEFFS) * len(VARIABLE_INLETS) * len(meshes)} combinations",
                  flush=True)
            splits = split_cases(cases, rng)
        report = generate(root, splits, args.nx, args.ny, args.n_internal,
                          variable=(args.mode == "variable"), solver=args.solver,
                          device=device)
    print(json.dumps({"solve": report}), flush=True)
    return report


if __name__ == "__main__":
    main()
