"""The port's reference-scale grid tools against the JAX package's
(``tools/golden_transform_grid.py``, imported as tests/test_examples_duct.py
imports it): the transform grids, case lists, names and splits for the
seed; the train-only patch's rotations; the files ``generate`` writes;
``scoring_util.split_rel_l2`` against a whole-split rel-L2; and the grid
train / score / analysis tools end to end at a tiny size on the CPU."""
import json
import sys
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.datagen import fvm_batch
from porous_cfd_tpu_torch.models.pipn import pipn_foam
from porous_cfd_tpu_torch.tools import (analyze_grid_errors, analyze_p_offset,
                                        golden_transform_grid, scoring_util,
                                        train_golden_grid, train_golden_variable)
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import golden_transform_grid as jax_grid  # noqa: E402

NX, NY, N_INTERNAL = 24, 16, 120
POINTS = ["--n-internal", "48", "--n-boundary", "40", "--n-obs", "16"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for torch while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def captured_splits(module, argv, monkeypatch):
    """The splits ``module``'s main hands to ``generate`` for ``argv``."""
    seen = {}

    def capture(root, splits, *args, **kwargs):
        seen["splits"] = splits
        return {}

    monkeypatch.setattr(module, "generate", capture)
    if module is jax_grid:
        monkeypatch.setattr(sys, "argv", ["golden_transform_grid.py", *argv])
        module.main()
    else:
        module.main(argv, device="cpu")
    return seen["splits"]


@pytest.mark.parametrize("scale_n,rot_mult,n_cases", [(2, 1, 160), (3, 2, 621)])
def test_enumerate_meshes_is_the_jax_tools(scale_n, rot_mult, n_cases):
    got = golden_transform_grid.enumerate_meshes(scale_n, rot_mult)
    assert got == jax_grid.enumerate_meshes(scale_n, rot_mult)
    assert len(got) == n_cases
    assert golden_transform_grid.TRANSFORMS == jax_grid.TRANSFORMS


@pytest.mark.parametrize("argv,sizes", [
    (["fixed", "--scale-n", "3", "--rot-mult", "2"], (372, 124, 125)),
    (["fixed"], (96, 32, 32)),
    (["variable", "--keep-p", "0.10"], None)], ids=["fixed-621", "fixed-160", "variable"])
def test_case_lists_names_and_splits_are_the_jax_tools(argv, sizes, monkeypatch):
    """For seed 8421 the case list (the variable grid's kept combinations,
    jittered inlets and angles among them), its split and every case name
    equal the JAX tool's."""
    got = captured_splits(golden_transform_grid, argv, monkeypatch)
    want = captured_splits(jax_grid, argv, monkeypatch)
    assert got == want
    if sizes is not None:
        assert tuple(len(got[s]) for s in ("train", "val", "test")) == sizes
    else:
        assert 250 < sum(len(v) for v in got.values()) < 350   # keep-p 0.10 of 3,520
        assert any(np.ndim(c["d"]) for c in got["train"])     # the anisotropic pair
    for split, cases in got.items():
        assert [golden_transform_grid.case_name(i, c) for i, c in enumerate(cases)] == \
            [jax_grid.case_name(i, c) for i, c in enumerate(want[split])]
        assert [golden_transform_grid._solve_params(c) for c in cases] == \
            [jax_grid._solve_params(c) for c in want[split]]


def test_patch_cases_are_the_jax_tools_and_disjoint_from_the_base_grid(tmp_path,
                                                                       monkeypatch):
    """The train-only patch draws the JAX tool's cases, only at rotation
    midpoints: no (shape, rotation) of the base grid among them."""
    shapes = "square,star,semi_circle"
    seen = {}

    def capture(cases, *args, **kwargs):
        seen["cases"] = cases
        return iter(())

    for name in ("solve_cases", "generate_meta", "generate_min_points"):
        monkeypatch.setattr(jax_grid, name, capture if name == "solve_cases"
                            else (lambda *a, **k: None))
    (tmp_path / "train").mkdir()
    jax_grid.patch_train(Namespace(root=str(tmp_path), patch_shapes=shapes, scale_n=2,
                                   keep_p=0.2, nx=NX, ny=NY, solver="numpy", n_internal=50))
    got = golden_transform_grid.patch_cases(set(shapes.split(",")), 2, 0.2)
    assert got == seen["cases"] and len(got) > 20
    base = {(s, round(float(r), 6)) for s, spec in golden_transform_grid.TRANSFORMS.items()
            for r in golden_transform_grid.rotations(spec, 1)}
    assert not {(c["shape"], round(c["rot"], 6)) for c in got} & base
    assert {c["shape"] for c in got} == set(shapes.split(","))


@pytest.fixture(scope="module")
def variable_splits():
    """Five cases of the variable grid (an anisotropic d pair and angled
    inlets among them): 3 train, 1 val, 1 test."""
    rng = np.random.default_rng(golden_transform_grid.SEED)
    meshes = golden_transform_grid.enumerate_meshes(2, 1)
    cases = golden_transform_grid.variable_cases(meshes, rng, 0.10)
    pick = [c for c in cases if np.ndim(c["d"])][:2] + [c for c in cases
                                                       if not np.ndim(c["d"])][:3]
    return {"train": pick[:3], "val": pick[3:4], "test": pick[4:]}


@pytest.mark.parametrize("variable", [False, True], ids=["fixed", "variable"])
def test_generate_writes_the_jax_tools_files(tmp_path, variable, variable_splits,
                                            monkeypatch):
    """``generate`` with the numpy solver writes the JAX tool's files byte
    for byte: meta.json, min_points.json, the data configs, the manifest
    and each solver.json among them (the solves' wall clock is a fake one
    that ticks 1 ms a read, so timing.txt and meta.json's timing agree)."""
    ticks = iter(range(0, 10 ** 12, 10 ** 6))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    splits = variable_splits if variable else {
        k: [{kk: c[kk] for kk in ("shape", "rot", "sx", "sy")} for c in v]
        for k, v in variable_splits.items()}
    for side, module in (("port", golden_transform_grid), ("jax", jax_grid)):
        module.generate(tmp_path / side, splits, NX, NY, N_INTERNAL, variable, solver="numpy")
    files = {side: sorted(p.relative_to(tmp_path / side)
                          for p in (tmp_path / side).rglob("*") if p.is_file())
             for side in ("jax", "port")}
    assert files["jax"] == files["port"]
    names = {p.name for p in files["jax"]}
    assert {"meta.json", "min_points.json", "data_config.json", "manifest.json",
            "solver.json", "timing.txt"} <= names
    for rel in files["jax"]:
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes(), \
            rel
    solver = json.loads(next((tmp_path / "port" / "train").glob("*/solver.json")).read_text())
    assert solver["solver"] == "numpy_f64" and solver["elapsed_mode"] == "per_case"


def test_batch_solver_writes_its_provenance(tmp_path, monkeypatch):
    """``--solver batch`` marches chunks on the device and writes each
    case's solver.json with the JAX keys; the chunks' summary has the
    largest and median step counts."""
    calls = []
    real = fvm_batch.solve_duct_batch

    def small(cases, **kw):
        calls.append(len(cases))
        return real(cases, **{**kw, "max_steps": 60})

    monkeypatch.setattr(fvm_batch, "solve_duct_batch", small)
    cases = golden_transform_grid.enumerate_meshes(2, 1)[:3]
    marches = []
    out = list(golden_transform_grid.solve_cases(cases, NX, NY, "batch", chunk=2, device="cpu",
                                                 marches=marches))
    assert calls == [2, 1] and [o[0] for o in out] == [0, 1, 2]
    meta = out[0][4]
    assert set(meta) == {"solver", "tol", "residual", "steps", "elapsed_mode"}
    assert meta["solver"] == "batch_f32" and meta["tol"] == 2e-4
    summary = golden_transform_grid.march_summary(marches)
    assert summary["cases"] == 3 and summary["max_case_steps"] == 60
    with pytest.raises(ValueError, match="solver"):
        next(golden_transform_grid.solve_cases(cases, NX, NY, "cg"))


@pytest.fixture(scope="module")
def fixed_grid(tmp_path_factory, variable_splits):
    """The fixed grid's five geometries, solved at 24 x 16 by the numpy
    solver and written as the tool writes them."""
    root = tmp_path_factory.mktemp("grid")
    splits = {k: [{kk: c[kk] for kk in ("shape", "rot", "sx", "sy")} for c in v]
              for k, v in variable_splits.items()}
    golden_transform_grid.generate(root, splits, NX, NY, N_INTERNAL, False, solver="numpy")
    return root


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_split_rel_l2_equals_the_whole_split(fixed_grid, chunk):
    """Chunks of 1, 3 and 64 cases give the whole-split rel-L2 of one batch
    (float64 sums; rtol 1e-6)."""
    points = (48, 40, 16)
    ds = scoring_util.load_split(fixed_grid, "train", points)
    model = pipn_foam(1e-3, 1.0, 1.0, fe_local_layers=[2, 8, 8], fe_global_layers=[13, 8, 16],
                      seg_layers=[24, 8, 3], scalers=ds.normalizers, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    stacked = ds.stacked().to("cpu")
    got = scoring_util.split_rel_l2(model, stacked, len(ds),
                                    {f: ds.normalizers[f] for f in ("U", "p")}, chunk)
    batch = gather_cases(stacked, torch.arange(len(ds)))
    with torch.no_grad():
        pred = make_predict_functions(model).predict_batch(batch).numpy()
    for f in ("U", "p"):
        pr = scoring_util.denormalize(ds.normalizers[f], pred[f])
        rf = scoring_util.denormalize(ds.normalizers[f], batch.numpy()[f])
        want = np.linalg.norm(pr - rf) / np.linalg.norm(rf)
        np.testing.assert_allclose(got[f], want, rtol=1e-6)


def test_grid_tools_run_end_to_end(fixed_grid):
    """train_golden_grid trains ``pipn`` on its coupled path for 2 epochs,
    scores the three splits and evaluates the test split; the analyses read
    its checkpoint: per-case rows for every case, the p offsets' three
    numbers a split (the oracle offset never worse than raw)."""
    res = train_golden_grid.main(["--root", str(fixed_grid), "--epochs", "2",
                                  "--paths", "analytic", "--resample-every", "1", *POINTS],
                                 device="cpu")
    assert res["cases"] == {"train": 3, "val": 1, "test": 1}
    run = res["analytic"]
    assert run["steps"] == 2 and run["steps_per_s"] > 0
    for split in ("train", "val", "test"):
        assert all(0 < run[split][f] < 10 for f in ("U", "p"))
    assert np.isfinite(res["evaluate_test"]["p_mae"])
    saved = json.loads((fixed_grid / "logs" / "grid_scores.json").read_text())
    assert saved["analytic"]["val"] == run["val"]
    assert not (REPO / "CONVERGENCE.md").read_text().count(str(fixed_grid))

    rows = analyze_grid_errors.main(["--root", str(fixed_grid), *POINTS], device="cpu")
    assert len(rows["rows"]) == 5 and (fixed_grid / "per_case_errors.json").exists()
    first = rows["rows"][0]
    assert first["shape"] in golden_transform_grid.TRANSFORMS and first["relp"] > 0
    off = analyze_p_offset.main(["--root", str(fixed_grid), *POINTS], device="cpu")
    for split in ("train", "val", "test"):
        r = off[split]
        assert r["oracle_centred"]["pooled"] <= r["raw"]["pooled"] + 1e-12
        assert np.isfinite(r["outlet_anchored"]["pooled"])
    with pytest.raises(ValueError, match="derivative paths"):
        train_golden_grid.main(["--root", str(fixed_grid), "--paths", "fast"], device="cpu")


def test_variable_tool_runs_end_to_end(tmp_path, variable_splits):
    """train_golden_variable trains ``pi-gano`` for 2 epochs on a five-case
    variable grid, scores the three splits and evaluates the test split
    (the MAE by inlet angle and by (d, inlet speed) as numbers)."""
    golden_transform_grid.generate(tmp_path, variable_splits, NX, NY, N_INTERNAL, True,
                                   solver="numpy")
    res = train_golden_variable.main(["--root", str(tmp_path), "--epochs", "2",
                                      "--n-internal", "48", "--n-boundary", "40",
                                      "--n-obs", "16"], device="cpu")
    assert res["steps"] == 2
    for split in ("train", "val", "test"):
        assert all(0 < res[split][f] < 10 for f in ("U", "p"))
    ev = res["evaluate_test"]
    assert ev["cases"] == 1 and np.isfinite(ev["p_mae"])
    assert (tmp_path / "logs" / "goldenvar_scores.json").exists()
    ds = FoamDataset(str(tmp_path / "train"), 48, 40, 16, np.random.default_rng(8421))
    assert ds.stacked().data.shape[0] == 3
