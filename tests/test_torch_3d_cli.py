"""The 3D experiments' CLIs, abc and windbreaks, and the variable duct's
inference and evaluate CLIs, in process on the CPU (``run(argv,
device="cpu")``) at the zoos' full widths on synthetic splits as the JAX
package's own 3D test writes them (tests/test_examples_3d.py:15-31): the
training CLI writes its checkpoint, the restored model predicts as the
trained one did, the evaluate line's numbers are finite and group every
case; the 3D golden run at a tiny size; ``extract_coef``,
``extract_u_magnitude`` and ``extract_angle`` against the JAX functions,
and ``mae_by``'s grouping."""
import json

import numpy as np
import pandas
import pytest
import torch

from porous_cfd_tpu.data import scalers as jax_scalers
from porous_cfd_tpu.pipelines import evaluation as jax_evaluation
from porous_cfd_tpu_torch.data import scalers
from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.datagen import meta, synthetic_case
from porous_cfd_tpu_torch.examples.abc import evaluate as abc_evaluate
from porous_cfd_tpu_torch.examples.abc import inference as abc_inference
from porous_cfd_tpu_torch.examples.abc import train as abc_train
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import inference as fixed_inference
from porous_cfd_tpu_torch.examples.duct_variable_boundary import evaluate as var_evaluate
from porous_cfd_tpu_torch.examples.duct_variable_boundary import inference as var_inference
from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as var_train
from porous_cfd_tpu_torch.examples.windbreaks import evaluate as wb_evaluate
from porous_cfd_tpu_torch.examples.windbreaks import inference as wb_inference
from porous_cfd_tpu_torch.examples.windbreaks import train as wb_train
from porous_cfd_tpu_torch.pipelines import evaluation
from porous_cfd_tpu_torch.tools import train_golden_3d
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
from porous_cfd_tpu_torch.viz import viz3d

FIELDS = ["C", "U", "p", "cellToRegion", "d", "f"]
POINTS = ["--n-internal", "48", "--n-boundary", "50", "--n-observations", "12"]
V_TOL = dict(rtol=1e-5, atol=1e-6)
STATS = "lightning_logs/run/plots/val/stats"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_split(root, dims, patch_names, variable_boundaries):
    """3 training and 2 held-out synthetic cases of 160 internal points and
    24 a patch, with variable inlet velocity and d, f."""
    rng = np.random.default_rng(8421)
    for split, n in (("train", 3), ("val", 2)):
        synthetic_case.write_foam_split(root / split, n, rng, n_internal=160, n_per_patch=24,
                                        dims=dims, d=30000.0, f=79.731, variable=True,
                                        patch_names=patch_names)
        synthetic_case.write_data_config(root / split, fields=FIELDS,
                                         variable_boundaries=variable_boundaries,
                                         normalize={"Scale": ["d", "f"],
                                                    "Standardize": ["C", "U", "p"]},
                                         dims=["x", "y", "z"][:dims])
        meta.generate_meta(root / split, *FIELDS, max_dim=dims)
    meta.generate_min_points(root)
    return root


def train_restore_evaluate(cli, root, tmp_path, model_name, capsys, monkeypatch):
    """Train 2 epochs through ``cli``'s training CLI, restore the checkpoint
    through its inference CLI (each held-out case as the trained model
    predicts it, in f32) and evaluate it; returns the evaluate line."""
    train, inference, evaluate = cli
    model = train.run(["--model", model_name, "--name", "run", "--epochs", "2",
                       "--batch-size", "3", "--train-dir", str(root / "train"),
                       "--val-dir", str(root / "val"), "--logs-dir", str(tmp_path), *POINTS],
                      device="cpu")
    run_dir = tmp_path / "lightning_logs" / "run"
    assert json.loads((run_dir / "model_meta.json").read_text())["Model type"] == model_name
    payload = torch.load(run_dir / "model.ckpt", weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 2
    assert all(bool(v.isfinite().all()) for v in payload["module"].values())

    argv = ["--checkpoint", str(run_dir / "model.ckpt"), "--data-dir", str(root / "val"),
            "--meta-dir", str(root / "train"), *POINTS]
    preds = inference.run(argv + ["--precision", "32-true"], device="cpu")
    data = FoamDataset(str(root / "val"), 48, 50, 12, np.random.default_rng(8421),
                       str(root / "train"))
    stacked = model.attach_neighbors(data.stacked().to("cpu"))
    fns = make_predict_functions(model)
    assert len(preds) == 2
    for i, pred in enumerate(preds):
        ref = fns.predict_batch(gather_cases(stacked, torch.tensor([i]))).data[0].numpy()
        np.testing.assert_allclose(pred.data, ref, **V_TOL)

    capsys.readouterr()
    summary = evaluate.run(argv + ["--batch-size", "1"], device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["cases"] == 2
    assert np.isfinite(summary["U_mae"]) and np.isfinite(summary["p_mae"])
    # --save-plots: the evaluation's plots and Errors.csv, drawn, under
    # <checkpoint parent>/plots/<split>/stats; each case's field plots under
    # .../<split>/<case>, recorded here (tests/test_torch_evaluation_plots.py
    # holds them to the JAX package's)
    evaluate.run(argv + ["--save-plots", "--batch-size", "1"], device="cpu")
    stats = run_dir / "plots" / "val" / "stats"
    assert {"Errors.csv", "Average relative error.png", "Top 20% mean errors.png",
            "Total simulation time [s].png", "Absolute average residuals.png"} <= \
        {p.name for p in stats.iterdir()}
    assert list(pandas.read_csv(stats / "Errors.csv", index_col=0).index) == \
        list(summary["errors"])
    drawn = []
    for mod in (inference, fixed_inference, viz3d):
        for name in ("plot_fields", "plot_fields_3d", "plot_surface_errors"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, lambda title, *a, save_path=None, **k:
                                    drawn.append((title, save_path.name)))
    inference.run(argv + ["--save-plots"], device="cpu")
    assert {case for _, case in drawn} == {"case_0", "case_1"}
    assert drawn[1][0] == "Ground truth"
    return summary


def test_abc_clis(tmp_path, capsys, monkeypatch):
    root = write_split(tmp_path / "data", 3, None, {"Ux": "inlet"})
    summary = train_restore_evaluate((abc_train, abc_inference, abc_evaluate), root,
                                     tmp_path, "pipn", capsys, monkeypatch)
    assert (tmp_path / STATS / "MAE by inlet speed.png").exists()
    by_speed = summary["mae_by_inlet_speed"]
    assert sum(e["cases"] for e in by_speed) == 2
    assert all(len(e["mae"]) == 4 and np.all(np.isfinite(e["mae"])) for e in by_speed)


def test_windbreaks_clis(tmp_path, capsys, monkeypatch):
    root = write_split(tmp_path / "data", 3, ["inlet", "interface", "outlet", "solid", "walls"],
                       {"Ux": "inlet"})
    summary = train_restore_evaluate((wb_train, wb_inference, wb_evaluate), root, tmp_path,
                                     "pi-gano-pp", capsys, monkeypatch)
    for name in ("Solid Absolute error distribution", "Solid Average relative error",
                 "MAE heatmap"):
        assert (tmp_path / STATS / f"{name}.png").exists(), name
    assert len(summary["solid_mae"]) == 4 and np.all(np.isfinite(summary["solid_mae"]))
    cells = summary["mae_by_d_and_inlet_speed"]
    assert sum(e["cases"] for e in cells) == 2 and all(set(e) == {"d", "U inlet", "cases", "mae"}
                                                       for e in cells)


def test_variable_duct_inference_and_evaluate(tmp_path, capsys, monkeypatch):
    root = write_split(tmp_path / "data", 2, None, {"U": "inlet"})
    summary = train_restore_evaluate((var_train, var_inference, var_evaluate), root, tmp_path,
                                     "pi-gano", capsys, monkeypatch)
    for name in ("MAE by inlet angle", "MAE heatmap", "Pressure drop"):
        assert (tmp_path / STATS / f"{name}.png").exists(), name
    assert sum(e["cases"] for e in summary["mae_by_inlet_angle"]) == 2
    assert sum(e["cases"] for e in summary["mae_by_d_and_inlet_speed"]) == 2
    assert np.isfinite(summary["pressure_drop_error"])


def test_golden_3d_run_at_a_tiny_size(tmp_path, capsys):
    """Solve the 8 + 3 cases on a 12 x 8 x 8 grid, train one step and score:
    the scores file holds what the line printed."""
    scores = train_golden_3d.main(
        ["--root", str(tmp_path / "g3"), "--epochs", "1", "--nx", "12", "--ny", "8", "--nz",
         "8", "--n-internal", "40", "--n-boundary", "40", "--n-obs", "12"], device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        (tmp_path / "g3" / "golden_3d_scores.json").read_text())
    assert scores["steps"] == 1 and scores["train_cases"] == 8
    assert scores["solve"]["train"]["max_residual"] < 2e-4
    for split in ("train", "val"):
        assert all(np.isfinite(scores[split][k]) for k in ("U", "p"))
    assert scores["evaluate_val"]["cases"] == 3
    train, val = train_golden_3d.zoo_cases(5, 3)
    assert len(train) == 5 and len(val) == 3 and {c[0] for c in train + val} <= {
        "sphere", "box", "cylinder"}


def test_extract_helpers_match_jax():
    rng = np.random.default_rng(2)
    u = rng.normal(size=(3, 7, 3)).astype(np.float32)
    std, mean = rng.uniform(0.5, 2.0, 3), rng.normal(size=3)
    lo, hi = np.asarray([1.0]), np.asarray([30000.0])
    coef = rng.uniform(0, 1, (3, 7, 1)).astype(np.float32)
    port_u, ref_u = scalers.StandardScaler(std, mean), jax_scalers.StandardScaler(std, mean)
    port_c, ref_c = scalers.Normalizer(lo, hi), jax_scalers.Normalizer(lo, hi)
    np.testing.assert_allclose(evaluation.extract_coef(coef, port_c),
                               jax_evaluation.extract_coef(coef, ref_c), rtol=1e-6)
    for spacing in (0.025, 1e-6):
        np.testing.assert_allclose(evaluation.extract_u_magnitude(u, port_u, spacing),
                                   jax_evaluation.extract_u_magnitude(u, ref_u, spacing),
                                   rtol=1e-6)
    np.testing.assert_allclose(evaluation.extract_u_magnitude(u[..., :1], port_u[0], 1e-6),
                               jax_evaluation.extract_u_magnitude(u[..., :1], ref_u[0], 1e-6),
                               rtol=1e-6)
    np.testing.assert_allclose(evaluation.extract_angle(u[..., :2], port_u[:2]),
                               jax_evaluation.extract_angle(u[..., :2], ref_u[:2]),
                               rtol=1e-5, atol=1e-4)


def test_mae_by_groups_cases_by_their_values():
    results = {"U error": np.ones((4, 5, 2)) * np.arange(4)[:, None, None],
               "p error": np.zeros((4, 5, 1)),
               "d": np.asarray([[[1]], [[2]], [[1]], [[2]]]),
               "U inlet": np.asarray([[[0.1]], [[0.1]], [[0.1]], [[0.2]]])}
    got = evaluation.mae_by(results, ["d", "U inlet"])
    assert [(e["d"], e["U inlet"], e["cases"]) for e in got] == [(1, 0.1, 2), (2, 0.1, 1),
                                                                 (2, 0.2, 1)]
    assert got[0]["mae"] == [1.0, 1.0, 0.0] and got[2]["mae"] == [3.0, 3.0, 0.0]
