"""The port's duct_fixed_boundary experiment on the CPU, on tiny golden-duct
splits that the port's FVM solver writes: the training CLI trains ``pipn``
on its three derivative paths, ``pipn-pp`` and ``pipn-pp-mrg`` and writes
the checkpoint and ``model_meta.json``; the zoo, ``pipn-pp-full`` too, has
the JAX package's shapes; the inference CLI restores a checkpoint and predicts what
the trained weights predict; the evaluate CLI's line agrees with the JAX
package's evaluation of the same weights on the same split; the golden-duct
run runs end to end; and the bench prints its line."""
import json
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.duct_fixed_boundary import evaluate as jax_fixed_evaluate
from examples.duct_fixed_boundary import train as jax_fixed_train
from porous_cfd_tpu.data.dataset import FoamDataset as JaxFoamDataset
from porous_cfd_tpu.pipelines import evaluation as jax_evaluation
from porous_cfd_tpu.pipelines import inference as jax_inference
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch import bench
from porous_cfd_tpu_torch.convert import params_to_flax
from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.datagen import fvm, meta, synthetic_case
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate, inference, train
from porous_cfd_tpu_torch.pipelines import evaluation
from porous_cfd_tpu_torch.pipelines import inference as port_inference
from porous_cfd_tpu_torch.tools import golden_spread, train_golden_duct
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions

REPO = Path(__file__).resolve().parents[1]
NX, NY = 24, 16
POINTS = ["--n-internal", "48", "--n-boundary", "40", "--n-observations", "16"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for torch while this module runs: the suite runs in
    several worker processes at once, and these full-width models would
    otherwise each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """3 training and 2 held-out duct cases solved at 24 x 16."""
    root = tmp_path_factory.mktemp("fixed") / "data"
    for name, cases in (("train", fvm.GOLDEN_CASES[:3]), ("val", fvm.GOLDEN_CASES[3:5])):
        fvm.write_golden_split(root / name, cases, nx=NX, ny=NY)
        synthetic_case.write_data_config(root / name, ["C", "U", "p", "cellToRegion"], {},
                                         {"Scale": [], "Standardize": ["C", "U", "p"]},
                                         ["x", "y"])
        meta.generate_meta(root / name, "C", "U", "p", "cellToRegion", max_dim=2)
    meta.generate_min_points(root)
    return root


def train_argv(split, logs, model, name, epochs=1, extra=()):
    return ["--model", model, "--name", name, "--epochs", str(epochs), "--batch-size", "2",
            "--train-dir", str(split / "train"), "--val-dir", str(split / "val"),
            "--logs-dir", str(logs), *POINTS, *extra]


@pytest.fixture(scope="module")
def trained(split, tmp_path_factory):
    """``pipn`` (decoupled) trained for 2 epochs; its checkpoint."""
    logs = tmp_path_factory.mktemp("logs")
    train.run(train_argv(split, logs, "pipn", "pipn", epochs=2), device="cpu")
    return logs / "lightning_logs" / "pipn" / "model.ckpt"


@pytest.mark.parametrize("model,extra", [
    ("pipn", ()), ("pipn", ("--coupled-context",)), ("pipn", ("--exact-derivatives",)),
    ("pipn-pp", ()), ("pipn-pp-mrg", ())],
    ids=["pipn", "pipn-coupled", "pipn-exact", "pipn-pp", "pipn-pp-mrg"])
def test_train_cli_trains_each_model(split, tmp_path, model, extra):
    train.run(train_argv(split, tmp_path, model, "run", extra=extra), device="cpu")
    run_dir = tmp_path / "lightning_logs" / "run"
    assert (run_dir / "model.ckpt").exists() and (run_dir / "best.ckpt").exists()
    meta_json = json.loads((run_dir / "model_meta.json").read_text())
    assert meta_json["Model type"] == model and meta_json["N boundary"] == 40
    payload = torch.load(run_dir / "model.ckpt", weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] == 2
    assert all(bool(v.isfinite().all()) for v in payload["module"].values())


def test_the_zoo_is_the_jax_packages_and_pipn_pp_full_is_not_ported(split):
    """Named when the U-Net raised: each model's parameter tree, the U-Net's
    too, has the JAX zoo's shapes, and the paths are the asked ones (the
    U-Net's CLI runs are tests/test_torch_unet_cli.py's)."""
    ds = FoamDataset(str(split / "train"), 48, 40, 16, np.random.default_rng(8421))
    jax_ds = JaxFoamDataset(str(split / "train"), 48, 40, 16, np.random.default_rng(8421))
    for model_type in ("pipn", "pipn-pp", "pipn-pp-mrg", "pipn-pp-full"):
        args = train.build_arg_parser().parse_args(["--model", model_type])
        port = train.get_model(args, ds.normalizers, "cpu")
        ref = jax_fixed_train.get_model(args, jax_ds.normalizers)
        batch = jax_ds.stacked()
        one = jax_engine.gather_cases(ref.attach_neighbors(batch), jnp.arange(1))
        params = jax.eval_shape(lambda: ref.module.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(one["C"]), one))["params"]
        got = jax.tree_util.tree_map(np.shape, params_to_flax(port.module))
        assert got == jax.tree_util.tree_map(lambda x: x.shape, params), model_type
        if model_type == "pipn-pp-full":
            assert port.module.decoder.dropout == ref.module.dec_dropout
        else:
            assert port.module.seg_dropout == tuple(ref.module.seg_dropout)
        assert (port.derivative_apply is None) == (ref.derivative_apply is None)
    exact = train.get_model(train.build_arg_parser().parse_args(
        ["--model", "pipn", "--exact-derivatives"]), ds.normalizers, "cpu")
    assert exact.derivative_apply is None


def test_parsers_have_the_jax_flags_and_defaults():
    assert flags(port_inference.build_arg_parser()) == flags(jax_inference.build_arg_parser())
    assert flags(evaluation.build_arg_parser()) == flags(jax_evaluation.build_arg_parser())


def test_load_model_and_params_restores_a_prediction(split, trained, monkeypatch):
    argv = ["--checkpoint", str(trained), "--data-dir", str(split / "val"),
            "--meta-dir", str(split / "train"), *POINTS]
    args = port_inference.build_arg_parser().parse_args(argv)
    data = FoamDataset(args.data_dir, 48, 40, 16, np.random.default_rng(8421), args.meta_dir)
    model, state = inference.load_model_and_params(args, data, device="cpu")
    payload = torch.load(trained, weights_only=True)
    for key, value in payload["module"].items():
        torch.testing.assert_close(model.module.state_dict()[key], value, rtol=0, atol=0)
    assert state.step == payload["step"]

    # the trained weights' own prediction, case by case, in f32
    f32 = inference.run(argv + ["--precision", "32-true"], device="cpu")
    fns = make_predict_functions(model)
    stacked = data.stacked().to("cpu")
    assert len(f32) == len(data) == 2
    for i, pred in enumerate(f32):
        ref = fns.predict_batch(gather_cases(stacked, torch.tensor([i]))).data[0].numpy()
        assert pred.data.shape == ref.shape == (88, 3)
        np.testing.assert_array_equal(pred.data, ref)
    # the default bf16-mixed within the JAX package's bf16 tolerance, and
    # not the untrained weights' prediction
    bf16 = inference.run(argv, device="cpu")
    for a, b in zip(bf16, f32):
        np.testing.assert_allclose(a.data, b.data, rtol=5e-2, atol=5e-3)
    fresh = make_predict_functions(train.get_model(
        Namespace(model="pipn"), data.normalizers, "cpu"))
    untrained = fresh.predict_batch(gather_cases(stacked, torch.tensor([0]))).data[0].numpy()
    assert np.abs(untrained - f32[0].data).max() > 1e-3
    # --save-plots: each case's three field plots under
    # <checkpoint parent>/plots/<split>/<case> (the drawing is
    # tests/test_torch_evaluation_plots.py's; here it is recorded)
    drawn = []
    monkeypatch.setattr(inference, "plot_fields",
                        lambda title, *a, save_path=None, **k: drawn.append((title, save_path)))
    inference.run(argv + ["--save-plots"], device="cpu")
    plots = trained.parent / "plots" / "val"
    assert drawn == [(t, plots / case) for case in ("case_0", "case_1")
                     for t in ("Predicted", "Ground truth", "Absolute error")]
    assert sorted(p.name for p in plots.iterdir()) == ["case_0", "case_1"]


def test_get_pressure_drop_is_the_jax_packages():
    rng = np.random.default_rng(2)
    inlet, outlet = rng.normal(size=(3, 16, 1)), rng.normal(size=(3, 16, 1))
    assert evaluation.get_pressure_drop(inlet, outlet) == \
        jax_evaluation.get_pressure_drop(inlet, outlet)


def test_evaluate_cli_line_agrees_with_the_jax_package(split, trained, capsys):
    """The port's line against the JAX package's evaluation loop run on the
    same split, rng and weights (carried by ``convert.params_to_flax``):
    its per-batch ``get_common_data`` and the example's pressure drop."""
    argv = ["--checkpoint", str(trained), "--data-dir", str(split / "val"),
            "--meta-dir", str(split / "train"), *POINTS, "--batch-size", "1"]
    summary = evaluate.run(argv, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary and summary["cases"] == 2
    assert all(np.isfinite(v) for k, v in summary.items() if k != "errors")
    # the error table's rows: the JAX evaluation's, then the pressure drop's
    assert list(summary["errors"]) == ["Average max errors", "Top 20",
                                       "Top errors distance from interface", "MAE",
                                       "Fluid MAE", "Porous MAE", "Residuals", "Pressure drop"]
    assert summary["errors"]["Pressure drop"] == [None, None, summary["pressure_drop_error"]]
    assert all(np.isfinite(x) for row in summary["errors"].values() for x in row
               if x is not None)

    args = evaluation.build_arg_parser().parse_args(argv)
    model, _ = inference.load_model_and_params(
        args, FoamDataset(args.data_dir, 48, 40, 16, np.random.default_rng(8421),
                          args.meta_dir, extra_fields=["momentError", "div(phi)"]),
        device="cpu")
    jax_data = JaxFoamDataset(args.data_dir, 48, 40, 16, np.random.default_rng(8421),
                              args.meta_dir, extra_fields=["momentError", "div(phi)"])
    jax_model = jax_fixed_train.get_model(Namespace(model="pipn"), jax_data.normalizers)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_flax(model.module))
    fns = jax_engine.make_train_functions(jax_model, jax_engine.make_optimizer(jax_model, 1))
    stacked = jax_data.stacked()
    u_err, p_err, pred_drop, tgt_drop = [], [], [], []
    for i in range(len(jax_data)):
        batch = jax_engine.gather_cases(stacked, jnp.asarray([i]))
        pde, extras = fns.predict_batch(params, batch, True)
        common = jax_evaluation.get_common_data(jax_data, pde.numpy(), batch.numpy(),
                                                extras.numpy())
        drops = jax_fixed_evaluate.sample_process(jax_data, pde, batch, extras)
        u_err.append(common["U error"])
        p_err.append(common["p error"])
        pred_drop.append(drops["Predicted drop"])
        tgt_drop.append(drops["Target drop"])
    ref = {"U_mae": np.mean(np.concatenate(u_err)), "p_mae": np.mean(np.concatenate(p_err)),
           "pressure_drop_predicted": np.mean(pred_drop),
           "pressure_drop_target": np.mean(tgt_drop)}
    for key, r in ref.items():
        np.testing.assert_allclose(summary[key], r, rtol=1e-4, atol=1e-6, err_msg=key)
    assert summary["pressure_drop_error"] == pytest.approx(
        abs(summary["pressure_drop_predicted"] - summary["pressure_drop_target"]))


def test_golden_duct_run_end_to_end(tmp_path, capsys):
    """13 + 4 cases at 24 x 16, two epochs; scores finite, the scores file
    written and printed, CONVERGENCE.md untouched."""
    convergence = (REPO / "CONVERGENCE.md").read_bytes()
    root = tmp_path / "golden"
    argv = ["--root", str(root), "--epochs", "2", "--nx", str(NX), "--ny", str(NY), *POINTS]
    out = train_golden_duct.main(argv, device="cpu")
    assert (REPO / "CONVERGENCE.md").read_bytes() == convergence
    assert json.loads((root / "golden_scores.json").read_text()) == json.loads(json.dumps(out))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    assert len(list((root / "train").glob("case_*"))) == 13
    assert len(list((root / "val").glob("case_*"))) == 4
    dec = out["decoupled"]
    assert dec["epochs"] == 2 and dec["wall_s"] > 0 and dec["steps_per_s"] > 0
    for split_name in ("train", "val"):
        assert all(np.isfinite(dec[split_name][k]) and dec[split_name][k] > 0
                   for k in ("U", "p"))
    assert out["bar_met"] is False and out["evaluate_val"]["cases"] == 4
    assert "coupled" not in out and "exact" not in out and "solve_s" in out
    again = train_golden_duct.main(argv + ["--reuse-data", "--epochs", "1"], device="cpu")
    assert "solve_s" not in again and again["decoupled"]["epochs"] == 1


def test_golden_spread_end_to_end(tmp_path, capsys, monkeypatch):
    """Two dropout seeds and the dropout-off run on 13 + 4 cases at 24 x 16,
    one epoch each: every run scored, the spread and the file written and
    printed; seed 8421 with dropout on trains what the golden run trains."""
    monkeypatch.setattr(golden_spread, "POINTS", (48, 40, 16))
    root = tmp_path / "golden"
    argv = ["--root", str(root), "--epochs", "1", "--nx", str(NX), "--ny", str(NY),
            "--seeds", "8421", "5"]
    out = golden_spread.main(argv, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    assert json.loads((root / "golden_spread.json").read_text()) == json.loads(json.dumps(out))
    assert [(r["seed"], r["dropout"]) for r in out["runs"]] == \
        [(8421, True), (5, True), (8421, False)]
    for r in out["runs"]:
        assert all(np.isfinite(r[s][k]) and r[s][k] > 0 for s in ("train", "val")
                   for k in ("U", "p"))
    lo, mean, hi = out["min_mean_max_with_dropout"]["train_p"]
    assert lo <= mean <= hi and {lo, hi} == {r["train"]["p"] for r in out["runs"][:2]}
    # the seeds draw other masks; the dropout-off run draws none
    logs = root / "logs" / "lightning_logs"
    trained = [torch.load(logs / n / "model.ckpt", weights_only=False)["module"]
               for n in ("spread-seed8421", "spread-seed5", "spread-seed8421-nodropout")]
    for other in trained[1:]:
        assert any(not torch.equal(trained[0][k], other[k]) for k in trained[0])
    golden = train_golden_duct.main(["--root", str(root), "--reuse-data", "--epochs", "1",
                                     *POINTS], device="cpu")
    assert golden["decoupled"]["train"] == out["runs"][0]["train"]


def test_bench_prints_its_line_at_a_tiny_envelope(capsys, monkeypatch):
    monkeypatch.setattr(bench, "CASES", 1)
    monkeypatch.setattr(bench, "BATCH", 1)
    monkeypatch.setattr(bench, "POINTS", (16, 16, 4))
    tiny = ["--epochs", "1"]
    out = bench.run(["--runs", "2", *tiny], device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    fams = out["families"]
    assert list(fams) == list(bench.FAMILIES)
    for family in fams:
        assert isinstance(fams[family], float) and fams[family] > 0, family
        assert len(out["runs"][family]) == 2
    assert out["value"] == fams["pipn"] and out["card"] is None
    assert out["metric"] == "train_steps_per_sec (2D duct PIPN, batch 1, 32 pts)"
    assert out["envelope"] == {"cases": 1, "batch": 1, "points": [16, 16, 4], "seed": 8421}
    # a family that fails fails the run
    monkeypatch.setattr(bench, "FAMILIES", {"pipn": bench.FAMILIES["pipn"],
                                            "broken": (train, "pipn-unknown", [])})
    with pytest.raises(NotImplementedError, match="pipn-unknown"):
        bench.run(["--runs", "1", *tiny], device="cpu")
