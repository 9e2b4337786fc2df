"""The port's comparison pipeline (``porous_cfd_tpu_torch/pipelines/
compare.py``) and the seven experiments' compare CLIs against the JAX
package's:

- ``compare`` on two narrow ``pipn`` models with JAX weights carried to the
  port (``convert.params_from_flax``): ``Test.csv`` and ``Shapiro.csv``
  within tolerance, in the same comparison directory, the same plots (viz
  functions replaced by recorders in both packages);
- without ``--save-plots`` the port draws nothing and still writes both
  tables (the JAX version always draws its two delta plots);
- the seven compare CLIs parse the JAX flags with the JAX defaults;
- the fixed experiment's compare CLI end to end on the CPU from two
  checkpoints its training CLI wrote;
- the tables' CSV layout, which ``pandas.read_csv(path, index_col=0)``
  reads back.

Tolerances: the errors are derived from predictions (rtol 1e-4 with atol
1e-4 * max|ref|, ROADMAP §3); the p-values within 1e-3 of each other
relative to the larger, with an absolute floor of 1e-12 (the two packages'
f32 errors differ in their last bits, which moves rank ties and the
log-error moments a little)."""
import importlib
import json
from argparse import Namespace

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pandas
import pytest
import torch

from porous_cfd_tpu.pipelines import compare as jax_compare
from porous_cfd_tpu.pipelines import evaluation as jax_evaluation
from porous_cfd_tpu_torch.datagen import fvm, meta, synthetic_case
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import compare as fixed_compare
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
from porous_cfd_tpu_torch.pipelines import compare, evaluation
from porous_cfd_tpu_torch.viz import common
from test_torch_evaluation_plots import roots  # noqa: F401  (the shared splits)
from test_torch_evaluation_plots import assert_same_values, load, models, record, tol

P_TOL = dict(rtol=1e-3, atol=1e-12)
EXPERIMENTS = ["duct_fixed_boundary", "duct_fixed_boundary_hard",
               "vertical_duct_fixed_boundary", "duct_variable_boundary",
               "manufactured_solutions", "abc", "windbreaks"]
POINTS = ["--n-internal", "48", "--n-boundary", "40", "--n-observations", "16"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def compare_args(root, side, split_dir, save_plots=True):
    logs = root / side / "lightning_logs"
    return Namespace(save_plots=save_plots, data_dir=str(split_dir), batch_size=2,
                     checkpoint=str(logs / "pipn-a" / "model.ckpt"),
                     checkpoint_other=str(logs / "pipn-b" / "model.ckpt"))


def two_models(roots):
    jax_data, port_data = load(roots, "2d", extra=False)
    ref1, params1, port1 = models("2d", jax_data, port_data)
    ref2, params2, port2 = models("2d", jax_data, port_data, seed=11)
    return jax_data, port_data, (ref1, params1, port1), (ref2, params2, port2)


def key(call, root):
    name, args = call
    path = args["save_path"]
    return name, args.get("title", ""), "" if path is None else str(path.relative_to(root))


def test_compare_matches_jax(roots, tmp_path, monkeypatch):
    jax_data, port_data, (r1, p1, m1), (r2, p2, m2) = two_models(roots)
    split_dir = roots["2d"] / "val"
    jax_calls = record(monkeypatch, [jax_evaluation, jax_compare])
    port_calls = record(monkeypatch, [common, compare])
    jax_compare.compare(compare_args(tmp_path, "jax", split_dir), r1, p1, r2, p2, jax_data)
    got = compare.compare(compare_args(tmp_path, "port", split_dir), m1, m2, port_data)

    rel = "lightning_logs/comparisons/Pipn a vs Pipn b/val"
    assert got.path == tmp_path / "port" / rel and got.names == ("Pipn a", "Pipn b")
    for name in ("Test.csv", "Shapiro.csv"):
        want = pandas.read_csv(tmp_path / "jax" / rel / name, index_col=0)
        have = pandas.read_csv(tmp_path / "port" / rel / name, index_col=0)
        assert list(have.index) == list(want.index) == ["Ux", "Uy", "p"]
        assert list(have.columns) == list(want.columns)
        np.testing.assert_allclose(have.to_numpy(np.float64), want.to_numpy(np.float64),
                                   err_msg=name, **P_TOL)
    assert list(got.test) == ["Ux", "Uy", "p"]
    assert all(0 <= v <= 1 for row in got.test.values() for v in row)
    errors = [np.concatenate(np.concatenate([e.results["U error"], e.results["p error"]], -1))
              for e in got.evaluations]
    for g, e in zip(got.errors, errors):
        np.testing.assert_array_equal(g, e)

    # the same plots into the same directories; JAX iterates the shared
    # Errors.csv rows as a set, so the comparison bars are matched by title
    jax_calls = sorted(jax_calls, key=lambda c: key(c, tmp_path / "jax"))
    port_calls = sorted(port_calls, key=lambda c: key(c, tmp_path / "port"))
    assert [key(c, tmp_path / "port") for c in port_calls] == \
        [key(c, tmp_path / "jax") for c in jax_calls]
    titles = {k[1] for k in map(lambda c: key(c, tmp_path / "port"), port_calls)
              if k[2] == rel}
    assert {"Max error difference", "Average error difference", "MAE", "Top 20",
            "Top errors distance from interface"} <= titles
    for (name, g), (_, r) in zip(port_calls, jax_calls):
        for arg in r:
            if arg not in ("save_path", "total", "average"):
                assert_same_values(g[arg], r[arg], f"{name} {r.get('title')} {arg}")


def test_without_save_plots_compare_draws_nothing(roots, tmp_path, monkeypatch, capsys):
    """The deliberate difference: the port draws its plots only under
    ``--save-plots``; ``Test.csv`` and ``Shapiro.csv`` are written either
    way, as in JAX, and the summary line carries the p-values."""
    jax_data, port_data, (r1, p1, m1), (r2, p2, m2) = two_models(roots)
    split_dir = roots["2d"] / "val"
    jax_calls = record(monkeypatch, [jax_evaluation, jax_compare])
    port_calls = record(monkeypatch, [common, compare])
    jax_compare.compare(compare_args(tmp_path, "jax", split_dir, False), r1, p1, r2, p2,
                        jax_data)
    got = compare.report(compare.compare(compare_args(tmp_path, "port", split_dir, False),
                                         m1, m2, port_data))
    assert port_calls == [] and [c[1]["title"] for c in jax_calls
                                 if c[0] == "plot_per_case"][-2:] == \
        ["Max error difference", "Average error difference"]
    assert sorted(p.name for p in got.path.iterdir()) == ["Shapiro.csv", "Test.csv"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got.summary()))
    assert line["names"] == ["Pipn a", "Pipn b"] and line["cases"] == 2
    assert set(line["test"]["p"]) == {"Kruskal-Wallis", "Mann-Whitney U", "ANOVA"}
    assert len(line["inference_ms_per_case"]) == 2 and set(line["levene"]) == {"Ux", "Uy", "p"}


class Parsed(Exception):
    pass


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_compare_parsers_have_the_jax_flags_and_defaults(experiment, monkeypatch):
    """Each compare CLI parses its command line as the JAX example's does
    (the evaluation flags and ``--checkpoint-other``), defaults included."""
    port = importlib.import_module(f"porous_cfd_tpu_torch.examples.{experiment}.compare")
    ref = importlib.import_module(f"examples.{experiment}.compare")
    real = compare.build_arg_parser

    def spy():
        parser = real()
        parse = parser.parse_args

        def stop(argv=None):
            raise Parsed(parse(argv))

        parser.parse_args = stop
        return parser

    monkeypatch.setattr(compare, "build_arg_parser", spy)
    if hasattr(port, "build_arg_parser"):
        monkeypatch.setattr(port, "build_arg_parser", spy)
    full = ["--checkpoint", "a/model.ckpt", "--checkpoint-other", "b/model.ckpt",
            "--data-dir", "d/val", "--meta-dir", "d/train", "--n-internal", "7",
            "--n-boundary", "5", "--n-observations", "3", "--batch-size", "2",
            "--precision", "32-true", "--save-plots"]
    for argv in ([], full):
        with pytest.raises(Parsed) as parsed:
            port.run(argv, device="cpu")
        ref_parser = getattr(ref, "build_arg_parser", jax_compare.build_arg_parser)
        assert vars(parsed.value.args[0]) == vars(ref_parser().parse_args(argv))


@pytest.fixture(scope="module")
def fixed_logs(tmp_path_factory):
    """2 + 2 golden-duct cases at 24 x 16 and two checkpoints the fixed
    training CLI wrote (``pipn`` and ``pipn-pp``, one epoch each)."""
    root = tmp_path_factory.mktemp("compare_cli")
    data = root / "data"
    for name, cases in (("train", fvm.GOLDEN_CASES[:2]), ("val", fvm.GOLDEN_CASES[3:5])):
        fvm.write_golden_split(data / name, cases, nx=24, ny=16)
        synthetic_case.write_data_config(data / name, ["C", "U", "p", "cellToRegion"], {},
                                         {"Scale": [], "Standardize": ["C", "U", "p"]},
                                         ["x", "y"])
        meta.generate_meta(data / name, "C", "U", "p", "cellToRegion", max_dim=2)
    meta.generate_min_points(data)
    for model in ("pipn", "pipn-pp"):
        fixed_train.run(["--model", model, "--name", model, "--epochs", "1", "--batch-size",
                         "2", "--train-dir", str(data / "train"), "--val-dir",
                         str(data / "val"), "--logs-dir", str(root), *POINTS], device="cpu")
    return data, root / "lightning_logs"


def test_fixed_compare_cli_end_to_end(fixed_logs, capsys):
    data, logs = fixed_logs
    argv = ["--checkpoint", str(logs / "pipn" / "model.ckpt"), "--checkpoint-other",
            str(logs / "pipn-pp" / "model.ckpt"), "--data-dir", str(data / "val"),
            "--meta-dir", str(data / "train"), *POINTS, "--batch-size", "1"]
    got = fixed_compare.run(argv, device="cpu")
    out = capsys.readouterr().out
    assert "Statistical tests p-values" in out and "Homoscedasticity" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got.summary()))
    assert got.path == logs / "comparisons" / "Pipn vs Pipn pp" / "val"
    test = pandas.read_csv(got.path / "Test.csv", index_col=0, float_precision="round_trip")
    assert list(test.columns) == list(compare.TESTS) and list(test.index) == ["Ux", "Uy", "p"]
    np.testing.assert_array_equal(test.to_numpy(np.float64),
                                  np.asarray(list(got.test.values())))
    assert ((test.to_numpy() >= 0) & (test.to_numpy() <= 1)).all()
    shapiro = pandas.read_csv(got.path / "Shapiro.csv", index_col=0)
    assert list(shapiro.columns) == ["Pipn", "Pipn pp"]
    # each model's errors are those its evaluate CLI reports
    for ckpt, errors in zip(("pipn", "pipn-pp"), got.errors):
        ev = got.evaluations[0 if ckpt == "pipn" else 1]
        assert errors.shape == (2 * 88, 3)
        np.testing.assert_allclose(errors.mean(0), np.asarray(ev.errors["MAE"]), **tol(errors))


def test_tables_are_written_as_pandas_writes_them(tmp_path):
    rows = {"MAE": [0.1, 0.2, 1 / 3], "Pressure drop": [None, None, 2.5e-7]}
    evaluation.write_table(tmp_path / "t.csv", ["$U_x$", "$U_y$", "$p$"], rows)
    pandas.DataFrame([[0.1, 0.2, 1 / 3], [np.nan, np.nan, 2.5e-7]], index=list(rows),
                     columns=["$U_x$", "$U_y$", "$p$"]).to_csv(tmp_path / "pandas.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    columns, back = evaluation.read_table(tmp_path / "t.csv")
    assert columns == ["$U_x$", "$U_y$", "$p$"] and list(back) == list(rows)
    assert back["MAE"] == rows["MAE"] and np.isnan(back["Pressure drop"][:2]).all()
    df = pandas.read_csv(tmp_path / "t.csv", index_col=0)
    assert list(df.index) == list(rows) and df.loc["Pressure drop", "$p$"] == 2.5e-7
