"""The evaluation's error table and plots, and the experiments' plot hooks,
in the port against the JAX package, on splits from the port's case writer
(2D with and without an interface patch, 3D with and without one, the
manufactured split), with JAX weights carried to the port by
``convert.params_from_flax`` (a narrow ``pipn`` on every split):

- ``error_table`` against the ``Errors.csv`` that the JAX
  ``plot_common_data`` writes, row by row (the fixed and variable examples'
  rewrite re-keyed on its ``Unnamed: 0`` column);
- each experiment's evaluate hooks and inference hook, with the viz
  functions replaced in both packages by recorders: the same plots with the
  same titles in the same order into the same directories, the arrays
  within tolerance;
- the files one ``--save-plots`` evaluation writes, drawn.

Tolerances (ROADMAP §3): the plotted arrays and the table are derived from
predictions, rtol 1e-4 with atol 1e-4 * max|ref|."""
import functools
import inspect
from argparse import Namespace
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import jax
import jax.numpy as jnp
import numpy as np
import pandas
import pytest
import torch

from examples.abc import evaluate as jax_abc_evaluate
from examples.abc import inference as jax_abc_inference
from examples.duct_fixed_boundary import evaluate as jax_fixed_evaluate
from examples.duct_fixed_boundary import inference as jax_fixed_inference
from examples.duct_variable_boundary import evaluate as jax_var_evaluate
from examples.duct_variable_boundary import inference as jax_var_inference
from examples.manufactured_solutions import inference as jax_ms_inference
from examples.windbreaks import evaluate as jax_wb_evaluate
from examples.windbreaks import inference as jax_wb_inference
from porous_cfd_tpu.data.dataset import FoamDataset as JaxFoamDataset
from porous_cfd_tpu.data.manufactured import ManufacturedDataset as JaxManufacturedDataset
from porous_cfd_tpu.models import pipn as jax_pipn
from porous_cfd_tpu.pipelines import evaluation as jax_evaluation
from porous_cfd_tpu.pipelines import inference as jax_inference
from porous_cfd_tpu.viz import common as jax_common
from porous_cfd_tpu.viz import viz2d as jax_viz2d
from porous_cfd_tpu.viz import viz3d as jax_viz3d
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.data.manufactured import ManufacturedDataset
from porous_cfd_tpu_torch.datagen import meta, synthetic_case
from porous_cfd_tpu_torch.examples.abc import evaluate as abc_evaluate
from porous_cfd_tpu_torch.examples.abc import inference as abc_inference
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate as fixed_evaluate
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import inference as fixed_inference
from porous_cfd_tpu_torch.examples.duct_variable_boundary import evaluate as var_evaluate
from porous_cfd_tpu_torch.examples.duct_variable_boundary import inference as var_inference
from porous_cfd_tpu_torch.examples.manufactured_solutions import generate_data
from porous_cfd_tpu_torch.examples.manufactured_solutions import inference as ms_inference
from porous_cfd_tpu_torch.examples.windbreaks import evaluate as wb_evaluate
from porous_cfd_tpu_torch.examples.windbreaks import inference as wb_inference
from porous_cfd_tpu_torch.models import pipn
from porous_cfd_tpu_torch.pipelines import evaluation, inference
from porous_cfd_tpu_torch.viz import common, viz3d

FIELDS = ["C", "U", "p", "cellToRegion", "d", "f"]
N_INT, N_BND, N_OBS = 48, 40, 12
WINDBREAK_PATCHES = ["inlet", "interface", "outlet", "solid", "walls"]
# split -> (dims, patch names, variable boundaries)
SPLITS = {"2d": (2, ["inlet", "interface", "outlet", "walls"], {"U": "inlet"}),
          "2d-plain": (2, ["inlet", "outlet", "walls"], {}),
          "3d": (3, WINDBREAK_PATCHES, {"Ux": "inlet"}),
          "3d-plain": (3, ["inlet", "outlet", "walls"], {"Ux": "inlet"})}
# experiment -> (split, JAX evaluate and inference modules, the port's, timing)
EXPERIMENTS = {
    "fixed": ("2d", jax_fixed_evaluate, jax_fixed_inference, fixed_evaluate, fixed_inference,
              True),
    "fixed-no-interface": ("2d-plain", jax_fixed_evaluate, jax_fixed_inference, fixed_evaluate,
                           fixed_inference, True),
    "variable": ("2d", jax_var_evaluate, jax_var_inference, var_evaluate, var_inference, True),
    "abc": ("3d-plain", jax_abc_evaluate, jax_abc_inference, abc_evaluate, abc_inference, True),
    "windbreaks": ("3d", jax_wb_evaluate, jax_wb_inference, wb_evaluate, wb_inference, True),
    "manufactured": ("manufactured", None, jax_ms_inference, None, ms_inference, False),
}
# the modules whose viz names an evaluation reaches
JAX_EVALUATE = [jax_evaluation, jax_fixed_evaluate, jax_var_evaluate, jax_abc_evaluate,
                jax_wb_evaluate]
PORT_EVALUATE = [common, fixed_evaluate, var_evaluate, abc_evaluate, wb_evaluate]
VIZ = {name: getattr(mod, name) for mod in (jax_common, jax_viz2d, jax_viz3d)
       for name in ("box_plot", "plot_data_dist", "plot_errors", "plot_multi_bar",
                    "plot_per_case", "plot_timing", "plot_errors_vs_var",
                    "plot_errors_vs_multi_vars", "plot_fields", "plot_fields_3d",
                    "plot_surface_errors", "plot_streamlines", "plot_houses")
       if hasattr(mod, name)}


def tol(ref):
    """Derived from predictions (ROADMAP §3)."""
    ref = np.asarray(ref, np.float64)
    scale = float(np.nanmax(np.abs(ref))) if np.isfinite(ref).any() else 0.0
    return dict(rtol=1e-4, atol=1e-4 * scale)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The four FoamDataset splits (2 training and 2 held-out cases each, 60
    internal points and 24 a patch, variable inlets and d, f) and the
    manufactured one, all from the port's writers."""
    base = tmp_path_factory.mktemp("eval_plots")
    out = {}
    for name, (dims, patches, variable) in SPLITS.items():
        rng = np.random.default_rng(8421)
        root = base / name
        for split in ("train", "val"):
            synthetic_case.write_foam_split(root / split, 2, rng, n_internal=60, n_per_patch=24,
                                            dims=dims, d=30000.0, f=79.731, variable=True,
                                            patch_names=patches)
            synthetic_case.write_data_config(root / split, fields=FIELDS,
                                             variable_boundaries=variable,
                                             normalize={"Scale": ["d", "f"],
                                                        "Standardize": ["C", "U", "p"]},
                                             dims=["x", "y", "z"][:dims])
            meta.generate_meta(root / split, *FIELDS, max_dim=dims)
        meta.generate_min_points(root)
        out[name] = root
    generate_data.run(str(base / "manufactured"), 8421, {"train": 2, "val": 2})
    out["manufactured"] = base / "manufactured"
    return out


def load(roots, split, extra=True):
    """The held-out split through both packages' datasets from one rng
    seed (the evaluate CLIs' extra fields with ``extra``)."""
    root = roots[split]
    if split == "manufactured":
        args = (str(root / "val"), 60, 40, 50.0, 1.0)
        return (JaxManufacturedDataset(*args, rng=np.random.default_rng(8421),
                                       meta_dir=str(root / "train")),
                ManufacturedDataset(*args, rng=np.random.default_rng(8421),
                                    meta_dir=str(root / "train")))
    kw = {"extra_fields": ["momentError", "div(phi)"]} if extra else {}
    args = (str(root / "val"), N_INT, N_BND, N_OBS)
    return (JaxFoamDataset(*args, np.random.default_rng(8421), str(root / "train"), **kw),
            FoamDataset(*args, np.random.default_rng(8421), str(root / "train"), **kw))


def models(split, jax_data, port_data, seed=7):
    """A narrow pipn (or the manufactured pipn) in both packages, JAX
    parameters drawn from ``seed`` and carried to the port."""
    if split == "manufactured":
        cfg = dict(fe_local_layers=[2, 16, 16], fe_global_layers=[16 + 2 + 1, 16, 32],
                   seg_layers=[32 + 16, 16, 3])
        ref = jax_pipn.pipn_manufactured(0.01, 50.0, 1.0, **cfg)
        port = pipn.pipn_manufactured(0.01, 50.0, 1.0, **cfg, device="cpu")
    else:
        dims, patches, _ = SPLITS[split]
        cfg = dict(fe_local_layers=[dims, 16, 16],
                   fe_global_layers=[16 + len(patches) + 1, 16, 32],
                   seg_layers=[32 + 16, 16, dims + 1])
        ref = jax_pipn.pipn_foam(1e-3, 1.0, 1.0, **cfg, scalers=jax_data.normalizers)
        port = pipn.pipn_foam(1e-3, 1.0, 1.0, **cfg, scalers=port_data.normalizers,
                              device="cpu")
    batch = ref.attach_neighbors(jax_data.stacked())
    shapes = jax.eval_shape(lambda: ref.module.init(
        {"params": jax.random.PRNGKey(0)}, batch["C"], batch, deterministic=True))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.normal(size=s.shape)
                               / np.sqrt(s.shape[0] if len(s.shape) == 2 else 10))
                              .astype(np.float32)), shapes)
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), port.module)
    return ref, params, port


def record(monkeypatch, modules):
    """Replace every viz function that ``modules`` reach by name with a
    recorder; returns the list of (name, bound arguments) calls."""
    calls = []

    def recorder(name, *args, **kwargs):
        bound = inspect.signature(VIZ[name]).bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append((name, dict(bound.arguments)))

    for mod in modules:
        for name in VIZ:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, functools.partial(recorder, name))
    return calls


def assert_same_values(got, ref, what):
    if isinstance(ref, str) or ref is None:
        assert got == ref, what
    elif isinstance(ref, dict):
        assert list(got) == list(ref), what
        for k in ref:
            assert_same_values(got[k], ref[k], f"{what}/{k}")
    elif isinstance(ref, (list, tuple)) and ref and isinstance(ref[0], str):
        assert list(got) == list(ref), what
    elif isinstance(ref, (list, tuple)) and ref and np.ndim(ref[0]) > 0:
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_values(g, r, f"{what}[{i}]")
    else:
        r = np.asarray(ref, np.float64)
        g = np.asarray(got, np.float64)
        assert g.shape == r.shape, what
        np.testing.assert_allclose(g, r, err_msg=what, **tol(r))


def assert_same_calls(port_calls, jax_calls, port_root, jax_root):
    """The same plots, in order, with the same titles, into the same
    directories (relative to each package's root), the arrays within
    tolerance. The pressure-drop bars are the deliberate difference: the
    JAX examples swap the two means, the port labels each with its own."""
    assert [c[0] for c in port_calls] == [c[0] for c in jax_calls]
    for (name, got), (_, ref) in zip(port_calls, jax_calls):
        assert got.keys() == ref.keys(), name
        got, ref = dict(got), dict(ref)
        for side, root in ((got, port_root), (ref, jax_root)):
            if side["save_path"] is not None:
                side["save_path"] = str(Path(side["save_path"]).relative_to(root))
        if name == "plot_timing":     # the solver's times; the inference's differ
            got["total"], ref["total"] = got["total"][1:], ref["total"][1:]
            got["average"], ref["average"] = got["average"][1:], ref["average"][1:]
        if name == "plot_multi_bar" and ref["title"] == "Pressure drop":
            ref["values"] = {"Predicted": ref["values"]["True"],
                             "True": ref["values"]["Predicted"]}
        for key in ref:
            assert_same_values(got[key], ref[key], f"{name} {ref.get('title')} {key}")


def jax_errors_table(path):
    """The JAX ``Errors.csv``, re-keyed on its ``Unnamed: 0`` column where
    an example read it without its index and wrote it again."""
    df = pandas.read_csv(path, index_col=0)
    if "Unnamed: 0" in df.columns:
        df.index = [u if isinstance(u, str) else i for i, u in zip(df.index, df["Unnamed: 0"])]
        df = df.drop(columns="Unnamed: 0")
    return df


def args_for(root, side, split_dir, save_plots=True):
    return Namespace(save_plots=save_plots, data_dir=str(split_dir), batch_size=2,
                     checkpoint=str(root / side / "lightning_logs" / "run" / "model.ckpt"),
                     precision="32-true")


@pytest.mark.parametrize("experiment", list(EXPERIMENTS))
def test_evaluate_table_and_plots_match_jax(experiment, roots, tmp_path, monkeypatch):
    split, jax_ev, _, port_ev, _, timing = EXPERIMENTS[experiment]
    jax_data, port_data = load(roots, split)
    ref, params, port = models(split, jax_data, port_data)
    split_dir = roots[split] / "val"
    hooks = ((jax_ev.sample_process, jax_ev.postprocess_fn) if jax_ev else (None, None))
    port_hooks = ((port_ev.sample_process, port_ev.postprocess_fn) if port_ev else (None, None))

    jax_calls = record(monkeypatch, JAX_EVALUATE)
    port_calls = record(monkeypatch, PORT_EVALUATE)
    jax_evaluation.evaluate(args_for(tmp_path, "jax", split_dir), ref, params, jax_data,
                            timing, *hooks)
    ev = evaluation.evaluate_split(args_for(tmp_path, "port", split_dir), port, port_data,
                                   *port_hooks, enable_timing=timing)
    assert jax_calls and len(port_calls) == len(jax_calls)
    assert_same_calls(port_calls, jax_calls, tmp_path / "port", tmp_path / "jax")

    # the table: the JAX file row by row, and the port's own file read back
    stats = ("lightning_logs", "run", "plots", "val", "stats", "Errors.csv")
    want = jax_errors_table(tmp_path.joinpath("jax", *stats))
    assert ev.error_columns == list(want.columns) == \
        ["$U_x$", "$U_y$", "$U_z$"][:SPLITS.get(split, (2,))[0]] + ["$p$"]
    assert list(ev.errors) == list(want.index)
    assert ("Top errors distance from interface" in ev.errors) == \
        ("interface" in port_data.stacked().domain)
    for label, row in ev.errors.items():
        got = np.asarray([np.nan if v is None else v for v in row])
        np.testing.assert_allclose(got, want.loc[label].to_numpy(np.float64), err_msg=label,
                                   **tol(want.loc[label].to_numpy(np.float64)))
    written = pandas.read_csv(tmp_path.joinpath("port", *stats), index_col=0,
                              float_precision="round_trip")
    assert list(written.index) == list(ev.errors) and list(written.columns) == ev.error_columns
    np.testing.assert_array_equal(
        written.to_numpy(np.float64),
        np.asarray([[np.nan if v is None else v for v in r] for r in ev.errors.values()]))
    # the deliberate difference: the JAX examples re-read Errors.csv without
    # its index and write it again; the port writes it once, its rows intact
    rewritten = "Pressure drop" in ev.errors
    assert rewritten == (experiment in ("fixed", "fixed-no-interface", "variable"))
    assert ("Unnamed: 0" in pandas.read_csv(tmp_path.joinpath("jax", *stats),
                                            index_col=0).columns) == rewritten
    assert "Unnamed: 0" not in written.columns
    if rewritten:
        assert ev.errors["Pressure drop"][:-1] == [None] * (len(ev.error_columns) - 1)


@pytest.mark.parametrize("experiment", [e for e in EXPERIMENTS if e != "fixed-no-interface"])
def test_inference_hook_plots_match_jax(experiment, roots, tmp_path, monkeypatch):
    split, _, jax_inf, _, port_inf, _ = EXPERIMENTS[experiment]
    jax_data, port_data = load(roots, split, extra=False)
    ref, params, port = models(split, jax_data, port_data)
    split_dir = roots[split] / "val"
    jax_calls = record(monkeypatch, [jax_inf, jax_viz3d])
    # the 2D hooks draw through the fixed experiment's plot_case_fields
    port_calls = record(monkeypatch, [port_inf, fixed_inference, viz3d])
    jax_inference.predict(args_for(tmp_path, "jax", split_dir), ref, params, jax_data,
                          jax_inf.sample_process_fn)
    inference.predict(args_for(tmp_path, "port", split_dir), port, port_data,
                      port_inf.sample_process_fn)
    assert jax_calls and len(port_calls) == len(jax_calls)
    assert_same_calls(port_calls, jax_calls, tmp_path / "port", tmp_path / "jax")
    case_dirs = {c[1]["save_path"].name for c in port_calls}
    assert case_dirs == {"case_0", "case_1"}
    if experiment == "windbreaks":
        assert [c[0] for c in port_calls[:3]] == ["plot_fields_3d", "plot_fields_3d",
                                                  "plot_surface_errors"]
        assert port_calls[0][1]["title"].startswith("Predicted D=")


def test_without_save_plots_the_port_draws_nothing(roots, tmp_path, monkeypatch):
    """The deliberate difference: the JAX evaluation builds every figure and
    shows it (nothing on a headless machine); the port draws none, and its
    inference hooks none, without ``--save-plots``."""
    jax_data, port_data = load(roots, "2d")
    ref, params, port = models("2d", jax_data, port_data)
    split_dir = roots["2d"] / "val"
    jax_calls = record(monkeypatch, JAX_EVALUATE)
    port_calls = record(monkeypatch, PORT_EVALUATE + [var_inference, fixed_inference])
    jax_evaluation.evaluate(args_for(tmp_path, "jax", split_dir, False), ref, params, jax_data,
                            True, jax_var_evaluate.sample_process,
                            jax_var_evaluate.postprocess_fn)
    ev = evaluation.evaluate_split(args_for(tmp_path, "port", split_dir, False), port,
                                   port_data, var_evaluate.sample_process,
                                   var_evaluate.postprocess_fn, enable_timing=True)
    inference.predict(args_for(tmp_path, "port", split_dir, False), port, port_data,
                      var_inference.sample_process_fn)
    assert len(jax_calls) > 10 and port_calls == []
    assert not (tmp_path / "port").exists()
    assert "Pressure drop" in ev.errors and "MAE" in ev.errors
    # the core evaluation carries the table beside its results, which stay
    # arrays (chip_smoke.py checks every one of them is finite)
    core = evaluation.evaluate(port, port_data.stacked(), 2, port_data.normalizers)
    assert all(v is None or isinstance(v, np.ndarray) for v in core.results.values())
    assert list(core.errors) == [k for k in ev.errors if k != "Pressure drop"]


def test_save_plots_writes_the_jax_files(roots, tmp_path):
    """One drawn ``--save-plots`` evaluation of the fixed experiment: the
    same files under ``<checkpoint parent>/plots/<split>/stats``."""
    jax_data, port_data = load(roots, "2d")
    ref, params, port = models("2d", jax_data, port_data)
    split_dir = roots["2d"] / "val"
    jax_evaluation.evaluate(args_for(tmp_path, "jax", split_dir), ref, params, jax_data, True,
                            jax_fixed_evaluate.sample_process, jax_fixed_evaluate.postprocess_fn)
    evaluation.evaluate_split(args_for(tmp_path, "port", split_dir), port, port_data,
                              fixed_evaluate.sample_process, fixed_evaluate.postprocess_fn,
                              enable_timing=True)

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    got = files(tmp_path / "port")
    assert got == files(tmp_path / "jax")
    stats = "lightning_logs/run/plots/val/stats/"
    assert {stats + n for n in ("Errors.csv", "Pressure drop.png", "Top 20% mean errors.png",
                                "Total simulation time [s].png",
                                "Errors mean normalized distance from interface.png")} <= set(got)
