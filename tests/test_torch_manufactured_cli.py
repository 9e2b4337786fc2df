"""The manufactured_solutions experiment in the port against the JAX
package's: the split writer and ``generate_data`` write the JAX package's
bytes from one seed; ``ManufacturedDataset`` gives the JAX one's arrays; the
manufactured PIPN++ takes the ``"id_first"`` geometry order in its module,
its analytic path and its chain's level-0 rows, and its analytic path
matches JAX ``pipn_manufactured_pp`` (outputs, J, H, the loss vector and
the gradients) from converted flax weights at small widths; then the port's
CLIs (train, inference, evaluate) and the verification tool on the CPU at
a tiny size. Both sides run f32 on the CPU (JAX at "highest" matmul
precision, tests/conftest.py)."""
import json
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.manufactured_solutions import generate_data as jax_generate_data
from porous_cfd_tpu.data import manufactured as jax_manufactured
from porous_cfd_tpu.datagen import synthetic_case as jax_case
from porous_cfd_tpu.models.pipn import pipn_manufactured_pp as jax_pipn_manufactured_pp
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data import manufactured
from porous_cfd_tpu_torch.datagen import synthetic_case
from porous_cfd_tpu_torch.examples.manufactured_solutions import (evaluate, generate_data,
                                                                  inference, train)
from porous_cfd_tpu_torch.models.pipn import _geometry_features, pipn_manufactured_pp
from porous_cfd_tpu_torch.tools import convergence_report
from porous_cfd_tpu_torch.train import engine

# the zoo's structure (manufactured_solutions/train.py) at small widths: a
# one-layer static level [2 * 2 + 2, .], a one-layer dynamic level, a
# one-layer global level, tanh
MS = dict(nu=0.01, d=50.0, f=1.0, fe_local_layers=[2, 16, 16],
          fe_global_layers=[[2 * 2 + 2, 16], [16 + 2, 24], [24 + 2, 32]],
          fe_global_radius=[0.6, 1.2], fe_global_fraction=[0.5, 0.25],
          seg_layers=[32 + 16, 24, 16, 3], max_neighbors=8)
B, NI, NB = 2, 30, 24
V_TOL = dict(rtol=1e-5, atol=1e-5)
SMALL_SPLITS = {"train": 4, "val": 2, "test": 2}
# the CLI runs: sizes the small splits hold
POINTS = ["--n-internal", "60", "--n-boundary", "40"]


def tol(ref):
    """J, H, losses and gradients (ROADMAP)."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def files_of(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def assert_same_trees(a: Path, b: Path, at_least: int):
    files = files_of(a)
    assert files == files_of(b) and len(files) >= at_least
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_write_manufactured_split_writes_the_jax_writers_bytes(tmp_path):
    for mod, sub in ((jax_case, "jax"), (synthetic_case, "port")):
        mod.write_manufactured_split(tmp_path / sub, 3, np.random.default_rng(17),
                                     n_internal=50, n_per_patch=12)
    assert_same_trees(tmp_path / "jax", tmp_path / "port", 3 * 5)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """``generate_data`` of both packages at seed 8421, small splits."""
    root = tmp_path_factory.mktemp("manufactured")
    jax_generate_data.run(str(root / "jax"), 8421, SMALL_SPLITS)
    generate_data.run(str(root / "port"), 8421, SMALL_SPLITS)
    return root


def test_generate_data_writes_the_jax_packages_bytes(data_root):
    assert_same_trees(data_root / "jax", data_root / "port", 8 * 5 + 3 * 2 + 1)
    cfg = json.loads((data_root / "port" / "train" / "data_config.json").read_text())
    assert cfg["Fields"] == ["C", "cellToRegion"]


@pytest.mark.parametrize("split", ["train", "val"])
def test_manufactured_dataset_matches_jax(data_root, split):
    root = data_root / "port"
    kw = {"meta_dir": str(root / "train")} if split == "val" else {}
    got = manufactured.ManufacturedDataset(str(root / split), 60, 40, 50.0, 1.0,
                                           np.random.default_rng(3), **kw)
    ref = jax_manufactured.ManufacturedDataset(str(root / split), 60, 40, 50.0, 1.0,
                                               np.random.default_rng(3), **kw)
    g, r = got.stacked(), ref.stacked()
    np.testing.assert_array_equal(np.asarray(g.data), np.asarray(r.data))
    assert g.labels == r.labels
    assert g.domain.keys() == r.domain.keys()
    for key in r.domain:
        np.testing.assert_array_equal(np.asarray(g.domain[key]), np.asarray(r.domain[key]),
                                      err_msg=key)
    assert got.normalizers == {} and ref.normalizers == {}
    # the fields are the analytic ones, and the split holds no observations
    u, p, forcing = manufactured.manufactured_fields(np.asarray(g["C"]),
                                                     np.asarray(g["cellToRegion"]), 0.01,
                                                     50.0, 1.0)
    for name, want in (("U", u), ("p", p), ("f", forcing)):
        np.testing.assert_allclose(np.asarray(g[name]), want, rtol=1e-6, atol=1e-6)
    assert got.n_obs == 0


@pytest.fixture(scope="module")
def analytic_sides():
    """JAX ``pipn_manufactured_pp`` on its analytic path with its parameters
    and batch (chain attached), and the port's with those parameters."""
    torch.set_num_threads(2)
    model = jax_pipn_manufactured_pp(**MS, activation=nn.tanh)
    jb = model.attach_neighbors(jax_manufactured.make_manufactured_batch(
        np.random.default_rng(21), B, NI, NB))
    params = model.module.init({"params": jax.random.PRNGKey(3)}, jb["C"], jb,
                               deterministic=True)["params"]
    port = pipn_manufactured_pp(**MS, device="cpu")
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), port.module)
    pb = port.attach_neighbors(manufactured.make_manufactured_batch(
        np.random.default_rng(21), B, NI, NB))
    return model, params, jb, port, pb


def test_id_first_order_reaches_the_module_and_the_chain(analytic_sides):
    model, _, jb, port, pb = analytic_sides
    assert port.module.geom_features_order == "id_first" == model.module.geom_features_order
    boundary = pb["boundary"]
    geom = _geometry_features(boundary, "id_first")
    torch.testing.assert_close(geom[..., :2], boundary["boundaryId"], rtol=0, atol=0)
    # level 0's pre-gathered rows are [boundaryId || C] of each neighbour
    idx = pb.domain["_sa_idx_0"].long()
    want = torch.gather(geom, 1, idx.reshape(B, -1, 1).expand(-1, -1, geom.shape[-1]))
    torch.testing.assert_close(pb.domain["_sa_xg_0"], want, rtol=0, atol=0)
    np.testing.assert_array_equal(pb.domain["_sa_xg_0"].numpy(),
                                  np.asarray(jb.domain["sa_xg_0"]))
    # and the module forward (its SA levels on the chain) agrees with the
    # analytic path's values, which read _sa_xg_0
    with torch.no_grad():
        out = port.module(pb["C"], pb)
        fast = port.derivative_apply(pb, True)[0]
    torch.testing.assert_close(out, fast, **V_TOL)


def test_weights_carry_across_with_the_flax_names(analytic_sides):
    _, params, _, port, _ = analytic_sides
    tree = params_to_flax(port.module)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))
    again = pipn_manufactured_pp(**MS, device="cpu")
    params_from_flax(tree, again.module)
    for (k, a), (_, b) in zip(port.module.state_dict().items(),
                              again.module.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_analytic_path_matches_jax(analytic_sides):
    model, params, jb, port, pb = analytic_sides
    ref = model.derivative_apply(params, jb, None, True)
    with torch.no_grad():
        got = port.derivative_apply(pb, True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **V_TOL)
    for o, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol(r))


def test_losses_and_gradients_match_jax(analytic_sides):
    model, params, jb, port, pb = analytic_sides

    def total(p):
        losses, _ = jax_engine.compute_losses(model, p, jb, None, deterministic=True)
        return jnp.sum(losses), losses

    (_, ref_losses), ref_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    port.module.zero_grad(set_to_none=True)
    losses, _ = engine.compute_losses(port, pb, deterministic=True)
    assert losses.shape == (6,)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses),
                               **tol(ref_losses))
    losses.sum().backward()
    for name, lin in port.module.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = ref_grads
            for k in name.split("."):
                node = node[k]
            for got, r in ((lin.weight.grad.numpy().T, node["kernel"]),
                           (lin.bias.grad.numpy(), node["bias"])):
                np.testing.assert_allclose(got, np.asarray(r), err_msg=name, **tol(r))


def test_factory_follows_the_jax_recipe():
    model = pipn_manufactured_pp(**MS, device="cpu")
    ref = jax_pipn_manufactured_pp(**MS)
    for key in ("learning_rate", "lr_gamma", "adam_eps", "enable_data_loss", "dims"):
        assert getattr(model, key) == getattr(ref, key), key
    assert model.module.activation == "tanh" and model.module.seg_dropout is None
    assert type(model.momentum_loss).__name__ == "MomentumLossManufactured"
    assert type(model.continuity_loss).__name__ == "ContinuityLoss"


def test_zoo_matches_the_jax_zoo():
    from examples.manufactured_solutions.train import get_model as jax_get_model
    for name in ("pipn", "pipn-pp"):
        ref = jax_get_model(name, 50.0, 1.0)
        got = train.get_model(name, 50.0, 1.0, "cpu")
        assert (got.derivative_apply is None) == (ref.derivative_apply is None), name
        for attr in ("fe_local_layers", "seg_layers"):
            assert tuple(getattr(got.module, attr)) == tuple(getattr(ref.module, attr))
    pp = train.get_model("pipn-pp", device="cpu").module
    assert [len(m.linears) for m in (pp.feature_extract.global_feature.sa_0.conv_mlp,
                                     pp.feature_extract.global_feature.sa_1.conv_mlp,
                                     pp.feature_extract.global_feature.global_sa.mlp)] == [1, 1, 1]
    assert pp.feature_extract.global_feature.sa_0.conv_mlp.layers == (6, 64)
    with pytest.raises(NotImplementedError):
        train.get_model("pipn-pp-mrg", device="cpu")


@pytest.fixture(scope="module")
def trained(data_root):
    """Both zoo models trained two epochs through the training CLI on the
    CPU, in the generated small splits."""
    torch.set_num_threads(2)
    root = data_root / "port"
    logs = data_root / "logs"
    models = {}
    for name in ("pipn-pp", "pipn"):
        models[name] = train.run(["--model", name, "--name", name, "--epochs", "2",
                                  "--batch-size", "2", "--train-dir", str(root / "train"),
                                  "--val-dir", str(root / "val"), "--logs-dir", str(logs),
                                  "--n-observations", "0", "--precision", "32-true",
                                  *POINTS], device="cpu")
    return root, logs, models


@pytest.mark.parametrize("name", ["pipn-pp", "pipn"])
def test_train_writes_meta_and_checkpoints(trained, name):
    _, logs, models = trained
    run_dir = logs / "lightning_logs" / name
    meta = json.loads((run_dir / "model_meta.json").read_text())
    assert meta["Model type"] == name and meta["N internal"] == 60
    assert meta["N boundary"] == 40 and meta["N observations"] == 0
    assert (run_dir / "model.ckpt").exists()
    # pipn trains on the exact operator, pipn-pp on its analytic path
    assert (models[name].derivative_apply is None) == (name == "pipn")


@pytest.mark.parametrize("name", ["pipn-pp", "pipn"])
def test_inference_restores_the_trained_model(trained, name):
    root, logs, models = trained
    ckpt = logs / "lightning_logs" / name / "model.ckpt"
    argv = ["--checkpoint", str(ckpt), "--data-dir", str(root / "val"), "--meta-dir",
            str(root / "train"), "--precision", "32-true", *POINTS]
    preds = inference.run(argv, device="cpu")
    assert len(preds) == SMALL_SPLITS["val"]
    # the trained module itself on the same split gives the same fields
    model = models[name]
    data = inference.load_split(inference.build_arg_parser().parse_args(argv))
    stacked = model.attach_neighbors(data.stacked().to("cpu"))
    with torch.no_grad():
        for i, pred in enumerate(preds):
            case = engine.gather_cases(stacked, torch.tensor([i]))
            want = model.module(case["C"], case).squeeze(0)
            np.testing.assert_allclose(np.asarray(pred.data), want.numpy(), **V_TOL)


def test_evaluate_prints_one_line(trained, capsys):
    root, logs, _ = trained
    ckpt = logs / "lightning_logs" / "pipn-pp" / "model.ckpt"
    summary = evaluate.run(["--checkpoint", str(ckpt), "--data-dir", str(root / "val"),
                            "--meta-dir", str(root / "train"), "--precision", "32-true",
                            *POINTS], device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["cases"] == SMALL_SPLITS["val"]
    for key in ("U_mae", "p_mae", "U_rel_l2", "p_rel_l2", "momentum_mae", "divergence_mae"):
        assert np.isfinite(summary[key]) and summary[key] > 0, key
    assert list(summary["errors"]) == ["Average max errors", "Top 20",
                                       "Top errors distance from interface", "MAE",
                                       "Fluid MAE", "Porous MAE", "Residuals"]
    # --save-plots: the plots and Errors.csv under <checkpoint parent>/plots/val/stats
    evaluate.run(["--checkpoint", str(ckpt), "--data-dir", str(root / "val"),
                  "--meta-dir", str(root / "train"), "--save-plots", *POINTS],
                 device="cpu")
    stats = ckpt.parent / "plots" / "val" / "stats"
    assert {"Errors.csv", "Average relative error.png", "Absolute residuals.png"} <= \
        {p.name for p in stats.iterdir()}
    assert "Total simulation time [s].png" not in {p.name for p in stats.iterdir()}


def test_sizes_the_data_cannot_hold_are_refused(data_root):
    """The README's old quick-start sizes: generate_data writes 200 internal
    and 80 boundary points a case; both packages refuse 1000 / 200."""
    root = data_root / "port"
    for cls in (manufactured.ManufacturedDataset, jax_manufactured.ManufacturedDataset):
        with pytest.raises(ValueError, match="Cannot sample"):
            cls(str(root / "train"), 1000, 200, 50.0, 1.0, np.random.default_rng(0))
    with pytest.raises(ValueError, match="Cannot sample"):
        train.run(["--model", "pipn", "--train-dir", str(root / "train"), "--val-dir",
                   str(root / "val"), "--n-internal", "1000", "--n-boundary", "200"],
                  device="cpu")


def test_entry_points_refuse_cpu_without_being_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = ["--checkpoint", str(tmp_path / "model.ckpt"), "--data-dir", str(tmp_path)]
    for entry, argv in ((train.run, ["--model", "pipn-pp", "--train-dir", str(tmp_path)]),
                        (inference.run, missing), (evaluate.run, missing),
                        (convergence_report.main, ["--epochs", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipn_manufactured_pp(**MS)


def test_convergence_report_runs_and_writes_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(2)
    for name, value in (("CASES", 4), ("BATCH", 2), ("POINTS", (40, 24)), ("LOG_EVERY", 1)):
        monkeypatch.setattr(convergence_report, name, value)
    lines = convergence_report.main(["--epochs", "2"], device="cpu")
    assert [r["model"] for r in lines] == ["pipn", "pipn-pp"]
    printed = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    for r in lines:
        assert r["steps"] == 4 and r["card"] is None
        assert np.isfinite(r["final_loss"]) and [e for e, _ in r["loss_curve"]] == [1, 2]
        for split in ("train", "val"):
            assert set(r[split]) == {"U", "p"} and all(np.isfinite(list(r[split].values())))
    assert list(tmp_path.iterdir()) == []
