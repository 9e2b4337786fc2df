"""The port's duct_fixed_boundary_hard and vertical_duct_fixed_boundary
experiments on the CPU against the JAX package's: ``VerticalDuctDataset``
column for column on a synthetic ``inlet-top`` split
(tests/test_examples_variable.py:61-95); the hard loss scaler's weights;
each CLI's training loss (its dataset, zoo model and loss weights, dropout
off) from the same weights; both training CLIs for 2 epochs, the vertical
one fine-tuning from a duct_fixed_boundary checkpoint; inference restoring
exactly and evaluate printing finite numbers."""
import json
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.duct_fixed_boundary import train as jax_fixed_train
from examples.duct_fixed_boundary_hard import train as jax_hard_train
from examples.vertical_duct_fixed_boundary.vertical_duct_dataset import \
    VerticalDuctDataset as JaxVerticalDuctDataset
from porous_cfd_tpu.data.dataset import FoamDataset as JaxFoamDataset
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.datagen import fvm, meta, synthetic_case
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
from porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard import evaluate as hard_evaluate
from porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard import inference as hard_inference
from porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard import train as hard_train
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary import evaluate as v_evaluate
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary import inference as v_inference
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary import train as v_train
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.vertical_duct_dataset import \
    VerticalDuctDataset
from porous_cfd_tpu_torch.train import engine
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions

NX, NY = 24, 16
N_INT, N_BND, N_OBS = 48, 40, 16
POINTS = ["--n-internal", str(N_INT), "--n-boundary", str(N_BND),
          "--n-observations", str(N_OBS)]
VERTICAL_PATCHES = ["inlet", "inlet-top", "interface", "outlet", "walls"]
# the full-width pipn's nine losses from the same weights in f32 (XLA and
# torch sum the 1024-wide rows in different orders; the observation losses
# carry weight 100 and 30)
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for torch while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixed_split(tmp_path_factory):
    """3 training and 2 held-out golden-duct cases solved at 24 x 16."""
    root = tmp_path_factory.mktemp("fixed") / "data"
    for name, cases in (("train", fvm.GOLDEN_CASES[:3]), ("val", fvm.GOLDEN_CASES[3:5])):
        fvm.write_golden_split(root / name, cases, nx=NX, ny=NY)
        synthetic_case.write_data_config(root / name, ["C", "U", "p", "cellToRegion"], {},
                                         {"Scale": [], "Standardize": ["C", "U", "p"]},
                                         ["x", "y"])
        meta.generate_meta(root / name, "C", "U", "p", "cellToRegion", max_dim=2)
    meta.generate_min_points(root)
    return root


@pytest.fixture(scope="module")
def vertical_split(tmp_path_factory):
    """The JAX test's synthetic two-inlet split (inlet-top among five
    patches), 2 training and 2 held-out cases."""
    root = tmp_path_factory.mktemp("vertical") / "data"
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        synthetic_case.write_foam_split(root / split, 2, rng, n_internal=120, n_per_patch=20,
                                        patch_names=VERTICAL_PATCHES)
        synthetic_case.write_data_config(root / split, ["C", "U", "p", "cellToRegion"], {},
                                         {"Scale": [], "Standardize": ["C", "U", "p"]},
                                         ["x", "y"])
        meta.generate_meta(root / split, "C", "U", "p", "cellToRegion", max_dim=2)
    meta.generate_min_points(root)
    return root


@pytest.fixture(scope="module")
def fixed_ckpt(fixed_split, tmp_path_factory):
    """``pipn`` trained 2 epochs by the duct_fixed_boundary CLI."""
    logs = tmp_path_factory.mktemp("fixed_logs")
    fixed_train.run(["--model", "pipn", "--name", "fixed", "--epochs", "2", "--batch-size", "2",
                     "--train-dir", str(fixed_split / "train"),
                     "--val-dir", str(fixed_split / "val"), "--logs-dir", str(logs), *POINTS],
                    device="cpu")
    return logs / "lightning_logs" / "fixed" / "model.ckpt"


def test_vertical_dataset_equals_the_jax_class(vertical_split):
    """Every case's table, column for column, its labels and its patch
    rows; the inlet-top rows carry the inlet's id."""
    for split, meta_dir in (("train", None), ("val", str(vertical_split / "train"))):
        args = (str(vertical_split / split), 60, 50, 10)
        got = VerticalDuctDataset(*args, np.random.default_rng(1), meta_dir)
        want = JaxVerticalDuctDataset(*args, np.random.default_rng(1), meta_dir)
        assert len(got) == len(want) == 2
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert dict(a.labels) == dict(b.labels)
            assert dict(a.labels)["boundaryId"] == ("boundaryIdinlet", "boundaryIdinterface",
                                                    "boundaryIdoutlet", "boundaryIdwalls")
            np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
            assert set(a.domain) == set(b.domain)
            for k in b.domain:
                np.testing.assert_array_equal(np.asarray(a.domain[k]), np.asarray(b.domain[k]))
            top = np.asarray(a.domain["inlet-top"])
            assert np.all(np.asarray(a["boundaryId"])[top, 0] == 1.0)
        np.testing.assert_array_equal(np.asarray(got.stacked().data),
                                      np.asarray(want.stacked().data))


@pytest.mark.parametrize("scaler", ["fixed", "relobralo"])
def test_hard_loss_scaler_equals_the_jax_one(scaler):
    args = Namespace(loss_scaler=scaler)
    got, want = hard_train.get_loss_scaler(args), jax_hard_train.get_loss_scaler(args)
    assert type(got).__name__ == type(want).__name__
    if scaler == "fixed":
        np.testing.assert_array_equal(np.asarray(got.weights, np.float32),
                                      np.asarray(want.weights, np.float32))
        assert list(np.asarray(got.weights)[-3:]) == [30, 30, 100]
    else:
        for key in ("num_losses", "alpha", "beta", "tau", "eps"):
            assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("cli", ["hard", "vertical"])
def test_cli_training_loss_equals_the_jax_clis(cli, fixed_split, vertical_split):
    """Each CLI's training loss on its training split (its dataset class,
    the zoo's full-width ``pipn``, its loss weights), dropout off, from the
    same weights: the nine losses and the weighted total within
    LOSS_RTOL."""
    root = fixed_split if cli == "hard" else vertical_split
    port_cls, jax_cls = ((FoamDataset, JaxFoamDataset) if cli == "hard"
                         else (VerticalDuctDataset, JaxVerticalDuctDataset))
    args = Namespace(model="pipn", loss_scaler="fixed", train_dir=str(root / "train"),
                     val_dir=str(root / "val"), n_internal=N_INT, n_boundary=N_BND,
                     n_observations=N_OBS)
    ds, _ = fixed_train.make_datasets(args, port_cls)
    jax_ds, _ = jax_fixed_train.make_datasets(args, jax_cls)
    port_weights = (hard_train if cli == "hard" else v_train).get_loss_scaler(args).weights
    jax_weights = (jax_hard_train if cli == "hard" else jax_fixed_train).get_loss_scaler(
        args).weights
    np.testing.assert_array_equal(np.asarray(port_weights, np.float32),
                                  np.asarray(jax_weights, np.float32))
    model = jax_fixed_train.get_model(args, jax_ds.normalizers)
    port = fixed_train.get_model(args, ds.normalizers, "cpu")
    jb = jax_ds.stacked()
    params = model.module.init(jax.random.PRNGKey(0), jnp.asarray(jb["C"]), jb, True)["params"]
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), port.module)
    w = jnp.asarray(np.asarray(jax_weights, np.float32))

    @jax.jit
    def reference(p):
        losses, _ = jax_engine.compute_losses(model, p, jb, None, deterministic=True)
        return losses, jnp.sum(w * losses)

    ref_losses, ref_total = reference(params)
    with torch.no_grad():
        losses, _ = engine.compute_losses(port, ds.stacked().to("cpu"), deterministic=True)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    total = float(torch.sum(torch.as_tensor(np.asarray(port_weights, np.float32)) * losses))
    np.testing.assert_allclose(total, float(ref_total), rtol=LOSS_RTOL)


def restored_predictions_match(inference_mod, dataset_cls, model, split, ckpt):
    """The inference CLI restores ``ckpt`` and predicts each held-out case
    as ``model`` (its weights) predicts the split."""
    argv = ["--checkpoint", str(ckpt), "--data-dir", str(split / "val"),
            "--meta-dir", str(split / "train"), "--precision", "32-true", *POINTS]
    preds = inference_mod.run(argv, device="cpu")
    data = dataset_cls(str(split / "val"), N_INT, N_BND, N_OBS, np.random.default_rng(8421),
                       str(split / "train"))
    with torch.no_grad():
        ref = make_predict_functions(model).predict_batch(
            gather_cases(data.stacked().to("cpu"), torch.arange(len(data)))).data
    assert len(preds) == len(data) == 2
    for i, p in enumerate(preds):
        torch.testing.assert_close(torch.as_tensor(p.data), ref[i], rtol=1e-5, atol=1e-6)


def test_hard_clis_train_restore_and_evaluate(fixed_split, tmp_path):
    model = hard_train.run(["--model", "pipn", "--name", "hard", "--epochs", "2",
                            "--batch-size", "2", "--train-dir", str(fixed_split / "train"),
                            "--val-dir", str(fixed_split / "val"), "--logs-dir", str(tmp_path),
                            *POINTS], device="cpu")
    run_dir = tmp_path / "lightning_logs" / "hard"
    payload = torch.load(run_dir / "model.ckpt", weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 4
    assert json.loads((run_dir / "model_meta.json").read_text())["Model type"] == "pipn"
    for key, value in payload["module"].items():
        torch.testing.assert_close(model.module.state_dict()[key], value, rtol=0, atol=0)
    restored_predictions_match(hard_inference, FoamDataset, model, fixed_split,
                               run_dir / "model.ckpt")
    summary = hard_evaluate.run(["--checkpoint", str(run_dir / "model.ckpt"),
                                 "--data-dir", str(fixed_split / "val"),
                                 "--meta-dir", str(fixed_split / "train"), *POINTS],
                                device="cpu")
    assert summary["cases"] == 2
    assert all(np.isfinite(v) for k, v in summary.items() if k != "errors")
    assert all(np.isfinite(x) for row in summary["errors"].values() for x in row
               if x is not None) and summary["errors"]["Pressure drop"][-1] > 0


def test_vertical_clis_fine_tune_from_a_fixed_checkpoint(vertical_split, fixed_ckpt, tmp_path,
                                                         capsys):
    """The vertical CLI resumes the duct_fixed_boundary checkpoint (its
    weights, optimizer state and epoch 2) and trains 2 epochs more on the
    two-inlet split; inference restores its checkpoint; evaluate prints
    finite numbers."""
    start = torch.load(fixed_ckpt, weights_only=True)
    model = v_train.run(["--model", "pipn", "--name", "vertical", "--epochs", "4",
                         "--batch-size", "2", "--checkpoint", str(fixed_ckpt),
                         "--train-dir", str(vertical_split / "train"),
                         "--val-dir", str(vertical_split / "val"),
                         "--logs-dir", str(tmp_path), *POINTS], device="cpu")
    assert f"resumed from {fixed_ckpt} at epoch {start['epoch']}" in capsys.readouterr().out
    run_dir = tmp_path / "lightning_logs" / "vertical"
    payload = torch.load(run_dir / "model.ckpt", weights_only=True)
    assert payload["epoch"] == 4 and payload["step"] == start["step"] + 2
    moved = [k for k, v in payload["module"].items()
             if not torch.equal(v, start["module"][k])]
    assert moved and all(bool(v.isfinite().all()) for v in payload["module"].values())
    restored_predictions_match(v_inference, VerticalDuctDataset, model, vertical_split,
                               run_dir / "model.ckpt")
    summary = v_evaluate.run(["--checkpoint", str(run_dir / "model.ckpt"),
                              "--data-dir", str(vertical_split / "val"),
                              "--meta-dir", str(vertical_split / "train"), *POINTS],
                             device="cpu")
    assert summary["cases"] == 2
    assert all(np.isfinite(v) for k, v in summary.items() if k != "errors")
    assert all(np.isfinite(x) for row in summary["errors"].values() for x in row
               if x is not None) and summary["errors"]["Pressure drop"][-1] > 0
