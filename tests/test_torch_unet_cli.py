"""The U-Nets through the port's CLIs on the CPU, at the zoo's full widths
on tiny cases: ``pipn-pp-full`` through the duct_fixed_boundary training,
inference and evaluate CLIs on golden-duct cases the port's FVM solver
writes (the evaluate line against the JAX package's evaluation of the same
weights), and ``pi-gano-pp-full`` through the duct_variable_boundary
training CLI on a split the port's case writer writes."""
import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.duct_fixed_boundary import train as jax_fixed_train
from porous_cfd_tpu.data.dataset import FoamDataset as JaxFoamDataset
from porous_cfd_tpu.pipelines import evaluation as jax_evaluation
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_to_flax
from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.datagen import fvm, meta, synthetic_case
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate, inference
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed
from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as variable
from porous_cfd_tpu_torch.pipelines import evaluation
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions

POINTS = ["--n-internal", "48", "--n-boundary", "40", "--n-observations", "16"]
VARIABLE_FIELDS = ["C", "U", "p", "cellToRegion", "d", "f"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixed_split(tmp_path_factory):
    """2 training and 2 held-out golden-duct cases solved at 24 x 16."""
    root = tmp_path_factory.mktemp("unet_fixed") / "data"
    for name, cases in (("train", fvm.GOLDEN_CASES[:2]), ("val", fvm.GOLDEN_CASES[2:4])):
        fvm.write_golden_split(root / name, cases, nx=24, ny=16)
        synthetic_case.write_data_config(root / name, ["C", "U", "p", "cellToRegion"], {},
                                         {"Scale": [], "Standardize": ["C", "U", "p"]},
                                         ["x", "y"])
        meta.generate_meta(root / name, "C", "U", "p", "cellToRegion", max_dim=2)
    meta.generate_min_points(root)
    return root


def test_pipn_pp_full_trains_predicts_and_evaluates(fixed_split, tmp_path, capsys):
    split = fixed_split
    model = fixed.run(["--model", "pipn-pp-full", "--name", "unet", "--epochs", "2",
                       "--batch-size", "2", "--train-dir", str(split / "train"),
                       "--val-dir", str(split / "val"), "--logs-dir", str(tmp_path), *POINTS],
                      device="cpu")
    assert model.derivative_apply is not None
    run_dir = tmp_path / "lightning_logs" / "unet"
    assert (run_dir / "model.ckpt").exists() and (run_dir / "best.ckpt").exists()
    meta_json = json.loads((run_dir / "model_meta.json").read_text())
    assert meta_json["Model type"] == "pipn-pp-full"
    payload = torch.load(run_dir / "model.ckpt", weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 2
    assert all(bool(v.isfinite().all()) for v in payload["module"].values())

    # inference restores the checkpoint and predicts each held-out case as
    # the trained model does, in f32
    argv = ["--checkpoint", str(run_dir / "model.ckpt"), "--data-dir", str(split / "val"),
            "--meta-dir", str(split / "train"), *POINTS]
    preds = inference.run(argv + ["--precision", "32-true"], device="cpu")
    data = FoamDataset(str(split / "val"), 48, 40, 16, np.random.default_rng(8421),
                       str(split / "train"))
    stacked = model.attach_neighbors(data.stacked().to("cpu"))
    fns = make_predict_functions(model)
    assert len(preds) == 2
    for i, pred in enumerate(preds):
        ref = fns.predict_batch(gather_cases(stacked, torch.tensor([i]))).data[0].numpy()
        np.testing.assert_allclose(pred.data, ref, rtol=1e-5, atol=1e-6)

    # the evaluate line against the JAX package's evaluation loop on the
    # same split, rng and weights
    capsys.readouterr()
    summary = evaluate.run(argv + ["--batch-size", "1"], device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["cases"] == 2
    assert all(np.isfinite(v) for k, v in summary.items() if k != "errors")
    assert all(np.isfinite(x) for row in summary["errors"].values() for x in row
               if x is not None)
    args = evaluation.build_arg_parser().parse_args(argv)
    jax_data = JaxFoamDataset(args.data_dir, 48, 40, 16, np.random.default_rng(8421),
                              args.meta_dir, extra_fields=["momentError", "div(phi)"])
    jax_model = jax_fixed_train.get_model(Namespace(model="pipn-pp-full"),
                                          jax_data.normalizers)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_flax(model.module))
    jfns = jax_engine.make_train_functions(jax_model, jax_engine.make_optimizer(jax_model, 1))
    jstacked = jax_model.attach_neighbors(jax_data.stacked())
    u_err, p_err = [], []
    for i in range(len(jax_data)):
        batch = jax_engine.gather_cases(jstacked, jnp.asarray([i]))
        pde, extras = jfns.predict_batch(params, batch, True)
        common = jax_evaluation.get_common_data(jax_data, pde.numpy(), batch.numpy(),
                                                extras.numpy())
        u_err.append(common["U error"])
        p_err.append(common["p error"])
    np.testing.assert_allclose(summary["U_mae"], np.mean(np.concatenate(u_err)), rtol=1e-4)
    np.testing.assert_allclose(summary["p_mae"], np.mean(np.concatenate(p_err)), rtol=1e-4)


@pytest.fixture(scope="module")
def variable_split(tmp_path_factory):
    """A 3/2-case variable-boundary split written by the port."""
    root = tmp_path_factory.mktemp("unet_variable") / "data"
    rng = np.random.default_rng(8421)
    for split, n in [("train", 3), ("val", 2)]:
        synthetic_case.write_foam_split(root / split, n, rng, n_internal=160, n_per_patch=24,
                                        variable=True)
        synthetic_case.write_data_config(root / split, fields=VARIABLE_FIELDS,
                                         variable_boundaries={"U": "inlet"},
                                         normalize={"Scale": ["d", "f"],
                                                    "Standardize": ["C", "U", "p"]},
                                         dims=["x", "y"])
        meta.generate_meta(root / split, *VARIABLE_FIELDS, max_dim=2)
    meta.generate_min_points(root)
    return root


def test_pi_gano_pp_full_trains_through_the_variable_cli(variable_split, tmp_path):
    data = variable_split
    variable.run(["--model", "pi-gano-pp-full", "--name", "unet", "--epochs", "2",
                  "--batch-size", "3", "--n-internal", "80", "--n-boundary", "40",
                  "--n-observations", "20", "--train-dir", str(data / "train"),
                  "--val-dir", str(data / "val"), "--logs-dir", str(tmp_path)], device="cpu")
    log_dir = tmp_path / "lightning_logs" / "unet"
    ckpt = torch.load(log_dir / "model.ckpt", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["step"] == 2
    assert "decoder.fpno_2.par_reduce.weight" in ckpt["module"]
    assert all(bool(torch.isfinite(v).all()) for v in ckpt["module"].values())
    assert (log_dir / "best.ckpt").exists()
    assert json.loads((log_dir / "model_meta.json").read_text())["Model type"] == \
        "pi-gano-pp-full"
