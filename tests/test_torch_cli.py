"""The port's duct_variable_boundary training CLI on the CPU: its flags and
defaults are the JAX package's; ``run([...], device="cpu")`` trains each
ported model of the experiment from a ``FoamDataset`` on disk (the port's
own case writer) and writes its checkpoint and the ``model_meta.json`` that
the JAX trainer writes; and ``--precision bf16-mixed`` validation errors
agree with the JAX package's within its own bf16 tolerance
(tests/test_precision.py)."""
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_pi_gano import CFG

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.pi_gano import pi_gano as jax_pi_gano
from porous_cfd_tpu.pipelines.training import build_arg_parser as jax_build_arg_parser
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu.train.trainer import Trainer as JaxTrainer
from examples.duct_variable_boundary import train as jax_variable_train
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.datagen import meta, synthetic_case
from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as cli
from porous_cfd_tpu_torch.models.pi_gano import pi_gano
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser
from porous_cfd_tpu_torch.train import engine

FIELDS = ["C", "U", "p", "cellToRegion", "d", "f"]
POINTS = ["--n-internal", "80", "--n-boundary", "40", "--n-observations", "20"]
# the JAX package's bf16 tolerance for eval errors (tests/test_precision.py)
BF16_TOL = dict(rtol=5e-2, atol=5e-3)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 3/2-case variable-boundary split written by the port."""
    root = tmp_path_factory.mktemp("cli") / "data"
    rng = np.random.default_rng(8421)
    for split, n in [("train", 3), ("val", 2)]:
        synthetic_case.write_foam_split(root / split, n, rng, n_internal=160, n_per_patch=24,
                                        variable=True)
        synthetic_case.write_data_config(root / split, fields=FIELDS,
                                         variable_boundaries={"U": "inlet"},
                                         normalize={"Scale": ["d", "f"],
                                                    "Standardize": ["C", "U", "p"]},
                                         dims=["x", "y"])
        meta.generate_meta(root / split, *FIELDS, max_dim=2)
    meta.generate_min_points(root)
    return root


def test_arg_parser_has_the_jax_flags_and_defaults():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    assert flags(build_arg_parser()) == flags(jax_build_arg_parser())


@pytest.mark.parametrize("model", ["pi-gano", "pi-gano-full", "pi-gano-pp"])
def test_cli_trains_and_writes_checkpoint_and_meta(data, tmp_path, model):
    cli.run(["--model", model, "--name", "run", "--epochs", "2", "--batch-size", "3",
             *POINTS, "--train-dir", str(data / "train"), "--val-dir", str(data / "val"),
             "--logs-dir", str(tmp_path / "port")], device="cpu")
    log_dir = tmp_path / "port" / "lightning_logs" / "run"
    ckpt = torch.load(log_dir / "model.ckpt", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["step"] == 2
    trunks = [k for k in ckpt["module"] if k.endswith("operator_3.Dense_0.weight")]
    assert len(trunks) == (3 if model == "pi-gano-full" else 1)
    assert all(torch.isfinite(v).all() for v in ckpt["module"].values())
    assert (log_dir / "best.ckpt").exists()
    # the JAX trainer's model_meta.json for the same arguments
    ref_dir = tmp_path / "jax"
    ref_dir.mkdir()
    JaxTrainer.write_model_meta(types.SimpleNamespace(model_type=model, batch_size=3,
                                                      log_dir=ref_dir),
                                80, 40, 20, "bf16-mixed")
    assert (log_dir / "model_meta.json").read_text() == (ref_dir / "model_meta.json").read_text()
    assert json.loads((log_dir / "model_meta.json").read_text())["Precision"] == "bf16-mixed"


def test_unported_model_raises():
    """Named when ``pi-gano-pp-full`` raised: the CLI now builds the U-Net on
    its analytic path, its parameter tree shaped as the JAX zoo's (the CLI
    run itself is tests/test_torch_unet_cli.py's)."""
    args = build_arg_parser().parse_args(["--model", "pi-gano-pp-full"])
    model = cli.get_model(args, make_scalers(), device="cpu")
    assert model.derivative_apply is not None and model.neighbor_precompute is not None
    ref = jax_variable_train.get_model(args, jax_synthetic.make_scalers())
    batch = ref.attach_neighbors(jax_synthetic.make_foam_batch(1, 40, 24, 8, seed=2))
    params = jax.eval_shape(lambda: ref.module.init(jax.random.PRNGKey(0), batch["C"],
                                                    batch))["params"]
    assert jax.tree_util.tree_map(np.shape, params_to_flax(model.module)) == \
        jax.tree_util.tree_map(lambda x: x.shape, params)


@pytest.mark.parametrize("full", [False, True], ids=["pi-gano", "pi-gano-full"])
def test_bf16_validation_errors_match_jax(full):
    """Validation under bf16-mixed: the port's autocast forward against the
    JAX package's bf16 eval module, same weights and cases; both close to
    their f32 errors, the port's bf16 ones not equal to them."""
    jax_model = jax_pi_gano(**CFG, operator_dropout=[0, 0, 0], full=full,
                            scalers=jax_synthetic.make_scalers(), fast_derivatives=True)
    batch_j = jax_synthetic.make_foam_batch(4, 40, 16, 8, rng=np.random.default_rng(3))
    jfns = jax_engine.make_train_functions(jax_model.with_precision("bf16-mixed"),
                                           jax_engine.make_optimizer(jax_model, 1))
    params = jfns.init_state(batch_j).params
    ref = np.asarray(jfns.eval_batch(params, batch_j))

    model = pi_gano(**CFG, operator_dropout=[0, 0, 0], full=full, scalers=make_scalers(),
                    fast_derivatives=True, device="cpu")
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    batch = make_foam_batch(4, 40, 16, 8, rng=np.random.default_rng(3))
    mixed = model.with_precision("bf16-mixed")
    assert mixed.eval_dtype == torch.bfloat16 and model.eval_dtype is None
    assert mixed.with_precision("32-true").eval_dtype is None
    got = engine.make_predict_functions(mixed).eval_batch(batch)
    f32 = engine.make_predict_functions(model).eval_batch(batch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **BF16_TOL)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), **BF16_TOL)
    assert not torch.equal(got, f32)
    # training and verbose prediction stay f32: the analytic path is the same
    with torch.no_grad():
        for a, b in zip(mixed.derivative_apply(batch), model.derivative_apply(batch)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
