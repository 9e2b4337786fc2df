"""The golden-duct recipe trained by both packages on the same batch: the
duct_fixed_boundary ``pipn`` at the example's widths on its decoupled
analytic path, dropout off, from the JAX package's initial weights (carried
across by ``convert.params_from_flax``), Adam as the example trains it, the
whole training split of golden-duct cases (the port's FVM solver) as one
batch a step. Holds the port's per-step total loss and its final trained
rel-L2 of U and p to the JAX package's.

The test runs a small grid for a few steps. As a script it runs the golden
configuration (120 x 72, the 13 training cases, 1500/350/700 points) for a
few hundred steps on the CPU and prints both loss curves and rel-L2s as one
JSON line:

    python tests/test_torch_golden_parity.py --epochs 300 [--root DIR]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from porous_cfd_tpu.data.dataset import FoamDataset as JaxFoamDataset  # noqa: E402
from porous_cfd_tpu.models.pipn import pipn_foam as jax_pipn_foam  # noqa: E402
from porous_cfd_tpu.physics.scaling import FixedLossScaler as JaxFixedLossScaler  # noqa: E402
from porous_cfd_tpu.train import engine as jax_engine  # noqa: E402
from porous_cfd_tpu_torch.convert import params_from_flax  # noqa: E402
from porous_cfd_tpu_torch.data.dataset import FoamDataset  # noqa: E402
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed  # noqa: E402
from porous_cfd_tpu_torch.models.pipn import pipn_foam  # noqa: E402
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler  # noqa: E402
from porous_cfd_tpu_torch.tools import train_golden_duct as golden  # noqa: E402
from porous_cfd_tpu_torch.train import engine  # noqa: E402

WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# the example's pipn widths, dropout off
WIDTHS = dict(fe_local_layers=[2, 64, 64], fe_global_layers=[64 + 1 + 4, 96, 128, 1024],
              seg_layers=[1024 + 64, 512, 256, 128, 3], seg_dropout=[0.0, 0.0, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for torch while this module runs: the suite runs in
    several worker processes at once, and both packages' full-width models
    would otherwise take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(pred, ref) -> float:
    return float(np.linalg.norm(pred - ref) / np.linalg.norm(ref))


def train_both(root: Path, points, epochs: int, every: int = 1) -> dict:
    """Both packages trained ``epochs`` steps on the training split of
    ``root`` as one batch; the total loss of every ``every``-th step and of
    the last, and the trained rel-L2 of U and p (denormalised, f32) of
    each."""
    n_int, n_bnd, n_obs = points
    split = str(root / "train")
    jax_ds = JaxFoamDataset(split, n_int, n_bnd, n_obs, np.random.default_rng(fixed.SEED))
    port_ds = FoamDataset(split, n_int, n_bnd, n_obs, np.random.default_rng(fixed.SEED))
    common = dict(nu=fixed.NU, d=fixed.D, f=fixed.F, **WIDTHS)
    jax_model = jax_pipn_foam(**common, scalers=jax_ds.normalizers, activation=nn.silu)
    port_model = pipn_foam(**common, scalers=port_ds.normalizers, device="cpu")
    jax_batch = jax_engine.gather_cases(jax_ds.stacked(), jnp.arange(len(jax_ds)))
    port_batch = engine.gather_cases(port_ds.stacked().to("cpu"), torch.arange(len(port_ds)))

    jax_fns = jax_engine.make_train_functions(jax_model, jax_engine.make_optimizer(jax_model, 1),
                                              JaxFixedLossScaler(WEIGHTS))
    jax_state = jax_fns.init_state(jax_batch)
    params_from_flax(jax.tree_util.tree_map(np.asarray, jax_state.params), port_model.module)
    port_fns = engine.make_train_functions(port_model, engine.make_optimizer(port_model, 1),
                                           FixedLossScaler(WEIGHTS))
    port_state = port_fns.init_state()
    curves = {"jax": [], "port": []}
    steps = []
    t0 = time.perf_counter()
    for step in range(1, epochs + 1):
        jax_state, jm = jax_fns.train_step(jax_state, jax_batch)
        port_state, pm = port_fns.train_step(port_state, port_batch)
        if step % every == 0 or step == epochs:
            steps.append(step)
            curves["jax"].append(float(jm[0]))
            curves["port"].append(float(pm[0]))
    out = {"steps": steps, "total_loss": curves, "seconds": time.perf_counter() - t0}
    u_s, p_s = port_ds.normalizers["U"], port_ds.normalizers["p"]

    def denorm(scaler, x):
        return scaler.inverse_transform(torch.as_tensor(np.array(x))).numpy()

    jax_pred = jax_fns.predict_batch(jax_state.params, jax_batch, False).numpy()
    port_pred = engine.make_predict_functions(port_model).predict_batch(port_batch).numpy()
    ref = port_batch.numpy()
    for side, pred in (("jax", jax_pred), ("port", port_pred)):
        out[f"{side}_trained_rel_l2"] = {
            "U": rel_l2(denorm(u_s, pred["U"]), denorm(u_s, ref["U"])),
            "p": rel_l2(denorm(p_s, pred["p"]), denorm(p_s, ref["p"]))}
    return out


def write_split(root: Path, nx: int, ny: int, n_cases: int):
    golden.generate(root, nx, ny, golden.TRAIN_CASES[:n_cases], golden.VAL_CASES[:1])


def test_golden_recipe_trains_as_the_jax_package(tmp_path):
    """Four cases at 24 x 16, 8 steps: every step's total loss and the
    trained rel-L2 of U and p within rtol 1e-3 of the JAX package's."""
    write_split(tmp_path, 24, 16, 4)
    out = train_both(tmp_path, (48, 40, 16), 8)
    jax_curve, port_curve = (np.asarray(out["total_loss"][k]) for k in ("jax", "port"))
    assert port_curve[-1] < 0.9 * port_curve[0]
    np.testing.assert_allclose(port_curve, jax_curve, rtol=1e-3)
    for field in ("U", "p"):
        np.testing.assert_allclose(out["port_trained_rel_l2"][field],
                                   out["jax_trained_rel_l2"][field], rtol=1e-3)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="data/golden_parity")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--nx", type=int, default=120)
    ap.add_argument("--ny", type=int, default=72)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    root = Path(args.root)
    if not (root / "train").exists():
        write_split(root, args.nx, args.ny, len(golden.TRAIN_CASES))
    out = {"grid": [args.nx, args.ny], "cases": len(golden.TRAIN_CASES),
           "points": [1500, 350, 700],
           **train_both(root, (1500, 350, 700), args.epochs, args.every)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
