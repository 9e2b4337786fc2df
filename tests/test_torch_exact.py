"""The exact autodiff path: the port's ``pinn_derivatives`` (reverse mode
twice, grad-of-sum semantics) against the JAX package's (vjp, then
forward-over-reverse) on a small MLP and on a small PIPN; ``compute_losses``
and verbose ``predict_batch`` of ``pipn_foam(fast_derivatives=False)``
against the JAX exact branches (train/engine.py:98-110, :289-301), with
their gradients; and the port alone: with dropout on and the same seed, the
exact path's forward values equal the analytic path's, whose masks it
draws."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.mlp import MLP as JaxMLP
from porous_cfd_tpu.models.pipn import pipn_foam as jax_pipn_foam
from porous_cfd_tpu.physics import operators as jax_operators
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.models.pi_gano import pi_gano
from porous_cfd_tpu_torch.models.pipn import pipn_foam, pipn_foam_pp
from porous_cfd_tpu_torch.physics import operators
from porous_cfd_tpu_torch.train import engine

CFG = dict(nu=1489.4e-6, d=14000.0, f=17.11,
           fe_local_layers=[2, 16, 16], fe_global_layers=[16 + 5, 16, 32, 64],
           seg_layers=[64 + 16, 32, 32, 16, 3])
B, NI, NB, NO = 2, 40, 16, 8
WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# values: f32 on both sides (ROADMAP)
V_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(ref):
    """J, H, residuals, losses and gradients (ROADMAP): second derivatives
    through every layer, summed in another order on each side."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_pinn_derivatives_of_a_small_mlp_match_jax(act):
    """An MLP over points with a max-pooled term, so rows couple: the
    grad-of-sum Jacobian and the Laplacian's mixed terms show."""
    layers = [2, 16, 16, 3]
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(2, 12, 2)).astype(np.float32)
    extra = rng.uniform(-1, 1, size=(2, 5, 2)).astype(np.float32)
    jmlp = JaxMLP(layers, activation={"silu": nn.silu, "tanh": nn.tanh}[act])
    params = jmlp.init(jax.random.PRNGKey(1), jnp.asarray(pts))["params"]

    def jax_apply(x):
        y = jmlp.apply({"params": params}, jnp.concatenate([x, jnp.asarray(extra)], -2))
        return y + jnp.max(y, axis=-2, keepdims=True) ** 2

    ref = jax_operators.pinn_derivatives(jax_apply, jnp.asarray(pts))
    mlp = MLP(layers, activation=act)
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), mlp)

    def port_apply(x):
        y = mlp(torch.cat([x, torch.from_numpy(extra)], dim=-2))
        return y + torch.max(y, dim=-2, keepdim=True).values ** 2

    out, jac, lap = operators.pinn_derivatives(port_apply, torch.from_numpy(pts))
    assert jac.shape == lap.shape == (2, 12, 3, 2) and out.shape == (2, 17, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref[0]), **V_TOL)
    for o, r in zip((jac, lap), ref[1:]):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **tol(r))
    _, jac_only, none = operators.pinn_derivatives(port_apply, torch.from_numpy(pts),
                                                   compute_laplacian=False)
    assert none is None
    torch.testing.assert_close(jac_only, jac)


@pytest.fixture(scope="module")
def jax_side():
    model = jax_pipn_foam(**CFG, scalers=jax_synthetic.make_scalers(), fast_derivatives=False)
    batch = jax_synthetic.make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(31))
    params = model.module.init({"params": jax.random.PRNGKey(3)}, batch["C"], batch,
                               deterministic=True)["params"]
    return model, params, batch


def port_model(params):
    model = pipn_foam(**CFG, scalers=make_scalers(), fast_derivatives=False, device="cpu")
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    return model


def port_batch():
    return make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(31))


def test_pinn_derivatives_of_a_small_pipn_match_jax(jax_side):
    model, params, batch = jax_side
    bnd = batch["boundary"]["C"]

    def jax_apply(x):
        return model.module.apply({"params": params}, jnp.concatenate([x, bnd], -2), batch,
                                  deterministic=True)

    ref = jax_operators.pinn_derivatives(jax_apply, batch["internal"]["C"])
    port = port_model(params)
    pb = port_batch()

    def port_apply(x):
        return port.module(torch.cat([x, pb["boundary"]["C"]], dim=-2), pb)

    got = operators.pinn_derivatives(port_apply, pb["internal"]["C"])
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref[0]), **V_TOL)
    for o, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **tol(r))


def test_exact_losses_and_gradients_match_jax(jax_side):
    model, params, batch = jax_side
    w = jnp.asarray(WEIGHTS, jnp.float32)

    def total(p):
        losses, predicted = jax_engine.compute_losses(model, p, batch, None, deterministic=True)
        return jnp.sum(w * losses), (losses, predicted)

    (_, (ref_losses, ref_pred)), ref_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        params)
    port = port_model(params)
    losses, predicted = engine.compute_losses(port, port_batch(), deterministic=True)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses),
                               **tol(ref_losses))
    np.testing.assert_allclose(predicted.data.detach().numpy(), np.asarray(ref_pred.data),
                               **V_TOL)
    torch.sum(torch.tensor(WEIGHTS, dtype=torch.float32) * losses).backward()
    for name, lin in port.module.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = ref_grads
            for k in name.split("."):
                node = node[k]
            for got, r in ((lin.weight.grad.numpy().T, node["kernel"]),
                           (lin.bias.grad.numpy(), node["bias"])):
                np.testing.assert_allclose(got, np.asarray(r), err_msg=name, **tol(r))


def test_exact_verbose_prediction_matches_jax(jax_side):
    model, params, batch = jax_side
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 1))
    ref_pred, ref_extras = fns.predict_batch(params, batch, True)
    port = port_model(params)
    pred, extras = engine.make_predict_functions(port).predict_batch(port_batch(), True)
    assert pred.data.grad_fn is None and extras.data.grad_fn is None
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref_pred.data), **V_TOL)
    r = np.asarray(ref_extras.data)
    np.testing.assert_allclose(extras.data.numpy(), r, **tol(r))


@pytest.mark.parametrize("coupled", [False, True])
def test_exact_dropout_draws_the_analytic_paths_masks(coupled):
    """Same seed, dropout on: the exact path's module forward gives the
    analytic path's values on every row, so its masks are the same
    (layer, case, merged row, column) draws."""
    batch = make_foam_batch(B, NI, NB, NO, seed=8)
    vals = []
    for fast in (True, False):
        model = pipn_foam(**CFG, scalers=make_scalers(), seg_dropout=[0.3, 0.3, 0, 0],
                          fast_derivatives=fast, coupled_context=coupled, device="cpu",
                          generator=torch.Generator().manual_seed(6))
        with torch.no_grad():
            vals.append(engine.model_derivatives(model, batch, False, seed=1234)[0])
    torch.testing.assert_close(vals[0], vals[1], rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        det = engine.model_derivatives(model, batch, True)[0]
    assert (det - vals[1]).abs().max() > 1e-3


def test_exact_training_step_learns_with_dropout():
    model = pipn_foam(**CFG, scalers=make_scalers(), seg_dropout=[0.05, 0.05, 0, 0],
                      fast_derivatives=False, device="cpu",
                      generator=torch.Generator().manual_seed(2))
    fns = engine.make_train_functions(model, engine.make_optimizer(model, 1))
    state = fns.init_state(seed=3)
    batch = make_foam_batch(B, NI, NB, NO, seed=9)
    totals = []
    for _ in range(6):
        state, m = fns.train_step(state, batch)
        totals.append(float(m[0]))
    assert np.isfinite(totals).all() and totals[-1] < totals[0]
    for name, p in model.module.named_parameters():
        assert p.grad is not None and bool((p.grad != 0).any()), name


def test_other_families_keep_raising_for_the_exact_path():
    """Named when PI-GANO's and PIPN++'s exact paths raised: both now build
    with no analytic path and take a training step with dropout on, finite
    and with a gradient in every parameter (tests/test_torch_exact_pp.py
    holds them to the JAX package)."""
    models = (pi_gano(1e-3, 3, [8, 16], [7, 8], [2, 8], 2, [0.0, 0.1], make_scalers(),
                      VARIABLE_BOUNDARIES, fast_derivatives=False, device="cpu",
                      generator=torch.Generator().manual_seed(1)),
              pipn_foam_pp(1e-3, 1.0, 1.0, [2, 8, 8], [[8, 8, 8], [10, 8, 8], [10, 8, 16]],
                           [0.5, 1.0], [0.5, 0.25], [24, 8, 3], make_scalers(),
                           seg_dropout=[0.1, 0.0], fast_derivatives=False, device="cpu",
                           generator=torch.Generator().manual_seed(1)))
    for model in models:
        assert model.derivative_apply is None
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1))
        state = fns.init_state(seed=3)
        batch = model.attach_neighbors(make_foam_batch(B, NI, NB, NO, seed=9))
        state, m = fns.train_step(state, batch)
        assert state.step == 1 and bool(torch.isfinite(m).all())
        for name, p in model.module.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
