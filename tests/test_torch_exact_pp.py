"""The exact autodiff paths of PIPN++, PIPN++ MRG, the manufactured PIPN++,
PI-GANO, PiGanoFull and PI-GANO++ (``fast_derivatives=False``): the port's
module forwards under ``pinn_derivatives`` against the JAX package's exact
branches at small widths, dropout off (the losses, their gradients and
verbose prediction, with the JAX parameters carried across by
``convert.params_from_flax``); then the port alone: with dropout on and one
seed the exact path draws the analytic path's masks, a few training steps
learn, ``NeuralOperator``'s masks keep what the rate says (the uint32 trap)
and ``pi_gano`` defaults to the exact path, as the JAX factory does. Both
sides run f32 on the CPU (JAX at "highest" matmul precision,
tests/conftest.py)."""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import manufactured as jax_manufactured
from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models import pi_gano as jax_pi_gano
from porous_cfd_tpu.models import pipn as jax_pipn
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data import manufactured
from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models import pi_gano, pipn
from porous_cfd_tpu_torch.models.mlp import NeuralOperator, NeuralOperatorSequential
from porous_cfd_tpu_torch.ops import dropout
from porous_cfd_tpu_torch.ops.neural_op_cuda import trunk_seed
from porous_cfd_tpu_torch.train import engine

B, NI, NO = 2, 30, 8
# values: f32 on both sides (ROADMAP)
V_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(ref):
    """J, H, residuals, losses and gradients (ROADMAP): second derivatives
    through every layer, summed in another order on each side."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


PP = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 16, 16], seg_layers=[32 + 16, 24, 3],
          fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
          fe_global_layers=[[2 + 4 + 2, 16, 16], [16 + 2, 24, 24], [24 + 2, 24, 32]],
          max_neighbors=8)
MRG = dict(n_dims=2, mrg_in_features=4 + 2, nu=1e-3, d=100.0, f=1.0,
           fe_local_layers=[2, 16, 16], seg_layers=[1024 + 16, 24, 3], max_neighbors=8)
# the manufactured zoo's structure at small widths: a one-layer static level
# [2 * 2 + 2, .], a one-layer dynamic level and a one-layer global level
MS = dict(nu=0.01, d=50.0, f=1.0, fe_local_layers=[2, 16, 16],
          fe_global_layers=[[2 * 2 + 2, 16], [16 + 2, 24], [24 + 2, 32]],
          fe_global_radius=[0.6, 1.2], fe_global_fraction=[0.5, 0.25],
          seg_layers=[32 + 16, 24, 16, 3], max_neighbors=8)
GANO = dict(nu=1489.4e-6, out_features=3, branch_layers=[8, 16, 40, 40],
            geometry_layers=[7, 16, 24, 24], local_layers=[2, 16, 16, 16], n_operators=3,
            variable_boundaries=VARIABLE_BOUNDARIES)
GANO_PP = dict(nu=1489.4e-6, out_features=3, branch_layers=[8, 16, 40, 40],
               geometry_layers=[[2 * 2 + 4, 16, 16], [16 + 2, 24, 24], [24 + 2, 24, 24]],
               geometry_radius=[0.5, 1], geometry_fraction=[0.5, 0.25],
               local_layers=[2, 16, 16, 16], n_operators=3,
               variable_boundaries=VARIABLE_BOUNDARIES, max_neighbors=32)


@dataclasses.dataclass(frozen=True)
class Family:
    """One family: its JAX and port factories (keyword arguments of
    ``fast_derivatives`` and the dropout rates aside), its boundary rows,
    its batch and its dropout keyword."""
    jax_factory: object
    port_factory: object
    cfg: dict
    n_bnd: int
    manufactured: bool = False
    dropout_key: str | None = "seg_dropout"
    rates: tuple = (0.3, 0.0)
    extra: tuple = ()

    def jax_model(self):
        kw = dict(self.cfg, **dict(self.extra), fast_derivatives=False)
        if not self.manufactured:
            kw["scalers"] = jax_synthetic.make_scalers()
        if self.dropout_key:
            kw[self.dropout_key] = [0.0] * len(self.rates)
        if self.manufactured:
            kw["activation"] = nn.tanh
        return self.jax_factory(**kw)

    def port_model(self, fast=False, rates=None, seed=6):
        kw = dict(self.cfg, **dict(self.extra), fast_derivatives=fast, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
        if not self.manufactured:
            kw["scalers"] = make_scalers()
        if self.dropout_key:
            kw[self.dropout_key] = list(rates if rates is not None else
                                        [0.0] * len(self.rates))
        return self.port_factory(**kw)

    def batches(self, seed):
        rng = (np.random.default_rng(seed), np.random.default_rng(seed))
        if self.manufactured:
            return (jax_manufactured.make_manufactured_batch(rng[0], B, NI, self.n_bnd),
                    manufactured.make_manufactured_batch(rng[1], B, NI, self.n_bnd))
        return (jax_synthetic.make_foam_batch(B, NI, self.n_bnd, NO, rng=rng[0]),
                make_foam_batch(B, NI, self.n_bnd, NO, rng=rng[1]))


FAMILIES = {
    "pipn_foam_pp": Family(jax_pipn.pipn_foam_pp, pipn.pipn_foam_pp, PP, 24),
    "pipn_foam_pp_mrg": Family(jax_pipn.pipn_foam_pp_mrg, pipn.pipn_foam_pp_mrg, MRG, 60),
    "pipn_manufactured_pp": Family(jax_pipn.pipn_manufactured_pp, pipn.pipn_manufactured_pp,
                                   MS, 24, manufactured=True, dropout_key=None),
    "pi_gano": Family(jax_pi_gano.pi_gano, pi_gano.pi_gano, GANO, 16,
                      dropout_key="operator_dropout", rates=(0.3, 0.3, 0.0)),
    "pi_gano_full": Family(jax_pi_gano.pi_gano, pi_gano.pi_gano, GANO, 16,
                           dropout_key="operator_dropout", rates=(0.3, 0.3, 0.0),
                           extra=(("full", True),)),
    "pi_gano_pp": Family(jax_pi_gano.pi_gano_pp, pi_gano.pi_gano_pp, GANO_PP, 64,
                         dropout_key="operator_dropout", rates=(0.3, 0.3, 0.0)),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def sides(request):
    """Both sides of one family: the JAX exact model with its parameters and
    its batch, the port's exact model with those parameters and its batch
    (each side's per-dataset aux attached)."""
    torch.set_num_threads(2)
    fam = FAMILIES[request.param]
    model = fam.jax_model()
    jb, pb = fam.batches(21)
    jb = model.attach_neighbors(jb)
    params = model.module.init({"params": jax.random.PRNGKey(3)}, jb["C"], jb,
                               deterministic=True)["params"]
    port = fam.port_model()
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), port.module)
    return request.param, model, params, jb, port, port.attach_neighbors(pb)


def test_the_exact_path_has_no_derivative_apply(sides):
    name, model, _, _, port, _ = sides
    assert model.derivative_apply is None and port.derivative_apply is None, name
    assert FAMILIES[name].port_model(fast=True).derivative_apply is not None


def test_exact_losses_and_gradients_match_jax(sides):
    name, model, params, jb, port, pb = sides
    w = np.ones(port.num_losses, np.float32)
    if port.enable_data_loss:
        w[-3:] = 100.0

    def total(p):
        losses, predicted = jax_engine.compute_losses(model, p, jb, None, deterministic=True)
        return jnp.sum(jnp.asarray(w) * losses), (losses, predicted)

    (_, (ref_losses, ref_pred)), ref_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        params)
    port.module.zero_grad(set_to_none=True)
    losses, predicted = engine.compute_losses(port, pb, deterministic=True)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses),
                               err_msg=name, **tol(ref_losses))
    np.testing.assert_allclose(predicted.data.detach().numpy(), np.asarray(ref_pred.data),
                               err_msg=name, **V_TOL)
    torch.sum(torch.from_numpy(w) * losses).backward()
    n = 0
    for mod_name, lin in port.module.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = ref_grads
            for k in mod_name.split("."):
                node = node[k]
            for got, r in ((lin.weight.grad.numpy().T, node["kernel"]),
                           (lin.bias.grad.numpy(), node["bias"])):
                np.testing.assert_allclose(got, np.asarray(r), err_msg=f"{name} {mod_name}",
                                           **tol(r))
            n += 1
    assert n >= 6


def test_exact_verbose_prediction_matches_jax(sides):
    name, model, params, jb, port, pb = sides
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 1))
    ref_pred, ref_extras = fns.predict_batch(params, jb, True)
    pred, extras = engine.make_predict_functions(port).predict_batch(pb, True)
    assert pred.data.grad_fn is None and extras.data.grad_fn is None
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref_pred.data), err_msg=name,
                               **V_TOL)
    r = np.asarray(ref_extras.data)
    np.testing.assert_allclose(extras.data.numpy(), r, err_msg=name, **tol(r))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_exact_path_equals_the_analytic_path_with_dropout(name):
    """Same weights, same seed, dropout on: the two paths give the same
    values, J and H on every row. The pooled context of each of these
    families does not depend on the differentiated coordinates (PIPN++ and
    PI-GANO++ pool the boundary cloud; PI-GANO's geometry encoder sees the
    coordinates detached, as the JAX module's does), so the analytic path
    is exact, and the exact path's module forward draws the analytic path's
    masks (the decoder's, or the trunk's for each operator)."""
    fam = FAMILIES[name]
    torch.set_num_threads(2)
    batch = fam.batches(8)[1]
    got = []
    for fast in (True, False):
        model = fam.port_model(fast=fast, rates=fam.rates)
        with torch.no_grad() if fast else torch.enable_grad():
            out = engine.model_derivatives(model, model.attach_neighbors(batch), False,
                                           seed=1234)
        got.append([t.detach() for t in out])
    for a, b, label in zip(got[0], got[1], ("values", "J", "H")):
        assert a.shape == b.shape, label
        r = a.numpy()
        np.testing.assert_allclose(b.numpy(), r, err_msg=f"{name} {label}",
                                   **(V_TOL if label == "values" else tol(r)))
    if fam.dropout_key:
        with torch.no_grad():
            det = engine.model_derivatives(model, model.attach_neighbors(batch), True)[0]
        assert (det - got[1][0]).abs().max() > 1e-2 * det.abs().max(), "dropout changed nothing"


@pytest.mark.parametrize("name", list(FAMILIES))
def test_exact_training_steps_learn(name):
    fam = FAMILIES[name]
    torch.set_num_threads(2)
    # the duct examples' rate: at 0.3 a step's dropout noise hides a few steps' gain
    model = fam.port_model(rates=[0.05 if r else 0.0 for r in fam.rates])
    fns = engine.make_train_functions(model, engine.make_optimizer(model, 1))
    state = fns.init_state(seed=3)
    batch = model.attach_neighbors(fam.batches(9)[1])
    totals = []
    for _ in range(10):
        state, m = fns.train_step(state, batch)
        totals.append(float(m[0]))
    assert np.isfinite(totals).all() and totals[-1] < totals[0], totals
    for pname, p in model.module.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), pname


def unit_operator(rate, width=64):
    """A NeuralOperator whose output before dropout is 1 everywhere."""
    op = NeuralOperator(width, width, rate, activation=None)
    with torch.no_grad():
        op.Dense_0.weight.zero_()
        op.Dense_0.bias.fill_(1.0)
    return op


@pytest.mark.parametrize("rate", [0.05, 0.3])
def test_neural_operator_mask_keeps_what_the_rate_says(rate):
    """The keep threshold is compared as uint32: rate 0.05 keeps 95% (a
    signed compare kept about 45%, ROADMAP §3). Kept values are scaled by
    1 / keep, and the mask is the trunk kernel's draw for the operator's
    index."""
    op = unit_operator(rate).requires_grad_(False)
    x = torch.zeros(4, 500, 64)
    par = torch.ones(4, 1, 64)
    out = op(x, par, deterministic=False, seed=77, layer=2)
    kept = float((out > 0).float().mean())
    assert abs(kept - (1 - rate)) < 0.01, kept
    np.testing.assert_allclose(out[out > 0].numpy(), 1 / (1 - rate), rtol=1e-6)
    ref = dropout.keep_mask(trunk_seed(77), 2, 4, 500, 64, rate)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    other = op(x, par, deterministic=False, seed=77, layer=1)
    assert float((other != out).float().mean()) > 0.01
    torch.testing.assert_close(op(x, par, deterministic=True), torch.ones(4, 500, 64))
    with pytest.raises(ValueError, match="seed"):
        op(x, par, deterministic=False)


def test_neural_operator_sequential_passes_each_operator_its_index():
    seq = NeuralOperatorSequential(3, 16, [0.3, 0.3, 0.3], activation="tanh")
    x = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(1))
    par = torch.ones(2, 1, 16)
    want = x
    for i, op in enumerate(seq.operators):
        want = op(want, par, deterministic=False, seed=5, layer=i)
    torch.testing.assert_close(seq(x, par, deterministic=False, seed=5), want, rtol=0, atol=0)


def test_pi_gano_defaults_to_the_exact_path_as_jax_does():
    model = pi_gano.pi_gano(**GANO, operator_dropout=[0.0, 0.1, 0.0], scalers=make_scalers(),
                            device="cpu")
    ref = jax_pi_gano.pi_gano(**GANO, operator_dropout=[0.0, 0.1, 0.0],
                              scalers=jax_synthetic.make_scalers())
    assert model.derivative_apply is None and ref.derivative_apply is None
    assert model.neighbor_precompute is None and ref.neighbor_precompute is None
    fast = pi_gano.pi_gano(**GANO, operator_dropout=[0.0, 0.1, 0.0], scalers=make_scalers(),
                           fast_derivatives=True, device="cpu")
    assert fast.derivative_apply is not None and fast.neighbor_precompute is not None
