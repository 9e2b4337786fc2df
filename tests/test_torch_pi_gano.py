"""The PI-GANO slice: the JAX package's ``pi_gano(..., fast_derivatives=True)``
and the port's, with the JAX parameters carried across by
``convert.params_from_flax``, on the same ``make_foam_batch`` batches.
Compares the plain forward, ``derivative_apply``, verbose ``predict_batch``,
``MomentumLossVariable``, ``compute_losses`` with its gradients and three
Adam steps (dropout off: the port's masks differ from ``jax.random``'s by
design), and the per-dataset precompute against the path without it. Both
sides run f32 on the CPU (JAX at "highest" matmul precision,
tests/conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.pi_gano import pi_gano as jax_pi_gano
from porous_cfd_tpu.physics import losses as jax_losses
from porous_cfd_tpu.physics.scaling import FixedLossScaler as JaxFixedLossScaler
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models.pi_gano import gather_parameters, pi_gano
from porous_cfd_tpu_torch.physics import losses, scaling
from porous_cfd_tpu_torch.physics.operators import split_derivatives
from porous_cfd_tpu_torch.train import engine

# the example's structure at narrow widths: the trunk (16 + 24 = 40) is as
# wide as the branch
CFG = dict(nu=1489.4e-6, out_features=3, branch_layers=[8, 16, 40, 40],
           geometry_layers=[7, 16, 24, 24], local_layers=[2, 16, 16, 16], n_operators=3,
           variable_boundaries=VARIABLE_BOUNDARIES)
B, NI, NB, NO = 2, 40, 16, 8
WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# Values (fields): f32 on both sides, sums at most 40 wide.
V_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(ref):
    """J, H, residuals, losses, gradients and parameters: products of
    derivative rules through every layer, sums over rows and widths in
    another order; scale the absolute part by the largest entry."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def assert_trees_close(got: dict, ref: dict, path=""):
    assert got.keys() == ref.keys(), path
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(got[k], ref[k], f"{path}/{k}")
        else:
            r = np.asarray(ref[k])
            np.testing.assert_allclose(np.asarray(got[k]), r, err_msg=f"{path}/{k}", **tol(r))


def grads_to_flax(module) -> dict:
    tree: dict = {}
    for name, lin in module.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = tree
            for k in name.split("."):
                node = node.setdefault(k, {})
            node["kernel"] = lin.weight.grad.numpy().T
            node["bias"] = lin.bias.grad.numpy()
    return tree


def jax_batch(seed):
    return jax_synthetic.make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(seed))


def port_batch(seed):
    return make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def jax_side():
    model = jax_pi_gano(**CFG, operator_dropout=[0, 0, 0],
                        scalers=jax_synthetic.make_scalers(), fast_derivatives=True)
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 2),
                                          JaxFixedLossScaler(WEIGHTS))
    batches = [jax_batch(s) for s in (11, 12, 13)]
    state = fns.init_state(batches[0])
    return model, fns, state, batches


def port_model(params, dropout=(0, 0, 0)):
    model = pi_gano(**CFG, operator_dropout=dropout, scalers=make_scalers(),
                    fast_derivatives=True, device="cpu")
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    return model


def test_plain_forward_matches_jax(jax_side):
    jax_model, _, state, batches = jax_side
    jb = batches[0]
    pts = jnp.concatenate([jb["internal"]["C"], jb["boundary"]["C"]], -2)
    ref = np.asarray(jax_model.module.apply({"params": state.params}, pts, jb,
                                            deterministic=True))
    model = port_model(state.params)
    batch = port_batch(11)
    with torch.no_grad():
        out = model.module(batch["C"], batch)
    assert out.shape == (B, NI + NB, 3)
    np.testing.assert_allclose(out.numpy(), ref, **V_TOL)


def test_derivative_apply_and_verbose_prediction_match_jax(jax_side):
    jax_model, fns, state, batches = jax_side
    ref = [np.asarray(a) for a in
           jax_model.derivative_apply(state.params, batches[0], None, True)]
    model = port_model(state.params)
    with torch.no_grad():
        out = [a.numpy() for a in model.derivative_apply(port_batch(11))]
    assert out[0].shape == (B, NI + NB, 3) and out[1].shape == (B, NI, 3, 2)
    np.testing.assert_allclose(out[0], ref[0], **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, **tol(r))

    ref_pred, ref_extras = fns.predict_batch(state.params, batches[0], True)
    pred, extras = engine.make_predict_functions(model).predict_batch(port_batch(11), True)
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref_pred.data), **V_TOL)
    r = np.asarray(ref_extras.data)
    np.testing.assert_allclose(extras.data.numpy(), r, **tol(r))


def test_momentum_loss_variable_matches_jax():
    """Per-point d/f fields through their Normalizers, on random derivatives."""
    rng = np.random.default_rng(3)
    jb, batch = jax_batch(4), port_batch(4)
    u = rng.normal(size=(B, NI, 2)).astype(np.float32)
    u_jac = rng.normal(size=(B, NI, 2, 2)).astype(np.float32)
    u_lap = rng.normal(size=(B, NI, 2, 2)).astype(np.float32)
    p_grad = rng.normal(size=(B, NI, 2)).astype(np.float32)
    js, ps = jax_synthetic.make_scalers(), make_scalers()
    ref_loss = jax_losses.MomentumLossVariable(1489.4e-6, js["U"], js["C"], js["p"], js["d"],
                                               js["f"])
    port_loss = losses.MomentumLossVariable(1489.4e-6, ps["U"], ps["C"], ps["p"], ps["d"],
                                            ps["f"])
    args = (u, u_jac, u_lap, p_grad)
    ref = np.asarray(ref_loss.residual(jb["internal"], *map(jnp.asarray, args)))
    got = port_loss.residual(batch["internal"], *map(torch.from_numpy, args)).numpy()
    assert np.abs(ref).max() > 1.0       # the porous zone's source is in play
    np.testing.assert_allclose(got, ref, **tol(ref))
    r = np.asarray(ref_loss(jb["internal"], *map(jnp.asarray, args)))
    np.testing.assert_allclose(port_loss(batch["internal"], *map(torch.from_numpy, args)).numpy(),
                               r, **tol(r))


def test_compute_losses_and_gradients_match_jax(jax_side):
    jax_model, _, state, batches = jax_side
    w = jnp.asarray(WEIGHTS, jnp.float32)

    def total(params):
        losses_, predicted = jax_engine.compute_losses(jax_model, params, batches[0], None,
                                                       deterministic=True)
        return jnp.sum(w * losses_), (losses_, predicted)

    (_, (ref_losses, ref_pred)), ref_grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(state.params)
    model = port_model(state.params)
    got, predicted = engine.compute_losses(model, port_batch(11), deterministic=True)
    assert got.shape == (model.num_losses,) == (9,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_losses), **tol(ref_losses))
    np.testing.assert_allclose(predicted.data.detach().numpy(), np.asarray(ref_pred.data),
                               **V_TOL)
    torch.sum(torch.tensor(WEIGHTS, dtype=torch.float32) * got).backward()
    assert_trees_close(grads_to_flax(model.module),
                       jax.tree_util.tree_map(np.asarray, ref_grads))


def test_three_adam_steps_match_jax(jax_side):
    """steps_per_epoch = 2: the third step runs at lr0 * gamma."""
    _, fns, state, batches = jax_side
    model = port_model(state.params)
    port = engine.make_train_functions(model, engine.make_optimizer(model, 2),
                                       scaling.FixedLossScaler(WEIGHTS))
    pstate = port.init_state()
    assert port.metric_labels == fns.metric_labels
    jstate = jax.tree_util.tree_map(jnp.copy, state)
    for i, seed in enumerate((11, 12, 13)):
        jstate, ref_m = fns.train_step(jstate, batches[i])
        pstate, m = port.train_step(pstate, port_batch(seed))
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **tol(ref_m))
        assert_trees_close(params_to_flax(model.module),
                           jax.tree_util.tree_map(np.asarray, jstate.params))


def test_precompute_gives_the_same_outputs(jax_side):
    """attach_neighbors builds the geometry and branch inputs once per
    dataset; they keep their float values (FoamData keeps ``_`` entries as
    they are), and the path through them equals the path without them."""
    _, _, state, _ = jax_side
    model = port_model(state.params)
    data = make_foam_batch(4, NI, NB, NO, seed=7)
    attached = model.attach_neighbors(data)
    geom_in, par_in = attached.domain["_gano_geom_in"], attached.domain["_gano_par"]
    assert geom_in.dtype == par_in.dtype == torch.float32
    assert geom_in.shape == (4, NI + NB, 7) and par_in.shape == (4, NB // 4 + NI, 8)
    torch.testing.assert_close(par_in, gather_parameters(data, VARIABLE_BOUNDARIES),
                               rtol=0, atol=0)
    assert not torch.equal(geom_in, geom_in.round())
    idx = torch.tensor([3, 1])
    with torch.no_grad():
        with_aux = model.derivative_apply(engine.gather_cases(attached, idx))
        without = model.derivative_apply(engine.gather_cases(data, idx))
    for a, b in zip(with_aux, without):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trains_with_dropout_and_reproducibly():
    def run():
        model = pi_gano(**CFG, operator_dropout=[0, 0.1, 0.1], scalers=make_scalers(),
                        fast_derivatives=True, generator=torch.Generator().manual_seed(4), device="cpu")
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1),
                                          scaling.FixedLossScaler(WEIGHTS))
        state = fns.init_state(seed=21)
        batch = model.attach_neighbors(port_batch(6))
        totals = []
        for _ in range(12):
            state, m = fns.train_step(state, batch)
            totals.append(float(m[0]))
        return totals

    totals = run()
    assert np.isfinite(totals).all() and totals[-1] < totals[0]
    assert run() == totals


def test_split_derivatives_of_the_slice_feed_the_residual():
    """Verbose prediction's residual channels are [Momentum x, y, div] on
    internal rows, from the model's own MomentumLossVariable."""
    model = pi_gano(**CFG, operator_dropout=[0, 0, 0], scalers=make_scalers(),
                    fast_derivatives=True, generator=torch.Generator().manual_seed(2), device="cpu")
    batch = port_batch(9)
    with torch.no_grad():
        out, jac, lap = model.derivative_apply(batch)
        _, extras = engine.make_predict_functions(model).predict_batch(batch, True)
    u_jac, u_lap, p_grad = split_derivatives(jac, lap, 2)
    mom = model.momentum_loss.residual(batch["internal"], out[:, :NI, :2], u_jac, u_lap, p_grad)
    torch.testing.assert_close(extras["Momentum"], mom, rtol=0, atol=0)
    assert extras.data.shape == (B, NI, 3)


def test_trainer_and_evaluate_attach_the_precompute(tmp_path):
    """Trainer.fit (train and validation data) and evaluate build the
    per-dataset aux once each, where the JAX trainer and evaluation call
    attach_neighbors."""
    import dataclasses

    from porous_cfd_tpu_torch.pipelines.evaluation import evaluate
    from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig

    model = pi_gano(**CFG, operator_dropout=[0, 0.1, 0], scalers=make_scalers(),
                    fast_derivatives=True, generator=torch.Generator().manual_seed(5), device="cpu")
    seen = []

    def counting(dataset):
        seen.append(len(dataset))
        return model.neighbor_precompute(dataset)

    counted = dataclasses.replace(model, neighbor_precompute=counting)
    data = make_foam_batch(4, NI, NB, NO, seed=3)
    Trainer(counted, data, engine.gather_cases(data, torch.arange(2)),
            TrainerConfig(epochs=1, batch_size=2, logs_dir=str(tmp_path), name="t"),
            loss_scaler=scaling.FixedLossScaler(WEIGHTS)).fit()
    assert seen == [4, 2]
    ev = evaluate(counted, data, 2, make_scalers())
    assert seen == [4, 2, 4]
    assert len(ev.predictions) == 2 and np.isfinite(ev.results["U error"]).all()
