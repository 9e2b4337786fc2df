"""The PI-GANO++ slice: the JAX package's ``pi_gano_pp`` (its analytic
path, the default) and the port's, at a small configuration with the
duct_variable_boundary example's structure (two radius levels over the
boundary cloud's ``[C || boundaryId]`` rows, a trailing global level, and
the example's 32 neighbours), with the JAX parameters carried across by
``convert.params_from_flax``, on the same ``make_foam_batch`` batches with
each side's neighbour chain attached. Compares the chain (indices and masks
exactly), the plain forward, ``derivative_apply``, verbose
``predict_batch``, ``compute_losses`` with its gradients and three Adam
steps, with dropout off (the port's masks differ from ``jax.random``'s by
design); then the port's own contracts. Both sides run f32 on the CPU (JAX
at "highest" matmul precision, tests/conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pi_gano import WEIGHTS, V_TOL, assert_trees_close, grads_to_flax, tol

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.pi_gano import pi_gano_pp as jax_pi_gano_pp
from porous_cfd_tpu.physics.scaling import FixedLossScaler as JaxFixedLossScaler
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models.pi_gano import pi_gano_pp
from porous_cfd_tpu_torch.physics import scaling
from porous_cfd_tpu_torch.train import engine

# the example's structure at narrow widths: the trunk (24 + 16 = 40) is as
# wide as the branch; 32 neighbours as the example has them
CFG = dict(nu=1489.4e-6, out_features=3, branch_layers=[8, 16, 40, 40],
           geometry_layers=[[2 * 2 + 4, 16, 16], [16 + 2, 24, 24], [24 + 2, 24, 24]],
           geometry_radius=[0.5, 1], geometry_fraction=[0.5, 0.25],
           local_layers=[2, 16, 16, 16], n_operators=3,
           variable_boundaries=VARIABLE_BOUNDARIES, max_neighbors=32)
B, NI, NB, NO = 2, 40, 64, 8


@pytest.fixture(scope="module")
def jax_side():
    model = jax_pi_gano_pp(**CFG, operator_dropout=[0, 0, 0],
                           scalers=jax_synthetic.make_scalers())
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 2),
                                          JaxFixedLossScaler(WEIGHTS))
    batches = [model.attach_neighbors(jax_synthetic.make_foam_batch(
        B, NI, NB, NO, rng=np.random.default_rng(s))) for s in (11, 12, 13)]
    state = fns.init_state(batches[0])
    return model, fns, state, batches


def port_model(params=None, dropout=(0, 0, 0), seed=0):
    model = pi_gano_pp(**CFG, operator_dropout=list(dropout), scalers=make_scalers(),
                       generator=torch.Generator().manual_seed(seed), device="cpu")
    if params is not None:
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    return model


def port_batch(model, seed):
    return model.attach_neighbors(make_foam_batch(B, NI, NB, NO,
                                                  rng=np.random.default_rng(seed)))


def test_chain_precompute_equals_jax(jax_side):
    """The boundary chain at K = 32 in the C-first feature order: centroids,
    indices and masks exactly, the float entries within 1e-6."""
    _, _, _, batches = jax_side
    ref = batches[0].domain
    got = port_batch(port_model(), 11).domain
    keys = sorted(k for k in ref if k.startswith("sa_"))
    assert [f"_{k}" for k in keys] == sorted(k for k in got if k.startswith("_sa_"))
    assert got["_sa_idx_0"].shape == (B, NB // 2, 32)
    # neighbourhoods wider than the PIPN++ tests' K = 8 occur at both levels
    assert int(got["_sa_mask_0"].sum(-1).max()) > 8 < int(got["_sa_mask_1"].sum(-1).max())
    for key in keys:
        g, r = got[f"_{key}"].numpy(), np.asarray(ref[key])
        assert g.shape == r.shape, key
        if key.split("_")[1] in ("cent", "idx", "mask"):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=key)


def test_plain_forward_matches_jax(jax_side):
    jax_model, _, state, batches = jax_side
    jb = batches[0]
    ref = np.asarray(jax_model.module.apply({"params": state.params}, jb["C"], jb,
                                            deterministic=True))
    model = port_model(state.params)
    batch = port_batch(model, 11)
    with torch.no_grad():
        out = model.module(batch["C"], batch)
    assert out.shape == (B, NI + NB, 3)
    np.testing.assert_allclose(out.numpy(), ref, **V_TOL)


def test_derivative_apply_and_verbose_prediction_match_jax(jax_side):
    jax_model, fns, state, batches = jax_side
    ref = [np.asarray(a) for a in
           jax_model.derivative_apply(state.params, batches[0], None, True)]
    model = port_model(state.params)
    batch = port_batch(model, 11)
    with torch.no_grad():
        out = [a.numpy() for a in model.derivative_apply(batch)]
    assert out[0].shape == (B, NI + NB, 3) and out[1].shape == (B, NI, 3, 2)
    np.testing.assert_allclose(out[0], ref[0], **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, **tol(r))

    ref_pred, ref_extras = fns.predict_batch(state.params, batches[0], True)
    pred, extras = engine.make_predict_functions(model).predict_batch(batch, True)
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref_pred.data), **V_TOL)
    r = np.asarray(ref_extras.data)
    np.testing.assert_allclose(extras.data.numpy(), r, **tol(r))


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
    got, predicted = engine.compute_losses(model, port_batch(model, 11), deterministic=True)
    assert got.shape == (model.num_losses,) == (9,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_losses), **tol(ref_losses))
    np.testing.assert_allclose(predicted.data.detach().numpy(), np.asarray(ref_pred.data),
                               **V_TOL)
    torch.sum(torch.tensor(WEIGHTS, dtype=torch.float32) * got).backward()
    grads = grads_to_flax(model.module)
    # every level of the SetAbstraction chain receives a gradient
    seq = grads["geometry_encoder"]["set_abstraction"]
    for key in ("sa_0", "sa_1", "global_sa"):
        assert all(np.abs(v["kernel"]).max() > 0 for v in jax.tree_util.tree_leaves(
            seq[key], is_leaf=lambda n: "kernel" in n))
    assert_trees_close(grads, jax.tree_util.tree_map(np.asarray, ref_grads))


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
        pstate, m = port.train_step(pstate, port_batch(model, seed))
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **tol(ref_m))
        assert_trees_close(params_to_flax(model.module),
                           jax.tree_util.tree_map(np.asarray, jstate.params))


def test_path_without_an_attached_chain_builds_the_same_one():
    model = port_model(seed=3)
    raw = make_foam_batch(B, NI, NB, NO, seed=4)
    with torch.no_grad():
        for a, b in zip(model.derivative_apply(model.attach_neighbors(raw)),
                        model.derivative_apply(raw)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="attach_neighbors"):
        model.derivative_apply(raw.to("meta"))


def test_trains_with_dropout_and_reproducibly():
    def run():
        model = port_model(dropout=(0, 0.1, 0.1), seed=4)
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1),
                                          scaling.FixedLossScaler(WEIGHTS))
        state = fns.init_state(seed=21)
        batch = port_batch(model, 6)
        totals = []
        for _ in range(10):
            state, m = fns.train_step(state, batch)
            totals.append(float(m[0]))
        return totals

    totals = run()
    assert np.isfinite(totals).all() and totals[-1] < totals[0]
    assert run() == totals
