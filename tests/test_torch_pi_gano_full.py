"""The PiGanoFull slice: the JAX package's ``pi_gano(full=True,
fast_derivatives=True)`` and the port's, with the JAX parameters carried
across by ``convert.params_from_flax`` (one ``neural_ops_{k}`` trunk per
output, no reduction), on the same ``make_foam_batch`` batches. Compares
the plain forward, ``derivative_apply``, verbose ``predict_batch``,
``compute_losses`` with its gradients and three Adam steps, with dropout
off (the port's masks differ from ``jax.random``'s by design); then the
masks with dropout on: their keep rate, and the three trunks drawing the
same masks from the step's one seed, as JAX's analytic path hands each
trunk the same key. Both sides run f32 on the CPU (JAX at "highest" matmul
precision, tests/conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pi_gano import (B, CFG, NB, NI, NO, V_TOL, WEIGHTS, assert_trees_close,
                                grads_to_flax, jax_batch, port_batch, tol)

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.pi_gano import pi_gano as jax_pi_gano
from porous_cfd_tpu.physics.scaling import FixedLossScaler as JaxFixedLossScaler
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import make_scalers
from porous_cfd_tpu_torch.models.pi_gano import pi_gano
from porous_cfd_tpu_torch.ops import dropout as dropout_mod, neural_op_cuda
from porous_cfd_tpu_torch.physics import scaling
from porous_cfd_tpu_torch.train import engine


@pytest.fixture(scope="module")
def jax_side():
    model = jax_pi_gano(**CFG, operator_dropout=[0, 0, 0], full=True,
                        scalers=jax_synthetic.make_scalers(), fast_derivatives=True)
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 2),
                                          JaxFixedLossScaler(WEIGHTS))
    batches = [jax_batch(s) for s in (11, 12, 13)]
    state = fns.init_state(batches[0])
    return model, fns, state, batches


def port_model(params=None, dropout=(0, 0, 0), seed=0):
    model = pi_gano(**CFG, operator_dropout=dropout, full=True, scalers=make_scalers(),
                    fast_derivatives=True, generator=torch.Generator().manual_seed(seed), device="cpu")
    if params is not None:
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    return model


def test_module_has_one_trunk_per_output_and_no_reduction(jax_side):
    _, _, state, _ = jax_side
    assert sorted(k for k in state.params if k.startswith("neural_ops")) == [
        "neural_ops_0", "neural_ops_1", "neural_ops_2"]
    module = port_model(state.params).module
    assert not hasattr(module, "reduction") and not hasattr(module, "neural_ops")
    assert [t.last_activation for t in module.trunks] == [False] * 3


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
        out = [a.numpy() for a in model.derivative_apply(model.attach_neighbors(port_batch(11)))]
    assert out[0].shape == (B, NI + NB, 3) and out[1].shape == (B, NI, 3, 2)
    np.testing.assert_allclose(out[0], ref[0], **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, **tol(r))

    ref_pred, ref_extras = fns.predict_batch(state.params, batches[0], True)
    pred, extras = engine.make_predict_functions(model).predict_batch(port_batch(11), True)
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
    got, predicted = engine.compute_losses(model, port_batch(11), deterministic=True)
    assert got.shape == (model.num_losses,) == (9,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_losses), **tol(ref_losses))
    np.testing.assert_allclose(predicted.data.detach().numpy(), np.asarray(ref_pred.data),
                               **V_TOL)
    torch.sum(torch.tensor(WEIGHTS, dtype=torch.float32) * got).backward()
    grads = grads_to_flax(model.module)
    # each output's trunk takes its gradient from its own output alone
    for k in range(3):
        assert np.abs(grads[f"neural_ops_{k}"]["operator_2"]["Dense_0"]["kernel"]).max() > 0
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
        pstate, m = port.train_step(pstate, port_batch(seed))
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **tol(ref_m))
        assert_trees_close(params_to_flax(model.module),
                           jax.tree_util.tree_map(np.asarray, jstate.params))


def test_trunk_masks_keep_rate_and_are_shared_by_the_three_trunks():
    """With dropout on, the trunks' masks keep at their rate, and the three
    trunks draw the same ones: given equal weights, the three outputs are
    equal, and not equal to the deterministic outputs."""
    rates = (0.0, 0.1, 0.1)
    model = port_model(dropout=rates, seed=3)
    trunks = model.module.trunks
    with torch.no_grad():
        for trunk in trunks[1:]:
            trunk.load_state_dict(trunks[0].state_dict())
    batch = model.attach_neighbors(port_batch(5))
    seed = 77
    with torch.no_grad():
        out, jac, lap = model.derivative_apply(batch, False, seed)
        det = model.derivative_apply(batch, True)
    for k in (1, 2):
        torch.testing.assert_close(out[..., k], out[..., 0], rtol=0, atol=0)
        torch.testing.assert_close(jac[..., k, :], jac[..., 0, :], rtol=0, atol=0)
        torch.testing.assert_close(lap[..., k, :], lap[..., 0, :], rtol=0, atol=0)
    assert (out - det[0]).abs().max() > 1e-4
    mask = dropout_mod.keep_mask(neural_op_cuda.trunk_seed(seed), 1, 64, NI + NB,
                                 CFG["branch_layers"][-1], 0.1)
    kept = float((mask > 0).float().mean())
    assert abs(kept - 0.9) < 4 * (0.1 * 0.9 / mask.numel()) ** 0.5


def test_trains_with_dropout_and_reproducibly():
    def run():
        model = port_model(dropout=(0, 0.1, 0.1), seed=4)
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1),
                                          scaling.FixedLossScaler(WEIGHTS))
        state = fns.init_state(seed=21)
        batch = model.attach_neighbors(port_batch(6))
        totals = []
        for _ in range(10):
            state, m = fns.train_step(state, batch)
            totals.append(float(m[0]))
        return totals

    totals = run()
    assert np.isfinite(totals).all() and totals[-1] < totals[0]
    assert run() == totals


def test_no_reduction_path_with_nothing_attached_equals_the_precompute():
    model = port_model(seed=6)
    data = port_batch(8)
    with torch.no_grad():
        for a, b in zip(model.derivative_apply(model.attach_neighbors(data)),
                        model.derivative_apply(data)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
