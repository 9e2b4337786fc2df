"""The training slice: the port's compute_losses, train_step / train_epoch,
Adam with its staircase schedule and the loss scalers against the JAX
package's, on the same weights (carried across with
``convert.params_from_flax``) and the same ``make_foam_batch`` batches. Both
sides run f32 on the CPU (JAX at "highest" matmul precision,
tests/conftest.py), with dropout off: the port's counter-based masks differ
from ``jax.random``'s stream by design. Dropout on is held to itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.pipn import pipn_foam as jax_pipn_foam
from porous_cfd_tpu.physics import scaling as jax_scaling
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models.pipn import pipn_foam
from porous_cfd_tpu_torch.physics import scaling
from porous_cfd_tpu_torch.train import engine

CFG = dict(nu=1489.4e-6, d=14000.0, f=17.11,
           fe_local_layers=[2, 16, 16], fe_global_layers=[16 + 5, 16, 32, 64],
           seg_layers=[64 + 16, 32, 32, 16, 3])
B, NI, NB, NO = 2, 40, 16, 8
WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)


def tol(ref):
    """Losses, gradients and parameters: f32 on both sides, with the sums
    over rows and the 64- and 80-wide contractions taken in another order;
    scale the absolute part by the largest entry."""
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
    """The module's .grad as a flax tree (kernels transposed)."""
    tree: dict = {}
    for name, lin in module.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = tree
            for k in name.split("."):
                node = node.setdefault(k, {})
            node["kernel"] = lin.weight.grad.numpy().T
            node["bias"] = lin.bias.grad.numpy()
    return tree


@pytest.fixture(scope="module")
def jax_side():
    jax_model = jax_pipn_foam(**CFG, scalers=jax_synthetic.make_scalers())
    tx = jax_engine.make_optimizer(jax_model, 2)
    fns = jax_engine.make_train_functions(
        jax_model, tx, jax_scaling.FixedLossScaler(WEIGHTS))
    batches = [jax_synthetic.make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(s))
               for s in (11, 12, 13)]
    state = fns.init_state(batches[0])
    return jax_model, fns, state, batches


def port_model(params, dropout=None):
    model = pipn_foam(**CFG, seg_dropout=dropout, scalers=make_scalers(), device="cpu")
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    return model


def port_batch(seed):
    return make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(seed))


def test_compute_losses_and_gradients_match_jax(jax_side):
    jax_model, _, state, batches = jax_side
    w = jnp.asarray(WEIGHTS, jnp.float32)

    def total(params):
        losses, predicted = jax_engine.compute_losses(jax_model, params, batches[0], None,
                                                      deterministic=True)
        return jnp.sum(w * losses), (losses, predicted)

    (_, (ref_losses, ref_pred)), ref_grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(state.params)
    model = port_model(state.params)
    losses, predicted = engine.compute_losses(model, port_batch(11), deterministic=True)
    assert losses.shape == (model.num_losses,) == (9,)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses),
                               **tol(ref_losses))
    np.testing.assert_allclose(predicted.data.detach().numpy(), np.asarray(ref_pred.data),
                               rtol=1e-5, atol=1e-5)
    torch.sum(torch.tensor(WEIGHTS, dtype=torch.float32) * losses).backward()
    assert_trees_close(grads_to_flax(model.module),
                       jax.tree_util.tree_map(np.asarray, ref_grads))


def test_three_adam_steps_across_an_lr_step_match_jax(jax_side):
    """steps_per_epoch = 2: the third step runs at lr0 * gamma. Adam's bias
    correction and eps placement must match optax's."""
    jax_model, fns, state, batches = jax_side
    model = port_model(state.params)
    tx = engine.make_optimizer(model, 2)
    assert tx.lr(1) == model.learning_rate and tx.lr(2) == model.learning_rate * 0.999
    port = engine.make_train_functions(model, tx, scaling.FixedLossScaler(WEIGHTS))
    pstate = port.init_state()
    assert port.metric_labels == fns.metric_labels
    jstate = jax.tree_util.tree_map(jnp.copy, state)
    for i, seed in enumerate((11, 12, 13)):
        jstate, ref_m = fns.train_step(jstate, batches[i])
        pstate, m = port.train_step(pstate, port_batch(seed))
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **tol(ref_m))
        assert_trees_close(params_to_flax(model.module),
                           jax.tree_util.tree_map(np.asarray, jstate.params))
    assert pstate.step == int(jstate.step) == 3


def test_train_epoch_equals_single_steps():
    data = make_foam_batch(4, NI, NB, NO, seed=5)
    perm = np.array([[2, 0], [3, 1]])
    results = []
    for by_epoch in (True, False):
        model = pipn_foam(**CFG, seg_dropout=[0.1, 0.1, 0, 0], scalers=make_scalers(),
                          generator=torch.Generator().manual_seed(3), device="cpu")
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 2))
        state = fns.init_state(seed=9)
        if by_epoch:
            state, m = fns.train_epoch(state, data, perm)
        else:
            ms = []
            for idxs in perm:
                state, mi = fns.train_step(state, engine.gather_cases(data, torch.as_tensor(idxs)))
                ms.append(mi)
            m = torch.stack(ms).mean(0)
        results.append((m, [p.detach().clone() for p in model.module.parameters()]))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_relobralo_matches_jax(beta):
    """beta 0 and 1 fix the Bernoulli lookback draw, so both packages take
    the same branch; update_period 2 exercises accumulation."""
    rng = np.random.default_rng(4)
    losses = [np.abs(rng.normal(size=9)).astype(np.float32) + 0.1 for _ in range(6)]
    ref = jax_scaling.RelobraloScaler(9, alpha=0.3, beta=beta, update_period=2)
    port = scaling.RelobraloScaler(9, alpha=0.3, beta=beta, update_period=2)
    rs, ps = ref.init_state(), port.init_state()
    for step, loss in enumerate(losses):
        rw, rs = ref(rs, jnp.asarray(loss), step, jax.random.PRNGKey(step))
        pw, ps = port(ps, torch.from_numpy(loss), step, step)
        np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-5, atol=1e-6)
        for name in ("init_losses", "prev_losses", "lambda_ema"):
            np.testing.assert_allclose(getattr(ps, name).numpy(),
                                       np.asarray(getattr(rs, name)), rtol=1e-5, atol=1e-6)


def test_fixed_scaler_from_dict_and_factory():
    s = scaling.make_loss_scaler("fixed", 9, {"continuity": [1], "momentum": [1, 1],
                                              "boundary": [1, 1, 1],
                                              "observations": [100, 100, 100]})
    assert s.weights == tuple(float(w) for w in WEIGHTS)
    w, state = s(None, torch.ones(9), 0, 0)
    assert w.tolist() == list(map(float, WEIGHTS)) and state is None
    assert type(scaling.make_loss_scaler(None, 9)) is scaling.LossScaler
    assert isinstance(scaling.make_loss_scaler("relobralo", 9), scaling.RelobraloScaler)
    with pytest.raises(ValueError):
        scaling.make_loss_scaler("bogus", 9)


def _dropout_run(steps):
    model = pipn_foam(**CFG, seg_dropout=[0.05, 0.05, 0, 0], scalers=make_scalers(),
                      generator=torch.Generator().manual_seed(8), device="cpu")
    fns = engine.make_train_functions(model, engine.make_optimizer(model, 1),
                                      scaling.FixedLossScaler(WEIGHTS))
    state = fns.init_state(seed=21)
    batch = make_foam_batch(B, NI, NB, NO, seed=6)
    totals = []
    for _ in range(steps):
        state, m = fns.train_step(state, batch)
        totals.append(float(m[0]))
    return totals, [p.detach().clone() for p in model.module.parameters()]


def test_training_with_dropout_learns_and_is_reproducible():
    totals, params = _dropout_run(20)
    assert np.isfinite(totals).all()
    # random targets under weight-100 observation losses: a steady fall
    assert totals[-1] < totals[0]
    assert np.mean(totals[-5:]) < np.mean(totals[:5])
    again, params2 = _dropout_run(20)
    assert totals == again
    for a, b in zip(params, params2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_step_seed_is_a_pure_function_of_seed_and_step():
    from porous_cfd_tpu_torch.ops.dropout import fold_in
    assert fold_in(8421, 3) == fold_in(8421, 3)
    assert len({fold_in(8421, s) for s in range(100)} | {fold_in(8422, 0)}) == 101
