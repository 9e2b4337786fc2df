"""The PIPN++ slice: the JAX package's ``pipn_foam_pp(fast_derivatives=True)``
and the port's, at a small configuration with the duct example's structure
(two radius levels and a trailing global level), with the JAX parameters
carried across by ``convert.params_from_flax``, on the same
``make_foam_batch`` batches with each side's neighbour chain attached.
Compares the plain forward, ``derivative_apply``, verbose ``predict_batch``,
``compute_losses`` with its gradients and three Adam steps (dropout off:
the port's masks differ from ``jax.random``'s by design); then the port's
own contracts: the path without an attached chain, training with dropout,
and the Trainer and evaluate attaching the chain. Both sides run f32 on the
CPU (JAX at "highest" matmul precision, tests/conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.pipn import pipn_foam_pp as jax_pipn_foam_pp
from porous_cfd_tpu.physics.scaling import FixedLossScaler as JaxFixedLossScaler
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models.pipn import pipn_foam_pp
from porous_cfd_tpu_torch.physics import scaling
from porous_cfd_tpu_torch.train import engine

# tests/test_sa_pallas.py's small PIPN++ configuration
CFG = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 16, 16], seg_layers=[32 + 16, 24, 3],
           fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
           fe_global_layers=[[2 + 4 + 2, 16, 16], [16 + 2, 24, 24], [24 + 2, 24, 32]],
           max_neighbors=8)
B, NI, NB, NO = 2, 40, 24, 8
WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# Values (fields): f32 on both sides, sums at most 48 wide.
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


@pytest.fixture(scope="module")
def jax_side():
    model = jax_pipn_foam_pp(**CFG, scalers=jax_synthetic.make_scalers(), seg_dropout=[0.0, 0])
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 2),
                                          JaxFixedLossScaler(WEIGHTS))
    batches = [model.attach_neighbors(jax_synthetic.make_foam_batch(
        B, NI, NB, NO, rng=np.random.default_rng(s))) for s in (11, 12, 13)]
    state = fns.init_state(batches[0])
    return model, fns, state, batches


def port_model(params=None, dropout=(0.0, 0.0), seed=0):
    model = pipn_foam_pp(**CFG, scalers=make_scalers(), seg_dropout=list(dropout),
                         generator=torch.Generator().manual_seed(seed), device="cpu")
    if params is not None:
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    return model


def port_batch(model, seed):
    return model.attach_neighbors(make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(seed)))


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
    for key in ("sa_0", "sa_1", "global_sa"):
        leaf = grads["feature_extract"]["global_feature"][key]
        assert all(np.abs(v["kernel"]).max() > 0 for v in jax.tree_util.tree_leaves(
            leaf, is_leaf=lambda n: "kernel" in n))
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
    """On the CPU derivative_apply builds the chain itself when none is
    attached, and gets the same outputs bit for bit; the chain holds the
    model's level shapes."""
    model = port_model(seed=3)
    raw = make_foam_batch(B, NI, NB, NO, seed=4)
    attached = model.attach_neighbors(raw)
    assert attached.domain["_sa_idx_0"].shape == (B, NB // 2, 8)
    assert attached.domain["_sa_xg_0"].shape == (B, NB // 2 * 8, 6)
    assert attached.domain["_sa_idx_1"].shape == (B, NB // 8, 8)
    with torch.no_grad():
        for a, b in zip(model.derivative_apply(attached), model.derivative_apply(raw)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_path_off_the_cpu_without_an_attached_chain_raises():
    """Off the CPU the path wants the chain attached once per dataset and
    builds none per call (a meta-device batch stands in for the card's)."""
    model = port_model(seed=3)
    raw = make_foam_batch(B, NI, NB, NO, seed=4).to("meta")
    with pytest.raises(ValueError, match="attach_neighbors"):
        model.derivative_apply(raw)


def test_trains_with_dropout_and_reproducibly():
    def run():
        model = port_model(dropout=(0.1, 0.0), seed=4)
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1),
                                          scaling.FixedLossScaler(WEIGHTS))
        state = fns.init_state(seed=21)
        batch = port_batch(model, 6)
        totals = []
        for _ in range(12):
            state, m = fns.train_step(state, batch)
            totals.append(float(m[0]))
        return totals

    totals = run()
    assert np.isfinite(totals).all() and totals[-1] < totals[0]
    assert run() == totals


def test_trainer_and_evaluate_attach_the_chain(tmp_path):
    """Trainer.fit (train and validation data) and evaluate build the chain
    once per dataset each."""
    import dataclasses

    from porous_cfd_tpu_torch.pipelines.evaluation import evaluate
    from porous_cfd_tpu_torch.train.engine import gather_cases
    from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig

    model = port_model(dropout=(0.05, 0.0), seed=5)
    seen = []

    def counting(dataset):
        seen.append(len(dataset))
        return model.neighbor_precompute(dataset)

    counted = dataclasses.replace(model, neighbor_precompute=counting)
    data = make_foam_batch(4, NI, NB, NO, seed=3)
    Trainer(counted, data, gather_cases(data, torch.arange(2)),
            TrainerConfig(epochs=1, batch_size=2, logs_dir=str(tmp_path), name="t"),
            loss_scaler=scaling.FixedLossScaler(WEIGHTS)).fit()
    assert seen == [4, 2]
    ev = evaluate(counted, data, 2, make_scalers())
    assert seen == [4, 2, 4]
    assert len(ev.predictions) == 2 and np.isfinite(ev.results["U error"]).all()
