"""The max-pool-coupled PIPN slice: the port's ``pipn_foam(coupled_context=
True)`` (winner gather by index, ``index_add`` of the layer-0 terms, the
decoder's j0_add mode; plain versions on the CPU) against the JAX package's
coupled path on the same weights and ``make_foam_batch`` batches, by both of
its routes: the dense one (context J/H through the full first-layer
weight) and the winner-gather one (``FORCE_WINNER_GATHER``, its Pallas
kernels in interpret mode). derivative_apply, compute_losses and its
gradients, verbose prediction and three Adam steps. Dropout off on both
sides (the port's masks are its own counter function). Also, on the port
alone: the exact, coupled and decoupled paths agree off the pooling
winners' rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import porous_cfd_tpu.models.pipn as jax_pipn_mod
from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.physics import scaling as jax_scaling
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models.pipn import pipn_foam
from porous_cfd_tpu_torch.ops import pointnet_cuda
from porous_cfd_tpu_torch.physics import analytic, scaling
from porous_cfd_tpu_torch.train import engine

CFG = dict(nu=1489.4e-6, d=14000.0, f=17.11,
           fe_local_layers=[2, 16, 16], fe_global_layers=[16 + 5, 16, 32, 64],
           seg_layers=[64 + 16, 32, 32, 16, 3])
B, NI, NB, NO = 2, 40, 16, 8
WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
ROUTES = ["dense", "winner_gather"]
# values: f32 on both sides (ROADMAP); J, H, residuals, losses: 1e-4 scaled
V_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(ref):
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


# gradients: the JAX package's own comparison of its two coupled routes,
# tests/test_analytic.py:199-200, is looser than ROADMAP's, so it holds here
GRAD_TOL = dict(rtol=1e-3, atol=5e-4)


def run_route(route, fn, *args):
    """``fn(*args)`` with the JAX package's coupled path on ``route``."""
    jax_pipn_mod.FORCE_WINNER_GATHER = route == "winner_gather"
    try:
        return fn(*args)
    finally:
        jax_pipn_mod.FORCE_WINNER_GATHER = False


@pytest.fixture(scope="module")
def jax_side():
    model = jax_pipn_mod.pipn_foam(**CFG, scalers=jax_synthetic.make_scalers(),
                                   coupled_context=True)
    batches = [jax_synthetic.make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(s))
               for s in (21, 22, 23)]
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 2),
                                          jax_scaling.FixedLossScaler(WEIGHTS))
    state = fns.init_state(batches[0])
    return model, fns, state, batches


def port_model(params, **kw):
    model = pipn_foam(**CFG, scalers=make_scalers(), coupled_context=True, device="cpu", **kw)
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    return model


def port_batch(seed):
    return make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(seed))


def assert_trees_close(got, ref, path="", **kw):
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(got[k], ref[k], f"{path}/{k}", **kw)
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                       err_msg=f"{path}/{k}", **(kw or tol(ref[k])))


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


@pytest.mark.parametrize("route", ROUTES)
def test_coupled_derivative_apply_matches_jax(jax_side, route):
    model, _, state, batches = jax_side
    ref = run_route(route, model.derivative_apply, state.params, batches[0], None, True)
    port = port_model(state.params)
    with torch.no_grad():
        out = port.derivative_apply(port_batch(21))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol(r))


@pytest.mark.parametrize("route", ROUTES)
def test_coupled_losses_and_gradients_match_jax(jax_side, route):
    model, _, state, batches = jax_side
    w = jnp.asarray(WEIGHTS, jnp.float32)

    def total(params):
        losses, _ = jax_engine.compute_losses(model, params, batches[0], None,
                                              deterministic=True)
        return jnp.sum(w * losses), losses

    (_, ref_losses), ref_grads = run_route(
        route, jax.jit(jax.value_and_grad(total, has_aux=True)), state.params)
    port = port_model(state.params)
    losses, _ = engine.compute_losses(port, port_batch(21), deterministic=True)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses),
                               **tol(ref_losses))
    torch.sum(torch.tensor(WEIGHTS, dtype=torch.float32) * losses).backward()
    assert_trees_close(grads_to_flax(port.module),
                       jax.tree_util.tree_map(np.asarray, ref_grads), **GRAD_TOL)


def test_coupled_verbose_prediction_matches_jax(jax_side):
    model, fns, state, batches = jax_side
    ref_pred, ref_extras = fns.predict_batch(state.params, batches[1], True)
    port = port_model(state.params)
    pred, extras = engine.make_predict_functions(port).predict_batch(port_batch(22), True)
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref_pred.data), **V_TOL)
    r = np.asarray(ref_extras.data)
    np.testing.assert_allclose(extras.data.numpy(), r, **tol(r))


def test_coupled_three_adam_steps_match_jax(jax_side):
    model, fns, state, batches = jax_side
    port = port_model(state.params)
    pfns = engine.make_train_functions(port, engine.make_optimizer(port, 2),
                                       scaling.FixedLossScaler(WEIGHTS))
    pstate = pfns.init_state()
    jstate = jax.tree_util.tree_map(jnp.copy, state)
    for i, seed in enumerate((21, 22, 23)):
        jstate, ref_m = fns.train_step(jstate, batches[i])
        pstate, m = pfns.train_step(pstate, port_batch(seed))
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **tol(ref_m))
        assert_trees_close(params_to_flax(port.module),
                           jax.tree_util.tree_map(np.asarray, jstate.params))


def test_coupled_gradients_reach_both_uses_of_the_context_block():
    """The decoder's context block W0[:, L:] gets gradient through the ctx
    vector and through the coupling terms; the coupled path's gradient of it
    differs from the decoupled one's by the latter."""
    batch = port_batch(5)
    grads = []
    for coupled in (True, False):
        model = pipn_foam(**CFG, scalers=make_scalers(), coupled_context=coupled,
                          generator=torch.Generator().manual_seed(2), device="cpu")
        losses, _ = engine.compute_losses(model, batch, deterministic=True)
        losses.sum().backward()
        grads.append(model.module.decoder.linear_0.weight.grad[:, 16:].clone())
    assert (grads[0] - grads[1]).abs().max() > 1e-6


def winner_rows(model, batch):
    """The internal rows that win a channel of the pooled feature, per case."""
    fe = model.module.feature_extract
    pts = batch["C"]
    local = analytic.mlp_value(fe.local_feature.linears, pts, "silu")
    feats = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
    _, arg = pointnet_cuda.pointnet_global_plain(fe.global_feature.linears,
                                                 torch.cat([local, feats], dim=-1), "silu")
    return [sorted({int(r) for r in arg[b, 0] if r < NI}) for b in range(B)]


def test_exact_coupled_and_decoupled_agree_off_the_winner_rows():
    """Off a winner row nothing else depends on the point, so J agrees on
    all three paths (mirrors tests/test_analytic.py:203), and so does H on
    the two analytic ones; at the winner rows coupled and decoupled differ.
    The exact operator's H carries the reference's grad-of-sum mixed term
    at every row, so it is held to J only (as tests/test_analytic.py:85)."""
    batch = port_batch(7)
    outs = {}
    for name, kw in (("exact", dict(fast_derivatives=False)),
                     ("coupled", dict(coupled_context=True)),
                     ("decoupled", dict(coupled_context=False))):
        model = pipn_foam(**CFG, scalers=make_scalers(), device="cpu",
                          generator=torch.Generator().manual_seed(4), **kw)
        outs[name] = engine.model_derivatives(model, batch, True)
        outs[name] = [t.detach() for t in outs[name]]
    winners = winner_rows(model, batch)
    for b in range(B):
        clean = [i for i in range(NI) if i not in winners[b]]
        assert winners[b] and len(clean) > NI // 2
        for name in ("exact", "decoupled"):
            torch.testing.assert_close(outs[name][0], outs["coupled"][0], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(outs[name][1][b, clean], outs["coupled"][1][b, clean],
                                       rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(outs["decoupled"][2][b, clean],
                                   outs["coupled"][2][b, clean], rtol=1e-4, atol=1e-5)
        assert (outs["decoupled"][1][b, winners[b]]
                - outs["coupled"][1][b, winners[b]]).abs().max() > 1e-5
