"""Parity of the port's data containers, scalers, analytic derivative rules
and physics residuals with the JAX package, on inputs made once with numpy."""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import foam_data as jax_foam_data
from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.physics import analytic as jax_analytic
from porous_cfd_tpu.physics import losses as jax_losses
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data import foam_data, synthetic
from porous_cfd_tpu_torch.data.scalers import (Normalizer, StandardScaler,
                                               scalers_from_meta)
from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.physics import analytic, losses
from porous_cfd_tpu_torch.physics.operators import split_derivatives

JAX_ACT = {"silu": nn.silu, "tanh": nn.tanh}
# Values: f32 on both sides, short sums.
V_TOL = dict(rtol=1e-5, atol=1e-5)


def d_tol(ref):
    """Derivatives and residuals: chained rule products, sums in another
    order; the absolute part scales with the largest entry."""
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def batches(seed=4):
    return (jax_synthetic.make_foam_batch(3, 12, 8, 4, rng=np.random.default_rng(seed)),
            synthetic.make_foam_batch(3, 12, 8, 4, rng=np.random.default_rng(seed)))


@pytest.mark.parametrize("item", ["C", "U", "boundaryId", "p", "sdf",
                                  "internal", "boundary", "obs", "inlet", "walls"])
def test_foam_data_lookup_matches_jax(item):
    ref, got = batches()
    r, g = ref[item], got[item]
    if isinstance(r, jax_foam_data.FoamData):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(r.data))
        assert g.labels == r.labels and list(g.domain) == list(r.domain)
        np.testing.assert_array_equal(g.domain[item].numpy(), np.asarray(r.domain[item]))
        np.testing.assert_array_equal(g["U"].numpy(), np.asarray(r["U"]))
    else:
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_foam_data_views_match_jax():
    ref, got = batches()
    for r, g in zip(jax_foam_data.split_contiguous(ref),
                    foam_data.split_contiguous(got)):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(r.data))
        assert list(g.domain) == list(r.domain)
    one = got["internal"]
    assert "C" in one and "internal" in one and "boundary" not in one
    sq = foam_data.FoamData(got.data[:1], got.labels,
                            {k: v[:1] for k, v in got.domain.items()}).squeeze()
    assert sq.data.shape == got.data.shape[1:]
    cases = [foam_data.FoamData(got.data[i], got.labels,
                                {k: v[i] for k, v in got.domain.items()})
             for i in range(3)]
    col = foam_data.collate(cases)
    torch.testing.assert_close(col.data, got.data, rtol=0, atol=0)
    host = got.numpy()
    assert isinstance(host.data, np.ndarray)
    np.testing.assert_array_equal(host["inlet"]["U"], np.asarray(ref["inlet"]["U"]))
    with pytest.raises(KeyError, match="Available labels"):
        got["nope"]


def test_scalers_match_jax():
    x = np.random.default_rng(0).normal(size=(4, 5, 2)).astype(np.float32)
    for ours, theirs in zip(synthetic.make_scalers().values(),
                            jax_synthetic.make_scalers().values()):
        t = torch.from_numpy(x)
        np.testing.assert_allclose(ours.transform(t).numpy(),
                                   np.asarray(theirs.transform(x)), **V_TOL)
        np.testing.assert_allclose(ours.inverse_transform(t).numpy(),
                                   np.asarray(theirs.inverse_transform(x)), **V_TOL)
    meta = {"Stats": {"U": {"Std": [1.0, 2.0], "Mean": [0.5, 0.0]},
                      "d": {"Min": [0.0], "Max": [4.0]}}}
    sc = scalers_from_meta(meta, {"Standardize": ["U"], "Scale": ["d"]})
    assert isinstance(sc["U"], StandardScaler) and isinstance(sc["d"], Normalizer)
    assert sc["U"][1].std.item() == 2.0 and sc["d"].range.item() == 4.0


@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_analytic_chain_matches_jax(act):
    rng = np.random.default_rng(2)
    layers = [2, 12, 12]
    params = {f"linear_{i}": {
        "kernel": rng.normal(size=(layers[i], layers[i + 1])).astype(np.float32),
        "bias": (rng.normal(size=layers[i + 1]) * 0.1).astype(np.float32)}
        for i in range(2)}
    jparams = {k: {kk: jnp.asarray(vv) for kk, vv in p.items()} for k, p in params.items()}
    mlp = params_from_flax(params, MLP(layers, activation=act))
    x = rng.uniform(-1, 1, size=(2, 7, 2)).astype(np.float32)
    j0, h0 = jax_analytic.identity_jacobian_t(jnp.asarray(x))
    ref = jax_analytic.mlp_prop_t(jparams, layers, jnp.asarray(x), j0, h0, JAX_ACT[act])
    with torch.no_grad():
        tj0, th0 = analytic.identity_jacobian_t(torch.from_numpy(x))
        np.testing.assert_array_equal(tj0.numpy(), np.asarray(j0))
        got = analytic.mlp_prop_t(mlp.linears, torch.from_numpy(x), tj0, th0, act)
        val = analytic.mlp_value(mlp.linears, torch.from_numpy(x), act)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **V_TOL)
    np.testing.assert_allclose(val.numpy(), np.asarray(ref[0]), **V_TOL)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **d_tol(np.asarray(r)))
    z = np.linspace(-6, 6, 41).astype(np.float32)
    jr = jax_analytic.ACTIVATION_RULES[JAX_ACT[act]](jnp.asarray(z))
    for g, r in zip(analytic.ACTIVATION_RULES[act](torch.from_numpy(z)), jr):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **V_TOL)


def test_residuals_and_losses_match_jax():
    rng = np.random.default_rng(3)
    ref_b, got_b = batches(5)
    u = rng.normal(size=(3, 12, 2)).astype(np.float32)
    jac = rng.normal(size=(3, 12, 3, 2)).astype(np.float32)
    lap = rng.normal(size=(3, 12, 3, 2)).astype(np.float32)
    js, ts = jax_synthetic.make_scalers(), synthetic.make_scalers()
    jm = jax_losses.MomentumLossFixed(1e-3, 14000.0, 17.11, js["U"], js["C"], js["p"])
    tm = losses.MomentumLossFixed(1e-3, 14000.0, 17.11, ts["U"], ts["C"], ts["p"])
    jc = jax_losses.ContinuityLossStandardized(js["U"], js["C"])
    tc = losses.ContinuityLossStandardized(ts["U"], ts["C"])
    ju_jac, ju_lap, jp_grad = (jnp.asarray(jac[..., :2, :]), jnp.asarray(lap[..., :2, :]),
                               jnp.asarray(jac[..., 2, :]))
    tu_jac, tu_lap, tp_grad = split_derivatives(torch.from_numpy(jac),
                                                torch.from_numpy(lap), 2)
    np.testing.assert_array_equal(tp_grad.numpy(), np.asarray(jp_grad))
    internal_j, internal_t = ref_b["internal"], got_b["internal"]
    r_ref = np.asarray(jm.residual(internal_j, jnp.asarray(u), ju_jac, ju_lap, jp_grad))
    r_got = tm.residual(internal_t, torch.from_numpy(u), tu_jac, tu_lap, tp_grad).numpy()
    np.testing.assert_allclose(r_got, r_ref, **d_tol(r_ref))
    np.testing.assert_allclose(
        tm(internal_t, torch.from_numpy(u), tu_jac, tu_lap, tp_grad).numpy(),
        np.asarray(jm(internal_j, jnp.asarray(u), ju_jac, ju_lap, jp_grad)), rtol=1e-4)
    np.testing.assert_allclose(tc.residual(tu_jac).numpy(),
                               np.asarray(jc.residual(ju_jac)), **V_TOL)
    np.testing.assert_allclose(tc(tu_jac).item(), float(jc(ju_jac)), rtol=1e-5)
    a, b = torch.from_numpy(u), torch.from_numpy(u[::-1].copy())
    for name in ("mse", "mae"):
        np.testing.assert_allclose(getattr(losses, name)(a, b).item(),
                                   float(getattr(jax_losses, name)(u, u[::-1])),
                                   rtol=1e-6)
    np.testing.assert_allclose(losses.vector_loss(a, b, "mae").numpy(),
                               np.asarray(jax_losses.vector_loss(u, u[::-1], "mae")),
                               rtol=1e-6)
