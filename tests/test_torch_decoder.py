"""The port's decoder_prop (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode, decoupled-context mode: values over
[internal || boundary] rows, J and H in the (B, Ni, O, D) layout."""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.ops import decoder_pallas
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.ops import decoder_cuda

N_LOCAL = 24
LAYERS = [N_LOCAL + 48, 32, 16, 3]   # [local + context, hidden.., out]
JAX_ACT = {"silu": nn.silu, "tanh": nn.tanh}
# Values: f32 on both sides, sums at most 72 wide.
V_TOL = dict(rtol=1e-5, atol=1e-5)


def jh_tol(ref):
    """J and H: the activation rules chain products of derivatives through
    every layer, whose sums are taken in another order; scale the absolute
    part by the largest entry."""
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def make_inputs(b=2, ni=40, nb=24, d=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    return (f(b, ni, N_LOCAL), f(b, d, ni, N_LOCAL), f(b, d, ni, N_LOCAL),
            f(b, nb, N_LOCAL), f(b, 1, LAYERS[0] - N_LOCAL))


def make_params(seed=1):
    rng = np.random.default_rng(seed)
    return {f"linear_{i}": {
        "kernel": (rng.normal(size=(LAYERS[i], LAYERS[i + 1]))
                   / np.sqrt(LAYERS[i])).astype(np.float32),
        "bias": (rng.normal(size=LAYERS[i + 1]) * 0.1).astype(np.float32)}
        for i in range(len(LAYERS) - 1)}


@pytest.mark.parametrize("with_boundary", [True, False])
@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_decoder_prop_matches_jax(act, with_boundary):
    params = make_params()
    v, jt, ht, v_b, g = make_inputs()
    if not with_boundary:
        v_b = None
    jparams = {k: {kk: jnp.asarray(vv) for kk, vv in p.items()}
               for k, p in params.items()}
    ref = decoder_pallas.decoder_prop(
        jparams, LAYERS, N_LOCAL, jnp.asarray(v), jnp.asarray(jt),
        jnp.asarray(ht), None if v_b is None else jnp.asarray(v_b),
        jnp.asarray(g), JAX_ACT[act], tile=8, interpret=True)
    mlp = params_from_flax(params, MLP(LAYERS, activation=act,
                                       last_activation=False))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, t(v), t(jt),
                                        t(ht), t(v_b), t(g), act)
    n_rows = v.shape[1] + (0 if v_b is None else v_b.shape[1])
    assert out[0].shape == (2, n_rows, 3)
    assert out[1].shape == out[2].shape == (2, v.shape[1], 3, 2)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, **jh_tol(r))


def test_decoder_prop_boundary_rows_follow_internal_rows():
    """The merged value tensor holds the internal rows first; its boundary
    rows equal a value-only pass through the same decoder."""
    params = make_params()
    v, jt, ht, v_b, g = make_inputs()
    mlp = params_from_flax(params, MLP(LAYERS, activation="silu",
                                       last_activation=False))
    t = torch.from_numpy
    with torch.no_grad():
        full = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, t(v), t(jt),
                                         t(ht), t(v_b), t(g), "silu")
        internal = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, t(v), t(jt),
                                             t(ht), None, t(g), "silu")
        seg_in = torch.cat([t(v_b), t(g).expand(-1, v_b.shape[1], -1)], dim=-1)
        bnd = mlp(seg_in)
    n_int = v.shape[1]
    torch.testing.assert_close(full[0][:, :n_int], internal[0], **V_TOL)
    torch.testing.assert_close(full[0][:, n_int:], bnd, **V_TOL)
    for a, b in zip(full[1:], internal[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
