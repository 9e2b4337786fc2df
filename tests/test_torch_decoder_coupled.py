"""The port's decoder_prop in its two max-pool-coupled modes (the plain
version, on the CPU) against the JAX package's Pallas kernel in interpret
mode: ``j0_add`` (additive layer-0 J/H terms, with ``j0_dtype=float32``) and
``ctx_width`` (J/H rows widened by the context block's input derivatives).
Values over [internal || boundary] rows, J and H, and every gradient: the
inputs, the additive terms (dja/dha), the context derivatives and every
weight, the context block of W0 included. Mirrors
tests/test_decoder_pallas.py:169-259."""
import flax.linen as nn
import jax
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
G = LAYERS[0] - N_LOCAL
JAX_ACT = {"silu": nn.silu, "tanh": nn.tanh}
B, NI, NB, D = 2, 24, 8, 2
# ROADMAP's tolerances: values f32 on both sides, sums at most 72 wide
V_TOL = dict(rtol=1e-5, atol=1e-5)


def scaled_tol(ref):
    """J, H and gradients: the rules chain products of derivatives through
    every layer, summed in another order; the absolute part scales with the
    largest entry."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def make_params(seed=1):
    rng = np.random.default_rng(seed)
    return {f"linear_{i}": {
        "kernel": (rng.normal(size=(LAYERS[i], LAYERS[i + 1]))
                   / np.sqrt(LAYERS[i])).astype(np.float32),
        "bias": (rng.normal(size=LAYERS[i + 1]) * 0.1).astype(np.float32)}
        for i in range(len(LAYERS) - 1)}


def make_inputs(mode, seed=0):
    """(v, jt, ht, v_b, g, extra_j, extra_h): the extra pair is (B, D, Ni,
    F1) dense addends for j0_add, or (B, D, Ni, G) context derivatives that
    are nonzero at a few winner-like rows only for ctx_width."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    base = (f(B, NI, N_LOCAL), f(B, D, NI, N_LOCAL), f(B, D, NI, N_LOCAL),
            f(B, NB, N_LOCAL), f(B, 1, G))
    if mode == "j0_add":
        return base + (f(B, D, NI, LAYERS[1]), f(B, D, NI, LAYERS[1]))
    jc = np.zeros((B, D, NI, G), np.float32)
    hc = np.zeros((B, D, NI, G), np.float32)
    rows = rng.choice(NI, size=6, replace=False)
    jc[:, :, rows] = f(B, D, 6, G) * 0.6
    hc[:, :, rows] = f(B, D, 6, G) * 0.6
    return base + (jc, hc)


def jax_call(mode, params, v, jt, ht, v_b, g, xj, xh, act):
    kw = (dict(j0_add=xj, h0_add=xh, j0_dtype=jnp.float32) if mode == "j0_add"
          else dict(jctx_t=xj, hctx_t=xh))
    return decoder_pallas.decoder_prop(params, LAYERS, N_LOCAL, v, jt, ht, v_b, g,
                                       JAX_ACT[act], tile=8, interpret=True, **kw)


def port_call(mode, mlp, v, jt, ht, v_b, g, xj, xh, act):
    kw = (dict(j0_add=xj, h0_add=xh) if mode == "j0_add" else dict(jctx_t=xj, hctx_t=xh))
    return decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v, jt, ht, v_b, g, act, **kw)


def port_mlp(params, act):
    return params_from_flax(params, MLP(LAYERS, activation=act, last_activation=False))


@pytest.mark.parametrize("with_boundary", [True, False])
@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("mode", ["j0_add", "ctx_width"])
def test_coupled_modes_match_jax(mode, act, with_boundary):
    params = make_params()
    inputs = list(make_inputs(mode))
    if not with_boundary:
        inputs[3] = None
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_call(mode, jp, *[None if a is None else jnp.asarray(a) for a in inputs], act)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out = port_call(mode, port_mlp(params, act), *map(t, inputs), act)
    assert out[0].shape == (B, NI + (NB if with_boundary else 0), 3)
    assert out[1].shape == out[2].shape == (B, NI, 3, D)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **scaled_tol(r))


@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("mode", ["j0_add", "ctx_width"])
def test_coupled_mode_gradients_match_jax(mode, act):
    """d/d(v, jt, ht, v_b, g, extra_j, extra_h, W, b) of a loss on all three
    outputs, dropout off, against jax.grad through the Pallas kernel's
    custom VJP (dja/dha are the kernel's own outputs in the j0_add mode)."""
    params = make_params()
    inputs = make_inputs(mode, seed=3)
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((B, NI + NB, 3), (B, NI, 3, D), (B, NI, 3, D))]

    def loss(p, *xs):
        ov, oj, oh = jax_call(mode, p, *xs, act)
        return (jnp.sum(ov * cots[0]) + jnp.sum(jnp.sin(oj) * cots[1])
                + 0.5 * jnp.sum(oh ** 2 * cots[2]))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax.grad(loss, argnums=tuple(range(8)))(jp, *map(jnp.asarray, inputs))
    mlp = port_mlp(params, act)
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    ov, oj, oh = port_call(mode, mlp, *ts, act)
    c = [torch.from_numpy(a) for a in cots]
    (torch.sum(ov * c[0]) + torch.sum(torch.sin(oj) * c[1])
     + 0.5 * torch.sum(oh ** 2 * c[2])).backward()
    names = ["v", "jt", "ht", "v_b", "g", "extra_j", "extra_h"]
    for name, t, r in zip(names, ts, ref[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=name,
                                   **scaled_tol(r))
    for i, lin in enumerate(mlp.linears):
        rk = np.asarray(ref[0][f"linear_{i}"]["kernel"])
        rb = np.asarray(ref[0][f"linear_{i}"]["bias"])
        np.testing.assert_allclose(lin.weight.grad.numpy().T, rk, err_msg=f"kernel {i}",
                                   **scaled_tol(rk))
        np.testing.assert_allclose(lin.bias.grad.numpy(), rb, err_msg=f"bias {i}",
                                   **scaled_tol(rb))
    # the context block of W0 gets gradient from the value rows (through ctx)
    # and, in the ctx_width mode, from the J/H rows too
    assert np.abs(ref[0]["linear_0"]["kernel"][N_LOCAL:]).max() > 0


def test_coupled_modes_equal_each_other_and_the_dense_form():
    """The j0_add terms formed from the context derivatives (jctx @ W0g)
    give the ctx_width mode's result, and both reduce to the decoupled
    decoder where the context derivatives are zero."""
    params = make_params()
    v, jt, ht, v_b, g, jc, hc = map(torch.from_numpy, make_inputs("ctx_width"))
    mlp = port_mlp(params, "silu")
    w0g = mlp.linear_0.weight[:, N_LOCAL:]
    with torch.no_grad():
        ctx = port_call("ctx_width", mlp, v, jt, ht, v_b, g, jc, hc, "silu")
        add = port_call("j0_add", mlp, v, jt, ht, v_b, g, jc @ w0g.t(), hc @ w0g.t(), "silu")
        zero = port_call("ctx_width", mlp, v, jt, ht, v_b, g, 0 * jc, 0 * hc, "silu")
        plain = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v, jt, ht, v_b, g, "silu")
    for a, b in zip(ctx, add):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(zero, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (ctx[1] - plain[1]).abs().max() > 1e-3


def test_coupled_modes_refuse_bad_arguments():
    params = make_params()
    v, jt, ht, v_b, g, jc, hc = map(torch.from_numpy, make_inputs("ctx_width"))
    ja = torch.zeros((B, D, NI, LAYERS[1]))
    mlp = port_mlp(params, "silu")
    with pytest.raises(ValueError, match="exclude"):
        decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v, jt, ht, v_b, g, "silu",
                                  jctx_t=jc, hctx_t=hc, j0_add=ja, h0_add=ja)
    with pytest.raises(ValueError, match="pairs"):
        decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v, jt, ht, v_b, g, "silu", j0_add=ja)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v.to(meta), jt.to(meta), ht.to(meta),
                                  None, g.to(meta), "silu", j0_add=ja.to(meta),
                                  h0_add=ja.to(meta))
