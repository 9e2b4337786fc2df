"""The port's decoder_prop (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode, decoupled-context mode: values over
[internal || boundary] rows, J and H in the (B, Ni, O, D) layout, and the
gradients with dropout off. The dropout masks (``ops/dropout.py``) differ
from the JAX kernel's TPU random bits by design and are held to Philox's
known answers, their keep rate and their sharing rules instead."""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.ops import decoder_pallas
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.physics import analytic
from porous_cfd_tpu_torch.ops import decoder_cuda, dropout

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


def grad_tol(ref):
    """Gradients: the reverse sweep chains third-derivative rules through
    every layer and sums over rows in another order than the JAX kernel's
    per-tile accumulation; scale the absolute part by the largest entry."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_decoder_prop_gradients_match_jax(act):
    """d/d(v, jt, ht, v_b, g, W, b) of a loss on all three outputs, dropout
    off, against jax.grad through the Pallas kernel's custom VJP."""
    import jax

    params = make_params()
    inputs = make_inputs()
    rng = np.random.default_rng(5)
    n_rows = inputs[0].shape[1] + inputs[3].shape[1]
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((2, n_rows, 3), (2, inputs[0].shape[1], 3, 2),
                      (2, inputs[0].shape[1], 3, 2))]

    def loss(p, v, jt, ht, v_b, g):
        ov, oj, oh = decoder_pallas.decoder_prop(p, LAYERS, N_LOCAL, v, jt, ht, v_b, g,
                                                 JAX_ACT[act], tile=8, interpret=True)
        return (jnp.sum(ov * cots[0]) + jnp.sum(jnp.sin(oj) * cots[1])
                + 0.5 * jnp.sum(oh ** 2 * cots[2]))

    jp = {k: {kk: jnp.asarray(vv) for kk, vv in p.items()} for k, p in params.items()}
    ref = jax.grad(loss, argnums=tuple(range(6)))(jp, *map(jnp.asarray, inputs))
    mlp = params_from_flax(params, MLP(LAYERS, activation=act, last_activation=False))
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    ov, oj, oh = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, *ts, act)
    c = [torch.from_numpy(a) for a in cots]
    (torch.sum(ov * c[0]) + torch.sum(torch.sin(oj) * c[1])
     + 0.5 * torch.sum(oh ** 2 * c[2])).backward()
    for t, r in zip(ts, ref[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **grad_tol(r))
    for i, lin in enumerate(mlp.linears):
        rk = np.asarray(ref[0][f"linear_{i}"]["kernel"])
        rb = np.asarray(ref[0][f"linear_{i}"]["bias"])
        np.testing.assert_allclose(lin.weight.grad.numpy().T, rk, **grad_tol(rk))
        np.testing.assert_allclose(lin.bias.grad.numpy(), rb, **grad_tol(rb))


# ---------------------------------------------------------------------------
# dropout: the counter-based masks of ops/dropout.py


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer values of Philox4x32-10."""
    got = dropout.philox4x32_10([torch.tensor(c) for c in counter], key)
    assert tuple(int(t) for t in got) == want


@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_dropout_keep_fraction(rate):
    """Within 4 sigma of 1 - rate: a signed threshold compare would keep
    about 45% at rate 0.05 and nothing at 0.5."""
    m = dropout.keep_mask(12345, 0, 4, 500, 128, rate)
    n = m.numel()
    kept = float((m > 0).float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(kept - (1 - rate)) < 4 * sigma
    assert torch.all((m == 0) | (m == torch.tensor(1 / (1 - rate), dtype=torch.float32)))


def test_dropout_masks_depend_on_seed_layer_and_nothing_else():
    a = dropout.keep_mask(7, 0, 2, 64, 32, 0.5)
    torch.testing.assert_close(a, dropout.keep_mask(7, 0, 2, 64, 32, 0.5), rtol=0, atol=0)
    for other in (dropout.keep_mask(8, 0, 2, 64, 32, 0.5),
                  dropout.keep_mask(7, 1, 2, 64, 32, 0.5),
                  dropout.keep_mask(dropout.fold_in(7, 1), 0, 2, 64, 32, 0.5)):
        assert (a != other).float().mean() > 0.3
    # rows are merged-row indices: a mask over fewer rows is a prefix
    torch.testing.assert_close(dropout.keep_mask(7, 0, 2, 40, 32, 0.5), a[:, :40],
                               rtol=0, atol=0)


def test_dropout_one_mask_for_a_points_value_j_and_h_rows():
    """Through one layer (identity weights, tanh): a dropped column is zero
    in v, J and H of that point, and the boundary rows continue the internal
    rows' merged-row mask."""
    v = torch.rand(2, 10, 8) + 0.5
    j, h = torch.rand(2, 10, 2, 8) + 0.5, torch.rand(2, 10, 2, 8) + 0.5
    v2, j2, h2 = analytic_dropout(v, j, h)
    mask = dropout.keep_mask(3, 0, 2, 10, 8, 0.5)
    dropped = mask == 0
    assert dropped.any() and (~dropped).any()
    assert torch.all((v2 == 0) == dropped)
    assert torch.all((j2 == 0) == dropped[:, :, None, :].expand_as(j2))
    assert torch.all((h2 == 0) == dropped[:, :, None, :].expand_as(h2))


def analytic_dropout(v, j, h):
    return analytic.dropout_prop_merged(3, 0, 0.5, v, j, h, v.shape[1])


def test_dropout_forward_and_backward_share_the_masks():
    """A finite difference on a bias matches autograd with dropout on: the
    backward sees the forward's masks."""
    params = make_params()
    v, jt, ht, v_b, g = (torch.from_numpy(a).double() for a in make_inputs(b=1, ni=30, nb=8))
    mlp = params_from_flax(params, MLP(LAYERS, activation="silu",
                                       last_activation=False)).double()
    drop = [0.5, 0.5, 0.0]

    def scalar():
        out = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v, jt, ht, v_b, g, "silu",
                                        drop, False, 99)
        return sum((o ** 2).sum() for o in out)

    scalar().backward()
    bias = mlp.linear_1.bias
    ad = bias.grad[0].item()
    eps = 1e-6
    with torch.no_grad():
        bias[0] += eps
        up = scalar().item()
        bias[0] -= 2 * eps
        down = scalar().item()
    fd = (up - down) / (2 * eps)
    assert abs(fd - ad) < 1e-5 * max(1.0, abs(ad))
    det = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v, jt, ht, v_b, g, "silu")
    with torch.no_grad():
        drp = decoder_cuda.decoder_prop(mlp.linears, N_LOCAL, v, jt, ht, v_b, g, "silu",
                                        drop, False, 99)
    assert (det[0] - drp[0]).abs().max() > 1e-3
