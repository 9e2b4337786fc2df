"""The port's pointnet_global (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode: the pooled max and the first
maximal row per channel."""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.ops import pointnet_pallas
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.ops import pointnet_cuda
from porous_cfd_tpu_torch.physics import analytic

LAYERS = [16, 24, 32]
JAX_ACT = {"silu": nn.silu, "tanh": nn.tanh}
# Values: both sides are f32 and the sums here are at most 24 wide.
RTOL, ATOL = 1e-5, 1e-5


def make_params(layers, seed=1):
    rng = np.random.default_rng(seed)
    return {f"linear_{i}": {
        "kernel": (rng.normal(size=(layers[i], layers[i + 1]))
                   / np.sqrt(layers[i])).astype(np.float32),
        "bias": (rng.normal(size=layers[i + 1]) * 0.1).astype(np.float32)}
        for i in range(len(layers) - 1)}


def port_mlp(params, layers, act):
    return params_from_flax(params, MLP(layers, activation=act))


def run_both(params, layers, x, act):
    ref_m, ref_a = pointnet_pallas.pointnet_global(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()},
        layers, jnp.asarray(x), JAX_ACT[act], tile=8, interpret=True,
        return_argmax=True)
    with torch.no_grad():
        m, a = pointnet_cuda.pointnet_global(
            port_mlp(params, layers, act).linears, torch.from_numpy(x), act)
    return np.asarray(ref_m), np.asarray(ref_a), m.numpy(), a.numpy()


@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("b,n", [(2, 64), (1, 13), (3, 300)])
def test_pointnet_global_matches_jax(act, b, n):
    """N = 13 and 300 are not multiples of the JAX tile (8): the ragged edge
    must never win."""
    x = np.random.default_rng(0).normal(size=(b, n, LAYERS[0])).astype(np.float32)
    params = make_params(LAYERS)
    ref_m, ref_a, m, a = run_both(params, LAYERS, x, act)
    assert m.shape == (b, 1, LAYERS[-1]) and a.shape == m.shape
    assert a.dtype == np.int32
    np.testing.assert_allclose(m, ref_m, rtol=RTOL, atol=ATOL)
    # the argmax is compared wherever the top two rows differ by more than
    # the value tolerance (closer pairs may legitimately swap)
    with torch.no_grad():
        g = analytic.mlp_value(port_mlp(params, LAYERS, act).linears,
                               torch.from_numpy(x), act)
    top2 = torch.topk(g, 2, dim=-2).values.numpy()
    decided = (top2[:, 0] - top2[:, 1]) > RTOL * np.abs(ref_m[:, 0]) + ATOL
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(a[:, 0][decided], ref_a[:, 0][decided])


@pytest.mark.parametrize("act", ["tanh", "silu"])
def test_pointnet_global_ties_take_the_first_row(act):
    """Exact ties: duplicated input rows give bit-identical outputs, and a
    saturated tanh gives exactly 1.0 on every row past a threshold. The first
    maximal row must win in both packages."""
    layers = [1, 4]
    params = {"linear_0": {"kernel": np.array([[100.0, 100.0, 3.0, -3.0]], np.float32),
                           "bias": np.zeros(4, np.float32)}}
    col = np.array([-1.0, -0.5, 0.5, 0.2, 0.7, 0.5, -1.0, 0.7, 0.5], np.float32)
    x = np.stack([col, col[::-1].copy()])[..., None]          # (2, 9, 1)
    ref_m, ref_a, m, a = run_both(params, layers, x, act)
    np.testing.assert_allclose(m, ref_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(a, ref_a)
    # case 0, channel 2 (3x): rows 4 and 7 tie at the maximum 0.7 -> row 4
    assert a[0, 0, 2] == 4
    # case 1 is reversed: the maximum 0.7 first appears at row 1
    assert a[1, 0, 2] == 1
    if act == "tanh":
        # tanh(100 x) is exactly 1.0 for x >= 0.2: first such row
        assert a[0, 0, 0] == 2 and a[1, 0, 0] == 0
        # channel 3 (-3x): the minimum -1.0 first appears at row 0 / row 2
        assert a[0, 0, 3] == 0 and a[1, 0, 3] == 2


def grad_tol(ref):
    """Gradients: sums over rows in another order than the JAX kernel's
    per-tile accumulation; scale the absolute part by the largest entry."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_pointnet_global_gradients_match_jax(act):
    """d/d(x, W, b) of a scalar of the pooled max, against jax.grad through
    the Pallas kernel's custom VJP (interpret mode)."""
    import jax

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, LAYERS[0])).astype(np.float32)
    cot = rng.normal(size=(2, 1, LAYERS[-1])).astype(np.float32)
    params = make_params(LAYERS)

    def loss(p, xx):
        m = pointnet_pallas.pointnet_global(p, LAYERS, xx, JAX_ACT[act], tile=8,
                                            interpret=True)
        return jnp.sum(m * cot) + jnp.sum(jnp.sin(m))

    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}
    ref_p, ref_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    mlp = port_mlp(params, LAYERS, act)
    xt = torch.from_numpy(x).requires_grad_()
    m, _ = pointnet_cuda.pointnet_global(mlp.linears, xt, act)
    (torch.sum(m * torch.from_numpy(cot)) + torch.sum(torch.sin(m))).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), **grad_tol(ref_x))
    for i, lin in enumerate(mlp.linears):
        rk = np.asarray(ref_p[f"linear_{i}"]["kernel"])
        rb = np.asarray(ref_p[f"linear_{i}"]["bias"])
        np.testing.assert_allclose(lin.weight.grad.numpy().T, rk, **grad_tol(rk))
        np.testing.assert_allclose(lin.bias.grad.numpy(), rb, **grad_tol(rb))


def test_pointnet_global_tie_gradient_goes_to_the_first_row():
    """Exact ties: the cotangent goes whole to the first maximal row, as in
    the JAX Pallas kernel (not split the way jnp.max's VJP splits it)."""
    import jax

    layers = [1, 4]
    params = {"linear_0": {"kernel": np.array([[100.0, 100.0, 3.0, -3.0]], np.float32),
                           "bias": np.zeros(4, np.float32)}}
    col = np.array([-1.0, -0.5, 0.5, 0.2, 0.7, 0.5, -1.0, 0.7, 0.5], np.float32)
    x = np.stack([col, col[::-1].copy()])[..., None]          # (2, 9, 1)
    jp = {"linear_0": {k: jnp.asarray(v) for k, v in params["linear_0"].items()}}
    ref_x = jax.grad(lambda xx: jnp.sum(pointnet_pallas.pointnet_global(
        jp, layers, xx, nn.tanh, tile=8, interpret=True)))(jnp.asarray(x))
    mlp = port_mlp(params, layers, "tanh")
    xt = torch.from_numpy(x).requires_grad_()
    pointnet_cuda.pointnet_global(mlp.linears, xt, "tanh")[0].sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), rtol=1e-5, atol=1e-6)
    # case 0, channel 2 (3x): rows 4 and 7 tie at 0.7, and only row 4 (the
    # first) gets the cotangent; row 7 wins no other channel
    assert float(xt.grad[0, 7, 0]) == 0.0 and float(xt.grad[0, 4, 0]) != 0.0


@pytest.mark.parametrize("kind,b,n,f", [("random", 3, 40, 24), ("n_lt_f", 2, 7, 64),
                                        ("r_is_1", 2, 50, 16), ("r_is_f", 2, 90, 32)])
def test_pointnet_winner_rows_matches_numpy(kind, b, n, f):
    """The plain compaction the backward kernel is held to: each case's
    distinct winner rows ascending (np.unique), each channel's index among
    them, their count."""
    rng = np.random.default_rng(f)
    if kind == "r_is_1":
        arg = np.full((b, 1, f), 5)
    elif kind == "r_is_f":
        arg = np.stack([rng.permutation(n)[:f] for _ in range(b)])[:, None]
    else:
        arg = rng.integers(0, n, size=(b, 1, f))
    rows, slot, count = pointnet_cuda.pointnet_winner_rows(
        torch.from_numpy(arg.astype(np.int32)))
    assert rows.shape == (b, f) and slot.shape == (b, f) and count.shape == (b,)
    for i in range(b):
        uniq, inverse = np.unique(arg[i, 0], return_inverse=True)
        assert int(count[i]) == len(uniq)
        np.testing.assert_array_equal(rows[i, :len(uniq)].numpy(), uniq)
        assert (rows[i, len(uniq):] == -1).all()
        np.testing.assert_array_equal(slot[i].numpy(), inverse)
        np.testing.assert_array_equal(rows[i][slot[i]].numpy(), arg[i, 0])
    if kind == "r_is_1":
        assert count.tolist() == [1] * b
    if kind == "r_is_f":
        assert count.tolist() == [f] * b
