"""The port's neural_ops_prop (its plain version, on the CPU) against the JAX
package's Pallas trunk kernel in interpret mode: values over [internal ||
boundary] rows, J and H in the (B, Ni, O, D) layout, and the gradients of
the inputs, ctx (through geom), par, the operators and the reduction, with
dropout off. The trunk's dropout masks (``ops/dropout.py`` on the trunk's
own stream) differ from the JAX kernel's TPU random bits by design and are
held to their keep rate and their sharing rules instead."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.ops import neural_op_pallas
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.models.mlp import NeuralOperatorSequential, dense
from porous_cfd_tpu_torch.ops import dropout, neural_op_cuda

D, OUT = 2, 3
JAX_ACT = {"silu": nn.silu, "tanh": nn.tanh}
# (local, geometry, trunk width): the JAX kernel's own test shape, and the
# full-width trunk's 176 + 176 -> 352 in small: 20 + 20 -> 40, widths that
# are not multiples of 32 (nor, like 176 and 352, of the CUDA kernel's
# 128-column chunk)
WIDTHS = [(12, 20, 32), (20, 20, 40)]
# Values: f32 on both sides, sums at most 40 wide.
V_TOL = dict(rtol=1e-5, atol=1e-5)


def d_tol(ref):
    """J, H and gradients: the activation rules chain products of
    derivatives through every layer, and sums over rows and widths are taken
    in another order; scale the absolute part by the largest entry."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


class Trunk(torch.nn.Module):
    """The flax paths ``neural_ops/operator_i/Dense_0`` and ``reduction``."""

    def __init__(self, n_ops, f, act):
        super().__init__()
        self.neural_ops = NeuralOperatorSequential(n_ops, f, (0.0,) * n_ops, act)
        self.reduction = dense(f, OUT)


def make_params(l_in, f, n_ops, seed=1):
    rng = np.random.default_rng(seed)
    trunk = {}
    for i in range(n_ops):
        a = l_in if i == 0 else f
        trunk[f"operator_{i}"] = {"Dense_0": {
            "kernel": (rng.normal(size=(a, f)) / np.sqrt(a)).astype(np.float32),
            "bias": (rng.normal(size=f) * 0.1).astype(np.float32)}}
    return {"neural_ops": trunk, "reduction": {
        "kernel": (rng.normal(size=(f, OUT)) / np.sqrt(f)).astype(np.float32),
        "bias": (rng.normal(size=OUT) * 0.1).astype(np.float32)}}


def make_inputs(l_loc, l_geom, f, b=2, ni=24, nb=16, seed=0):
    """(v, jt, ht, v_b, geom, par) with jt/ht in the (B, D, Ni, L) layout."""
    rng = np.random.default_rng(seed)
    g = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    return (g(b, ni, l_loc), g(b, D, ni, l_loc), g(b, D, ni, l_loc), g(b, nb, l_loc),
            g(b, 1, l_geom), g(b, 1, f) + 1.0)


def port_trunk(params, n_ops, f, act):
    return params_from_flax(params, Trunk(n_ops, f, act))


def jax_trunk(params, n_ops, l_loc, inputs, act):
    v, jt, ht, v_b, geom, par = inputs
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return neural_op_pallas.neural_ops_prop(
        jp["neural_ops"], n_ops, l_loc, v, jt, ht, v_b, geom, par, JAX_ACT[act],
        (0.0,) * n_ops, True, jp["reduction"], tile=8, interpret=True)


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_neural_ops_prop_matches_jax(act, widths):
    l_loc, l_geom, f = widths
    n_ops = 3
    params = make_params(l_loc + l_geom, f, n_ops)
    inputs = make_inputs(l_loc, l_geom, f)
    jin = tuple(map(jnp.asarray, inputs))
    ref = [np.asarray(r) for r in jax_trunk(params, n_ops, l_loc, jin, act)]
    trunk = port_trunk(params, n_ops, f, act)
    with torch.no_grad():
        out = neural_op_cuda.neural_ops_prop(trunk.neural_ops.linears, trunk.reduction, l_loc,
                                             *map(torch.from_numpy, inputs), act)
    assert out[0].shape == (2, 40, OUT)
    assert out[1].shape == out[2].shape == (2, 24, OUT, D)
    np.testing.assert_allclose(out[0].numpy(), ref[0], **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), r, **d_tol(r))


@pytest.mark.parametrize("with_boundary", [True, False])
def test_odd_point_counts_and_no_boundary(with_boundary):
    l_loc, l_geom, f = WIDTHS[1]
    n_ops = 2
    params = make_params(l_loc + l_geom, f, n_ops, seed=3)
    inputs = list(make_inputs(l_loc, l_geom, f, b=1, ni=13, nb=5, seed=4))
    if not with_boundary:
        inputs[3] = None
    jin = tuple(None if a is None else jnp.asarray(a) for a in inputs)
    ref = [np.asarray(r) for r in jax_trunk(params, n_ops, l_loc, jin, "tanh")]
    trunk = port_trunk(params, n_ops, f, "tanh")
    with torch.no_grad():
        out = neural_op_cuda.neural_ops_prop(
            trunk.neural_ops.linears, trunk.reduction, l_loc,
            *[None if a is None else torch.from_numpy(a) for a in inputs], "tanh")
    assert out[0].shape == (1, 13 + (5 if with_boundary else 0), OUT)
    np.testing.assert_allclose(out[0].numpy(), ref[0], **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), r, **d_tol(r))


@pytest.mark.parametrize("widths", WIDTHS)
def test_neural_ops_prop_gradients_match_jax(widths):
    """d/d(v, jt, ht, v_b, geom, par, W, b, reduction) of a loss on all three
    outputs, dropout off, against jax.grad through the Pallas kernel's
    custom VJP; par's cotangent collects the v, J and H streams."""
    l_loc, l_geom, f = widths
    n_ops = 3
    act = "silu"
    params = make_params(l_loc + l_geom, f, n_ops)
    inputs = make_inputs(l_loc, l_geom, f)
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((2, 40, OUT), (2, 24, OUT, D), (2, 24, OUT, D))]

    def loss(p, *ins):
        ov, oj, oh = jax_trunk(p, n_ops, l_loc, ins, act)
        return (jnp.sum(ov * cots[0]) + jnp.sum(jnp.sin(oj) * cots[1])
                + 0.5 * jnp.sum(oh ** 2 * cots[2]))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax.grad(loss, argnums=tuple(range(7)))(jp, *map(jnp.asarray, inputs))
    trunk = port_trunk(params, n_ops, f, act)
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    ov, oj, oh = neural_op_cuda.neural_ops_prop(trunk.neural_ops.linears, trunk.reduction,
                                                l_loc, *ts, act)
    c = [torch.from_numpy(a) for a in cots]
    (torch.sum(ov * c[0]) + torch.sum(torch.sin(oj) * c[1])
     + 0.5 * torch.sum(oh ** 2 * c[2])).backward()
    for name, t, r in zip(("v", "jt", "ht", "v_b", "geom", "par"), ts, ref[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=name, **d_tol(r))
    for i, lin in enumerate(trunk.neural_ops.linears):
        r = ref[0]["neural_ops"][f"operator_{i}"]["Dense_0"]
        np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(r["kernel"]),
                                   **d_tol(r["kernel"]))
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(r["bias"]),
                                   **d_tol(r["bias"]))
    r = ref[0]["reduction"]
    np.testing.assert_allclose(trunk.reduction.weight.grad.numpy().T, np.asarray(r["kernel"]),
                               **d_tol(r["kernel"]))
    np.testing.assert_allclose(trunk.reduction.bias.grad.numpy(), np.asarray(r["bias"]),
                               **d_tol(r["bias"]))


# ---------------------------------------------------------------------------
# dropout: the trunk's masks


def test_trunk_mask_keep_rate_at_the_trunk_rate():
    """A full trunk mask at rate 0.1 keeps within 4 sigma of 0.9 (a signed
    threshold compare would keep about 40%)."""
    seed = neural_op_cuda.trunk_seed(8421)
    m = dropout.keep_mask(seed, 1, 4, 600, 352, 0.1)
    kept = float((m > 0).float().mean())
    sigma = (0.1 * 0.9 / m.numel()) ** 0.5
    assert abs(kept - 0.9) < 4 * sigma
    assert torch.all((m == 0) | (m == torch.tensor(1 / 0.9, dtype=torch.float32)))


def test_trunk_masks_have_their_own_stream_and_share_a_points_rows():
    """The trunk's stream differs from the step seed's; a dropped column is
    zero in v, J and H of its point, the boundary rows continue the internal
    rows' merged-row mask, and the same seed gives the same masks."""
    l_loc, l_geom, f = WIDTHS[1]
    params = make_params(l_loc + l_geom, f, 1)
    trunk = port_trunk(params, 1, f, "silu")
    v, jt, ht, v_b, geom, par = map(torch.from_numpy, make_inputs(l_loc, l_geom, f))
    assert neural_op_cuda.trunk_seed(3) != 3
    # identity-like reduction: read the operator's output through one column
    with torch.no_grad():
        trunk.reduction.weight.zero_()
        trunk.reduction.weight[0, 0] = 1.0
        trunk.reduction.bias.zero_()
    args = (trunk.neural_ops.linears, trunk.reduction, l_loc, v, jt, ht, v_b, geom, par,
            "silu", [0.5], False, 3)
    with torch.no_grad():
        out = neural_op_cuda.neural_ops_prop(*args)
        again = neural_op_cuda.neural_ops_prop(*args)
        det = neural_op_cuda.neural_ops_prop(*args[:10])
    for a, b in zip(out, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    mask = dropout.keep_mask(neural_op_cuda.trunk_seed(3), 0, 2, 40, f, 0.5)[..., 0]
    dropped = mask == 0
    assert dropped.any() and (~dropped).any()
    torch.testing.assert_close(out[0][..., 0], det[0][..., 0] * mask)
    assert torch.all((out[1][:, :, 0] == 0) == dropped[:, :24, None])
    assert torch.all((out[2][:, :, 0] == 0) == dropped[:, :24, None])


def test_dropout_forward_and_backward_share_the_masks():
    """A finite difference on an operator bias matches autograd with dropout
    on: the backward sees the forward's masks."""
    l_loc, l_geom, f = WIDTHS[1]
    params = make_params(l_loc + l_geom, f, 3)
    trunk = port_trunk(params, 3, f, "silu").double()
    ins = [torch.from_numpy(a).double() for a in make_inputs(l_loc, l_geom, f, b=1, ni=20,
                                                             nb=8)]

    def scalar():
        out = neural_op_cuda.neural_ops_prop(trunk.neural_ops.linears, trunk.reduction, l_loc,
                                             *ins, "silu", [0.0, 0.5, 0.5], False, 99)
        return sum((o ** 2).sum() for o in out)

    scalar().backward()
    bias = trunk.neural_ops.operator_1.Dense_0.bias
    ad = bias.grad[0].item()
    eps = 1e-6
    with torch.no_grad():
        bias[0] += eps
        up = scalar().item()
        bias[0] -= 2 * eps
        down = scalar().item()
    assert abs((up - down) / (2 * eps) - ad) < 1e-5 * max(1.0, abs(ad))
