"""The port's neural_ops_prop (its plain version, on the CPU) in the trunk's
two other modes, each alone and both together: the last operator without
its activation (``last_activation=False``) and no fused reduction
(``reduction=None``, the output F wide), which PiGanoFull's trunks run
together. Held to the JAX package's Pallas kernel in interpret mode
(``last_activation=False, reduction_params=None``) and to its XLA route,
``_neural_ops_prop_ctx`` followed by ``dense_prop`` where there is a
reduction: values, J, H and every gradient, ``par``'s included, with
dropout off (the masks differ by design and are held to their own rules)."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.models.pi_gano import _neural_ops_prop_ctx
from porous_cfd_tpu.ops import neural_op_pallas
from porous_cfd_tpu.physics import analytic as jax_analytic
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.models.mlp import NeuralOperatorSequential, dense
from porous_cfd_tpu_torch.ops import dropout, neural_op_cuda

D, OUT = 2, 3
B, NI, NB = 2, 20, 7
L_LOC, L_GEOM, F = 6, 5, 11
N_OPS = 3
JAX_ACT = {"silu": nn.silu, "tanh": nn.tanh}
# (last_activation, reduction): each new mode alone, and both (PiGanoFull)
MODES = [(False, True), (True, False), (False, False)]
MODE_IDS = ["linear_last", "no_reduction", "both"]
V_TOL = dict(rtol=1e-5, atol=1e-5)


def d_tol(ref):
    """J, H and gradients: products of derivatives through every layer,
    sums taken in another order; the absolute part scales with the largest
    entry (ROADMAP's tolerance)."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1e-30))


class Trunk(torch.nn.Module):
    """The flax paths ``neural_ops/operator_i/Dense_0`` and, with a
    reduction, ``reduction``."""

    def __init__(self, act, last_activation, reduction):
        super().__init__()
        self.neural_ops = NeuralOperatorSequential(N_OPS, F, (0.0,) * N_OPS, act,
                                                   last_activation=last_activation)
        if reduction:
            self.reduction = dense(F, OUT)

    @property
    def red(self):
        return getattr(self, "reduction", None)


def make_params(reduction, seed=1):
    rng = np.random.default_rng(seed)
    trunk = {}
    for i in range(N_OPS):
        a = L_LOC + L_GEOM if i == 0 else F
        trunk[f"operator_{i}"] = {"Dense_0": {
            "kernel": (rng.normal(size=(a, F)) / np.sqrt(a)).astype(np.float32),
            "bias": (rng.normal(size=F) * 0.1).astype(np.float32)}}
    params = {"neural_ops": trunk}
    if reduction:
        params["reduction"] = {
            "kernel": (rng.normal(size=(F, OUT)) / np.sqrt(F)).astype(np.float32),
            "bias": (rng.normal(size=OUT) * 0.1).astype(np.float32)}
    return params


def make_inputs(seed=0):
    """(v, jt, ht, v_b, geom, par), jt/ht in the (B, D, Ni, L) layout."""
    rng = np.random.default_rng(seed)
    g = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    return (g(B, NI, L_LOC), g(B, D, NI, L_LOC), g(B, D, NI, L_LOC), g(B, NB, L_LOC),
            g(B, 1, L_GEOM), g(B, 1, F) + 1.0)


def jax_kernel(params, inputs, act, last_activation):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    v, jt, ht, v_b, geom, par = inputs
    return neural_op_pallas.neural_ops_prop(
        jp["neural_ops"], N_OPS, L_LOC, v, jt, ht, v_b, geom, par, JAX_ACT[act],
        (0.0,) * N_OPS, last_activation, jp.get("reduction"), tile=8, interpret=True)


def jax_xla(params, inputs, act, last_activation):
    """The XLA route: ``_neural_ops_prop_ctx`` (J/H as (B, Ni, D, .)), then
    the reduction; returned in the kernel's (B, Ni, O, D) layout."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    v, jt, ht, v_b, geom, par = inputs
    j, h = jnp.swapaxes(jt, 1, 2), jnp.swapaxes(ht, 1, 2)
    ov, oj, oh = _neural_ops_prop_ctx(jp["neural_ops"], N_OPS, (0.0,) * N_OPS, JAX_ACT[act],
                                      last_activation, v, j, h, v_b, geom, par, True, None,
                                      jax_analytic)
    if "reduction" in jp:
        ov, oj, oh = jax_analytic.dense_prop(jp["reduction"], ov, oj, oh)
    return ov, jnp.swapaxes(oj, -1, -2), jnp.swapaxes(oh, -1, -2)


def port(params, act, last_activation, reduction):
    return params_from_flax(params, Trunk(act, last_activation, reduction))


@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_modes_match_jax_kernel_and_xla_route(mode, act):
    last_activation, reduction = mode
    params = make_params(reduction)
    inputs = make_inputs()
    jin = tuple(map(jnp.asarray, inputs))
    trunk = port(params, act, last_activation, reduction)
    with torch.no_grad():
        out = neural_op_cuda.neural_ops_prop(
            trunk.neural_ops.linears, trunk.red, L_LOC, *map(torch.from_numpy, inputs), act,
            last_activation=last_activation)
    o = OUT if reduction else F
    assert out[0].shape == (B, NI + NB, o)
    assert out[1].shape == out[2].shape == (B, NI, o, D)
    for ref_fn in (jax_kernel, jax_xla):
        ref = [np.asarray(r) for r in ref_fn(params, jin, act, last_activation)]
        np.testing.assert_allclose(out[0].numpy(), ref[0], err_msg=ref_fn.__name__, **V_TOL)
        for name, a, r in zip(("jac", "lap"), out[1:], ref[1:]):
            np.testing.assert_allclose(a.numpy(), r, err_msg=f"{ref_fn.__name__} {name}",
                                       **d_tol(r))


def test_linear_last_operator_differs_from_the_activated_one():
    """The mode is not a no-op: the same weights with the last activation
    give other values."""
    params = make_params(False)
    ins = list(map(torch.from_numpy, make_inputs()))
    outs = []
    for last_activation in (True, False):
        trunk = port(params, "silu", last_activation, False)
        with torch.no_grad():
            outs.append(neural_op_cuda.neural_ops_prop(
                trunk.neural_ops.linears, None, L_LOC, *ins, "silu",
                last_activation=last_activation)[0])
    assert (outs[0] - outs[1]).abs().max() > 1e-2


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_modes_gradients_match_jax(mode):
    """d/d(v, jt, ht, v_b, geom, par, W, b[, reduction]) of a loss on all
    three outputs against jax.grad through the Pallas kernel's custom VJP;
    par's cotangent collects every operator's v, J and H streams, the linear
    last one's included."""
    last_activation, reduction = mode
    act = "silu"
    params = make_params(reduction, seed=2)
    inputs = make_inputs(seed=3)
    o = OUT if reduction else F
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((B, NI + NB, o), (B, NI, o, D), (B, NI, o, D))]

    def loss(p, *ins):
        ov, oj, oh = jax_kernel(p, ins, act, last_activation)
        return (jnp.sum(ov * cots[0]) + jnp.sum(jnp.sin(oj) * cots[1])
                + 0.5 * jnp.sum(oh ** 2 * cots[2]))

    ref = jax.grad(loss, argnums=tuple(range(7)))(params, *map(jnp.asarray, inputs))
    trunk = port(params, act, last_activation, reduction)
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    ov, oj, oh = neural_op_cuda.neural_ops_prop(trunk.neural_ops.linears, trunk.red, L_LOC,
                                                *ts, act, last_activation=last_activation)
    c = [torch.from_numpy(a) for a in cots]
    (torch.sum(ov * c[0]) + torch.sum(torch.sin(oj) * c[1])
     + 0.5 * torch.sum(oh ** 2 * c[2])).backward()
    for name, t, r in zip(("v", "jt", "ht", "v_b", "geom", "par"), ts, ref[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=name, **d_tol(r))
    layers = [(lin, ref[0]["neural_ops"][f"operator_{i}"]["Dense_0"])
              for i, lin in enumerate(trunk.neural_ops.linears)]
    if reduction:
        layers.append((trunk.reduction, ref[0]["reduction"]))
    for lin, r in layers:
        np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(r["kernel"]),
                                   **d_tol(r["kernel"]))
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(r["bias"]),
                                   **d_tol(r["bias"]))


def test_no_reduction_output_carries_the_last_operators_mask():
    """Without a reduction the output is the last operator's: a column it
    drops is exactly 0 in v, J and H, boundary rows continuing the internal
    rows' merged-row mask."""
    params = make_params(False)
    trunk = port(params, "silu", False, False)
    v, jt, ht, v_b, geom, par = map(torch.from_numpy, make_inputs())
    args = (trunk.neural_ops.linears, None, L_LOC, v, jt, ht, v_b, geom, par, "silu")
    seed = 11
    with torch.no_grad():
        out = neural_op_cuda.neural_ops_prop(*args, [0.0, 0.0, 0.5], False, seed,
                                             last_activation=False)
        det = neural_op_cuda.neural_ops_prop(*args, last_activation=False)
    mask = dropout.keep_mask(neural_op_cuda.trunk_seed(seed), 2, B, NI + NB, F, 0.5)
    assert (mask == 0).any() and (mask > 0).any()
    torch.testing.assert_close(out[0], det[0] * mask)
    torch.testing.assert_close(out[1], det[1] * mask[:, :NI, :, None])
    torch.testing.assert_close(out[2], det[2] * mask[:, :NI, :, None])
