"""The port's SetAbstraction level, ``sa_cuda.sa_neighborhood_plain`` (the
kernel's plain version, on the CPU), against the JAX package's Pallas
kernel ``sa_pallas.sa_neighborhood`` in interpret mode, both variants
(static: pre-gathered xg; dynamic: P gathered by index), with odd centroid
counts that the TPU kernel pads and the port does not, and with forced-empty
neighbourhoods: values and every gradient, dP's way to dx included. Then the
plain modules (``SetAbstractionSeq`` and ``sa_seq_fused``) against the flax
modules. The same numpy inputs on both sides, f32 (JAX at "highest" matmul
precision, tests/conftest.py)."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from porous_cfd_tpu.models import neighbors as jax_neighbors
from porous_cfd_tpu.models.set_abstraction import SetAbstractionSeq as JaxSetAbstractionSeq
from porous_cfd_tpu.ops import sa_pallas
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.models import neighbors
from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.models.set_abstraction import SetAbstractionSeq
from porous_cfd_tpu_torch.ops import sa_cuda

JAX_ACT = {"silu": nn.silu, "tanh": nn.tanh}
B, D, F_IN = 3, 2, 5
# Values: f32 on both sides, sums at most 24 wide.
V_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(ref):
    """Gradients: sums over every neighbour row in another order; scale the
    absolute part by the largest entry."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def make_params(layers, seed=1):
    rng = np.random.default_rng(seed)
    return {f"linear_{i}": {
        "kernel": (rng.normal(size=(layers[i], layers[i + 1]))
                   / np.sqrt(layers[i])).astype(np.float32),
        "bias": (rng.normal(size=layers[i + 1]) * 0.1).astype(np.float32)}
        for i in range(len(layers) - 1)}


def level(n, fraction, radius, k, empty_every=0, seed=0):
    """Inputs of one level from JAX's precompute, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n, F_IN)).astype(np.float32)
    pos = rng.uniform(-1, 1, size=(B, n, D)).astype(np.float32)
    chain = jax_neighbors.sa_chain_precompute(jnp.asarray(pos), [fraction], [radius], k,
                                              feats=jnp.asarray(x))
    idx, mask = np.array(chain["sa_idx_0"]), np.array(chain["sa_mask_0"])
    if empty_every:
        mask[:, ::empty_every] = False   # a centroid is always its own neighbour
    return x, pos, idx, mask, np.array(chain["sa_rel_0"]), np.array(chain["sa_xg_0"])


CASES = {
    # (n, fraction, radius, K, empty_every): 13 centroids, not a multiple of
    # the TPU kernel's block; every third neighbourhood emptied; 64
    # neighbours at PIPN++'s radius
    "odd": (42, 0.3, 0.6, 8, 0),
    "empty": (42, 0.3, 0.6, 8, 3),
    "k64": (150, 0.1, 0.5, 64, 4),
}


STACKS = [[F_IN + D, 16, 24], [F_IN + D, 24], [F_IN + D, 16, 8, 24]]
# every stack and activation on the small cases; the 64-neighbour case at one
RUNS = [(c, st, a) for c in ("odd", "empty") for st in range(3) for a in ("silu", "tanh")]
RUNS += [("k64", 0, "silu")]


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("case,stack,act", RUNS)
def test_plain_matches_the_pallas_kernel(case, stack, act, static):
    layers = STACKS[stack]
    x, pos, idx, mask, rel, xg = level(*CASES[case], seed=len(layers))
    params = make_params(layers)
    cot = np.random.default_rng(5).normal(size=(B, idx.shape[1], layers[-1])).astype(np.float32)

    def jax_loss(p, xx):
        out = sa_pallas.sa_neighborhood(p, layers, xx, jnp.asarray(pos), jnp.asarray(idx),
                                        jnp.asarray(mask), CASES[case][2], JAX_ACT[act],
                                        rel=jnp.asarray(rel),
                                        xg=jnp.asarray(xg) if static else None, interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (_, ref), (ref_gp, ref_gx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))

    mlp = params_from_flax(params, MLP(layers, activation=act))
    xt = torch.from_numpy(x).requires_grad_(not static)
    out = sa_cuda.sa_neighborhood(mlp.linears, xt, torch.from_numpy(idx).long(),
                                  torch.from_numpy(mask), torch.from_numpy(rel), act,
                                  torch.from_numpy(xg) if static else None)
    assert out.shape == (B, idx.shape[1], layers[-1])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **V_TOL)
    if CASES[case][4]:
        empty = ~mask.any(-1)
        assert empty.any() and np.all(out.detach().numpy()[empty] == 0)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, lin in enumerate(mlp.linears):
        for name, got, key in (("kernel", lin.weight.grad.numpy().T, "kernel"),
                               ("bias", lin.bias.grad.numpy(), "bias")):
            r = np.asarray(ref_gp[f"linear_{i}"][key])
            np.testing.assert_allclose(got, r, err_msg=f"linear_{i}/{name}", **tol(r))
    if not static:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), **tol(ref_gx))


def test_plain_routes_tied_maxima_to_the_first_neighbour():
    """Source rows 1 and 4 are equal and reached with equal rel, so the two
    neighbours tie on every channel: the whole cotangent goes to the first
    (row 1), as the kernels route it; the later copy and masked-out rows get
    none."""
    layers = [F_IN + D, 8, 8]
    mlp = params_from_flax(make_params(layers), MLP(layers, activation="silu"))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 6, F_IN)).astype(np.float32))
    x[0, 4] = x[0, 1]
    x.requires_grad_()
    idx = torch.tensor([[[2, 1, 4, 5]]])
    mask = torch.tensor([[[False, True, True, False]]])
    out = sa_cuda.sa_neighborhood_plain(mlp.linears, x, idx, mask, torch.zeros((1, 1, 4, D)),
                                        "silu")
    out.sum().backward()
    assert torch.count_nonzero(x.grad[0, 1]) == F_IN
    for row in (0, 2, 3, 4, 5):
        assert torch.all(x.grad[0, row] == 0), row


def jax_chain(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n, 6)).astype(np.float32)
    pos = rng.uniform(-1, 1, size=(B, n, D)).astype(np.float32)
    return x, pos


SEQ = dict(fractions=[0.5, 0.25], radii=[0.5, 1.0],
           conv=[[6 + D, 16, 16], [16 + D, 24, 24], [24 + D, 16, 32]])


@pytest.mark.parametrize("precomputed", [True, False])
def test_set_abstraction_seq_matches_flax(precomputed):
    """The plain SetAbstractionSeq, with the chain precomputed or found on
    the fly, against the flax module: values and parameter gradients."""
    x, pos = jax_chain(40, 7)
    module = JaxSetAbstractionSeq(SEQ["fractions"], SEQ["radii"], SEQ["conv"],
                                  return_skip=False, activation=jax.nn.silu, max_neighbors=8)
    chain = jax_neighbors.sa_chain_precompute(jnp.asarray(pos), SEQ["fractions"],
                                              SEQ["radii"], 8)
    jnbrs = [(chain[f"sa_cent_{i}"], chain[f"sa_idx_{i}"], chain[f"sa_mask_{i}"])
             for i in range(2)] if precomputed else None
    params = unfreeze(module.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(pos),
                                  True, jnbrs))["params"]
    cot = np.random.default_rng(1).normal(size=(B, 1, 32)).astype(np.float32)

    def loss(p):
        (out, _) = module.apply({"params": p}, jnp.asarray(x), jnp.asarray(pos), True, jnbrs)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), ref_g = jax.value_and_grad(loss, has_aux=True)(params)
    seq = SetAbstractionSeq(SEQ["fractions"], SEQ["radii"], SEQ["conv"], "silu", 8)
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), seq)
    pnbrs = None
    if precomputed:
        pchain = neighbors.sa_chain_precompute(torch.from_numpy(pos), SEQ["fractions"],
                                               SEQ["radii"], 8)
        pnbrs = neighbors.extract_sa_neighbors(pchain, 2)
    out, pos_out = seq(torch.from_numpy(x), torch.from_numpy(pos), True, pnbrs)
    assert out.shape == (B, 1, 32) and torch.all(pos_out == 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **V_TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, lin in seq.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = ref_g
            for part in name.split("."):
                node = node[part]
            for got, r in ((lin.weight.grad.numpy().T, node["kernel"]),
                           (lin.bias.grad.numpy(), node["bias"])):
                np.testing.assert_allclose(got, np.asarray(r), err_msg=name, **tol(r))


def test_sa_seq_fused_matches_flax():
    """The fused chain (sa_neighborhood per level, static at level 0, and
    pointnet_global for the trailing level) on the port's precompute,
    against the flax module on JAX's."""
    x, pos = jax_chain(40, 8)
    module = JaxSetAbstractionSeq(SEQ["fractions"], SEQ["radii"], SEQ["conv"],
                                  return_skip=False, activation=jax.nn.silu, max_neighbors=8)
    chain = jax_neighbors.sa_chain_precompute(jnp.asarray(pos), SEQ["fractions"],
                                              SEQ["radii"], 8)
    jnbrs = [(chain[f"sa_cent_{i}"], chain[f"sa_idx_{i}"], chain[f"sa_mask_{i}"])
             for i in range(2)]
    params = unfreeze(module.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(pos),
                                  True, jnbrs))["params"]
    ref, _ = module.apply({"params": params}, jnp.asarray(x), jnp.asarray(pos), True, jnbrs)
    seq = SetAbstractionSeq(SEQ["fractions"], SEQ["radii"], SEQ["conv"], "silu", 8)
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), seq)
    pchain = neighbors.sa_chain_precompute(torch.from_numpy(pos), SEQ["fractions"],
                                           SEQ["radii"], 8, torch.from_numpy(x))
    nbrs = neighbors.extract_sa_neighbors(pchain, 2)
    with torch.no_grad():
        got = sa_cuda.sa_seq_fused(seq, "silu", torch.from_numpy(x), nbrs)
        # without xg, level 0 runs the dynamic variant on x itself
        dyn = sa_cuda.sa_seq_fused(seq, "silu", torch.from_numpy(x),
                                   [nbrs[0][:5], nbrs[1]])
    assert got.shape == (B, 1, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **V_TOL)
    np.testing.assert_allclose(dyn.numpy(), np.asarray(ref), **V_TOL)
