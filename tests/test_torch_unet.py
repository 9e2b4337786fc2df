"""The U-Net ("full") variants, PIPN++ full and PI-GANO++ full, against the
JAX package at small widths on the CPU: kNN (tie order, k past the source
size), its interpolation, the U-Net neighbour precompute, the
FeaturePropagation blocks and both decoupled-hierarchy analytic paths
(``models/fp_analytic.py``: values, J, H and the parameter gradients through
the hierarchy), with the JAX parameters carried across by
``convert.params_from_flax``; ``knn_interp_prop`` against autodiff; the
dropout masks; and micro-batch accumulation against the JAX engine's
``_accumulated_grads``. The exact paths are
tests/test_torch_unet_exact.py's. Dropout is off where the two packages
are compared (the port's masks are its own counter function by design).
Both sides run f32 (JAX at "highest" matmul precision, tests/conftest.py)."""
import dataclasses

import flax.linen as nn
import jax
import numpy as np
import optax
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models import fp_analytic as jax_fp_analytic
from porous_cfd_tpu.models import neighbors as jax_neighbors
from porous_cfd_tpu.models import set_abstraction as jax_sa
from porous_cfd_tpu.models.pi_gano import pi_gano_pp_full as jax_pi_gano_pp_full
from porous_cfd_tpu.models.pipn import pipn_foam as jax_pipn_foam
from porous_cfd_tpu.models.pipn import pipn_foam_pp_full as jax_pipn_foam_pp_full
from porous_cfd_tpu.physics import scaling as jax_scaling
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models import fp_analytic, neighbors
from porous_cfd_tpu_torch.models import set_abstraction as sa
from porous_cfd_tpu_torch.models.pi_gano import pi_gano_pp_full
from porous_cfd_tpu_torch.models.pipn import pipn_foam, pipn_foam_pp_full
from porous_cfd_tpu_torch.physics import analytic, scaling
from porous_cfd_tpu_torch.train import engine

N_BID, D = 4, 2
B, NI, NB, NO = 2, 60, 40, 8
# the examples' U-Net structure at small widths: two three-layer radius
# levels and a one-layer global level; 16 neighbours, two per k-chunk
ENC = dict(enc_layers=[[2 * D + 1 + N_BID, 16, 16], [16 + D, 24, 24], [24 + D, 48]],
           enc_radius=[0.4, 0.8], enc_fraction=[0.5, 0.5],
           dec_layers=[[48 + 24, 24, 24], [16 + 24, 16, 16], [16 + N_BID + D + 1, 16, 16, 3]],
           dec_k=[3, 3, 3], max_neighbors=16)
PIPN = dict(ENC, nu=1489.4e-6, d=14000.0, f=17.11)
GANO = dict(ENC, nu=1489.4e-6, out_features=3, branch_layers=[8, 16, 24])
ACTS = {"silu": nn.silu, "tanh": nn.tanh}
WEIGHTS = np.array([1, 1, 1, 1, 1, 1, 100, 100, 100], np.float32)
V_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(ref):
    """J, H, losses and gradients (ROADMAP §3): second derivatives through
    every layer, summed in another order on each side."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def to_t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_model(family, act, fast, dropout=(0.0, 0.0, 0.0)):
    rates = [dropout[0], dropout[1], [dropout[2], 0.0, 0.0]]
    if family == "pipn_pp_full":
        return jax_pipn_foam_pp_full(**PIPN, dec_dropout=rates,
                                     scalers=jax_synthetic.make_scalers(),
                                     activation=ACTS[act], fast_derivatives=fast)
    return jax_pi_gano_pp_full(**GANO, fp_dropout=rates, scalers=jax_synthetic.make_scalers(),
                               variable_boundaries=VARIABLE_BOUNDARIES, activation=ACTS[act],
                               fast_derivatives=fast)


def port_model(family, act, fast, dropout=(0.0, 0.0, 0.0), seed=4):
    rates = [dropout[0], dropout[1], [dropout[2], 0.0, 0.0]]
    kw = dict(scalers=make_scalers(), activation=act, fast_derivatives=fast, device="cpu",
              generator=torch.Generator().manual_seed(seed))
    if family == "pipn_pp_full":
        return pipn_foam_pp_full(**PIPN, dec_dropout=rates, **kw)
    return pi_gano_pp_full(**GANO, fp_dropout=rates, variable_boundaries=VARIABLE_BOUNDARIES,
                           **kw)


def batches(seed, b=B):
    return (jax_synthetic.make_foam_batch(b, NI, NB, NO, rng=np.random.default_rng(seed)),
            make_foam_batch(b, NI, NB, NO, rng=np.random.default_rng(seed)))


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


def assert_trees_close(got: dict, ref: dict, path=""):
    assert got.keys() == ref.keys(), path
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(got[k], ref[k], f"{path}/{k}")
        else:
            r = np.asarray(ref[k])
            np.testing.assert_allclose(np.asarray(got[k]), r, err_msg=f"{path}/{k}", **tol(r))


def both_sides(family, act, fast, seed=21):
    """The JAX model with its parameters and attached batch, and the port's
    model with those parameters and its own attached batch."""
    model = jax_model(family, act, fast)
    jb, pb = batches(seed)
    jb = model.attach_neighbors(jb)
    params = model.module.init({"params": jax.random.PRNGKey(3)}, jb["C"], jb,
                               deterministic=True)["params"]
    port = port_model(family, act, fast)
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), port.module)
    return model, params, jb, port, port.attach_neighbors(pb)


# ---- kNN, interpolation and the precompute ----------------------------------

def grid_cloud(rng, b):
    """Sources on a shuffled grid of spacing 0.25 and queries at cell
    centres and on grid points: every query has four (or more) sources at
    exactly one distance, and the expansion form is exact on these values,
    so the tie order alone decides."""
    g = np.arange(-1.0, 1.01, 0.25)
    src = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    query = np.concatenate([src[:20] + 0.125, src[30:40]])
    return (np.stack([src[rng.permutation(len(src))] for _ in range(b)]).astype(np.float32),
            np.stack([query] * b).astype(np.float32))


@pytest.mark.parametrize("case", ["random", "grid_ties", "k_past_n"])
def test_knn_equals_jax(case):
    rng = np.random.default_rng(5)
    if case == "grid_ties":
        src, query = grid_cloud(rng, 2)
        k = 3
    else:
        n = 3 if case == "k_past_n" else 70
        src = rng.uniform(-1, 1, (2, n, 2)).astype(np.float32)
        query = rng.uniform(-1, 1, (2, 40, 2)).astype(np.float32)
        k = 5 if case == "k_past_n" else 4
    ref_idx, ref_d2 = jax.vmap(jax_neighbors.knn, in_axes=(0, 0, None))(src, query, k)
    idx, d2 = neighbors.knn(to_t(src), to_t(query), k)
    assert idx.shape == (2, query.shape[1], min(k, src.shape[1]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(ref_d2))
    if case == "grid_ties":
        # ties go to the lower index, nearest first
        d = neighbors.pairwise_sqdist(to_t(query), to_t(src))
        order = sorted(range(src.shape[1]), key=lambda j: (float(d[0, 0, j]), j))
        assert idx[0, 0].tolist() == order[:k]


def test_knn_interpolate_equals_jax_with_an_exact_hit():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 30, 5)).astype(np.float32)
    src = rng.uniform(-1, 1, (2, 30, 2)).astype(np.float32)
    query = np.concatenate([src[:, :4], rng.uniform(-1, 1, (2, 20, 2))], 1).astype(np.float32)
    ref = jax_neighbors.batched_knn_interpolate(x, src, query, 3)
    got = neighbors.knn_interpolate(to_t(x), to_t(src), to_t(query), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **V_TOL)
    # an exact hit takes the source's feature (its clamped weight dominates)
    np.testing.assert_allclose(got[:, :4].numpy(), x[:, :4], rtol=1e-4)
    idx = jax.vmap(jax_neighbors.knn, in_axes=(0, 0, None))(src, query, 3)[0]
    ref_w = jax_neighbors.batched_knn_interpolate_with_idx(x, src, query, idx)
    got_w = neighbors.knn_interpolate_with_idx(to_t(x), to_t(src), to_t(query),
                                               to_t(idx).long())
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), **V_TOL)


@pytest.mark.parametrize("has_global", [True, False])
def test_unet_chain_precompute_equals_jax_key_by_key(has_global):
    pos = np.random.default_rng(7).uniform(-1, 1, (2, 100, 2)).astype(np.float32)
    args = ([0.5, 0.5], [0.4, 0.8], 16, [3, 3, 3] if has_global else [3, 3], has_global)
    ref = jax_neighbors.unet_chain_precompute(pos, *args)
    got = neighbors.unet_chain_precompute(to_t(pos), *args)
    assert set(got) == {f"_{k}" for k in ref}
    for key, r in ref.items():
        g, r = got[f"_{key}"].numpy(), np.asarray(r)
        assert g.shape == r.shape, key
        np.testing.assert_array_equal(g, r, err_msg=key)
    assert got["_fp_idx_0"].shape == ((2, 25, 1) if has_global else (2, 50, 3))
    assert neighbors.extract_fp_idx(got, len(args[3]))[-1].shape == (2, 100, 3)
    assert neighbors.extract_fp_idx({}, 2) is None


# ---- the blocks --------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "tanh"])
def test_encoder_and_fp_blocks_forward_equal_jax(act):
    """SetAbstractionSeq with its skips (one max over the neighbours against
    the JAX levels' k-chunked running max), each
    FeaturePropagation block alone (found and given neighbours, k past the
    source size) and both decoders, on flax's parameters."""
    rng = np.random.default_rng(8)
    pos = rng.uniform(-1, 1, (2, 100, 2)).astype(np.float32)
    x_in = rng.normal(size=(2, 100, 1 + N_BID)).astype(np.float32)
    chain = jax_neighbors.unet_chain_precompute(pos, [0.5, 0.5], [0.4, 0.8], 16, [3, 3, 3],
                                                True)
    nbrs = jax_neighbors.extract_sa_neighbors(chain, 2)
    enc = jax_sa.SetAbstractionSeq([0.5, 0.5], [0.4, 0.8], ENC["enc_layers"],
                                   activation=ACTS[act], max_neighbors=16, k_chunks=8)
    feats = np.concatenate([x_in, pos], -1)
    p_enc = enc.init(jax.random.PRNGKey(1), feats, pos, True, nbrs)["params"]
    (x_r, pos_r), skips_r = enc.apply({"params": p_enc}, feats, pos, True, nbrs)
    port_enc = sa.SetAbstractionSeq([0.5, 0.5], [0.4, 0.8], ENC["enc_layers"], act, 16)
    params_from_flax(jax.tree_util.tree_map(np.asarray, p_enc), port_enc)
    port_chain = neighbors.unet_chain_precompute(to_t(pos), [0.5, 0.5], [0.4, 0.8], 16,
                                                 [3, 3, 3], True)
    (x, p), skips = port_enc(to_t(feats), to_t(pos), True,
                             neighbors.extract_sa_neighbors(port_chain, 2), return_skip=True)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(x_r), **V_TOL)
    np.testing.assert_array_equal(p.numpy(), np.asarray(pos_r))
    assert len(skips) == len(skips_r) == 3
    for (a, pa), (r, pr) in zip(skips, skips_r):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **V_TOL)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(pr))

    # one level alone, neighbours found (k = 5 past the single global point
    # too) and given, plain last or not
    coarse, cpos = np.asarray(skips_r[2][0]), np.asarray(skips_r[2][1])
    for k, src, spos, plain in ((3, coarse, cpos, False), (5, np.asarray(x_r),
                                                         np.asarray(pos_r), True)):
        fp = jax_sa.FeaturePropagation(k, [src.shape[-1] + 16, 12, 6], plain_last=plain,
                                       activation=ACTS[act])
        xs, ps = np.asarray(skips_r[1][0]), np.asarray(skips_r[1][1])
        p_fp = fp.init(jax.random.PRNGKey(2), src, spos, xs, ps)["params"]
        port_fp = sa.FeaturePropagation(k, [src.shape[-1] + 16, 12, 6], None, plain, act)
        params_from_flax(jax.tree_util.tree_map(np.asarray, p_fp), port_fp)
        ref = fp.apply({"params": p_fp}, src, spos, xs, ps)[0]
        got = port_fp(to_t(src), to_t(spos), to_t(xs), to_t(ps))[0]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **V_TOL)

    par = rng.normal(size=(2, 1, 24)).astype(np.float32)
    fp_idx = [to_t(chain[f"fp_idx_{i}"]).long() for i in range(3)]
    for neural in (False, True):
        if neural:
            dec = jax_sa.FeaturePropagationNeuralOperatorSeq(ENC["dec_layers"], [3, 3, 3],
                                                             activation=ACTS[act])
            args = (par, x_r, pos_r, skips_r)
            port_dec = sa.FeaturePropagationSeq(ENC["dec_layers"], [3, 3, 3], None, act,
                                                par_width=24)
            port_par = to_t(par)
        else:
            dec = jax_sa.FeaturePropagationSeq(ENC["dec_layers"], [3, 3, 3],
                                               activation=ACTS[act])
            args = (x_r, pos_r, skips_r)
            port_dec = sa.FeaturePropagationSeq(ENC["dec_layers"], [3, 3, 3], None, act)
            port_par = None
        p_dec = dec.init(jax.random.PRNGKey(3), *args)["params"]
        params_from_flax(jax.tree_util.tree_map(np.asarray, p_dec), port_dec)
        ref = dec.apply({"params": p_dec}, *args)[0]
        for idx in (None, fp_idx):
            got = port_dec(x, p, skips, True, idx, par_embedding=port_par)[0]
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **V_TOL)


# ---- the analytic paths --------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("family", ["pipn_pp_full", "pi_gano_pp_full"])
def test_analytic_path_matches_jax(family, act):
    """The decoupled-hierarchy path: values, J and H against the JAX
    function's, and the gradients of a loss on all three through the whole
    hierarchy (encoder, middle levels, the branch). A CPU batch without the
    precompute builds it."""
    model, params, jb, port, pb = both_sides(family, act, fast=True)
    ref = model.derivative_apply(params, jb, None, True)
    got = port.derivative_apply(pb, True)
    for label, a, r in zip(("values", "J", "H"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.detach().numpy(), r, err_msg=label,
                                   **(V_TOL if label == "values" else tol(r)))

    def loss(out, j, h):
        return (out ** 2).sum() + (j ** 2).sum() + 0.1 * (h ** 2).sum()

    ref_grads = jax.grad(lambda p: loss(*model.derivative_apply(p, jb, None, True)))(params)
    port.module.zero_grad(set_to_none=True)
    loss(*got).backward()
    assert_trees_close(grads_to_flax(port.module), ref_grads)
    bare = make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(21))
    with torch.no_grad():
        for a, b in zip(port.derivative_apply(bare, True), got):
            torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_knn_interp_prop_matches_autodiff_and_jax():
    rng = np.random.default_rng(3)
    b, m, n, k, f = 2, 10, 6, 3, 5
    x_c = rng.normal(size=(b, m, f)).astype(np.float32)
    src = rng.uniform(-1, 1, (b, m, 2)).astype(np.float32)
    q = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    idx = rng.integers(0, m, (b, n, k))
    v, j, h = fp_analytic.knn_interp_prop(to_t(x_c), to_t(src), to_t(q), to_t(idx), n - 2)
    ref = jax_fp_analytic.knn_interp_prop(x_c, src, q, idx.astype(np.int32), n - 2)
    for a, r in zip((v, j, h), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **tol(r))
    xc, pc = to_t(x_c).double(), to_t(src).double()
    for bi in range(b):
        for ni in range(n - 2):
            def one(pt, bi=bi, ni=ni):
                nb = idx[bi, ni]
                w = 1.0 / torch.clamp(((pt - pc[bi, nb]) ** 2).sum(-1), min=1e-12)
                return (xc[bi, nb] * w[:, None]).sum(0) / w.sum()

            pt = to_t(q[bi, ni]).double()
            jac = torch.autograd.functional.jacobian(one, pt)            # (F, D)
            diag = torch.stack([torch.autograd.functional.hessian(
                lambda p, c=c: one(p)[c], pt).diagonal() for c in range(f)], -1)  # (D, F)
            np.testing.assert_allclose(j[bi, ni].numpy(), jac.T.numpy(), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(h[bi, ni].numpy(), diag.numpy(), rtol=1e-3, atol=1e-3)
    assert v.shape == (b, n, f)


def test_knn_interp_prop_at_a_clamped_coincident_point():
    """A query on a coarse point clamps its weight: the value is that
    point's feature, and J and H are finite and take no term from it."""
    rng = np.random.default_rng(5)
    x_c = to_t(rng.normal(size=(1, 4, 2)).astype(np.float32))
    src = to_t(rng.uniform(-1, 1, (1, 4, 2)).astype(np.float32))
    idx = torch.tensor([[[0, 1, 2]]])
    v, j, h = fp_analytic.knn_interp_prop(x_c, src, src[:, :1], idx, 1)
    assert all(bool(t.isfinite().all()) for t in (v, j, h))
    np.testing.assert_allclose(v[0, 0].numpy(), x_c[0, 0].numpy(), rtol=1e-4)
    ref = jax_fp_analytic.knn_interp_prop(x_c.numpy(), src.numpy(), src[:, :1].numpy(),
                                          idx.numpy().astype(np.int32), 1)
    for a, r in zip((v, j, h), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


# ---- dropout, micro-batches ------------------------------------------------------

def test_dropout_masks_and_the_paths_draw_the_same():
    """A FeaturePropagation level drops with merged_mask of its own seed
    (fp_level_seed), at the kept share its rate says; with one seed both
    paths drop the same columns (their values agree, dropout on); the
    analytic path's draw is a function of the seed; a middle level with
    dropout takes the exact path, as in the JAX factories."""
    fp = sa.FeaturePropagation(3, [8, 64], [0.3], activation="tanh")
    with torch.no_grad():
        fp.mlp.linear_0.weight.zero_()
        fp.mlp.linear_0.bias.fill_(1.0)
    x = torch.zeros(4, 50, 4)
    pos = torch.rand(4, 50, 2, generator=torch.Generator().manual_seed(1))
    out = fp(x, pos, torch.zeros(4, 500, 4), torch.rand(4, 500, 2), False, seed=77)[0]
    kept = float((out > 0).float().mean())
    assert abs(kept - 0.7) < 0.01, kept
    mask = analytic.merged_mask(77, 0, 0.3, torch.ones(4, 500, 64))
    torch.testing.assert_close(out, np.tanh(1.0) * mask, rtol=1e-6, atol=0)
    assert sa.fp_level_seed(77, 2) != sa.fp_level_seed(77, 1) and sa.fp_level_seed(None, 1) \
        is None

    for family in ("pipn_pp_full", "pi_gano_pp_full"):
        batch = make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(9))
        got = []
        for fast in (True, False):
            model = port_model(family, "silu", fast, dropout=(0.0, 0.0, 0.4))
            with torch.no_grad() if fast else torch.enable_grad():
                got.append(engine.model_derivatives(model, model.attach_neighbors(batch),
                                                    False, seed=1234)[0].detach())
        np.testing.assert_allclose(got[1].numpy(), got[0].numpy(), **V_TOL)
        fast = port_model(family, "silu", True, dropout=(0.0, 0.0, 0.4))
        attached = fast.attach_neighbors(batch)
        with torch.no_grad():
            det = fast.derivative_apply(attached, True)[0]
            again = fast.derivative_apply(attached, False, seed=1234)[0]
            other = fast.derivative_apply(attached, False, seed=99)[0]
        torch.testing.assert_close(again, got[0], rtol=0, atol=0)
        assert (det - again).abs().max() > 1e-2 * det.abs().max()
        assert (other - again).abs().max() > 1e-2 * det.abs().max()
        mid = port_model(family, "silu", True, dropout=(0.1, 0.0, 0.0))
        assert mid.derivative_apply is None and mid.microbatch == 2
        assert jax_model(family, "silu", True, dropout=(0.1, 0.0, 0.0)).derivative_apply \
            is None


@pytest.mark.parametrize("b", [4, 3], ids=["divides", "degrades"])
def test_microbatch_accumulation_matches_the_jax_engine(b):
    """Micro-batches of 2 over 4 cases (two groups) and over 3 (groups of
    1): two steps of each package with ReLoBRaLo (beta 1 fixes its draw),
    dropout off. Each step's gradients (JAX's through SGD at rate 1),
    metrics and scaler state agree; the second step weighs its groups with
    the first step's scaler state."""
    cfg = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 16, 16],
               fe_global_layers=[16 + 1 + N_BID, 24, 32], seg_layers=[32 + 16, 24, 3],
               seg_dropout=[0.0, 0.0])
    ref = dataclasses.replace(jax_pipn_foam(**cfg, scalers=jax_synthetic.make_scalers()),
                              microbatch=2)
    jscaler = jax_scaling.RelobraloScaler(9, alpha=0.3, beta=1.0, update_period=1)
    fns = jax_engine.make_train_functions(ref, optax.sgd(1.0), jscaler)
    jb, pb = batches(31, b)
    state = fns.init_state(jb)
    port = dataclasses.replace(pipn_foam(**cfg, scalers=make_scalers(), device="cpu"),
                               microbatch=2)
    pscaler = scaling.RelobraloScaler(9, alpha=0.3, beta=1.0, update_period=1)
    pfns = engine.make_train_functions(port, engine.make_optimizer(port, 1), pscaler)
    pstate = pfns.init_state(seed=1)
    for _ in range(2):
        # copied: the JAX step donates its state
        params0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), state.params)
        params_from_flax(params0, port.module)
        state, m_ref = fns.train_step(state, jb)
        pstate, m = pfns.train_step(pstate, pb)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **tol(m_ref))
        ref_grads = jax.tree_util.tree_map(lambda a, c: np.asarray(a) - np.asarray(c),
                                           params0, state.params)
        assert_trees_close(grads_to_flax(port.module), ref_grads)
        for field in ("init_losses", "prev_losses", "lambda_ema"):
            r = np.asarray(getattr(state.scaler_state, field))
            np.testing.assert_allclose(getattr(pstate.scaler_state, field).numpy(), r,
                                       err_msg=field, **tol(r))
    assert pstate.step == 2
