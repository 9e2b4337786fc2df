"""The PIPN++ MRG slice: the JAX package's ``pipn_foam_pp_mrg`` and the
port's, with the JAX parameters carried across by
``convert.params_from_flax`` and dropout off, on the same ``make_foam_batch``
batches with each side's neighbour chain attached. The MRG encoder's widths
are fixed by the model; the local and decoder stacks are narrow. Compares
``SetAbstractionMrgSeq``'s forward (the port's module and its
``sa_mrg_fused`` composition), the plain forward, ``derivative_apply``,
verbose ``predict_batch``, ``compute_losses`` with its gradients and three
Adam steps, and the ``"id_first"`` chain precompute. The JAX side off the TPU
takes its module path (``sa_pallas.enabled`` is false on the CPU). Both sides
run f32 on the CPU (JAX at "highest" matmul precision, tests/conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models import pipn as jax_pipn
from porous_cfd_tpu.models.neighbors import extract_sa_neighbors as jax_extract
from porous_cfd_tpu.models.set_abstraction import SetAbstractionMrgSeq as JaxMrgSeq
from porous_cfd_tpu.physics.scaling import FixedLossScaler as JaxFixedLossScaler
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models import pipn
from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
from porous_cfd_tpu_torch.models.set_abstraction import SetAbstractionMrgSeq
from porous_cfd_tpu_torch.ops import sa_cuda
from porous_cfd_tpu_torch.physics import scaling
from porous_cfd_tpu_torch.train import engine

CFG = dict(n_dims=2, mrg_in_features=4 + 2, nu=1e-3, d=100.0, f=1.0,
           fe_local_layers=[2, 16, 16], seg_layers=[1024 + 16, 24, 3], max_neighbors=8)
B, NI, NB, NO = 2, 40, 60, 8
WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# Values (fields): f32 on both sides.
V_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for torch while this module runs: the suite runs in
    several worker processes at once, and these full-width models would
    otherwise each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tol(ref):
    """J, H, residuals, losses, gradients and parameters: products of
    derivative rules through every layer, sums over rows and widths in
    another order; scale the absolute part by the largest entry."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def assert_trees_close(got: dict, ref: dict, path=""):
    assert got.keys() == ref.keys(), path
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(got[k], ref[k], f"{path}/{k}")
        else:
            r = np.asarray(ref[k])
            np.testing.assert_allclose(np.asarray(got[k]), r, err_msg=f"{path}/{k}", **tol(r))


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


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_side():
    model = jax_pipn.pipn_foam_pp_mrg(**CFG, scalers=jax_synthetic.make_scalers(),
                                      seg_dropout=[0.0, 0])
    fns = jax_engine.make_train_functions(model, jax_engine.make_optimizer(model, 2),
                                          JaxFixedLossScaler(WEIGHTS))
    batches = [model.attach_neighbors(jax_synthetic.make_foam_batch(
        B, NI, NB, NO, rng=np.random.default_rng(s))) for s in (11, 12, 13)]
    state = fns.init_state(batches[0])
    return model, fns, state, batches


def port_model(params=None, dropout=(0.0, 0.0), seed=0):
    model = pipn.pipn_foam_pp_mrg(**CFG, scalers=make_scalers(), seg_dropout=list(dropout),
                                  generator=torch.Generator().manual_seed(seed), device="cpu")
    if params is not None:
        params_from_flax(numpy_tree(params), model.module)
    return model


def port_batch(model, seed):
    return model.attach_neighbors(make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(seed)))


def test_the_flax_tree_carries_both_ways(jax_side):
    _, _, state, _ = jax_side
    ref = numpy_tree(state.params)
    model = port_model(state.params)
    got = params_to_flax(model.module)
    assert set(got) == {"local_fe", "global_fe", "decoder"}
    assert set(got["global_fe"]) == {"branch1_sa0", "branch1_sa1", "branch2_sa",
                                     "branch3_gsa", "branch4_gsa"}
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(g, r)


def test_mrg_encoder_forward_matches_jax(jax_side):
    """The module on the attached chain and on none (FPS and the radius
    search on the fly), and ``sa_mrg_fused``'s plain composition, against
    JAX's module on its chain."""
    _, _, state, batches = jax_side
    jb = batches[0]
    jbnd = jb["boundary"]
    jgeom = jnp.concatenate([jbnd["boundaryId"], jbnd["C"]], axis=-1)
    jax_seq = JaxMrgSeq(CFG["mrg_in_features"], 2, jax.nn.silu, CFG["max_neighbors"])
    ref = np.asarray(jax_seq.apply({"params": state.params["global_fe"]}, jgeom, jbnd["C"],
                                   True, jax_extract(jb.domain, 2)))
    assert ref.shape == (B, 1, 1024)

    model = port_model(state.params)
    batch = port_batch(model, 11)
    bnd = batch["boundary"]
    geom = pipn._geometry_features(bnd, "id_first")
    nbrs = extract_sa_neighbors(batch.domain, 2)
    mrg = model.module.global_fe
    with torch.no_grad():
        outs = {"module": mrg(geom, bnd["C"], True, nbrs),
                "module, no chain": mrg(geom, bnd["C"]),
                "sa_mrg_fused": sa_cuda.sa_mrg_fused(mrg, "silu", geom, bnd["C"], nbrs)}
    for label, out in outs.items():
        np.testing.assert_allclose(out.numpy(), ref, err_msg=label, **V_TOL)


def test_chain_shapes_and_branch_four_rows():
    """NB boundary points -> ceil(NB / 2) level-0 centroids -> ceil of an
    eighth of those at level 1; branch 4 pools both levels' rows."""
    model = port_model(seed=3)
    batch = port_batch(model, 4)
    dom = batch.domain
    c0 = -(-NB // 2)
    c1 = -(-c0 // 8)
    assert dom["_sa_idx_0"].shape == (B, c0, 8) and dom["_sa_idx_1"].shape == (B, c1, 8)
    assert dom["_sa_xg_0"].shape == (B, c0 * 8, 6)
    seen = []
    lin = model.module.global_fe.branch4_gsa.mlp.linear_0
    hook = lin.register_forward_hook(lambda m, i, o: seen.append(tuple(i[0].shape)))
    with torch.no_grad():
        model.module(batch["C"], batch)
    hook.remove()
    assert seen == [(B, c1 + c0, 256 + 2)]


def test_id_first_precompute_matches_jax():
    """The port's boundary chain with level 0's rows in ``[boundaryId || C]``
    order against JAX's ``_boundary_sa_precompute(..., "id_first")``:
    indices exactly, float entries within 1e-6; C_first stays the PIPN++
    default."""
    fractions, radii = SetAbstractionMrgSeq.fractions, SetAbstractionMrgSeq.radii
    assert (fractions, radii) == (JaxMrgSeq.fractions, JaxMrgSeq.radii)
    raw = make_foam_batch(B, NI, NB, NO, seed=5)
    jraw = jax_synthetic.make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(5))
    got = pipn._boundary_sa_precompute(fractions, radii, 8, "id_first")(raw)
    ref = jax_pipn._boundary_sa_precompute(fractions, radii, 8, feats_order="id_first")(jraw)
    assert set(got) == {f"_{key}" for key in ref}
    for key, r in ref.items():
        g, r = got[f"_{key}"].numpy(), np.asarray(r)
        assert g.shape == r.shape, key
        if key.split("_")[1] in ("cent", "idx", "mask"):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, err_msg=key, rtol=1e-6, atol=1e-6)
    bnd = raw["boundary"]
    xg = got["_sa_xg_0"].reshape(B, -1, 8, 6)
    first = got["_sa_idx_0"][:, :, 0]
    torch.testing.assert_close(xg[:, :, 0, :4], torch.stack(
        [bnd["boundaryId"][b, first[b]] for b in range(B)]), rtol=0, atol=0)
    c_first = pipn._boundary_sa_precompute(fractions, radii, 8)(raw)["_sa_xg_0"]
    torch.testing.assert_close(c_first[..., :2], got["_sa_xg_0"][..., 4:], rtol=0, atol=0)
    with pytest.raises(ValueError, match="feature order"):
        pipn._geometry_features(bnd, "last")


def test_plain_forward_matches_jax(jax_side):
    jax_model, _, state, batches = jax_side
    jb = batches[0]
    ref = np.asarray(jax_model.module.apply({"params": state.params}, jb["C"], jb,
                                            deterministic=True))
    model = port_model(state.params)
    batch = port_batch(model, 11)
    with torch.no_grad():
        out = model.module(batch["C"], batch)
    assert out.shape == (B, NI + NB, 3)
    np.testing.assert_allclose(out.numpy(), ref, **V_TOL)


def test_derivative_apply_and_verbose_prediction_match_jax(jax_side):
    jax_model, fns, state, batches = jax_side
    ref = [np.asarray(a) for a in
           jax_model.derivative_apply(state.params, batches[0], None, True)]
    model = port_model(state.params)
    batch = port_batch(model, 11)
    with torch.no_grad():
        out = [a.numpy() for a in model.derivative_apply(batch)]
    assert out[0].shape == (B, NI + NB, 3) and out[1].shape == (B, NI, 3, 2)
    np.testing.assert_allclose(out[0], ref[0], **V_TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, **tol(r))

    ref_pred, ref_extras = fns.predict_batch(state.params, batches[0], True)
    pred, extras = engine.make_predict_functions(model).predict_batch(batch, True)
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref_pred.data), **V_TOL)
    r = np.asarray(ref_extras.data)
    np.testing.assert_allclose(extras.data.numpy(), r, **tol(r))


def test_compute_losses_and_gradients_match_jax(jax_side):
    jax_model, _, state, batches = jax_side
    w = jnp.asarray(WEIGHTS, jnp.float32)

    def total(params):
        losses_, predicted = jax_engine.compute_losses(jax_model, params, batches[0], None,
                                                       deterministic=True)
        return jnp.sum(w * losses_), (losses_, predicted)

    (_, (ref_losses, ref_pred)), ref_grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(state.params)
    model = port_model(state.params)
    got, predicted = engine.compute_losses(model, port_batch(model, 11), deterministic=True)
    assert got.shape == (model.num_losses,) == (9,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_losses), **tol(ref_losses))
    np.testing.assert_allclose(predicted.data.detach().numpy(), np.asarray(ref_pred.data),
                               **V_TOL)
    torch.sum(torch.tensor(WEIGHTS, dtype=torch.float32) * got).backward()
    grads = grads_to_flax(model.module)
    # every branch of the encoder receives a gradient
    for key, leaf in grads["global_fe"].items():
        assert all(np.abs(v["kernel"]).max() > 0 for v in jax.tree_util.tree_leaves(
            leaf, is_leaf=lambda n: "kernel" in n)), key
    assert_trees_close(grads, numpy_tree(ref_grads))


def test_three_adam_steps_match_jax(jax_side):
    """steps_per_epoch = 2: the third step runs at lr0 * gamma."""
    _, fns, state, batches = jax_side
    model = port_model(state.params)
    port = engine.make_train_functions(model, engine.make_optimizer(model, 2),
                                       scaling.FixedLossScaler(WEIGHTS))
    pstate = port.init_state()
    assert port.metric_labels == fns.metric_labels
    jstate = jax.tree_util.tree_map(jnp.copy, state)
    for i, seed in enumerate((11, 12, 13)):
        jstate, ref_m = fns.train_step(jstate, batches[i])
        pstate, m = port.train_step(pstate, port_batch(model, seed))
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), **tol(ref_m))
        assert_trees_close(params_to_flax(model.module), numpy_tree(jstate.params))


def test_path_without_an_attached_chain_builds_the_same_one():
    model = port_model(seed=3)
    raw = make_foam_batch(B, NI, NB, NO, seed=4)
    attached = model.attach_neighbors(raw)
    with torch.no_grad():
        for a, b in zip(model.derivative_apply(attached), model.derivative_apply(raw)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="attach_neighbors"):
        model.derivative_apply(raw.to("meta"))


def test_trains_with_dropout_and_reproducibly():
    def run():
        model = port_model(dropout=(0.1, 0.0), seed=4)
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1),
                                          scaling.FixedLossScaler(WEIGHTS))
        state = fns.init_state(seed=21)
        batch = port_batch(model, 6)
        totals = []
        for _ in range(8):
            state, m = fns.train_step(state, batch)
            totals.append(float(m[0]))
        return totals

    totals = run()
    assert np.isfinite(totals).all() and totals[-1] < totals[0]
    assert run() == totals


def test_exact_path_is_not_ported():
    """Named when MRG's exact path raised: it now builds with no analytic
    path, keeps the chain precompute, and takes a training step whose
    loss equals the analytic path's (the analytic path is exact for this
    family; tests/test_torch_exact_pp.py holds it to the JAX package)."""
    losses = []
    for fast in (True, False):
        model = pipn.pipn_foam_pp_mrg(**CFG, scalers=make_scalers(), seg_dropout=[0.05, 0],
                                      fast_derivatives=fast, device="cpu",
                                      generator=torch.Generator().manual_seed(4))
        assert (model.derivative_apply is None) == (not fast)
        assert model.neighbor_precompute is not None
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1))
        state, m = fns.train_step(fns.init_state(seed=21), port_batch(model, 6))
        assert state.step == 1 and bool(torch.isfinite(m).all())
        losses.append(m)
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-4,
                               atol=1e-4 * float(losses[0].abs().max()))
