"""The profile tools' pieces (``porous_cfd_tpu_torch/tools/pieces.py``) held
to the same sub-programs built from the JAX package's functions
(``models/pipn.py`` ``_decoder_prop_dispatch``, ``_pointnet_global_dispatch``,
``_winner_gather_ctx``, ``models/pi_gano.py``'s trunk through
``neural_op_pallas.neural_ops_prop``, ``physics/analytic.py`` ``mlp_prop_t``;
the Pallas kernels in interpret mode), on parameters carried across by
``convert.params_from_flax``, dropout off, at narrow widths; and each tool's
``run(device="cpu")`` at a cut envelope prints its keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.data.foam_data import split_contiguous as jax_split
from porous_cfd_tpu.models import pipn as jax_pipn
from porous_cfd_tpu.models.neighbors import extract_sa_neighbors as jax_extract_sa
from porous_cfd_tpu.models.pi_gano import pi_gano as jax_pi_gano
from porous_cfd_tpu.models.pi_gano import pi_gano_pp as jax_pi_gano_pp
from porous_cfd_tpu.models.set_abstraction import SetAbstractionSeq as JaxSetAbstractionSeq
from porous_cfd_tpu.ops import neural_op_pallas, pointnet_pallas
from porous_cfd_tpu.physics import analytic as jax_analytic
from porous_cfd_tpu.physics.scaling import FixedLossScaler as JaxFixedLossScaler
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models.pi_gano import pi_gano, pi_gano_pp
from porous_cfd_tpu_torch.models.pipn import pipn_foam, pipn_foam_pp
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
from porous_cfd_tpu_torch.tools import pieces
from porous_cfd_tpu_torch.tools.pieces import Envelope, Subject
from porous_cfd_tpu_torch.train import engine

B, NI, NB, NO = 2, 40, 16, 8
WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
PIPN = dict(nu=1489.4e-6, d=14000.0, f=17.11, fe_local_layers=[2, 16, 16],
            fe_global_layers=[16 + 5, 16, 32, 64], seg_layers=[64 + 16, 32, 32, 16, 3],
            seg_dropout=[0.0, 0.0, 0, 0])
PIPN_PP = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 16, 16],
               seg_layers=[32 + 16, 24, 3], fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
               fe_global_layers=[[2 + 4 + 2, 16, 16], [16 + 2, 24, 24], [24 + 2, 24, 32]],
               max_neighbors=8, seg_dropout=[0.0, 0])
PI_GANO = dict(nu=1489.4e-6, out_features=3, branch_layers=[8, 16, 40, 40],
               geometry_layers=[7, 16, 24, 24], local_layers=[2, 16, 16, 16], n_operators=3,
               operator_dropout=[0, 0, 0])
PI_GANO_PP = dict(PI_GANO, geometry_layers=[[2 * 2 + 4, 16, 16], [16 + 2, 24, 24],
                                            [24 + 2, 24, 24]],
                  geometry_radius=[0.5, 1], geometry_fraction=[0.5, 0.25], max_neighbors=8)
FACTORIES = {
    "pipn": (lambda s: jax_pipn.pipn_foam(**PIPN, scalers=s),
             lambda: pipn_foam(**PIPN, scalers=make_scalers(), device="cpu")),
    "pipn_pp": (lambda s: jax_pipn.pipn_foam_pp(**PIPN_PP, scalers=s),
                lambda: pipn_foam_pp(**PIPN_PP, scalers=make_scalers(), device="cpu")),
    "pi_gano": (lambda s: jax_pi_gano(**PI_GANO, scalers=s, fast_derivatives=True,
                                      variable_boundaries=VARIABLE_BOUNDARIES),
                lambda: pi_gano(**PI_GANO, scalers=make_scalers(), fast_derivatives=True,
                                variable_boundaries=VARIABLE_BOUNDARIES, device="cpu")),
    "pi_gano_pp": (lambda s: jax_pi_gano_pp(**PI_GANO_PP, scalers=s,
                                            variable_boundaries=VARIABLE_BOUNDARIES),
                   lambda: pi_gano_pp(**PI_GANO_PP, scalers=make_scalers(),
                                      variable_boundaries=VARIABLE_BOUNDARIES, device="cpu")),
}
# a cut envelope for the tools' own runs (full widths from the zoo)
TINY = Envelope(cases=2, batch=2, n_int=24, n_bnd=16, n_obs=8)


def tol(ref):
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture(scope="module")
def family(request):
    """The JAX model, state and attached batch of a family; the port's side
    is built fresh per test (``subject``)."""
    name = request.param
    jax_model = FACTORIES[name][0](jax_synthetic.make_scalers())
    fns = jax_engine.make_train_functions(jax_model, jax_engine.make_optimizer(jax_model, 1),
                                          JaxFixedLossScaler(WEIGHTS))
    jb = jax_model.attach_neighbors(jax_synthetic.make_foam_batch(
        B, NI, NB, NO, rng=np.random.default_rng(11)))
    return name, jax_model, fns, fns.init_state(jb), jb


def subject(family) -> Subject:
    name, _, _, state, _ = family
    model = FACTORIES[name][1]()
    params_from_flax(jax.tree_util.tree_map(np.asarray, state.params), model.module)
    batch = model.attach_neighbors(make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(11)))
    fns = engine.make_train_functions(model, engine.make_optimizer(model, 1),
                                      FixedLossScaler(WEIGHTS))
    return Subject(name, model, fns, fns.init_state(seed=1), batch, torch.device("cpu"))


def flax_grads(grads: dict) -> dict:
    """The port's gradients by parameter name as a flax tree (kernels
    transposed)."""
    tree: dict = {}
    for name, g in grads.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node["kernel" if leaf == "weight" else "bias"] = g.numpy().T if leaf == "weight" \
            else g.numpy()
    return tree


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def assert_grads_match(got: dict, ref_tree):
    """Every gradient the port reaches equals JAX's; every one it does not
    reach is zero in JAX's."""
    port = dict(leaves(flax_grads(got)))
    assert port
    for path, r in leaves(jax.tree_util.tree_map(np.asarray, ref_tree)):
        if path in port:
            np.testing.assert_allclose(port[path], r, err_msg="/".join(path), **tol(r))
        else:
            assert not np.any(r), "/".join(path)


def assert_values_match(got, ref):
    got = [got] if torch.is_tensor(got) else list(got)
    ref = [ref] if not isinstance(ref, (tuple, list)) else list(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy().reshape(r.shape), r, **tol(r))


def sum_sq(tensors):
    return sum(jnp.sum(t ** 2) for t in tensors)


def jax_pieces(family):
    """The JAX sub-program of each piece of the family: name -> (kind,
    thunk), kind "value" (outputs) or "grads" (a gradient tree)."""
    name, model, fns, state, jb = family
    params, module, act = state.params, model.module, model.module.activation
    key = jax.random.PRNGKey(0)
    internal, boundary = jax_split(jb)
    x_int, x_bnd = internal["C"], boundary["C"]

    # jitted: XLA's CPU code for a whole sub-program is several times
    # faster than op-by-op dispatch
    def grad(f):
        return "grads", lambda: jax.jit(jax.grad(f))(params)

    def value(f):
        return "value", lambda: jax.jit(f)(params)

    def losses(p):
        return jax_engine.compute_losses(model, p, jb, key, deterministic=False)[0]

    def deriv_sum(p):
        out, j, h = model.derivative_apply(p, jb, key, False)
        return jnp.sum(out) + jnp.sum(j) + jnp.sum(h)

    gano = name.startswith("pi_gano")
    local_params = (lambda p: p["points_encoder"]) if gano else \
        (lambda p: p["feature_extract"]["local_feature"])
    local_layers = module.local_layers if gano else module.fe_local_layers

    def local(p):
        j0, h0 = jax_analytic.identity_jacobian_t(x_int)
        lv, lj, lh = jax_analytic.mlp_prop_t(local_params(p), local_layers, x_int, j0, h0, act)
        return lv, lj, lh, jax_analytic.mlp_value(local_params(p), local_layers, x_bnd, act)

    out = {"step": ("value", lambda: fns.train_step(state, jb)[1]),
           "loss_grad": grad(lambda p: jnp.sum(losses(p))),
           "losses_fwd": value(losses),
           "derivative_fwd": value(lambda p: model.derivative_apply(p, jb, key, False)),
           "derivative_fwdbwd": grad(deriv_sum),
           "local_vjh_fwd": value(lambda p: local(p)[:3])}
    if name == "pipn":
        feats = jnp.concatenate([jb["boundaryId"], jb["sdf"]], axis=-1)
        feats_i, feats_b = feats[..., :NI, :], feats[..., NI:, :]

        def pointnet(p):
            lv, _, _, lv_b = local(p)
            g_in = jnp.concatenate([jnp.concatenate([lv, feats_i], -1),
                                    jnp.concatenate([lv_b, feats_b], -1)], axis=-2)
            return pointnet_pallas.pointnet_global(p["feature_extract"]["global_feature"],
                                                   module.fe_global_layers, g_in, act,
                                                   return_argmax=True)

        def winner(p):
            lv, lj, lh, lv_b = local(p)
            return sum_sq(jax_pipn._winner_gather_ctx(
                p["feature_extract"], module, lv, lj, lh, lv_b, feats_i, feats_b,
                p["decoder"]["linear_0"]["kernel"][lv.shape[-1]:], act))

        def full(coupled):
            return lambda p: sum_sq(jax_pipn.pipn_apply_with_derivatives(module, coupled)(
                p, jb, None, True))

        out.update({"local+pointnet_fwd": value(pointnet),
                    "local+winnerctx_fwd": value(winner),
                    "local+winnerctx_fwdbwd": grad(winner),
                    "full_coupled_fwd": value(full(True)),
                    "full_coupled_fwdbwd": grad(full(True)),
                    "full_decoupled_fwd": value(full(False)),
                    "full_decoupled_fwdbwd": grad(full(False))})
    if name in ("pipn_pp", "pi_gano_pp"):
        geom_in = jnp.concatenate([boundary["C"], boundary["boundaryId"]], axis=-1)
        if name == "pipn_pp":
            chain = (module.fe_fraction, module.fe_radius, module.fe_global_layers)
            seq_params = (lambda p: p["feature_extract"]["global_feature"])
        else:
            chain = (module.geometry_fraction, module.geometry_radius, module.geometry_layers)
            seq_params = (lambda p: p["geometry_encoder"]["set_abstraction"])
        nbrs = jax_extract_sa(jb.domain, len(chain[1]))
        seq = JaxSetAbstractionSeq(*chain, return_skip=False, activation=act,
                                   max_neighbors=module.max_neighbors)

        def sa(p):
            y = seq.apply({"params": seq_params(p)}, geom_in, x_bnd, True, nbrs)
            return y[0] if isinstance(y, tuple) else y

        out.update({"sa_fwd": value(sa),
                    "sa_fwdbwd": grad(lambda p: jnp.sum(sa(p) ** 2)),
                    "sa_plain_fwd": value(sa),
                    "sa_plain_fwdbwd": grad(lambda p: jnp.sum(sa(p) ** 2))})
    if name == "pipn_pp":
        def decoder(p):
            lv, lj, lh, lv_b = local(p)
            g = jnp.zeros((B, 1, module.seg_layers[0] - lv.shape[-1]))
            return sum_sq(jax_pipn._decoder_prop_dispatch(
                p["decoder"], module.seg_layers, lv.shape[-1], lv, lj, lh, lv_b, g, act,
                module.seg_dropout, True, None))

        out.update({"local+decoder_fwd": value(decoder),
                    "local+decoder_fwdbwd": grad(decoder)})
    if name == "pi_gano":
        def geometry(p):
            return jax_pipn._pointnet_global_dispatch(
                p["geometry_encoder"]["linear"], module.geometry_layers,
                jb.domain["_gano_geom_in"], act)

        def branch(p):
            return jax_pipn._pointnet_global_dispatch(p["branch"]["linear"],
                                                      module.branch_layers,
                                                      jb.domain["_gano_par"], act)

        geom0, par0, lv_b0 = geometry(params), branch(params), local(params)[3]

        def trunk(p):
            lv, ljt, lht, _ = local(p)
            return sum_sq(neural_op_pallas.neural_ops_prop(
                p["neural_ops"], module.n_operators, lv.shape[-1], lv, ljt, lht, lv_b0, geom0,
                par0, act, module.operator_dropout, True, p["reduction"], deterministic=True,
                rng=None))

        out.update({"geometry_fwd": value(geometry),
                    "branch_fwd": value(branch),
                    "local+trunk_fwd": value(trunk),
                    "local+trunk_fwdbwd": grad(trunk)})
    return out


def piece_names():
    """(family, piece) of every piece profile_pp, profile_gano and
    profile_delta time on the families held here."""
    from porous_cfd_tpu_torch.tools import profile_delta, profile_gano, profile_pp
    names = {(f, n) for f, ns in profile_delta.FAMILY_PIECES.items() for n in ns}
    names |= {(f, n) for f in profile_pp.FAMILIES for n in profile_pp.piece_names(f)}
    names |= {("pi_gano", n) for n in profile_gano.PIECE_NAMES}
    return sorted(names)


@pytest.mark.parametrize("family,piece", piece_names(), indirect=["family"])
def test_piece_matches_jax_sub_program(family, piece):
    kind, ref = jax_pieces(family)[piece]
    got = pieces.PIECES[piece](subject(family))
    if kind == "grads":
        assert_grads_match(got, ref())
    else:
        assert_values_match(got, ref())


# ---- the tools' own runs on the CPU -------------------------------------------


def test_profile_tools_print_their_keys(capsys, monkeypatch):
    import json

    from porous_cfd_tpu_torch.tools import (profile_delta, profile_gano, profile_pp,
                                            profile_step)
    monkeypatch.setattr(profile_step, "PEAK_SHAPE", (32, 16, 16))
    runs = [(profile_step, ["--family", "pipn"]),
            (profile_pp, ["--family", "pipn_pp"]),
            (profile_pp, ["--family", "pi_gano"]),
            (profile_gano, []),
            (profile_delta, ["--family", "pipn", "--n", "1"]),
            (profile_delta, ["--family", "pi_gano", "--n", "1"]),
            (profile_delta, ["--family", "pipn_pp", "--n", "1"])]
    for tool, argv in runs:
        out = tool.run(argv, device="cpu", envelope=TINY)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line == json.loads(json.dumps(out))
        assert line["device"] == "cpu" and line["card"] is None
        for name, piece in line["pieces"].items():
            # on the CPU a piece has its host time and no device time
            assert piece["device_ms"] is None and piece["wall_ms"] > 0, name
    assert set(out["pieces"]) == set(profile_delta.FAMILY_PIECES["pipn_pp"])
    step_line = profile_step.run(["--family", "pipn"], device="cpu", envelope=TINY)
    for key in ("matmul_peak_tf32_tflops", "matmul_peak_f32_tflops", "train_step_ms",
                "train_steps_per_sec", "inventory_step_gflops", "achieved_tflops",
                "mfu_vs_f32_peak_pct", "mfu_vs_tf32_peak_pct"):
        assert step_line[key] > 0, key
