"""The measurement tools' shared ground: the bench envelope, the subject a
tool measures (a zoo model at full width, its step functions and one batch),
and the sub-programs ("pieces") of a training step that the profile tools
time one by one.

The envelope is the bench's: ``make_foam_batch(52, 1500, 1000, 700)`` from
seed 8421, the first batch of 13 cases, with the model's
``attach_neighbors`` applied. Models come from the bench zoo
(``bench.make_model``: the examples' ``get_model`` at full width, with their
fixed loss weights). Tests cut the envelope to a few cases and tens of
points through ``Envelope``.

A piece is a plain function of a ``Subject`` (its model, whose module holds
the parameters, its step functions and state, and its batch), the port's
counterpart of the JAX tools' closures over ``(model, params, batch)``
(``tools/profile_delta.py:77-318``). The profiled families run their
analytic derivative paths, so a forward piece returns its outputs without
autograd; a forward+backward piece (``*_fwdbwd``) returns the gradients of
a scalar of its outputs by parameter name. Where a piece's JAX counterpart draws dropout, the port's draws it from
the fixed seed ``SEED``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from porous_cfd_tpu_torch import bench
from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch
from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
from porous_cfd_tpu_torch.models.pipn import (_decoder_prop_dispatch, _geometry_features,
                                              _pointnet_global_dispatch,
                                              _winner_gather_ctx, pipn_apply_with_derivatives)
from porous_cfd_tpu_torch.ops import neural_op_cuda, pointnet_cuda, sa_cuda
from porous_cfd_tpu_torch.physics import analytic
from porous_cfd_tpu_torch.train.engine import (compute_losses, gather_cases, make_optimizer,
                                               make_train_functions, model_derivatives)
from porous_cfd_tpu_torch.utils import profiling

SEED = bench.SEED


@dataclasses.dataclass(frozen=True)
class Envelope:
    """The data a tool runs on: ``cases`` cases of ``n_int`` internal,
    ``n_bnd`` boundary and ``n_obs`` observation points from ``seed``, in
    batches of ``batch``."""
    cases: int = bench.CASES
    batch: int = bench.BATCH
    n_int: int = bench.POINTS[0]
    n_bnd: int = bench.POINTS[1]
    n_obs: int = bench.POINTS[2]
    seed: int = bench.SEED


ENVELOPE = Envelope()


@dataclasses.dataclass
class Subject:
    """What a tool measures: ``model`` (its module holds the parameters),
    its step functions ``fns`` and ``state``, one attached ``batch``, and a
    cache of the constants some pieces hold fixed."""
    family: str
    model: object
    fns: object
    state: object
    batch: FoamData
    device: torch.device
    cache: dict = dataclasses.field(default_factory=dict)


def envelope_data(env: Envelope = ENVELOPE) -> FoamData:
    """The envelope's cases (CPU tensors)."""
    return make_foam_batch(env.cases, env.n_int, env.n_bnd, env.n_obs, seed=env.seed)


def load_subject(family: str, device, env: Envelope = ENVELOPE,
                 steps_per_epoch: Optional[int] = None) -> Subject:
    """The bench zoo's ``family`` on ``device``, its step functions with the
    zoo's fixed loss weights (``steps_per_epoch`` of the optimizer's decay:
    the envelope's by default), and the envelope's first batch, attached."""
    model, scaler = bench.make_model(family, device)
    dataset = model.attach_neighbors(envelope_data(env).to(device))
    batch = gather_cases(dataset, torch.arange(env.batch, device=device))
    fns = make_train_functions(model, make_optimizer(
        model, steps_per_epoch or max(1, env.cases // env.batch)), scaler)
    return Subject(family, model, fns, fns.init_state(seed=SEED), batch, device)


def time_piece(fn: Callable, device, n: int = 10) -> dict:
    """A piece's time: on the card ``profiling.device_ms`` (device ms per
    call beside the CUDA-event wall ms); on the CPU the host's wall ms per
    call only, with no device time."""
    if device.type == "cuda":
        out = profiling.device_ms(fn, n=n, device=device)
        return {"device_ms": out["device_ms"], "wall_ms": out["wall_ms"],
                "profiled_windows": out["windows"], "top_kernels": out["kernels"]}
    seconds, _ = profiling.timed(fn, n=n, warmup=1)
    return {"device_ms": None, "wall_ms": seconds * 1e3}


def header(tool: str, device, **extra) -> dict:
    """The fields every tool's line starts with: the tool, the device, the
    card's name and power limit as ``nvidia-smi`` gives them (None on the
    CPU) and the torch version."""
    return {"tool": tool, "device": str(device), "card": bench.card_label(device),
            "torch": torch.__version__, **extra}


# ---- helpers -----------------------------------------------------------------


def _grads(loss: torch.Tensor, module: torch.nn.Module) -> dict:
    """d loss / d parameter, by parameter name (the parameters it reaches)."""
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    got = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: g for (n, _), g in zip(named, got) if g is not None}


def _sum_sq(tensors) -> torch.Tensor:
    return sum((t ** 2).sum() for t in tensors)


def _local_linears(module):
    if hasattr(module, "points_encoder"):
        return module.points_encoder.linears            # PI-GANO
    return module.feature_extract.local_feature.linears  # PIPN, PIPN++


def _local_chain(s: Subject):
    """The local MLP's (v, J, H) on the internal rows (transposed layout)
    and its values on the boundary rows."""
    module = s.model.module
    internal, boundary = split_contiguous(s.batch)
    x_int, x_bnd = internal["C"], boundary["C"]
    linears, act = _local_linears(module), module.activation
    j0, h0 = analytic.identity_jacobian_t(x_int)
    lv, lj, lh = analytic.mlp_prop_t(linears, x_int, j0, h0, act)
    return lv, lj, lh, analytic.mlp_value(linears, x_bnd, act)


def _pipn_feats(s: Subject):
    n_int = split_contiguous(s.batch)[0].data.shape[-2]
    feats = torch.cat([s.batch["boundaryId"], s.batch["sdf"]], dim=-1)
    return feats[..., :n_int, :], feats[..., n_int:, :]


def _sa_inputs(s: Subject):
    """PIPN++'s (or PI-GANO++'s) geometry chain: the module, its input rows,
    the boundary positions and the attached neighbour chain."""
    module = s.model.module
    boundary = split_contiguous(s.batch)[1]
    if hasattr(module, "feature_extract"):
        seq, n_levels = module.feature_extract.global_feature, len(module.fe_radius)
        geom = _geometry_features(boundary, module.geom_features_order)
    else:
        seq, n_levels = module.geometry_encoder.set_abstraction, len(module.geometry_radius)
        geom = _geometry_features(boundary)
    return seq, geom, boundary["C"], extract_sa_neighbors(s.batch.domain, n_levels)


def _gano_context(s: Subject):
    """PI-GANO's pooled geometry and branch embeddings and the points
    encoder's boundary values, computed once and held fixed (the JAX tools'
    ``geom0``, ``par0``, ``lv_b0``)."""
    if "gano" not in s.cache:
        with torch.no_grad():
            s.cache["gano"] = (geometry_fwd(s), branch_fwd(s), _local_chain(s)[3])
    return s.cache["gano"]


# ---- the pieces ----------------------------------------------------------------


def step(s: Subject):
    """One training step (the optimizer's update included); its metrics."""
    s.state, metrics = s.fns.train_step(s.state, s.batch)
    return metrics


def loss_grad(s: Subject):
    """The gradients of the unweighted loss sum, dropout on."""
    losses, _ = compute_losses(s.model, s.batch, False, SEED)
    return _grads(losses.sum(), s.model.module)


def losses_fwd(s: Subject):
    """The loss vector: the derivative forward and the residuals."""
    with torch.no_grad():
        return compute_losses(s.model, s.batch, False, SEED)[0]


def derivative_fwd(s: Subject):
    """(out, J, H) of the model's derivative path, dropout on."""
    with torch.no_grad():
        return model_derivatives(s.model, s.batch, False, SEED)


def derivative_fwdbwd(s: Subject):
    out, jac, lap = model_derivatives(s.model, s.batch, False, SEED)
    return _grads(out.sum() + jac.sum() + lap.sum(), s.model.module)


def local_vjh_fwd(s: Subject):
    """The local MLP's (v, J, H) on the internal rows."""
    with torch.no_grad():
        return _local_chain(s)[:3]


def _sa_kernel(s: Subject):
    seq, geom, _, nbrs = _sa_inputs(s)
    return sa_cuda.sa_seq_fused(seq, s.model.module.activation, geom, nbrs)


def _sa_plain(s: Subject):
    seq, geom, pos, nbrs = _sa_inputs(s)
    return seq(geom, pos, True, nbrs)[0]


def sa_fwd(s: Subject):
    """The geometry SetAbstraction chain through its kernels
    (``sa_seq_fused``: sa_neighborhood a radius level, pointnet_global for
    the global level)."""
    with torch.no_grad():
        return _sa_kernel(s)


def sa_fwdbwd(s: Subject):
    return _grads((_sa_kernel(s) ** 2).sum(), s.model.module)


def sa_plain_fwd(s: Subject):
    """The same chain through the module's plain PyTorch forward (the
    counterpart of the JAX tool's "xla" sequence)."""
    with torch.no_grad():
        return _sa_plain(s)


def sa_plain_fwdbwd(s: Subject):
    return _grads((_sa_plain(s) ** 2).sum(), s.model.module)


def _local_decoder(s: Subject):
    module = s.model.module
    lv, lj, lh, lv_b = _local_chain(s)
    g = lv.new_zeros((lv.shape[0], 1, module.seg_layers[0] - lv.shape[-1]))
    return _sum_sq(_decoder_prop_dispatch(module.decoder, lv.shape[-1], lv, lj, lh, lv_b, g,
                                          module.activation, module.seg_dropout, True, None))


def local_decoder_fwd(s: Subject):
    """The local chain and the decoder's (v, J, H) (``decoder_prop``) on a
    zero context, without dropout; the sum of the outputs' squares."""
    with torch.no_grad():
        return _local_decoder(s)


def local_decoder_fwdbwd(s: Subject):
    return _grads(_local_decoder(s), s.model.module)


def local_pointnet_fwd(s: Subject):
    """The local chain and the pooled global feature with its argmax rows
    (``pointnet_global``)."""
    module = s.model.module
    feats_i, feats_b = _pipn_feats(s)
    with torch.no_grad():
        lv, _, _, lv_b = _local_chain(s)
        g_in = torch.cat([torch.cat([lv, feats_i], dim=-1), torch.cat([lv_b, feats_b], dim=-1)],
                         dim=-2)
        return pointnet_cuda.pointnet_global(module.feature_extract.global_feature.linears,
                                             g_in.contiguous(), module.activation)


def _winner_ctx(s: Subject):
    module = s.model.module
    feats_i, feats_b = _pipn_feats(s)
    lv, lj, lh, lv_b = _local_chain(s)
    w0g = module.decoder.linear_0.weight[:, lv.shape[-1]:]
    return _sum_sq(_winner_gather_ctx(module.feature_extract, lv, lj, lh, lv_b, feats_i,
                                      feats_b, w0g, module.activation))


def local_winnerctx_fwd(s: Subject):
    """The local chain and the max-pool coupling's winner chain
    (``_winner_gather_ctx``: g and the decoder's layer-0 J/H terms); the
    sum of their squares."""
    with torch.no_grad():
        return _winner_ctx(s)


def local_winnerctx_fwdbwd(s: Subject):
    return _grads(_winner_ctx(s), s.model.module)


def _full(s: Subject, coupled: bool):
    fn = pipn_apply_with_derivatives(s.model.module, coupled)
    return _sum_sq(fn(s.batch, False, SEED))


def full_coupled_fwd(s: Subject):
    """PIPN's whole analytic path with the max-pool coupling (winner chain,
    decoder_prop's j0_add mode), dropout on; the sum of the outputs'
    squares."""
    with torch.no_grad():
        return _full(s, True)


def full_coupled_fwdbwd(s: Subject):
    return _grads(_full(s, True), s.model.module)


def full_decoupled_fwd(s: Subject):
    """The same with the context held constant per case."""
    with torch.no_grad():
        return _full(s, False)


def full_decoupled_fwdbwd(s: Subject):
    return _grads(_full(s, False), s.model.module)


def geometry_fwd(s: Subject):
    """PI-GANO's geometry encoder: ``pointnet_global`` over [boundaryId ||
    sdf || C]."""
    module = s.model.module
    with torch.no_grad():
        return pointnet_cuda.pointnet_global(module.geometry_encoder.linear.linears,
                                             s.batch.domain["_gano_geom_in"].contiguous(),
                                             module.activation)[0]


def branch_fwd(s: Subject):
    """PI-GANO's branch: ``pointnet_global`` over the variable boundaries'
    parameter rows."""
    module = s.model.module
    with torch.no_grad():
        return _pointnet_global_dispatch(module.branch.linear, s.batch.domain["_gano_par"],
                                         module.activation)


def _local_trunk(s: Subject):
    module = s.model.module
    geom, par, lv_b = _gano_context(s)
    lv, ljt, lht, _ = _local_chain(s)
    return _sum_sq(neural_op_cuda.neural_ops_prop(
        module.neural_ops.linears, module.reduction, lv.shape[-1], lv.contiguous(),
        ljt.contiguous(), lht.contiguous(), lv_b, geom.contiguous(), par.contiguous(),
        module.activation, module.operator_dropout, True, None))


def local_trunk_fwd(s: Subject):
    """The points encoder's (v, J, H) and the trunk (``neural_ops_prop``) on
    the fixed geometry, branch and boundary values, without dropout; the sum
    of the outputs' squares."""
    with torch.no_grad():
        return _local_trunk(s)


def local_trunk_fwdbwd(s: Subject):
    return _grads(_local_trunk(s), s.model.module)


PIECES = {"step": step, "loss_grad": loss_grad, "losses_fwd": losses_fwd,
          "derivative_fwd": derivative_fwd, "derivative_fwdbwd": derivative_fwdbwd,
          "local_vjh_fwd": local_vjh_fwd,
          "sa_fwd": sa_fwd, "sa_fwdbwd": sa_fwdbwd,
          "sa_plain_fwd": sa_plain_fwd, "sa_plain_fwdbwd": sa_plain_fwdbwd,
          "local+decoder_fwd": local_decoder_fwd, "local+decoder_fwdbwd": local_decoder_fwdbwd,
          "local+pointnet_fwd": local_pointnet_fwd,
          "local+winnerctx_fwd": local_winnerctx_fwd,
          "local+winnerctx_fwdbwd": local_winnerctx_fwdbwd,
          "full_coupled_fwd": full_coupled_fwd, "full_coupled_fwdbwd": full_coupled_fwdbwd,
          "full_decoupled_fwd": full_decoupled_fwd,
          "full_decoupled_fwdbwd": full_decoupled_fwdbwd,
          "geometry_fwd": geometry_fwd, "branch_fwd": branch_fwd,
          "local+trunk_fwd": local_trunk_fwd, "local+trunk_fwdbwd": local_trunk_fwdbwd}


def time_pieces(s: Subject, names, n: int = 10) -> dict:
    """Each named piece's time (``time_piece``), in order."""
    return {name: time_piece(lambda f=PIECES[name]: f(s), s.device, n) for name in names}
