"""PIPN models (counterpart of ``porous_cfd_tpu/models/pipn.py``): the plain
``PipnModule``, ``PipnPpModule``, ``PipnPpMrgModule`` and
``PipnPpFullModule`` (the U-Net) forwards, the ``pipn_foam``,
``pipn_manufactured``, ``pipn_foam_pp``, ``pipn_foam_pp_mrg``,
``pipn_manufactured_pp`` and ``pipn_foam_pp_full`` factories
and their analytic derivative paths, which carry verbose prediction and
training (a model without one takes the exact autodiff operator,
``physics/operators.py``).

Per-point features + a pooled global geometry embedding, decoded by a shared
segmentation MLP. PIPN's analytic path runs two CUDA kernels on the card:
``pointnet_global`` (pooled global feature, and its argmax rows in the
max-pool-coupled mode) and ``decoder_prop`` (fused (v, J, H) decoder with
dropout, internal and boundary launches; in the coupled mode with additive
layer-0 J/H terms built from the pooling winners' rows). PIPN++
pools its embedding with a SetAbstraction chain over the boundary cloud:
``sa_neighborhood`` per radius level (static at level 0, dynamic at level
1) and ``pointnet_global`` for the trailing global level, on a neighbour
chain precomputed once per dataset (FPS through its own kernel); PIPN++
MRG's encoder runs three radius levels through ``sa_neighborhood`` and two
global ones through ``pointnet_global`` on one such chain. The U-Net's
analytic path (``models/fp_analytic.py``) runs its all-points encoder
through ``sa_neighborhood`` (two dynamic levels) and ``pointnet_global``.
Under autograd the backward kernels carry the gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models import fp_analytic
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.models.mlp import MLP, PointNetFeatureExtract
from porous_cfd_tpu_torch.models.neighbors import (extract_fp_idx, extract_sa_neighbors,
                                                   sa_chain_precompute, unet_chain_precompute)
from porous_cfd_tpu_torch.models.set_abstraction import (FeaturePropagationSeq,
                                                          PointNetFeatureExtractPp,
                                                          SetAbstractionMrgSeq,
                                                          SetAbstractionSeq)
from porous_cfd_tpu_torch.ops import decoder_cuda, pointnet_cuda, sa_cuda
from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.parallel.mesh import points_gather, points_max
from porous_cfd_tpu_torch.physics import analytic
from porous_cfd_tpu_torch.physics.losses import (ContinuityLoss, ContinuityLossStandardized,
                                                 MomentumLossFixed, MomentumLossManufactured)


class PipnModule(nn.Module):
    """Classic PIPN forward: features = [boundaryId || sdf], PointNet encoder
    on the differentiable points, tiled global embedding, shared decoder."""

    def __init__(self, fe_local_layers: Sequence[int],
                 fe_global_layers: Sequence[int], seg_layers: Sequence[int],
                 seg_dropout: Optional[Sequence[float]] = None,
                 activation: str = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fe_local_layers = tuple(fe_local_layers)
        self.fe_global_layers = tuple(fe_global_layers)
        self.seg_layers = tuple(seg_layers)
        self.seg_dropout = None if seg_dropout is None else tuple(seg_dropout)
        self.activation = activation
        self.feature_extract = PointNetFeatureExtract(
            fe_local_layers, fe_global_layers, activation, generator)
        self.decoder = MLP(seg_layers, seg_dropout, activation,
                           last_activation=False, generator=generator)

    def forward(self, points, batch: FoamData, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        """``points`` (..., N, 2) are the [internal || boundary] rows; the
        decoder's dropout (unless ``deterministic``) draws its masks from
        ``seed`` over those rows at their ``placement`` in the batch, as the
        analytic path does."""
        global_in = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
        local, g = self.feature_extract(global_in, points, deterministic, placement)
        exp_g = g.expand(*local.shape[:-1], g.shape[-1])
        seg_in = torch.cat([local, exp_g], dim=-1)
        return self.decoder(seg_in, deterministic, seed, placement)


def _geometry_features(boundary: FoamData, order: str = "C_first") -> torch.Tensor:
    """The geometry branch's input rows: ``[C || boundaryId]`` for
    ``"C_first"`` (PIPN++ on the foam data), ``[boundaryId || C]`` for
    ``"id_first"`` (PIPN++ MRG and the manufactured PIPN++)."""
    if order == "C_first":
        return torch.cat([boundary["C"], boundary["boundaryId"]], dim=-1)
    if order == "id_first":
        return torch.cat([boundary["boundaryId"], boundary["C"]], dim=-1)
    raise ValueError(f"geometry feature order {order!r} is not C_first or id_first")


class PipnPpModule(nn.Module):
    """PIPN++ forward: the geometry branch is a SetAbstraction chain over the
    boundary points, beside a local shared MLP on the differentiable points;
    tiled concat; decoder. ``geom_features_order`` is the geometry rows'
    concat order (``_geometry_features``): ``"C_first"`` for PIPN++ on the
    foam data, ``"id_first"`` for the manufactured PIPN++."""

    def __init__(self, fe_local_layers: Sequence[int],
                 fe_global_layers: Sequence[Sequence[int]], fe_radius: Sequence[float],
                 fe_fraction: Sequence[float], seg_layers: Sequence[int],
                 seg_dropout: Optional[Sequence[float]] = None, activation: str = "silu",
                 max_neighbors: int = 64, geom_features_order: str = "C_first",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.geom_features_order = geom_features_order
        self.fe_local_layers = tuple(fe_local_layers)
        self.fe_radius = tuple(fe_radius)
        self.fe_fraction = tuple(fe_fraction)
        self.seg_layers = tuple(seg_layers)
        self.seg_dropout = None if seg_dropout is None else tuple(seg_dropout)
        self.activation = activation
        self.max_neighbors = max_neighbors
        self.feature_extract = PointNetFeatureExtractPp(
            fe_local_layers, fe_global_layers, fe_fraction, fe_radius, activation,
            max_neighbors, generator)
        self.decoder = MLP(seg_layers, seg_dropout, activation, last_activation=False,
                           generator=generator)

    def forward(self, points, batch: FoamData, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        """``points`` and the decoder's dropout as in ``PipnModule.forward``;
        the geometry branch pools the whole boundary cloud (on each rank of
        a points share)."""
        boundary = placement.cloud(batch)["boundary"]
        geom = _geometry_features(boundary, self.geom_features_order)
        nbrs = extract_sa_neighbors(batch.domain, len(self.fe_radius))
        local, g = self.feature_extract(geom, boundary["C"], points, deterministic, nbrs)
        exp_g = g.expand(*local.shape[:-1], g.shape[-1])
        return self.decoder(torch.cat([local, exp_g], dim=-1), deterministic, seed, placement)


class PipnPpMrgModule(nn.Module):
    """PIPN++ MRG forward: a local shared MLP ``local_fe`` on the
    differentiable points, the multi-resolution-grouping encoder
    ``global_fe`` over the boundary points' ``[boundaryId || C]`` rows, the
    tiled concat and the decoder."""

    def __init__(self, n_dims: int, mrg_in_features: int, fe_local_layers: Sequence[int],
                 seg_layers: Sequence[int], seg_dropout: Optional[Sequence[float]] = None,
                 activation: str = "silu", max_neighbors: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_dims = n_dims
        self.mrg_in_features = mrg_in_features
        self.fe_local_layers = tuple(fe_local_layers)
        self.seg_layers = tuple(seg_layers)
        self.seg_dropout = None if seg_dropout is None else tuple(seg_dropout)
        self.activation = activation
        self.max_neighbors = max_neighbors
        self.local_fe = MLP(fe_local_layers, activation=activation, generator=generator)
        self.global_fe = SetAbstractionMrgSeq(mrg_in_features, n_dims, activation,
                                              max_neighbors, generator)
        self.decoder = MLP(seg_layers, seg_dropout, activation, last_activation=False,
                           generator=generator)

    def forward(self, points, batch: FoamData, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        """As ``PipnPpModule.forward``."""
        local = self.local_fe(points, deterministic)
        boundary = placement.cloud(batch)["boundary"]
        nbrs = extract_sa_neighbors(batch.domain, len(SetAbstractionMrgSeq.radii))
        g = self.global_fe(_geometry_features(boundary, "id_first"), boundary["C"],
                           deterministic, nbrs)
        exp_g = g.expand(*local.shape[:-1], g.shape[-1])
        return self.decoder(torch.cat([local, exp_g], dim=-1), deterministic, seed, placement)


def _decoder_prop_dispatch(decoder: MLP, n_local, v, jt, ht, v_b, g,
                           activation, dropout, deterministic, seed, j0_add=None,
                           h0_add=None, placement: Placement = WHOLE):
    """Decoder-stack propagation: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``decoder_cuda.decoder_prop`` goes by the
    tensors' device). Dropout runs unless ``deterministic``, with masks fixed
    by ``seed`` at the rows' ``placement``; ``j0_add``/``h0_add`` (..., D, Ni, F1) carry the max-pool
    coupling. Returns (out_merged, jac, lap) with jac/lap (..., Ni, O, D)."""
    return decoder_cuda.decoder_prop(
        decoder.linears, n_local, v.contiguous(), jt.contiguous(),
        ht.contiguous(), None if v_b is None else v_b.contiguous(),
        g.contiguous(), activation, dropout, deterministic, seed,
        j0_add=j0_add, h0_add=h0_add, placement=placement)


def _pointnet_global_dispatch(global_feature: MLP, x, activation):
    """Max-pooled value MLP over points: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns the (B, 1, F) max."""
    return pointnet_cuda.pointnet_global(global_feature.linears, x.contiguous(),
                                         activation)[0]


def pipn_apply_with_derivatives(module: PipnModule, coupled: bool = True):
    """The analytic derivative path of a PipnModule:
    ``fn(batch, deterministic=True, seed=None, placement=WHOLE) -> (out_full,
    jac, lap)`` with jac/lap shaped (..., Ni, O, D). With ``deterministic=False``
    the decoder applies its dropout, with masks that are a pure function of
    ``seed`` (a 64-bit integer; the training step derives it from the run's
    seed and the step) and of the rows' ``placement`` in the whole batch.
    ``batch`` may be a rank's share of the rows (a points-split
    ``placement``): the pool is then the whole cloud's, through
    ``parallel.mesh.points_max``, and every kernel runs on the share's rows.

    Max-pool coupling (``coupled=True``): the pooled global feature g
    depends on the differentiated internal coordinates through each
    channel's argmax row, so the true per-point derivative at a winner row
    includes the chain through g. ``_winner_gather_ctx`` propagates (v, J,
    H) through the global-feature chain at the winner rows only and hands
    the decoder the layer-0 terms it adds to J/H, from which the activation
    rules produce every cross term. A winner's terms enter its own row
    alone, so on a points share each rank propagates the chain of the
    channels it owns (``points_max``'s owner: the first maximal global row)
    at its local row, and adds nothing for the others. ``coupled=False``
    holds g constant per case. The two agree everywhere but at the winner
    rows."""

    def fn(batch: FoamData, deterministic: bool = True, seed=None,
           placement: Placement = WHOLE):
        internal_view, boundary_view = split_contiguous(batch)
        x_int = internal_view["C"]
        x_bnd = boundary_view["C"]
        n_int = x_int.shape[-2]
        feats = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
        act = module.activation
        fe = module.feature_extract

        j0, h0 = analytic.identity_jacobian_t(x_int)
        lv_i, lj, lh = analytic.mlp_prop_t(fe.local_feature.linears, x_int,
                                           j0, h0, act)
        lv_b = analytic.mlp_value(fe.local_feature.linears, x_bnd, act)
        n_local = lv_i.shape[-1]

        if not coupled:
            local_all = torch.cat([lv_i, lv_b], dim=-2)
            g, amax = pointnet_cuda.pointnet_global(
                fe.global_feature.linears, torch.cat([local_all, feats], dim=-1).contiguous(),
                act)
            # the whole cloud's pool where the rows are split over ranks
            g = points_max(g, amax, n_int, placement)
            return _decoder_prop_dispatch(
                module.decoder, n_local, lv_i, lj, lh, lv_b, g, act,
                module.seg_dropout, deterministic, seed, placement=placement)

        # the context block of the decoder's first weight: the ctx vector
        # and the coupling terms both take their gradient from it
        w0g = module.decoder.linear_0.weight[:, n_local:]
        g, zj0, zh0 = _winner_gather_ctx(fe, lv_i, lj, lh, lv_b, feats[..., :n_int, :],
                                         feats[..., n_int:, :], w0g, act, placement)
        return _decoder_prop_dispatch(
            module.decoder, n_local, lv_i, lj, lh, lv_b, g, act,
            module.seg_dropout, deterministic, seed, zj0, zh0, placement)

    return fn


def _gather_rows(x, rows, axis):
    """``x`` gathered at ``rows`` (B, F) along the point axis ``axis`` (1
    for (B, N, C), 2 for (B, D, N, C)): (B, F, C) or (B, D, F, C)."""
    if axis == 1:
        idx = rows[..., None].expand(*rows.shape, x.shape[-1])
    else:
        idx = rows[:, None, :, None].expand(x.shape[0], x.shape[1], rows.shape[1],
                                            x.shape[-1])
    return torch.gather(x, axis, idx)


def _winner_gather_ctx(fe, lv_i, lj, lh, lv_b, feats_i, feats_b, w0g, act,
                       placement: Placement = WHOLE):
    """Max-pool-coupled context terms by winner gathering (counterpart of the
    JAX package's ``_winner_gather_ctx``): ``winner_terms``, then
    ``winner_add_terms`` with the decoder's context block ``w0g`` (F1, G).
    Returns (g (B, 1, F), zj0, zh0) with the terms shaped (B, D, Ni, F1)."""
    g, rows, jw, hw = winner_terms(fe, lv_i, lj, lh, lv_b, feats_i, feats_b, act, placement)
    zj0, zh0 = winner_add_terms(rows, jw, hw, w0g, lv_i.shape[-2])
    return g, zj0, zh0


def winner_terms(fe, lv_i, lj, lh, lv_b, feats_i, feats_b, act,
                 placement: Placement = WHOLE):
    """The pooled feature and the coupling at its winner rows.

    ``pointnet_global`` gives the pooled g and each channel's first maximal
    row. Only the F winner rows' local (v, J, H) are gathered by index and
    propagated through the global-feature chain; its last layer is
    contracted to each winner's own channel (a dot per channel, not the full
    (K, F) product). Returns (g (B, 1, F), rows (B, F): each channel's
    winner, clamped to the internal rows, jw, hw (B, D, F): the channel's J
    and H at its winner, zero where a boundary row wins). On a points share
    (``placement``) g is the whole cloud's pool and the rows are local:
    jw, hw are zero in the channels another rank owns."""
    linears = fe.global_feature.linears
    g_in = torch.cat([torch.cat([lv_i, feats_i], dim=-1),
                      torch.cat([lv_b, feats_b], dim=-1)], dim=-2)
    g, amax = pointnet_cuda.pointnet_global(linears, g_in.contiguous(), act)
    winner = amax[:, 0, :].long()                               # (B, F)
    n_int = lv_i.shape[-2]
    g, own = points_max(g, amax, n_int, placement, with_owner=True)
    internal = (winner < n_int).to(lv_i.dtype)[:, None] * own   # (B, 1, F)
    rows = winner.clamp(max=n_int - 1)

    sel_v = torch.cat([_gather_rows(lv_i, rows, 1), _gather_rows(feats_i, rows, 1)], dim=-1)
    sel_j, sel_h = _gather_rows(lj, rows, 2), _gather_rows(lh, rows, 2)
    zf = sel_j.new_zeros((*sel_j.shape[:-1], feats_i.shape[-1]))
    # every layer but the last, activated; then the last layer at each
    # winner's own channel, and its activation rules
    qv, qj, qh = analytic.mlp_prop_t(linears[:-1], sel_v, torch.cat([sel_j, zf], dim=-1),
                                     torch.cat([sel_h, zf], dim=-1), act)
    last = linears[-1]
    zv = torch.einsum("bfk,fk->bf", qv, last.weight) + last.bias
    zjw = torch.einsum("bdfk,fk->bdf", qj, last.weight)
    zhw = torch.einsum("bdfk,fk->bdf", qh, last.weight)
    _, d1, d2 = analytic.rules_for(act)(zv)
    d1, d2 = d1[:, None], d2[:, None]
    return g, rows, d1 * zjw * internal, (d2 * zjw * zjw + d1 * zhw) * internal


def winner_add_terms(rows, jw, hw, w0g, n_int: int):
    """The decoder's layer-0 terms ``zj0 = (winner mask * J_g) W0g^T``: each
    winner's row jw[b, d, f] * W0g[:, f] added into its point's row
    (``index_add``, atomics on the card), (B, D, n_int, F1) each; a boundary
    winner's zero terms add nothing."""
    b_cases, d_dims, _ = jw.shape
    f1 = w0g.shape[0]
    dest = ((torch.arange(b_cases, device=rows.device)[:, None, None] * d_dims
             + torch.arange(d_dims, device=rows.device)[None, :, None]) * n_int
            + rows[:, None, :]).reshape(-1)
    w_rows = w0g.t()                                            # (F, F1)

    def scatter(w):
        terms = (w[..., None] * w_rows).reshape(-1, f1)
        return (terms.new_zeros((b_cases * d_dims * n_int, f1)).index_add(0, dest, terms)
                .reshape(b_cases, d_dims, n_int, f1))

    return scatter(jw), scatter(hw)


def pipn_foam(nu: float, d: float, f: float,
              fe_local_layers: Sequence[int],
              fe_global_layers: Sequence[int],
              seg_layers: Sequence[int],
              scalers: dict,
              seg_dropout: Optional[Sequence[float]] = None,
              activation: str = "silu",
              fast_derivatives: bool = True,
              coupled_context: bool = False,
              generator: Optional[torch.Generator] = None,
              device=None) -> PinnModel:
    """Data+physics PIPN with standardized features, on ``device`` (the CUDA
    card unless ``"cpu"`` is asked for). ``fast_derivatives`` takes the
    analytic derivative path, decoupled (the product default) or
    max-pool-coupled (``coupled_context``); without it the exact autodiff
    operator differentiates the module."""
    device = resolve_device(device)
    module = PipnModule(fe_local_layers, fe_global_layers, seg_layers,
                        seg_dropout, activation, generator).to(device)
    return _foam_model(module, nu, d, f, scalers, device,
                       pipn_apply_with_derivatives(module, coupled_context)
                       if fast_derivatives else None)


def pipn_manufactured(nu: float, d: float, f: float,
                      fe_local_layers: Sequence[int],
                      fe_global_layers: Sequence[int],
                      seg_layers: Sequence[int],
                      activation: str = "tanh",
                      fast_derivatives: bool = False,
                      coupled_context: bool = True,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> PinnModel:
    """Physics-only PIPN on raw coordinates: the manufactured-solutions
    verification workload (``data/manufactured.py``), on ``device`` (the
    CUDA card unless ``"cpu"`` is asked for). Its defaults are the exact
    autodiff operator and, with ``fast_derivatives``, the max-pool-coupled
    analytic path: reference-exact semantics, which is what a verification
    run is for. ``activation`` applies to every layer."""
    device = resolve_device(device)
    module = PipnModule(fe_local_layers, fe_global_layers, seg_layers, None, activation,
                        generator).to(device)
    return PinnModel(
        module=module,
        dims=seg_layers[-1] - 1,
        momentum_loss=MomentumLossManufactured(nu, d, f),
        continuity_loss=ContinuityLoss(),
        enable_data_loss=False,
        learning_rate=1e-3, lr_gamma=0.9995, adam_eps=1e-6,
        derivative_apply=(pipn_apply_with_derivatives(module, coupled_context)
                          if fast_derivatives else None))


def _foam_model(module, nu, d, f, scalers, device, derivative_apply,
                neighbor_precompute=None) -> PinnModel:
    u_s, p_s, c_s = (scalers[k].to(device) for k in ("U", "p", "C"))
    return PinnModel(
        module=module,
        dims=module.seg_layers[-1] - 1,
        momentum_loss=MomentumLossFixed(nu, d, f, u_s, c_s, p_s),
        continuity_loss=ContinuityLossStandardized(u_s, c_s),
        enable_data_loss=True,
        u_scaler=u_s, p_scaler=p_s,
        learning_rate=1e-3, lr_gamma=0.999,
        derivative_apply=derivative_apply,
        neighbor_precompute=neighbor_precompute)


def _boundary_sa_precompute(fractions, radii, max_neighbors: int,
                            feats_order: str = "C_first"):
    """The per-dataset aux of a boundary-cloud SetAbstraction chain
    (``neighbors.sa_chain_precompute`` over the boundary points), with level
    0's input rows gathered in the model's own concat order ``feats_order``
    (``_sa_xg_0``), so that the first level runs the kernel's static
    variant."""

    def precompute(dataset: FoamData) -> dict:
        _, boundary = split_contiguous(dataset)
        return sa_chain_precompute(boundary["C"], fractions, radii, max_neighbors,
                                   feats=_geometry_features(boundary, feats_order))

    return precompute


def pipn_pp_apply_with_derivatives(module):
    """The analytic derivative path of a PipnPpModule or a PipnPpMrgModule:
    ``fn(batch, deterministic=True, seed=None) -> (out_full, jac, lap)`` with
    jac/lap shaped (..., Ni, O, D). The geometry embedding pools over the
    boundary points only, which are not differentiated, so it is a per-case
    context exactly (no max-pool coupling): the SetAbstraction chain runs
    value-only (``sa_cuda.sa_seq_fused``; MRG's encoder through
    ``sa_cuda.sa_mrg_fused``) on the dataset's precomputed chain
    (``attach_neighbors``); the local MLP and the decoder propagate (v, J, H).
    On a points share (``placement``) the encoder runs whole on each rank,
    over the share's cases' whole boundary cloud, and the local MLP and the
    decoder on the share's rows. Dropout as in
    ``pipn_apply_with_derivatives``. Without an attached chain a CPU batch
    builds one here, as the reference module builds its neighbours on the
    fly; a batch on the card raises, so that a loop which forgot
    ``attach_neighbors`` does not run FPS and the radius search on every
    call."""
    is_mrg = isinstance(module, PipnPpMrgModule)
    if is_mrg:
        fractions, radii = SetAbstractionMrgSeq.fractions, SetAbstractionMrgSeq.radii
        order, local_linears = "id_first", module.local_fe.linears
    else:
        fractions, radii = module.fe_fraction, module.fe_radius
        order = module.geom_features_order
        local_linears = module.feature_extract.local_feature.linears
    precompute = _boundary_sa_precompute(fractions, radii, module.max_neighbors, order)

    def fn(batch: FoamData, deterministic: bool = True, seed=None,
           placement: Placement = WHOLE):
        internal_view, boundary_view = split_contiguous(batch)
        x_int = internal_view["C"]
        x_bnd = boundary_view["C"]
        act = module.activation
        cloud = placement.cloud(batch)
        nbrs = extract_sa_neighbors(cloud.domain, len(radii))
        if nbrs is None:
            if x_bnd.device.type != "cpu":
                raise ValueError("pipn_pp: the batch holds no SetAbstraction chain; attach "
                                 "it once per dataset with model.attach_neighbors(dataset)")
            nbrs = extract_sa_neighbors(precompute(cloud), len(radii))
        cloud_bnd = split_contiguous(cloud)[1]
        geom = _geometry_features(cloud_bnd, order)
        if is_mrg:
            g = sa_cuda.sa_mrg_fused(module.global_fe, act, geom, cloud_bnd["C"], nbrs)
        else:
            g = sa_cuda.sa_seq_fused(module.feature_extract.global_feature, act, geom, nbrs)

        j0, h0 = analytic.identity_jacobian_t(x_int)
        lv_i, lj, lh = analytic.mlp_prop_t(local_linears, x_int, j0, h0, act)
        lv_b = analytic.mlp_value(local_linears, x_bnd, act)
        return _decoder_prop_dispatch(
            module.decoder, lv_i.shape[-1], lv_i, lj, lh, lv_b, g, act,
            module.seg_dropout, deterministic, seed, placement=placement)

    return fn


def pipn_foam_pp(nu: float, d: float, f: float, fe_local_layers, fe_global_layers,
                 fe_radius, fe_fraction, seg_layers, scalers: dict, seg_dropout=None,
                 activation: str = "silu", max_neighbors: int = 64,
                 fast_derivatives: bool = True,
                 generator: Optional[torch.Generator] = None, device=None) -> PinnModel:
    """PIPN++ with standardized features, on ``device`` (the CUDA card unless
    ``"cpu"`` is asked for). Its analytic path is exact for this family and
    the default; ``fast_derivatives=False`` takes the exact autodiff operator
    on the module. ``attach_neighbors`` builds the boundary cloud's
    SetAbstraction chain once per dataset, for either path."""
    device = resolve_device(device)
    module = PipnPpModule(fe_local_layers, fe_global_layers, fe_radius, fe_fraction,
                          seg_layers, seg_dropout, activation, max_neighbors,
                          generator=generator).to(device)
    return _foam_model(module, nu, d, f, scalers, device,
                       pipn_pp_apply_with_derivatives(module) if fast_derivatives else None,
                       _boundary_sa_precompute(fe_fraction, fe_radius, max_neighbors))


def pipn_foam_pp_mrg(n_dims: int, mrg_in_features: int, nu: float, d: float, f: float,
                     fe_local_layers, seg_layers, scalers: dict, seg_dropout=None,
                     activation: str = "silu", max_neighbors: int = 64,
                     fast_derivatives: bool = True,
                     generator: Optional[torch.Generator] = None, device=None) -> PinnModel:
    """PIPN++ MRG with standardized features, on ``device`` (the CUDA card
    unless ``"cpu"`` is asked for). Its analytic path is exact for this
    family, as PIPN++'s is, and the default; ``fast_derivatives=False``
    takes the exact autodiff operator. ``attach_neighbors`` builds the
    boundary cloud's 2-level chain once per dataset, level 0's rows gathered
    in ``[boundaryId || C]`` order."""
    device = resolve_device(device)
    module = PipnPpMrgModule(n_dims, mrg_in_features, fe_local_layers, seg_layers,
                             seg_dropout, activation, max_neighbors, generator).to(device)
    return _foam_model(module, nu, d, f, scalers, device,
                       pipn_pp_apply_with_derivatives(module) if fast_derivatives else None,
                       _boundary_sa_precompute(SetAbstractionMrgSeq.fractions,
                                               SetAbstractionMrgSeq.radii, max_neighbors,
                                               feats_order="id_first"))


def pipn_manufactured_pp(nu: float, d: float, f: float, fe_local_layers, fe_global_layers,
                         fe_global_radius, fe_global_fraction, seg_layers,
                         activation: str = "tanh", max_neighbors: int = 64,
                         fast_derivatives: bool = True,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> PinnModel:
    """Physics-only PIPN++ on raw coordinates (the manufactured-solutions
    workload), on ``device`` (the CUDA card unless ``"cpu"`` is asked for):
    ``PipnPpModule`` with the ``"id_first"`` order, which its module forward,
    its analytic path and its chain's level-0 rows (``_sa_xg_0``) all take.
    The analytic path is exact for this family and the default;
    ``fast_derivatives=False`` takes the exact autodiff operator."""
    device = resolve_device(device)
    module = PipnPpModule(fe_local_layers, fe_global_layers, fe_global_radius,
                          fe_global_fraction, seg_layers, None, activation, max_neighbors,
                          "id_first", generator).to(device)
    return PinnModel(
        module=module,
        dims=seg_layers[-1] - 1,
        momentum_loss=MomentumLossManufactured(nu, d, f),
        continuity_loss=ContinuityLoss(),
        enable_data_loss=False,
        learning_rate=1e-3, lr_gamma=0.9995, adam_eps=1e-6,
        derivative_apply=(pipn_pp_apply_with_derivatives(module)
                          if fast_derivatives else None),
        neighbor_precompute=_boundary_sa_precompute(fe_global_fraction, fe_global_radius,
                                                    max_neighbors, "id_first"))


class PipnPpFullModule(nn.Module):
    """The U-Net PIPN++ forward: a SetAbstraction encoder ``encoder`` over
    all points with ``[sdf || boundaryId || C]`` features, and a
    FeaturePropagation decoder ``decoder`` back to every point (its level i
    drops with ``fp_level_seed(seed, i)``)."""

    def __init__(self, enc_layers, enc_radius, enc_fraction, dec_layers, dec_k,
                 dec_dropout=None, activation: str = "silu", max_neighbors: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.max_neighbors = max_neighbors
        self.encoder = SetAbstractionSeq(enc_fraction, enc_radius, enc_layers, activation,
                                         max_neighbors, generator)
        self.decoder = FeaturePropagationSeq(dec_layers, dec_k, dec_dropout, activation,
                                             generator)
        self.seg_layers = tuple(dec_layers[-1])  # the output MLP's widths, as PIPN's decoder

    def forward(self, points, batch: FoamData, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        """``points`` (..., N, 2) are the [internal || boundary] rows."""
        return _unet_forward(self, points, batch, deterministic, seed, placement=placement)


def _unet_forward(module, points, batch, deterministic, seed, par_embedding=None,
                  placement: Placement = WHOLE):
    """The U-Net forward of a PipnPpFullModule or a PiGanoPpFullModule: the
    encoder on ``[sdf || boundaryId || points]`` with its skips, then the
    decoder, on the batch's precomputed neighbours where it holds them. On a
    points share (``placement``) the encoder reads every point's
    coordinates: the internal ones are gathered over the points group
    (``points_gather``, differentiable to any order) beside the share's
    cases' whole boundary, the encoder and every FP level but the last run
    whole on each rank, and the last level on the share's rows."""
    nbrs = extract_sa_neighbors(batch.domain, len(module.encoder.radius))
    fp_idx = extract_fp_idx(batch.domain, len(module.decoder.fp_layers))
    x_in = torch.cat([batch["sdf"], batch["boundaryId"], points], dim=-1)
    if not placement.rows_split:
        (x, pos), skips = module.encoder(x_in, points, deterministic, nbrs, return_skip=True)
    else:
        cloud = placement.cloud(batch)
        _, cloud_bnd = split_contiguous(cloud)
        pts = torch.cat([points_gather(points[..., :placement.n_int, :], placement),
                         cloud_bnd["C"]], dim=-2)
        cloud_in = torch.cat([cloud["sdf"], cloud["boundaryId"], pts], dim=-1)
        (x, pos), skips = module.encoder(cloud_in, pts, deterministic, nbrs, return_skip=True)
        skips[0] = (x_in, points)
    return module.decoder(x, pos, skips, deterministic, fp_idx, seed, par_embedding,
                          placement=placement)[0]


def all_points_unet_precompute(fractions, radii, max_neighbors: int, dec_k,
                               has_global: bool):
    """The per-dataset aux of a U-Net over all points [internal || boundary]
    (``neighbors.unet_chain_precompute``): the clouds are static, so the SA
    chain and the FP levels' kNN indices are found once per dataset."""

    def precompute(dataset: FoamData) -> dict:
        internal, boundary = split_contiguous(dataset)
        pos = torch.cat([internal["C"], boundary["C"]], dim=-2)
        return unet_chain_precompute(pos, fractions, radii, max_neighbors, dec_k, has_global)

    return precompute


def pipn_foam_pp_full(nu: float, d: float, f: float, enc_layers, enc_radius, enc_fraction,
                      dec_layers, dec_k, scalers: dict, dec_dropout=None,
                      activation: str = "silu", max_neighbors: int = 64,
                      fast_derivatives: bool = True,
                      generator: Optional[torch.Generator] = None, device=None) -> PinnModel:
    """The U-Net PIPN++ on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for). ``attach_neighbors`` builds the SA chain and the FP levels'
    kNN indices over all points once per dataset. The default derivative
    path is the decoupled-hierarchy analytic one (``models/fp_analytic.py``:
    the encoder through ``sa_neighborhood`` and ``pointnet_global``);
    ``fast_derivatives=False``, or dropout on a middle level, takes the
    exact autodiff operator on the module, with micro-batches of 2 cases
    to bound its second-order graphs, as the JAX factory sets them (its
    remat has no counterpart: ROADMAP, deliberate differences)."""
    device = resolve_device(device)
    module = PipnPpFullModule(enc_layers, enc_radius, enc_fraction, dec_layers, dec_k,
                              dec_dropout, activation, max_neighbors,
                              generator=generator).to(device)
    precompute = all_points_unet_precompute(enc_fraction, enc_radius, max_neighbors, dec_k,
                                            len(enc_layers) > len(enc_radius))
    derivative_apply = (fp_analytic.pipn_pp_full_apply_with_derivatives(module, precompute)
                        if fast_derivatives else None)
    model = _foam_model(module, nu, d, f, scalers, device, derivative_apply, precompute)
    if derivative_apply is not None:
        return model
    return dataclasses.replace(model, microbatch=2)
