"""PIPN models (counterpart of ``porous_cfd_tpu/models/pipn.py``): the plain
``PipnModule`` and ``PipnPpModule`` forwards, the ``pipn_foam`` and
``pipn_foam_pp`` factories and their analytic derivative paths, which carry
verbose prediction and training.

Per-point features + a pooled global geometry embedding, decoded by a shared
segmentation MLP. PIPN's analytic path runs two CUDA kernels on the card:
``pointnet_global`` (pooled global feature) and ``decoder_prop`` (fused
(v, J, H) decoder with dropout, internal and boundary launches). PIPN++
pools its embedding with a SetAbstraction chain over the boundary cloud:
``sa_neighborhood`` per radius level (static at level 0, dynamic at level
1) and ``pointnet_global`` for the trailing global level, on a neighbour
chain precomputed once per dataset (FPS through its own kernel). Under
autograd the backward kernels carry the gradients.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.device import not_ported, resolve_device
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.models.mlp import MLP, PointNetFeatureExtract
from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors, sa_chain_precompute
from porous_cfd_tpu_torch.models.set_abstraction import PointNetFeatureExtractPp
from porous_cfd_tpu_torch.ops import decoder_cuda, pointnet_cuda, sa_cuda
from porous_cfd_tpu_torch.physics import analytic
from porous_cfd_tpu_torch.physics.losses import (ContinuityLossStandardized,
                                                 MomentumLossFixed)


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

    def forward(self, points, batch: FoamData, deterministic: bool = True):
        global_in = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
        local, g = self.feature_extract(global_in, points, deterministic)
        exp_g = g.expand(*local.shape[:-1], g.shape[-1])
        seg_in = torch.cat([local, exp_g], dim=-1)
        return self.decoder(seg_in, deterministic)


def _geometry_features(boundary: FoamData) -> torch.Tensor:
    """The geometry branch's input rows ``[C || boundaryId]``, the foam
    models' order (the manufactured variant's ``[boundaryId || C]`` is not
    ported)."""
    return torch.cat([boundary["C"], boundary["boundaryId"]], dim=-1)


class PipnPpModule(nn.Module):
    """PIPN++ forward: the geometry branch is a SetAbstraction chain over the
    boundary points with ``[C || boundaryId]`` features, beside a local
    shared MLP on the differentiable points; tiled concat; decoder."""

    def __init__(self, fe_local_layers: Sequence[int],
                 fe_global_layers: Sequence[Sequence[int]], fe_radius: Sequence[float],
                 fe_fraction: Sequence[float], seg_layers: Sequence[int],
                 seg_dropout: Optional[Sequence[float]] = None, activation: str = "silu",
                 max_neighbors: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
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

    def forward(self, points, batch: FoamData, deterministic: bool = True):
        boundary = batch["boundary"]
        geom = _geometry_features(boundary)
        nbrs = extract_sa_neighbors(batch.domain, len(self.fe_radius))
        local, g = self.feature_extract(geom, boundary["C"], points, deterministic, nbrs)
        exp_g = g.expand(*local.shape[:-1], g.shape[-1])
        return self.decoder(torch.cat([local, exp_g], dim=-1), deterministic)


def _decoder_prop_dispatch(decoder: MLP, n_local, v, jt, ht, v_b, g,
                           activation, dropout, deterministic, seed):
    """Decoder-stack propagation: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``decoder_cuda.decoder_prop`` goes by the
    tensors' device). Dropout runs unless ``deterministic``, with masks fixed
    by ``seed``. Returns (out_merged, jac, lap) with jac/lap (..., Ni, O,
    D)."""
    return decoder_cuda.decoder_prop(
        decoder.linears, n_local, v.contiguous(), jt.contiguous(),
        ht.contiguous(), None if v_b is None else v_b.contiguous(),
        g.contiguous(), activation, dropout, deterministic, seed)


def _pointnet_global_dispatch(global_feature: MLP, x, activation):
    """Max-pooled value MLP over points: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns the (B, 1, F) max."""
    return pointnet_cuda.pointnet_global(global_feature.linears, x.contiguous(),
                                         activation)[0]


def pipn_apply_with_derivatives(module: PipnModule, coupled: bool = True):
    """The analytic derivative path of a PipnModule:
    ``fn(batch, deterministic=True, seed=None) -> (out_full, jac, lap)`` with
    jac/lap shaped (..., Ni, O, D). With ``deterministic=False`` the decoder
    applies its dropout, with masks that are a pure function of ``seed``
    (a 64-bit integer; the training step derives it from the run's seed and
    the step). Only the decoupled-context mode (``coupled=False``: the pooled
    global feature is held constant per case) is ported; the
    max-pool-coupled mode raises."""
    if coupled:
        raise not_ported("the max-pool-coupled derivative path (coupled=True)")

    def fn(batch: FoamData, deterministic: bool = True, seed=None):
        internal_view, boundary_view = split_contiguous(batch)
        x_int = internal_view["C"]
        x_bnd = boundary_view["C"]
        feats = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
        act = module.activation
        fe = module.feature_extract

        j0, h0 = analytic.identity_jacobian_t(x_int)
        lv_i, lj, lh = analytic.mlp_prop_t(fe.local_feature.linears, x_int,
                                           j0, h0, act)
        lv_b = analytic.mlp_value(fe.local_feature.linears, x_bnd, act)

        local_all = torch.cat([lv_i, lv_b], dim=-2)
        g = _pointnet_global_dispatch(
            fe.global_feature, torch.cat([local_all, feats], dim=-1), act)
        return _decoder_prop_dispatch(
            module.decoder, lv_i.shape[-1], lv_i, lj, lh, lv_b, g, act,
            module.seg_dropout, deterministic, seed)

    return fn


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
    card unless ``"cpu"`` is asked for). Only the analytic derivative path in
    its decoupled-context mode (the product default) is ported."""
    if not fast_derivatives:
        raise not_ported("the exact autodiff derivative path "
                         "(fast_derivatives=False)")
    device = resolve_device(device)
    module = PipnModule(fe_local_layers, fe_global_layers, seg_layers,
                        seg_dropout, activation, generator).to(device)
    return _foam_model(module, nu, d, f, scalers, device,
                       pipn_apply_with_derivatives(module, coupled_context))


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


def _boundary_sa_precompute(fractions, radii, max_neighbors: int):
    """The per-dataset aux of a boundary-cloud SetAbstraction chain
    (``neighbors.sa_chain_precompute`` over the boundary points), with level
    0's input rows gathered in the model's own concat order (``xg``), so
    that the first level runs the kernel's static variant."""

    def precompute(dataset: FoamData) -> dict:
        _, boundary = split_contiguous(dataset)
        return sa_chain_precompute(boundary["C"], fractions, radii, max_neighbors,
                                   feats=_geometry_features(boundary))

    return precompute


def pipn_pp_apply_with_derivatives(module: PipnPpModule):
    """The analytic derivative path of a PipnPpModule:
    ``fn(batch, deterministic=True, seed=None) -> (out_full, jac, lap)`` with
    jac/lap shaped (..., Ni, O, D). The geometry embedding pools over the
    boundary points only, which are not differentiated, so it is a per-case
    context exactly (no max-pool coupling): the SetAbstraction chain runs
    value-only (``sa_cuda.sa_seq_fused``) on the dataset's precomputed chain
    (``attach_neighbors``); the local MLP and the decoder propagate (v, J, H).
    Dropout as in ``pipn_apply_with_derivatives``. Without an attached chain
    a CPU batch builds one here, as the reference module builds its
    neighbours on the fly; a batch on the card raises, so that a loop which
    forgot ``attach_neighbors`` does not run FPS and the radius search on
    every call."""
    precompute = _boundary_sa_precompute(module.fe_fraction, module.fe_radius,
                                         module.max_neighbors)

    def fn(batch: FoamData, deterministic: bool = True, seed=None):
        internal_view, boundary_view = split_contiguous(batch)
        x_int = internal_view["C"]
        x_bnd = boundary_view["C"]
        act = module.activation
        fe = module.feature_extract
        n_levels = len(module.fe_radius)
        nbrs = extract_sa_neighbors(batch.domain, n_levels)
        if nbrs is None:
            if x_bnd.device.type != "cpu":
                raise ValueError("pipn_pp: the batch holds no SetAbstraction chain; attach "
                                 "it once per dataset with model.attach_neighbors(dataset)")
            nbrs = extract_sa_neighbors(precompute(batch), n_levels)
        g = sa_cuda.sa_seq_fused(fe.global_feature, act, _geometry_features(boundary_view),
                                 nbrs)

        j0, h0 = analytic.identity_jacobian_t(x_int)
        lv_i, lj, lh = analytic.mlp_prop_t(fe.local_feature.linears, x_int, j0, h0, act)
        lv_b = analytic.mlp_value(fe.local_feature.linears, x_bnd, act)
        return _decoder_prop_dispatch(
            module.decoder, lv_i.shape[-1], lv_i, lj, lh, lv_b, g, act,
            module.seg_dropout, deterministic, seed)

    return fn


def pipn_foam_pp(nu: float, d: float, f: float, fe_local_layers, fe_global_layers,
                 fe_radius, fe_fraction, seg_layers, scalers: dict, seg_dropout=None,
                 activation: str = "silu", max_neighbors: int = 64,
                 fast_derivatives: bool = True,
                 generator: Optional[torch.Generator] = None, device=None) -> PinnModel:
    """PIPN++ with standardized features, on ``device`` (the CUDA card unless
    ``"cpu"`` is asked for). Its analytic path is exact for this family and
    the only one ported. ``attach_neighbors`` builds the boundary cloud's
    SetAbstraction chain once per dataset."""
    if not fast_derivatives:
        raise not_ported("the exact autodiff derivative path (fast_derivatives=False)")
    device = resolve_device(device)
    module = PipnPpModule(fe_local_layers, fe_global_layers, fe_radius, fe_fraction,
                          seg_layers, seg_dropout, activation, max_neighbors,
                          generator).to(device)
    return _foam_model(module, nu, d, f, scalers, device,
                       pipn_pp_apply_with_derivatives(module),
                       _boundary_sa_precompute(fe_fraction, fe_radius, max_neighbors))


def pipn_foam_pp_mrg(*args, **kwargs):
    """PIPN++ MRG needs SetAbstractionMrgSeq and sa_mrg_fused."""
    raise not_ported("pipn_foam_pp_mrg (PIPN++ MRG)")


def pipn_manufactured_pp(*args, **kwargs):
    """The physics-only PIPN++ needs the manufactured-solutions workload."""
    raise not_ported("pipn_manufactured_pp (manufactured-solutions PIPN++)")


def pipn_foam_pp_full(*args, **kwargs):
    """The U-Net PIPN++ needs FeaturePropagation and its analytic path."""
    raise not_ported("pipn_foam_pp_full (U-Net PIPN++)")
