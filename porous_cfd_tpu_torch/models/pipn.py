"""PIPN model (counterpart of ``porous_cfd_tpu/models/pipn.py``): the plain
``PipnModule`` forward, the ``pipn_foam`` factory and the decoupled-context
analytic derivative path that carries verbose prediction.

Per-point features + a pooled global geometry embedding, decoded by a shared
segmentation MLP. The analytic path runs two CUDA kernels on the card:
``pointnet_global`` (pooled global feature) and ``decoder_prop`` (fused
(v, J, H) decoder with dropout, internal and boundary launches); under
autograd their backward kernels carry the gradients.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.device import not_ported, resolve_device
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.models.mlp import MLP, PointNetFeatureExtract
from porous_cfd_tpu_torch.ops import decoder_cuda, pointnet_cuda
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
    u_s, p_s, c_s = (scalers[k].to(device) for k in ("U", "p", "C"))
    return PinnModel(
        module=module,
        dims=seg_layers[-1] - 1,
        momentum_loss=MomentumLossFixed(nu, d, f, u_s, c_s, p_s),
        continuity_loss=ContinuityLossStandardized(u_s, c_s),
        enable_data_loss=True,
        u_scaler=u_s, p_scaler=p_s,
        learning_rate=1e-3, lr_gamma=0.999,
        derivative_apply=pipn_apply_with_derivatives(module, coupled_context))
