"""PI-GANO model (counterpart of ``porous_cfd_tpu/models/pi_gano.py``):
geometry-aware branch/trunk neural operator for variable inlet conditions.

A geometry encoder (max-pooled MLP on [boundaryId || sdf || C]) and a branch
net (max-pooled MLP on the variable-boundary features) give two per-case
embeddings; a points encoder MLP feeds a NeuralOperator trunk whose first
layer also takes the geometry embedding and whose every layer is multiplied
by the branch embedding; a linear reduction gives [Ux, Uy, (Uz), p].

The analytic derivative path runs three CUDA kernels' launches on the card:
``pointnet_global`` for the geometry and branch embeddings (value-only pooled
context) and ``neural_ops_prop`` (the fused (v, J, H) trunk and reduction
with dropout, internal and boundary launches); under autograd their backward
kernels carry the gradients. ``PiGanoFull``, PI-GANO++ and the exact
autodiff path are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.device import not_ported, resolve_device
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.models.mlp import (MLP, Branch, GeometryEncoder,
                                             NeuralOperatorSequential, dense)
from porous_cfd_tpu_torch.models.pipn import _pointnet_global_dispatch
from porous_cfd_tpu_torch.ops import neural_op_cuda
from porous_cfd_tpu_torch.physics import analytic
from porous_cfd_tpu_torch.physics.losses import (ContinuityLossStandardized,
                                                 MomentumLossVariable)

VariableBoundaries = dict


def gather_parameters(batch: FoamData, variable_boundaries: VariableBoundaries):
    """Branch-net input: per variable subdomain, [C || features...] rows,
    concatenated along the point axis."""
    parts = []
    for subdomain in variable_boundaries["Subdomains"]:
        sub = batch[subdomain]
        cols = [sub["C"]] + [sub[feature] for feature in variable_boundaries["Features"]]
        parts.append(torch.cat(cols, dim=-1))
    return torch.cat(parts, dim=-2)


class PiGanoModule(nn.Module):
    """PI-GANO forward. ``full=True`` (one trunk per output, sum-reduced) is
    not ported."""

    def __init__(self, out_features: int, branch_layers: Sequence[int],
                 geometry_layers: Sequence[int], local_layers: Sequence[int],
                 n_operators: int, operator_dropout: Sequence[float],
                 variable_boundaries: VariableBoundaries, activation: str = "silu",
                 full: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if full:
            raise not_ported("PiGanoFull (full=True)")
        self.out_features = out_features
        self.branch_layers = tuple(branch_layers)
        self.geometry_layers = tuple(geometry_layers)
        self.local_layers = tuple(local_layers)
        self.n_operators = n_operators
        self.operator_dropout = tuple(float(r) for r in operator_dropout)
        self.variable_boundaries = variable_boundaries
        self.activation = activation
        n_feat = geometry_layers[-1] + local_layers[-1]
        self.geometry_encoder = GeometryEncoder(geometry_layers, activation, generator)
        self.points_encoder = MLP(local_layers, None, activation, generator=generator)
        self.branch = Branch(branch_layers, activation, generator)
        self.neural_ops = NeuralOperatorSequential(n_operators, n_feat, operator_dropout,
                                                   activation, generator=generator)
        self.reduction = dense(n_feat, out_features, generator)

    def forward(self, points, batch: FoamData, deterministic: bool = True):
        geom_in = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
        param_features = gather_parameters(batch, self.variable_boundaries)
        # the geometry encoder sees the coordinates without a gradient
        geom = self.geometry_encoder(geom_in, points.detach(), deterministic)
        local = self.points_encoder(points, deterministic)
        geom = geom.expand(*local.shape[:-1], geom.shape[-1])
        par = self.branch(param_features, deterministic)
        y = self.neural_ops(torch.cat([local, geom], dim=-1), par, deterministic)
        return self.reduction(y)


def _geometry_input(batch: FoamData):
    """[boundaryId || sdf || C] over [internal || boundary] rows."""
    internal_view, boundary_view = split_contiguous(batch)
    pts_all = torch.cat([internal_view["C"], boundary_view["C"]], dim=-2)
    return torch.cat([batch["boundaryId"], batch["sdf"], pts_all], dim=-1)


def pi_gano_apply_with_derivatives(module: PiGanoModule):
    """The analytic derivative path of a PiGanoModule:
    ``fn(batch, deterministic=True, seed=None) -> (out_full, jac, lap)`` with
    jac/lap shaped (..., Ni, O, D). The geometry and branch embeddings are
    pooled context, constant in the differentiated coordinates, so only the
    points encoder and the trunk propagate (v, J, H). Their inputs come from
    the dataset's aux (``_gano_inputs_precompute``) when it is attached, else
    from the batch. With ``deterministic=False`` the trunk applies its
    dropout, with masks that are a pure function of ``seed``."""

    def fn(batch: FoamData, deterministic: bool = True, seed=None):
        internal_view, boundary_view = split_contiguous(batch)
        x_int = internal_view["C"]
        x_bnd = boundary_view["C"]
        act = module.activation
        geom_in = batch.domain.get("_gano_geom_in")
        if geom_in is None:
            geom_in = _geometry_input(batch)
        geom = _pointnet_global_dispatch(module.geometry_encoder.linear, geom_in, act)
        par_features = batch.domain.get("_gano_par")
        if par_features is None:
            par_features = gather_parameters(batch, module.variable_boundaries)
        par = _pointnet_global_dispatch(module.branch.linear, par_features, act)

        linears = module.points_encoder.linears
        j0, h0 = analytic.identity_jacobian_t(x_int)
        lv, ljt, lht = analytic.mlp_prop_t(linears, x_int, j0, h0, act)
        lv_b = analytic.mlp_value(linears, x_bnd, act)
        return neural_op_cuda.neural_ops_prop(
            module.neural_ops.linears, module.reduction, lv.shape[-1], lv.contiguous(),
            ljt.contiguous(), lht.contiguous(), lv_b.contiguous(), geom.contiguous(),
            par.contiguous(), act, module.operator_dropout, deterministic, seed)

    return fn


def _gano_inputs_precompute(variable_boundaries: VariableBoundaries):
    """Dataset-level aux of the analytic path: the geometry-encoder input
    [boundaryId || sdf || C] and the branch input (``gather_parameters``) are
    functions of the data alone, so they are built once per dataset instead
    of in every step."""

    def precompute(dataset: FoamData) -> dict:
        return {"_gano_geom_in": _geometry_input(dataset),
                "_gano_par": gather_parameters(dataset, variable_boundaries)}

    return precompute


def _pi_gano_model(module, dims, nu, scalers, device, derivative_apply=None,
                   neighbor_precompute=None) -> PinnModel:
    u_s, p_s, c_s, d_s, f_s = (scalers[k].to(device) for k in ("U", "p", "C", "d", "f"))
    return PinnModel(
        module=module, dims=dims,
        momentum_loss=MomentumLossVariable(nu, u_s, c_s, p_s, d_s, f_s),
        continuity_loss=ContinuityLossStandardized(u_s, c_s),
        enable_data_loss=True, u_scaler=u_s, p_scaler=p_s,
        learning_rate=1e-3, lr_gamma=0.999,
        derivative_apply=derivative_apply,
        neighbor_precompute=neighbor_precompute)


def pi_gano(nu: float, out_features: int, branch_layers, geometry_layers, local_layers,
            n_operators: int, operator_dropout, scalers: dict,
            variable_boundaries: VariableBoundaries, activation: str = "silu",
            full: bool = False, fast_derivatives: bool = True,
            generator: Optional[torch.Generator] = None, device=None) -> PinnModel:
    """PI-GANO on ``device`` (the CUDA card unless ``"cpu"`` is asked for).
    Only the analytic derivative path is ported, so ``fast_derivatives``
    defaults to True here (the JAX factory's default, False, selects the
    exact autodiff path); ``full=True`` is not ported."""
    if not fast_derivatives:
        raise not_ported("the exact autodiff derivative path (fast_derivatives=False)")
    device = resolve_device(device)
    module = PiGanoModule(out_features, branch_layers, geometry_layers, local_layers,
                          n_operators, operator_dropout, variable_boundaries, activation,
                          full, generator).to(device)
    return _pi_gano_model(module, out_features - 1, nu, scalers, device,
                          pi_gano_apply_with_derivatives(module),
                          _gano_inputs_precompute(variable_boundaries))


def pi_gano_pp(*args, **kwargs):
    """PI-GANO++ needs the SetAbstraction geometry encoder."""
    raise not_ported("pi_gano_pp (PI-GANO++)")


def pi_gano_pp_full(*args, **kwargs):
    """PI-GANO++ full needs the SetAbstraction U-Net."""
    raise not_ported("pi_gano_pp_full (PI-GANO++ full)")
