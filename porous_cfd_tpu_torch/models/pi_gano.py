"""PI-GANO models (counterpart of ``porous_cfd_tpu/models/pi_gano.py``):
geometry-aware branch/trunk neural operators for variable inlet conditions.

A geometry encoder (max-pooled MLP on [boundaryId || sdf || C]) and a branch
net (max-pooled MLP on the variable-boundary features) give two per-case
embeddings; a points encoder MLP feeds a NeuralOperator trunk whose first
layer also takes the geometry embedding and whose every layer is multiplied
by the branch embedding; a linear reduction gives [Ux, Uy, (Uz), p].
``PiGanoFull`` (``full=True``) has one trunk per output instead, its last
operator linear, each summed over its features. PI-GANO++ pools its geometry
embedding with a SetAbstraction chain over the boundary points.

The analytic derivative path runs the CUDA kernels on the card:
``pointnet_global`` for the geometry and branch embeddings (value-only pooled
context; PI-GANO++'s global SetAbstraction level too), ``sa_neighborhood``
for PI-GANO++'s radius levels on a chain precomputed once per dataset, and
``neural_ops_prop`` (the fused (v, J, H) trunk with dropout, internal and
boundary launches: with the reduction, or, for each of PiGanoFull's trunks,
without it and with a linear last operator); under autograd their backward
kernels carry the gradients. The exact autodiff path (the default of
``pi_gano``, as in the JAX package) differentiates the plain module forward
and runs no kernel. PI-GANO++ full (``PiGanoPpFullModule``, the U-Net)
runs its all-points encoder through ``sa_neighborhood`` and
``pointnet_global`` and its branch through ``pointnet_global`` on its
analytic path (``models/fp_analytic.py``).
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
from porous_cfd_tpu_torch.models.mlp import (MLP, Branch, GeometryEncoder,
                                             NeuralOperatorSequential, dense)
from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
from porous_cfd_tpu_torch.models.pipn import (_boundary_sa_precompute, _geometry_features,
                                              _pointnet_global_dispatch, _unet_forward,
                                              all_points_unet_precompute)
from porous_cfd_tpu_torch.models.set_abstraction import (FeaturePropagationSeq,
                                                          GeometryEncoderPp, SetAbstractionSeq)
from porous_cfd_tpu_torch.ops import neural_op_cuda, pointnet_cuda, sa_cuda
from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.parallel.mesh import points_max
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
    """PI-GANO forward. With ``full`` (PiGanoFull) one trunk per output,
    ``neural_ops_{k}``, whose last operator is linear and whose features are
    summed, in place of one trunk and a reduction."""

    def __init__(self, out_features: int, branch_layers: Sequence[int],
                 geometry_layers: Sequence[int], local_layers: Sequence[int],
                 n_operators: int, operator_dropout: Sequence[float],
                 variable_boundaries: VariableBoundaries, activation: str = "silu",
                 full: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.full = full
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
        if full:
            for k in range(out_features):
                self.add_module(f"neural_ops_{k}", NeuralOperatorSequential(
                    n_operators, n_feat, operator_dropout, activation, last_activation=False,
                    generator=generator))
        else:
            self.neural_ops = NeuralOperatorSequential(n_operators, n_feat, operator_dropout,
                                                       activation, generator=generator)
            self.reduction = dense(n_feat, out_features, generator)

    @property
    def trunks(self) -> list[NeuralOperatorSequential]:
        """PiGanoFull's per-output trunks."""
        return [getattr(self, f"neural_ops_{k}") for k in range(self.out_features)]

    def forward(self, points, batch: FoamData, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        """``points`` (..., N, D) are the [internal || boundary] rows; the
        trunk's dropout (unless ``deterministic``) draws its masks from
        ``seed`` over those rows at their ``placement`` in the batch, as the
        analytic path does: every one of PiGanoFull's trunks takes the one
        seed. On a points share the geometry encoder pools over the whole
        cloud (``points_max``) and the branch runs whole on each rank."""
        geom_in = torch.cat([batch["boundaryId"], batch["sdf"]], dim=-1)
        param_features = gather_parameters(placement.cloud(batch), self.variable_boundaries)
        # the geometry encoder sees the coordinates without a gradient
        geom = self.geometry_encoder(geom_in, points.detach(), deterministic, placement)
        local = self.points_encoder(points, deterministic)
        geom = geom.expand(*local.shape[:-1], geom.shape[-1])
        par = self.branch(param_features, deterministic)
        operator_in = torch.cat([local, geom], dim=-1)
        if self.full:
            return torch.cat([trunk(operator_in, par, deterministic, seed, placement)
                              .sum(-1, keepdim=True) for trunk in self.trunks], dim=-1)
        return self.reduction(self.neural_ops(operator_in, par, deterministic, seed, placement))


class PiGanoPpModule(nn.Module):
    """PI-GANO++ forward: the geometry encoder is a SetAbstraction chain over
    the boundary points with ``[C || boundaryId]`` features, ending in a
    global level."""

    def __init__(self, out_features: int, branch_layers: Sequence[int],
                 geometry_layers: Sequence[Sequence[int]], geometry_radius: Sequence[float],
                 geometry_fraction: Sequence[float], local_layers: Sequence[int],
                 n_operators: int, operator_dropout: Sequence[float],
                 variable_boundaries: VariableBoundaries, activation: str = "silu",
                 max_neighbors: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_features = out_features
        self.geometry_radius = tuple(geometry_radius)
        self.geometry_fraction = tuple(geometry_fraction)
        self.local_layers = tuple(local_layers)
        self.n_operators = n_operators
        self.operator_dropout = tuple(float(r) for r in operator_dropout)
        self.variable_boundaries = variable_boundaries
        self.activation = activation
        self.max_neighbors = max_neighbors
        n_feat = geometry_layers[-1][-1] + local_layers[-1]
        self.geometry_encoder = GeometryEncoderPp(geometry_fraction, geometry_radius,
                                                  geometry_layers, activation, max_neighbors,
                                                  generator)
        self.points_encoder = MLP(local_layers, None, activation, generator=generator)
        self.branch = Branch(branch_layers, activation, generator)
        self.neural_ops = NeuralOperatorSequential(n_operators, n_feat, operator_dropout,
                                                   activation, generator=generator)
        self.reduction = dense(n_feat, out_features, generator)

    def forward(self, points, batch: FoamData, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        """As ``PiGanoModule.forward``; the geometry encoder runs whole on
        each rank of a points share, as the branch does."""
        cloud = placement.cloud(batch)
        param_features = gather_parameters(cloud, self.variable_boundaries)
        boundary = cloud["boundary"]
        b_pos = boundary["C"].detach()
        nbrs = extract_sa_neighbors(batch.domain, len(self.geometry_radius))
        geom = self.geometry_encoder(_geometry_features(boundary).detach(), b_pos,
                                     deterministic, nbrs)
        local = self.points_encoder(points, deterministic)
        geom = geom.expand(*local.shape[:-1], geom.shape[-1])
        par = self.branch(param_features, deterministic)
        y = self.neural_ops(torch.cat([local, geom], dim=-1), par, deterministic, seed,
                            placement)
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
    dropout, with masks that are a pure function of ``seed`` and of the
    rows' ``placement`` in the whole batch. On a points share the geometry
    pool takes the share's rows and ``points_max``, the branch runs whole
    on each rank, and the trunk runs on the share's rows."""

    def fn(batch: FoamData, deterministic: bool = True, seed=None,
           placement: Placement = WHOLE):
        internal_view, boundary_view = split_contiguous(batch)
        x_int = internal_view["C"]
        x_bnd = boundary_view["C"]
        act = module.activation
        geom_in = batch.domain.get("_gano_geom_in")
        if geom_in is None:
            geom_in = _geometry_input(batch)
        geom, rows = pointnet_cuda.pointnet_global(module.geometry_encoder.linear.linears,
                                                   geom_in.contiguous(), act)
        geom = points_max(geom, rows, x_int.shape[-2], placement)
        par_features = batch.domain.get("_gano_par")
        if par_features is None:
            par_features = gather_parameters(placement.cloud(batch), module.variable_boundaries)
        par = _pointnet_global_dispatch(module.branch.linear, par_features, act)

        return _trunk_prop(module, x_int, x_bnd, geom, par, deterministic, seed, placement,
                           module.full)

    return fn


def _trunk_prop(module, x_int, x_bnd, geom, par, deterministic, seed, placement, full=False):
    """The points encoder's (v, J, H) and the trunk through
    ``neural_ops_prop``: (out_full, jac, lap) with jac/lap (..., Ni, O, D).
    PiGanoFull (``full``) runs each output's trunk without a reduction and with its
    last operator linear, and sums its features; every trunk takes the
    step's one seed (the JAX path hands each the same key), so all three
    draw the same masks, at the rows' ``placement`` in the batch."""
    act = module.activation
    linears = module.points_encoder.linears
    j0, h0 = analytic.identity_jacobian_t(x_int)
    lv, ljt, lht = analytic.mlp_prop_t(linears, x_int, j0, h0, act)
    lv_b = analytic.mlp_value(linears, x_bnd, act)
    args = (lv.shape[-1], lv.contiguous(), ljt.contiguous(), lht.contiguous(),
            lv_b.contiguous(), geom.contiguous(), par.contiguous(), act,
            module.operator_dropout, deterministic, seed)
    if not full:
        return neural_op_cuda.neural_ops_prop(module.neural_ops.linears, module.reduction,
                                              *args, placement=placement)
    outs = [neural_op_cuda.neural_ops_prop(trunk.linears, None, *args, last_activation=False,
                                           placement=placement)
            for trunk in module.trunks]
    return (torch.cat([v.sum(-1, keepdim=True) for v, _, _ in outs], dim=-1),
            torch.cat([j.sum(-2, keepdim=True) for _, j, _ in outs], dim=-2),
            torch.cat([h.sum(-2, keepdim=True) for _, _, h in outs], dim=-2))


def pi_gano_pp_apply_with_derivatives(module: PiGanoPpModule):
    """The analytic derivative path of a PiGanoPpModule, with the signature
    of ``pi_gano_apply_with_derivatives``'s. The geometry embedding pools
    over the boundary points, which are not differentiated, so it is a
    per-case context exactly: the SetAbstraction chain runs value-only
    (``sa_cuda.sa_seq_fused``) on the dataset's precomputed chain
    (``attach_neighbors``). Without an attached chain a CPU batch builds one
    here; a batch on the card raises, as PIPN++'s path does. On a points
    share the chain and the branch run whole on each rank, over the share's
    cases, and the trunk on the share's rows."""
    precompute = _boundary_sa_precompute(module.geometry_fraction, module.geometry_radius,
                                         module.max_neighbors)
    n_levels = len(module.geometry_radius)

    def fn(batch: FoamData, deterministic: bool = True, seed=None,
           placement: Placement = WHOLE):
        internal_view, boundary_view = split_contiguous(batch)
        x_int = internal_view["C"]
        x_bnd = boundary_view["C"]
        act = module.activation
        cloud = placement.cloud(batch)
        nbrs = extract_sa_neighbors(cloud.domain, n_levels)
        if nbrs is None:
            if x_bnd.device.type != "cpu":
                raise ValueError("pi_gano_pp: the batch holds no SetAbstraction chain; attach "
                                 "it once per dataset with model.attach_neighbors(dataset)")
            nbrs = extract_sa_neighbors(precompute(cloud), n_levels)
        geom = sa_cuda.sa_seq_fused(module.geometry_encoder.set_abstraction, act,
                                    _geometry_features(split_contiguous(cloud)[1]), nbrs)
        par_features = gather_parameters(cloud, module.variable_boundaries)
        par = _pointnet_global_dispatch(module.branch.linear, par_features, act)
        return _trunk_prop(module, x_int, x_bnd, geom, par, deterministic, seed, placement)

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
            full: bool = False, fast_derivatives: bool = False,
            generator: Optional[torch.Generator] = None, device=None) -> PinnModel:
    """PI-GANO, or with ``full`` PiGanoFull, on ``device`` (the CUDA card
    unless ``"cpu"`` is asked for). As in the JAX factory, the default is
    the exact autodiff operator on the module; ``fast_derivatives`` takes
    the analytic path, whose per-dataset aux is the encoders' inputs."""
    device = resolve_device(device)
    module = PiGanoModule(out_features, branch_layers, geometry_layers, local_layers,
                          n_operators, operator_dropout, variable_boundaries, activation,
                          full, generator).to(device)
    if not fast_derivatives:
        return _pi_gano_model(module, out_features - 1, nu, scalers, device)
    return _pi_gano_model(module, out_features - 1, nu, scalers, device,
                          pi_gano_apply_with_derivatives(module),
                          _gano_inputs_precompute(variable_boundaries))


def pi_gano_pp(nu: float, out_features: int, branch_layers, geometry_layers,
               geometry_radius, geometry_fraction, local_layers, n_operators: int,
               operator_dropout, scalers: dict, variable_boundaries: VariableBoundaries,
               activation: str = "silu", max_neighbors: int = 64,
               fast_derivatives: bool = True, generator: Optional[torch.Generator] = None,
               device=None) -> PinnModel:
    """PI-GANO++ on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for). Its analytic path is exact for this family and the default;
    ``fast_derivatives=False`` takes the exact autodiff operator on the
    module. ``attach_neighbors`` builds the boundary cloud's SetAbstraction
    chain, ``[C || boundaryId]`` features first, once per dataset, for
    either path."""
    device = resolve_device(device)
    module = PiGanoPpModule(out_features, branch_layers, geometry_layers, geometry_radius,
                            geometry_fraction, local_layers, n_operators, operator_dropout,
                            variable_boundaries, activation, max_neighbors,
                            generator).to(device)
    return _pi_gano_model(module, out_features - 1, nu, scalers, device,
                          pi_gano_pp_apply_with_derivatives(module) if fast_derivatives
                          else None,
                          _boundary_sa_precompute(geometry_fraction, geometry_radius,
                                                  max_neighbors))


class PiGanoPpFullModule(nn.Module):
    """The U-Net PI-GANO++ forward: the branch net ``branch`` on the
    variable-boundary features, a SetAbstraction encoder ``encoder`` over all
    points with ``[sdf || boundaryId || C]`` features, and a
    FeaturePropagation neural-operator decoder ``decoder`` whose every level
    is modulated by the branch embedding. The decoder's last level emits
    ``out_features`` channels."""

    def __init__(self, out_features: int, branch_layers, enc_layers, enc_radius,
                 enc_fraction, dec_layers, dec_k, fp_dropout,
                 variable_boundaries: VariableBoundaries, activation: str = "silu",
                 max_neighbors: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_features = out_features
        self.variable_boundaries = variable_boundaries
        self.activation = activation
        self.max_neighbors = max_neighbors
        self.branch = Branch(branch_layers, activation, generator)
        self.encoder = SetAbstractionSeq(enc_fraction, enc_radius, enc_layers, activation,
                                         max_neighbors, generator)
        self.decoder = FeaturePropagationSeq(dec_layers, dec_k, fp_dropout, activation,
                                             generator, par_width=branch_layers[-1])

    def forward(self, points, batch: FoamData, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        """As ``PiGanoModule.forward``; FP level i drops with
        ``fp_level_seed(seed, i)``."""
        par = self.branch(gather_parameters(placement.cloud(batch), self.variable_boundaries),
                          deterministic)
        return _unet_forward(self, points, batch, deterministic, seed, par, placement)


def pi_gano_pp_full(nu: float, out_features: int, branch_layers, enc_layers, enc_radius,
                    enc_fraction, dec_layers, dec_k, fp_dropout, scalers: dict,
                    variable_boundaries: VariableBoundaries, activation: str = "silu",
                    max_neighbors: int = 64, fast_derivatives: bool = True,
                    generator: Optional[torch.Generator] = None, device=None) -> PinnModel:
    """The U-Net PI-GANO++ on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for), with ``dec_layers[-1][-1] == out_features``. Its default
    derivative path is the decoupled-hierarchy analytic one
    (``models/fp_analytic.py``: the encoder through ``sa_neighborhood`` and
    ``pointnet_global``, the branch through ``pointnet_global``);
    ``fast_derivatives=False``, or dropout on a middle level, takes the exact
    autodiff operator with micro-batches of 2 cases, as
    ``pipn_foam_pp_full`` does."""
    device = resolve_device(device)
    module = PiGanoPpFullModule(out_features, branch_layers, enc_layers, enc_radius,
                                enc_fraction, dec_layers, dec_k, fp_dropout,
                                variable_boundaries, activation, max_neighbors,
                                generator=generator).to(device)
    precompute = all_points_unet_precompute(enc_fraction, enc_radius, max_neighbors, dec_k,
                                            len(enc_layers) > len(enc_radius))
    derivative_apply = (fp_analytic.pi_gano_pp_full_apply_with_derivatives(module, precompute)
                        if fast_derivatives else None)
    model = _pi_gano_model(module, out_features - 1, nu, scalers, device, derivative_apply,
                           precompute)
    if derivative_apply is not None:
        return model
    return dataclasses.replace(model, microbatch=2)
