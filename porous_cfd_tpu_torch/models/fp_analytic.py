"""The decoupled-hierarchy analytic (v, J, H) path of the U-Net ("full")
variants (counterpart of ``porous_cfd_tpu/models/fp_analytic.py``):
``PipnPpFullModule`` and ``PiGanoPpFullModule``.

  * The SetAbstraction encoder over all points and every FeaturePropagation
    level but the last run as a value forward: their outputs are fields
    sampled at coarse points. On the card the encoder runs through the
    kernels (``sa_cuda.sa_seq_fused``: ``sa_neighborhood`` per radius level,
    dynamic from level 0 on, and ``pointnet_global`` for the global level);
    the middle FP levels are plain PyTorch, as they are plain XLA in the JAX
    package.
  * The last level's kNN interpolation is differentiated analytically in
    the query coordinates (``knn_interp_prop``), over the precomputed kNN
    indices: f(x) = sum_k w_k(x) F_k / sum_k w_k(x), w = 1 / |x - y_k|^2.
  * The level-0 skip block ``[sdf || boundaryId || C]`` has an identity
    Jacobian on its coordinate columns; the rest is constant data.
  * The last level's MLP propagates (v, J, H) with the layer rules
    (``analytic.mlp_prop_merged``) and its dropout; PI-GANO++'s branch
    modulation is constant per case and scales (v, J, H) alike.

What this drops against exact autodiff: the dependence of the coarse
features F_k on the query point's own coordinates (through the max-pooled
SA neighbourhoods). Parameter gradients still reach every layer, since F_k
enters (v, J, H) linearly. Where a middle level has dropout the factories
take the exact path instead (``mid_levels_deterministic``).
"""
from __future__ import annotations

from typing import Optional

import torch

from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.models.neighbors import (extract_fp_idx, extract_sa_neighbors,
                                                   gather_points)
from porous_cfd_tpu_torch.models.set_abstraction import fp_level_seed, level_dropout
from porous_cfd_tpu_torch.ops import sa_cuda
from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.physics import analytic

_CLAMP = 1e-12  # knn_interpolate_with_idx's floor


def knn_interp_prop(x_coarse, pos_src, pos_query, idx, n_int: int):
    """Inverse-square-distance interpolation with its derivatives in the
    query coordinates, the coarse features and positions held as context.

    :param x_coarse: (B, M, F) coarse features at pos_src (B, M, D).
    :param pos_query: (B, N, D) query positions, internal rows first.
    :param idx: (B, N, k) kNN indices into the coarse level.
    :return: v (B, N, F) on every row; j, h (B, n_int, D, F) on the first
        ``n_int``.

    With S = sum_k w_k F_k, W = sum_k w_k and f = S / W:
      f'  = (S' - f W') / W,   f'' = (S'' - 2 f' W' - f W'') / W
    per coordinate, and for w = 1 / u, u = |x - y_k|^2:
      dw/dx_d = -2 w^2 (x_d - y_kd),   d2w/dx_d^2 = 8 w^3 (x_d - y_kd)^2 - 2 w^2.
    Where u is clamped (a query on a coarse point) the weight is constant,
    as in the forward, and its derivatives are 0 (``live``).
    """
    diff = pos_query[..., :, None, :] - gather_points(pos_src, idx)   # (B, N, k, D)
    d2 = torch.sum(diff * diff, dim=-1)                               # (B, N, k)
    live = (d2 >= _CLAMP).to(diff.dtype)
    w = 1.0 / torch.clamp(d2, min=_CLAMP)
    feats = gather_points(x_coarse, idx)                              # (B, N, k, F)
    w_sum = torch.sum(w, dim=-1, keepdim=True)                        # (B, N, 1)
    v = torch.sum(feats * w[..., None], dim=-2) / w_sum

    diff_i = diff[..., :n_int, :, :]
    w_i = w[..., :n_int, :] * live[..., :n_int, :]
    f_i = feats[..., :n_int, :, :]
    w2 = w_i * w_i
    dw = -2.0 * w2[..., None] * diff_i                                # (B, Ni, k, D)
    d2w = 8.0 * (w2 * w_i)[..., None] * diff_i * diff_i - 2.0 * w2[..., None]
    sp = torch.einsum("...kd,...kf->...df", dw, f_i)                  # (B, Ni, D, F)
    spp = torch.einsum("...kd,...kf->...df", d2w, f_i)
    wp = torch.sum(dw, dim=-2)[..., None]                             # (B, Ni, D, 1)
    wpp = torch.sum(d2w, dim=-2)[..., None]
    w_sum_i = w_sum[..., :n_int, :, None]                             # (B, Ni, 1, 1)
    v_i = v[..., :n_int, None, :]                                     # (B, Ni, 1, F)
    j = (sp - v_i * wp) / w_sum_i
    h = (spp - 2.0 * j * wp - v_i * wpp) / w_sum_i
    return v, j, h


def skip_identity_triple(skip_feats, n_int: int, n_dim: int):
    """(v, J, H) of the level-0 skip block (B, N, Fw): its last ``n_dim``
    columns are the differentiated coordinates (identity Jacobian), the
    columns before them constant data."""
    b, _, fw = skip_feats.shape
    eye = torch.zeros((n_dim, fw), dtype=skip_feats.dtype, device=skip_feats.device)
    eye[:, fw - n_dim:] = torch.eye(n_dim, dtype=skip_feats.dtype, device=skip_feats.device)
    j = eye.expand(b, n_int, n_dim, fw)
    return skip_feats, j, torch.zeros_like(j)


def mid_levels_deterministic(dropout, n_levels: int) -> bool:
    """Whether every FP level but the last is free of dropout: the value
    stream runs them deterministically, which is exact only then."""
    if dropout is None:
        return True
    for d in dropout[:n_levels - 1]:
        rates = [d] if isinstance(d, (int, float)) else list(d)
        if any(float(r) != 0.0 for r in rates):
            return False
    return True


def hierarchy(module, batch: FoamData, precompute, par_embedding=None,
              placement: Placement = WHOLE):
    """The value stream of a U-Net module: the encoder through
    ``sa_cuda.sa_seq_fused`` and every FP level but the last. Returns
    (x_coarse, pos_coarse, idx_last, x_in, pts, n_int): the last level's
    coarse features and positions, its kNN indices into them, its skip rows
    ``[sdf || boundaryId || C]``, the points [internal || boundary] and the
    internal count, the last four of ``batch``'s own rows. On a points share
    (``placement``) the stream runs whole on each rank, over the share's
    cases' whole cloud, and the last four are the share's rows.
    ``par_embedding`` modulates the middle levels (PI-GANO++). A CPU batch
    with no precomputed chain builds one with ``precompute``; a batch on the
    card raises, so that a loop which forgot ``attach_neighbors`` does not
    search neighbours in every step."""
    cloud = placement.cloud(batch)
    x_in, pts, n_int = _skip_rows(cloud)
    encoder, decoder = module.encoder, module.decoder
    n_enc, n_fp = len(encoder.radius), len(decoder.fp_layers)
    domain = cloud.domain
    if extract_sa_neighbors(domain, n_enc) is None or extract_fp_idx(domain, n_fp) is None:
        if pts.device.type != "cpu":
            raise ValueError("U-Net: the batch holds no neighbour chain; attach it once per "
                             "dataset with model.attach_neighbors(dataset)")
        domain = precompute(cloud)
    fp_idx = extract_fp_idx(domain, n_fp)
    (x, pos), skips = sa_cuda.sa_seq_fused(encoder, module.activation, x_in,
                                           extract_sa_neighbors(domain, n_enc), pts,
                                           return_skip=True)
    x, pos = decoder(x, pos, skips, True, fp_idx, par_embedding=par_embedding,
                     n_levels=n_fp - 1)
    if not placement.rows_split:
        return x, pos, fp_idx[-1], x_in, pts, n_int
    rows = placement.global_rows(torch.arange(batch.data.shape[-2], device=pts.device))
    return (x, pos, fp_idx[-1][:, rows], *_skip_rows(batch))


def _skip_rows(batch: FoamData):
    """(``[sdf || boundaryId || C]``, C, internal count) of ``batch``'s
    [internal || boundary] rows."""
    internal_view, boundary_view = split_contiguous(batch)
    pts = torch.cat([internal_view["C"], boundary_view["C"]], dim=-2)
    return (torch.cat([batch["sdf"], batch["boundaryId"], pts], dim=-1), pts,
            internal_view["C"].shape[-2])


def _last_level(module, x, pos, idx, x_in, pts, n_int, deterministic, seed, placement):
    """The last FP level's (v, J, H), untransposed: (B, N, O), (B, Ni, D,
    O) twice."""
    iv, ij, ih = knn_interp_prop(x, pos, pts, idx, n_int)
    sv, sj, sh = skip_identity_triple(x_in, n_int, pts.shape[-1])
    decoder = module.decoder
    n_fp = len(decoder.fp_layers)
    return analytic.mlp_prop_merged(
        decoder.levels[-1].mlp.linears, torch.cat([iv, sv], dim=-1),
        torch.cat([ij, sj], dim=-1), torch.cat([ih, sh], dim=-1), n_int, module.activation,
        level_dropout(decoder.dropout, n_fp - 1, decoder.fp_layers[-1]),
        last_activation=False, deterministic=deterministic, seed=fp_level_seed(seed, n_fp - 1),
        placement=placement)


def pipn_pp_full_apply_with_derivatives(module, precompute):
    """The analytic path of a PipnPpFullModule: ``fn(batch,
    deterministic=True, seed=None, placement=WHOLE) -> (out_full, jac,
    lap)`` with jac/lap (..., Ni, O, D); None where a middle level has
    dropout. The last level's dropout runs unless ``deterministic``, with
    the exact path's masks for the same seed and placement. On a points
    share the value stream runs whole on each rank and the last level on
    the share's rows (``hierarchy``)."""
    if not mid_levels_deterministic(module.decoder.dropout, len(module.decoder.fp_layers)):
        return None

    def fn(batch: FoamData, deterministic: bool = True, seed: Optional[int] = None,
           placement: Placement = WHOLE):
        x, pos, idx, x_in, pts, n_int = hierarchy(module, batch, precompute,
                                                  placement=placement)
        out, j, h = _last_level(module, x, pos, idx, x_in, pts, n_int, deterministic, seed,
                                placement)
        return out, j.transpose(-1, -2), h.transpose(-1, -2)

    return fn


def pi_gano_pp_full_apply_with_derivatives(module, precompute):
    """The analytic path of a PiGanoPpFullModule, as
    ``pipn_pp_full_apply_with_derivatives``'s, with the branch embedding
    (``pointnet_global`` on the card, whole on each rank of a points share)
    modulating every FP level: in the value stream at the middle levels, and
    as a per-case scale of (v, J, H) at the last."""
    from porous_cfd_tpu_torch.models.pi_gano import gather_parameters
    from porous_cfd_tpu_torch.models.pipn import _pointnet_global_dispatch

    if not mid_levels_deterministic(module.decoder.dropout, len(module.decoder.fp_layers)):
        return None

    def fn(batch: FoamData, deterministic: bool = True, seed: Optional[int] = None,
           placement: Placement = WHOLE):
        par = _pointnet_global_dispatch(
            module.branch.linear,
            gather_parameters(placement.cloud(batch), module.variable_boundaries),
            module.activation)
        x, pos, idx, x_in, pts, n_int = hierarchy(module, batch, precompute, par, placement)
        out, j, h = _last_level(module, x, pos, idx, x_in, pts, n_int, deterministic, seed,
                                placement)
        scale = module.decoder.levels[-1].modulation(par)              # (B, 1, O)
        out, j, h = out * scale, j * scale[:, None], h * scale[:, None]
        return out, j.transpose(-1, -2), h.transpose(-1, -2)

    return fn
