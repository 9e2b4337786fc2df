"""Static-shape point-cloud neighbour ops (counterpart of
``porous_cfd_tpu/models/neighbors.py``): farthest-point sampling, the radius
search and the precompute of a SetAbstraction chain over a static cloud.

Everything works on dense batched tensors with static output shapes
(padded and masked). The documented deviations of the JAX package hold
here too: FPS starts at point 0, and the radius search returns the
lowest-indexed neighbours within r.

The precompute's keys start with ``_`` (``_sa_cent_0``, ``_sa_rel_0``,
...): ``FoamData`` keeps such entries as they are, so the float entries
(relative positions, centroid positions, pre-gathered features) are not
cast to integers. ``knn``, ``knn_interpolate`` and the U-Net precompute are
not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# FPS is the kernel's wrapper, which takes the plain version on the CPU
from porous_cfd_tpu_torch.ops.fps_cuda import farthest_point_sampling


def pairwise_sqdist(query: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., M, N) between query (..., M, D) and src
    (..., N, D) in the |a|^2 - 2ab + |b|^2 expansion form, clamped at 0: the
    JAX package's form, so that radius membership is decided the same way."""
    q2 = torch.sum(query * query, dim=-1, keepdim=True)
    s2 = torch.sum(src * src, dim=-1, keepdim=True)
    cross = torch.matmul(query, src.transpose(-1, -2))
    return torch.clamp(q2 - 2.0 * cross + s2.transpose(-1, -2), min=0.0)


def fps_count(n: int, ratio: float) -> int:
    """Number of centroids torch_cluster.fps selects for a given ratio."""
    return max(1, math.ceil(n * ratio))


def radius_neighbors(src: torch.Tensor, query: torch.Tensor, r: float, max_neighbors: int):
    """Up to ``max_neighbors`` source indices within distance r of each query
    point, lowest index first. src (..., N, D), query (..., C, D) ->
    (idx (..., C, K) int64, mask (..., C, K) bool); padded entries point at 0
    with mask False."""
    n = src.shape[-2]
    within = pairwise_sqdist(query, src) <= r * r
    # lowest-index-first: the in-radius score N - index is largest first
    scores = torch.where(within, n - torch.arange(n, device=src.device, dtype=torch.int32),
                         torch.zeros((), dtype=torch.int32, device=src.device))
    k_eff = min(max_neighbors, n)
    top, idx = torch.topk(scores, k_eff, dim=-1)
    mask = top > 0
    idx = torch.where(mask, idx, torch.zeros_like(idx))
    if k_eff < max_neighbors:
        pad = max_neighbors - k_eff
        idx = torch.nn.functional.pad(idx, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return idx, mask


def gather_points(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (B, N, F), idx (B, ...) -> (B, ..., F)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(arr, 1, flat[..., None].expand(*flat.shape, arr.shape[-1]))
    return out.reshape(*idx.shape, arr.shape[-1])


def sa_chain_precompute(pos: torch.Tensor, fractions: Sequence[float],
                        radii: Sequence[float], max_neighbors: int,
                        feats: Optional[torch.Tensor] = None) -> dict:
    """FPS centroids and radius neighbourhoods of each level of a
    SetAbstraction chain over a static cloud pos (B, N, D), with what the
    fused path reads per step: the relative positions ``(pos_j - pos_c) / r``
    (B, C, K, D), the centroid positions (B, C, D) and, when ``feats`` (B, N,
    F_in) is given, level 0's input rows gathered per neighbourhood (B, C*K,
    F_in). Level i + 1 runs on level i's centroids.

    :return: {'_sa_cent_i', '_sa_idx_i', '_sa_mask_i', '_sa_rel_i',
        '_sa_posc_i'} per level and '_sa_xg_0', to merge into a FoamData
        domain.
    """
    out = {}
    for i, (f, r) in enumerate(zip(fractions, radii)):
        cent = farthest_point_sampling(pos, fps_count(pos.shape[-2], f))
        pos_c = gather_points(pos, cent)
        idx, mask = radius_neighbors(pos, pos_c, r, max_neighbors)
        out[f"_sa_cent_{i}"] = cent
        out[f"_sa_idx_{i}"] = idx
        out[f"_sa_mask_{i}"] = mask
        out[f"_sa_rel_{i}"] = ((gather_points(pos, idx) - pos_c[..., None, :]) / r).float()
        out[f"_sa_posc_{i}"] = pos_c.float()
        if i == 0 and feats is not None:
            xg = gather_points(feats, idx)
            out["_sa_xg_0"] = xg.reshape(xg.shape[0], -1, xg.shape[-1]).float()
        pos = pos_c
    return out


def extract_sa_neighbors(domain: dict, n_layers: int):
    """The precomputed chain (``sa_chain_precompute`` keys) of a FoamData
    domain as one entry per level, (cent, idx, mask, rel, posc), level 0's
    extended by xg when present; None when the domain holds no chain."""
    if "_sa_cent_0" not in domain:
        return None
    out = []
    for i in range(n_layers):
        entry = tuple(domain[f"_sa_{k}_{i}"] for k in ("cent", "idx", "mask", "rel", "posc"))
        if i == 0 and "_sa_xg_0" in domain:
            entry = entry + (domain["_sa_xg_0"],)
        out.append(entry)
    return out


def masked_max(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over the neighbour axis of values (..., K, F), counting the
    entries whose mask (..., K) is set; a neighbourhood with none gives 0.
    ``torch.max`` with its index, never ``amax``: the gradient goes to the
    first maximal entry, the kernels' tie rule."""
    filled = values.masked_fill(~mask[..., None], torch.finfo(values.dtype).min)
    out = torch.max(filled, dim=-2).values
    return out.masked_fill(~mask.any(dim=-1)[..., None], 0.0)
