"""PointNet++ building blocks (counterpart of
``porous_cfd_tpu/models/set_abstraction.py``): SetAbstraction levels, the
trailing GlobalSetAbstraction, their sequence, and the PIPN++ encoder.

These are the plain forwards on dense, padded and masked neighbourhoods
(``models/neighbors.py``): with a precomputed chain or, without one, FPS
and the radius search on the fly. The analytic derivative path runs the
same parameters through the fused kernels instead (``ops/sa_cuda.py:
sa_seq_fused``). Submodule names are the flax ones (``sa_{i}/conv_mlp``,
``global_sa/mlp``, ``local_feature``, ``global_feature``), so
``convert.params_from_flax`` carries trees across unchanged.

The JAX package's semantics notes hold: relative positions are
``(pos_j - pos_i) / r``, FPS starts at index 0, and an empty neighbourhood
gives 0. The U-Net blocks (FeaturePropagation), the MRG encoder and
``k_chunks`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.models.neighbors import (farthest_point_sampling, fps_count,
                                                   gather_points, masked_max,
                                                   radius_neighbors)


class SetAbstraction(nn.Module):
    """FPS -> radius graph -> shared MLP on ``[x_j || (pos_j - pos_c) / r]``
    -> masked max over neighbours: (B, N, F), (B, N, D) -> (B, C, F'), (B,
    C, D) with C = ceil(ratio * N)."""

    def __init__(self, ratio: float, r: float, mlp_layers: Sequence[int],
                 max_neighbors: int = 64, activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ratio = ratio
        self.r = r
        self.max_neighbors = max_neighbors
        self.conv_mlp = MLP(mlp_layers, activation=activation, generator=generator)

    def forward(self, x, pos, deterministic: bool = True, neighbors=None):
        """``neighbors``: an optional precomputed (cent, idx, mask, ...)
        level of ``neighbors.sa_chain_precompute``."""
        if neighbors is not None:
            centroids, idx, mask = neighbors[:3]
        else:
            centroids = farthest_point_sampling(pos, fps_count(pos.shape[-2], self.ratio))
        pos_c = gather_points(pos, centroids)
        if neighbors is None:
            idx, mask = radius_neighbors(pos, pos_c, self.r, self.max_neighbors)
        rel = (gather_points(pos, idx) - pos_c[..., None, :]) / self.r
        h = self.conv_mlp(torch.cat([gather_points(x, idx), rel], dim=-1), deterministic)
        return masked_max(h, mask), pos_c


class GlobalSetAbstraction(nn.Module):
    """MLP on ``[x || pos]`` and a max over the points: one descriptor per
    cloud, at position 0."""

    def __init__(self, mlp_layers: Sequence[int], activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLP(mlp_layers, activation=activation, generator=generator)

    def forward(self, x, pos, deterministic: bool = True):
        h = self.mlp(torch.cat([x, pos], dim=-1), deterministic)
        out = torch.max(h, dim=-2, keepdim=True).values
        return out, pos.new_zeros((*pos.shape[:-2], 1, pos.shape[-1]))


class SetAbstractionSeq(nn.Module):
    """SetAbstraction levels ``sa_{i}``, and a trailing GlobalSetAbstraction
    ``global_sa`` when there are more conv stacks than radii. Returns (x,
    pos)."""

    def __init__(self, fraction: Sequence[float], radius: Sequence[float],
                 conv_mlp: Sequence[Sequence[int]], activation: str = "tanh",
                 max_neighbors: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fraction = tuple(fraction)
        self.radius = tuple(radius)
        self.conv_mlp = tuple(tuple(c) for c in conv_mlp)
        self.has_global = len(conv_mlp) > len(radius)
        for i, (f, r, layers) in enumerate(zip(fraction, radius, conv_mlp)):
            self.add_module(f"sa_{i}", SetAbstraction(f, r, layers, max_neighbors, activation,
                                                      generator))
        if self.has_global:
            self.global_sa = GlobalSetAbstraction(conv_mlp[-1], activation, generator)

    def forward(self, x, pos, deterministic: bool = True, neighbors=None):
        for i in range(len(self.radius)):
            x, pos = getattr(self, f"sa_{i}")(x, pos, deterministic,
                                              None if neighbors is None else neighbors[i])
        if self.has_global:
            x, pos = self.global_sa(x, pos, deterministic)
        return x, pos


class PointNetFeatureExtractPp(nn.Module):
    """PIPN++ encoder: a local shared MLP on all points, and a
    SetAbstraction branch over the geometry (boundary) cloud."""

    def __init__(self, local_layers: Sequence[int], global_layers: Sequence[Sequence[int]],
                 global_fraction: Sequence[float], global_radius: Sequence[float],
                 activation: str = "tanh", max_neighbors: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.local_feature = MLP(local_layers, activation=activation, generator=generator)
        self.global_feature = SetAbstractionSeq(global_fraction, global_radius, global_layers,
                                                activation, max_neighbors, generator)

    def forward(self, geom_features, geom_pos, global_pos, deterministic: bool = True,
                neighbors=None):
        local = self.local_feature(global_pos, deterministic)
        g, _ = self.global_feature(geom_features, geom_pos, deterministic, neighbors)
        return local, g
