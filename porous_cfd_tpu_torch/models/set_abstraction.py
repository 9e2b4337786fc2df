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
gives 0. ``GeometryEncoderPp`` is PI-GANO++'s geometry encoder and
``SetAbstractionMrgSeq`` PIPN++ MRG's. The U-Net blocks
(FeaturePropagation) and ``k_chunks`` are not ported yet.
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


class SetAbstractionMrgSeq(nn.Module):
    """Multi-resolution-grouping encoder: four branches whose global
    descriptors are concatenated, (B, 1, 1024). Branch 1 is two radius
    levels, branch 2 one three-layer level on branch 1's first grouping,
    branch 3 a global level on the input, branch 4 a global level on
    branches 1 and 2's outputs and centroids, concatenated along the points.

    ``neighbors``: an optional 2-level chain over ``pos`` with (fraction,
    radius) = (0.5, 0.5), (0.125, 1.0) (``fractions``, ``radii``); FPS
    starts at point 0, so branch 2's grouping is branch 1's first level and
    one chain serves all three radius levels."""

    fractions = (0.5, 0.125)
    radii = (0.5, 1.0)

    def __init__(self, in_features: int, n_dims: int, activation: str = "tanh",
                 max_neighbors: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = n_dims
        (f0, f1), (r0, r1) = self.fractions, self.radii
        self.branch1_sa0 = SetAbstraction(f0, r0, [in_features + d, 64, 128], max_neighbors,
                                          activation, generator)
        self.branch1_sa1 = SetAbstraction(f1, r1, [128 + d, 256], max_neighbors, activation,
                                          generator)
        self.branch2_sa = SetAbstraction(f0, r0, [in_features + d, 64, 128, 256],
                                         max_neighbors, activation, generator)
        self.branch3_gsa = GlobalSetAbstraction([in_features + d, 128, 256, 512], activation,
                                                generator)
        self.branch4_gsa = GlobalSetAbstraction([256 + d, 512], activation, generator)

    def forward(self, x, pos, deterministic: bool = True, neighbors=None):
        nb0, nb1 = neighbors[:2] if neighbors is not None else (None, None)
        x1, p1 = self.branch1_sa0(x, pos, deterministic, nb0)
        x1, p1 = self.branch1_sa1(x1, p1, deterministic, nb1)
        x2, p2 = self.branch2_sa(x, pos, deterministic, nb0)
        x3, _ = self.branch3_gsa(x, pos, deterministic)
        x4, _ = self.branch4_gsa(torch.cat([x1, x2], dim=-2), torch.cat([p1, p2], dim=-2),
                                 deterministic)
        return torch.cat([x3, x4], dim=-1)


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


class GeometryEncoderPp(nn.Module):
    """PI-GANO++ geometry encoder: a SetAbstractionSeq ``set_abstraction``
    ending in a global level, one descriptor (B, 1, F) per cloud."""

    def __init__(self, fraction: Sequence[float], radius: Sequence[float],
                 conv_mlp: Sequence[Sequence[int]], activation: str = "silu",
                 max_neighbors: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.set_abstraction = SetAbstractionSeq(fraction, radius, conv_mlp, activation,
                                                 max_neighbors, generator)

    def forward(self, x, pos, deterministic: bool = True, neighbors=None):
        g, _ = self.set_abstraction(x, pos, deterministic, neighbors)
        return g
