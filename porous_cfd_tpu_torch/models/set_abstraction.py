"""PointNet++ building blocks (counterpart of
``porous_cfd_tpu/models/set_abstraction.py``): SetAbstraction levels, the
trailing GlobalSetAbstraction, their sequence, the PIPN++ encoder, and the
U-Net decoders' FeaturePropagation levels (plain and neural-operator).

These are the plain forwards on dense, padded and masked neighbourhoods
(``models/neighbors.py``): with a precomputed chain or, without one, FPS
and the radius search on the fly. The analytic derivative paths run the
encoders' parameters through the fused kernels instead (``ops/sa_cuda.py:
sa_seq_fused``). Submodule names are the flax ones (``sa_{i}/conv_mlp``,
``global_sa/mlp``, ``local_feature``, ``global_feature``, ``fp_{i}/mlp``,
``fpno_{i}/mlp``, ``fpno_{i}/par_reduce``), so ``convert.params_from_flax``
carries trees across unchanged.

The JAX package's semantics notes hold: relative positions are
``(pos_j - pos_i) / r``, FPS starts at index 0, and an empty neighbourhood
gives 0. ``GeometryEncoderPp`` is PI-GANO++'s geometry encoder and
``SetAbstractionMrgSeq`` PIPN++ MRG's. A FeaturePropagation level's dropout
draws ``analytic.merged_mask`` of its own seed, ``fp_level_seed(seed, i)``,
which the U-Nets' analytic paths draw too.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from porous_cfd_tpu_torch.models.mlp import MLP, dense
from porous_cfd_tpu_torch.models.neighbors import (farthest_point_sampling, fps_count,
                                                   gather_points, knn, knn_interpolate_with_idx,
                                                   masked_max, radius_neighbors)
from porous_cfd_tpu_torch.ops import dropout as dropout_ops
from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.physics.analytic import ACTIVATIONS


class SetAbstraction(nn.Module):
    """FPS -> radius graph -> shared MLP on ``[x_j || (pos_j - pos_c) / r]``
    -> masked max over neighbours: (B, N, F), (B, N, D) -> (B, C, F'), (B,
    C, D) with C = ceil(ratio * N). The JAX module's ``k_chunks`` running
    max has no counterpart: the max is the same, and under torch's autograd
    every chunk's activations are saved all the same (PERF.md, phase 28 of
    ``chip_smoke.py``)."""

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
    pos), and with ``return_skip`` ((x, pos), skips): each level's input
    (x, pos), the U-Net decoder's skip connections."""

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

    def forward(self, x, pos, deterministic: bool = True, neighbors=None,
                return_skip: bool = False):
        skips = [(x, pos)]
        for i in range(len(self.radius)):
            x, pos = getattr(self, f"sa_{i}")(x, pos, deterministic,
                                              None if neighbors is None else neighbors[i])
            skips.append((x, pos))
        if self.has_global:
            x, pos = self.global_sa(x, pos, deterministic)
            skips.append((x, pos))
        return ((x, pos), skips[:-1]) if return_skip else (x, pos)


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


def fp_level_seed(seed: Optional[int], i: int) -> Optional[int]:
    """FeaturePropagation level i's dropout seed, derived from the step's."""
    return None if seed is None else dropout_ops.fold_in(seed, i)


def level_dropout(dropout, i: int, layers: Sequence[int]) -> Optional[list]:
    """Level i's dropout rates, one a layer: a scalar 0 is none, another
    scalar every layer's rate, a list taken as given."""
    if dropout is None:
        return None
    d = dropout[i]
    if isinstance(d, (int, float)):
        return None if d == 0 else [float(d)] * (len(layers) - 1)
    return [float(r) for r in d]


class FeaturePropagation(nn.Module):
    """kNN-interpolate coarse features (B, M, F) at pos (B, M, D) to the
    skip level's points, concatenate the skip features, shared MLP ``mlp``
    (its last layer plain with ``plain_last``). ``knn_idx`` gives the
    neighbours (``_fp_idx_{i}`` of the U-Net precompute), else they are
    found here."""

    def __init__(self, k: int, mlp_layers: Sequence[int], dropout=None,
                 plain_last: bool = False, activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.mlp = MLP(mlp_layers, dropout, activation, last_activation=not plain_last,
                       generator=generator)

    def upsample(self, x, pos, x_skip, pos_skip, knn_idx=None):
        """The MLP's input: ``[interpolated x || x_skip]`` at pos_skip."""
        if knn_idx is None:
            knn_idx = knn(pos, pos_skip, self.k)[0]
        x_up = knn_interpolate_with_idx(x, pos, pos_skip, knn_idx)
        return x_up if x_skip is None else torch.cat([x_up, x_skip], dim=-1)

    def forward(self, x, pos, x_skip, pos_skip, deterministic: bool = True, knn_idx=None,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        return self.mlp(self.upsample(x, pos, x_skip, pos_skip, knn_idx), deterministic,
                        seed, placement), pos_skip


class FeaturePropagationNeuralOperator(FeaturePropagation):
    """FeaturePropagation whose output is multiplied by the activated
    ``par_reduce`` (a dense layer from ``par_width``) of a per-case branch
    embedding (B, 1, par_width)."""

    def __init__(self, k: int, mlp_layers: Sequence[int], par_width: int, dropout=None,
                 plain_last: bool = False, activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__(k, mlp_layers, dropout, plain_last, activation, generator)
        self.activation = activation
        self.par_reduce = dense(par_width, mlp_layers[-1], generator)

    def modulation(self, par_embedding):
        """The activated ``par_reduce`` of the branch embedding, (B, 1, F)."""
        return ACTIVATIONS[self.activation](self.par_reduce(par_embedding))

    def forward(self, par_embedding, x, pos, x_skip, pos_skip, deterministic: bool = True,
                knn_idx=None, seed: Optional[int] = None, placement: Placement = WHOLE):
        y, pos_skip = super().forward(x, pos, x_skip, pos_skip, deterministic, knn_idx, seed,
                                      placement)
        return y * self.modulation(par_embedding), pos_skip


class FeaturePropagationSeq(nn.Module):
    """FeaturePropagation levels ``fp_{i}`` walking the skips backwards, the
    last level plain; level i drops with ``fp_level_seed(seed, i)``. With a
    ``par_width`` they are FeaturePropagationNeuralOperator levels
    ``fpno_{i}`` (the JAX package's FeaturePropagationNeuralOperatorSeq),
    each modulated by the branch embedding given to ``forward``."""

    def __init__(self, fp_layers: Sequence[Sequence[int]], k: Sequence[int], dropout=None,
                 activation: str = "tanh", generator: Optional[torch.Generator] = None,
                 par_width: Optional[int] = None):
        super().__init__()
        self.fp_layers = tuple(tuple(layers) for layers in fp_layers)
        self.k = tuple(k)
        self.dropout = dropout
        self.prefix = "fp" if par_width is None else "fpno"
        n = len(fp_layers)
        for i, (layers, k_i) in enumerate(zip(fp_layers, k)):
            rates = level_dropout(dropout, i, layers)
            self.add_module(f"{self.prefix}_{i}", FeaturePropagation(
                k_i, layers, rates, i == n - 1, activation, generator) if par_width is None
                else FeaturePropagationNeuralOperator(k_i, layers, par_width, rates, i == n - 1,
                                                      activation, generator))

    @property
    def levels(self) -> list[FeaturePropagation]:
        return [getattr(self, f"{self.prefix}_{i}") for i in range(len(self.fp_layers))]

    def forward(self, x, pos, skips, deterministic: bool = True, knn_idx=None,
                seed: Optional[int] = None, par_embedding=None,
                n_levels: Optional[int] = None, placement: Placement = WHOLE):
        """Levels [:n_levels] (all when None) from the coarsest (x, pos).
        The last level's rows are the batch's, at their ``placement``; a
        middle level's are coarse points, which every rank of a points
        share holds whole (their masks at the placement's cases alone)."""
        last = len(self.levels) - 1
        for i, level in enumerate(self.levels[:n_levels]):
            x_skip, pos_skip = skips[-(i + 1)]
            pl = placement if i == last else placement.cases_only()
            args = (x, pos, x_skip, pos_skip, deterministic,
                    None if knn_idx is None else knn_idx[i], fp_level_seed(seed, i), pl)
            x, pos = level(*args) if par_embedding is None else level(par_embedding, *args)
        return x, pos
