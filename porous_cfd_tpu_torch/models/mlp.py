"""Core dense building blocks (counterpart of ``porous_cfd_tpu/models/mlp.py``):
the MLP, PIPN's PointNet encoder, and PI-GANO's branch net, geometry encoder
and NeuralOperator trunk.

Layer names follow the flax modules (``linear_0``, ``linear_1``, ...), so a
state-dict key such as ``decoder.linear_0.weight`` names the flax parameter
``decoder/linear_0/kernel`` (transposed). Every ``nn.Linear`` is initialised
as ``flax.linen.Dense`` is: a LeCun-normal weight (truncated normal with
variance 1/fan_in) and a zero bias, drawn from an explicit generator.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.ops.neural_op_cuda import trunk_seed
from porous_cfd_tpu_torch.parallel.mesh import points_max
from porous_cfd_tpu_torch.physics.analytic import ACTIVATIONS, merged_mask

# std of a unit normal truncated to [-2, 2]; flax divides by it so that the
# truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978


def dense(in_features: int, out_features: int,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` with flax's default Dense initialisation, made on the CPU
    (the generator's device); move the finished module with ``.to``."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features)
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class MLP(nn.Module):
    """Linear stack. ``layers`` includes the input size: [in, h1, ..., out].
    ``dropout`` has one entry per layer, applied after its activation when
    not ``deterministic``; ``last_activation=False`` leaves the final layer
    plain. The dropout masks are ``analytic.merged_mask`` of ``seed`` and the
    layer over the input's rows (at their ``placement`` in the batch), so a
    decoder applied to the merged [internal || boundary] rows drops what the
    analytic decoder path drops for the same seed."""

    def __init__(self, layers: Sequence[int],
                 dropout: Optional[Sequence[float]] = None,
                 activation: str = "tanh", last_activation: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_out = len(layers) - 1
        if dropout is not None and len(dropout) != n_out:
            raise ValueError(
                f"Mismatching number of layers ({len(layers)}) and dropout "
                f"({len(dropout)}).")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.layers = tuple(layers)
        self.dropout = None if dropout is None else tuple(float(r) for r in dropout)
        self.activation = activation
        self.last_activation = last_activation
        for i in range(n_out):
            self.add_module(f"linear_{i}",
                            dense(layers[i], layers[i + 1], generator))

    @property
    def linears(self) -> list[nn.Linear]:
        return [getattr(self, f"linear_{i}") for i in range(len(self.layers) - 1)]

    def forward(self, x, deterministic: bool = True, seed: Optional[int] = None,
                placement: Placement = WHOLE):
        drop = (not deterministic and self.dropout is not None
                and any(r > 0 for r in self.dropout))
        if drop and seed is None:
            raise ValueError("MLP: dropout needs a seed")
        act = ACTIVATIONS[self.activation]
        linears = self.linears
        for i, lin in enumerate(linears):
            x = lin(x)
            if i < len(linears) - 1 or self.last_activation:
                x = act(x)
            if drop and self.dropout[i] > 0:
                x = x * merged_mask(seed, i, self.dropout[i], x, placement=placement)
        return x


def pool_rows(y, placement: Placement = WHOLE):
    """Max-pool of ``y`` (B, N, F) over its rows, the first maximal row
    taking the gradient; where the rows are a points share (``placement``),
    the whole cloud's pool (``parallel.mesh.points_max``)."""
    g, rows = torch.max(y, dim=-2, keepdim=True)
    return points_max(g, rows, None, placement)


class PointNetFeatureExtract(nn.Module):
    """PIPN encoder: local shared MLP on coordinates, global MLP on
    [local || features] followed by a max-pool over the point axis (over the
    whole cloud where the rows are a points share at ``placement``)."""

    def __init__(self, local_layers: Sequence[int],
                 global_layers: Sequence[int], activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.local_feature = MLP(local_layers, activation=activation,
                                 generator=generator)
        self.global_feature = MLP(global_layers, activation=activation,
                                  generator=generator)

    def forward(self, x, pos, deterministic: bool = True, placement: Placement = WHOLE):
        local = self.local_feature(pos)
        g = self.global_feature(torch.cat([local, x], dim=-1))
        return local, pool_rows(g, placement)


class Branch(nn.Module):
    """PI-GANO branch net: MLP on the variable-boundary features, max-pooled
    over the point axis -> (B, 1, H)."""

    def __init__(self, hidden_channels: Sequence[int], activation: str = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = MLP(hidden_channels, activation=activation, generator=generator)

    def forward(self, param_features, deterministic: bool = True):
        return torch.max(self.linear(param_features), dim=-2, keepdim=True).values


class GeometryEncoder(nn.Module):
    """PI-GANO geometry encoder: MLP on [features || pos], max-pooled over
    the point axis (the whole cloud's, at a points share's ``placement``)
    -> (B, 1, K)."""

    def __init__(self, hidden_channels: Sequence[int], activation: str = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = MLP(hidden_channels, activation=activation, generator=generator)

    def forward(self, x, pos, deterministic: bool = True, placement: Placement = WHOLE):
        return pool_rows(self.linear(torch.cat([x, pos], dim=-1)), placement)


class NeuralOperator(nn.Module):
    """One PI-GANO trunk layer: dense -> activation -> dropout, the output
    multiplied by the branch embedding. The dense layer is ``Dense_0``, the
    flax name. The dropout mask is the trunk kernel's: ``merged_mask`` of the
    trunk's seed (``trunk_seed``) and the operator's index ``layer`` over the
    input's rows, so a trunk applied to the merged [internal || boundary]
    rows drops what the analytic trunk path drops for the same seed."""

    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.0,
                 activation: Optional[str] = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = float(dropout)
        self.activation = activation
        self.Dense_0 = dense(in_channels, out_channels, generator)

    def forward(self, x, par_embedding, deterministic: bool = True,
                seed: Optional[int] = None, layer: int = 0, placement: Placement = WHOLE):
        y = self.Dense_0(x)
        if self.activation is not None:
            y = ACTIVATIONS[self.activation](y)
        if not deterministic and self.dropout > 0:
            if seed is None:
                raise ValueError("NeuralOperator: dropout needs a seed")
            y = y * merged_mask(trunk_seed(seed), layer, self.dropout, y, placement=placement)
        return y * par_embedding


class NeuralOperatorSequential(nn.Module):
    """Stack of ``n_operators`` square NeuralOperator layers (``operator_i``),
    ``n_features`` wide, with one dropout rate per layer."""

    def __init__(self, n_operators: int, n_features: int,
                 dropout: Sequence[float], activation: str = "silu",
                 last_activation: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(dropout) != n_operators:
            raise ValueError(f"{len(dropout)} dropout rates for {n_operators} operators")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.n_operators = n_operators
        self.dropout = tuple(float(r) for r in dropout)
        self.activation = activation
        self.last_activation = last_activation
        for i in range(n_operators):
            act = None if (i == n_operators - 1 and not last_activation) else activation
            self.add_module(f"operator_{i}",
                            NeuralOperator(n_features, n_features, self.dropout[i], act,
                                           generator))

    @property
    def operators(self) -> list[NeuralOperator]:
        return [getattr(self, f"operator_{i}") for i in range(self.n_operators)]

    @property
    def linears(self) -> list[nn.Linear]:
        return [op.Dense_0 for op in self.operators]

    def forward(self, x, par_embedding, deterministic: bool = True,
                seed: Optional[int] = None, placement: Placement = WHOLE):
        for i, op in enumerate(self.operators):
            x = op(x, par_embedding, deterministic, seed, i, placement)
        return x
