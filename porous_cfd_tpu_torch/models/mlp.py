"""Core dense building blocks (counterpart of ``porous_cfd_tpu/models/mlp.py``).

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

from porous_cfd_tpu_torch.device import not_ported
from porous_cfd_tpu_torch.physics.analytic import ACTIVATIONS

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
    ``dropout`` has one entry per layer; ``last_activation=False`` leaves the
    final layer plain."""

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

    def forward(self, x, deterministic: bool = True):
        if (not deterministic and self.dropout is not None
                and any(r > 0 for r in self.dropout)):
            raise not_ported("MLP dropout (deterministic=False, training)")
        act = ACTIVATIONS[self.activation]
        linears = self.linears
        for i, lin in enumerate(linears):
            x = lin(x)
            if i < len(linears) - 1 or self.last_activation:
                x = act(x)
        return x


class PointNetFeatureExtract(nn.Module):
    """PIPN encoder: local shared MLP on coordinates, global MLP on
    [local || features] followed by a max-pool over the point axis."""

    def __init__(self, local_layers: Sequence[int],
                 global_layers: Sequence[int], activation: str = "tanh",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.local_feature = MLP(local_layers, activation=activation,
                                 generator=generator)
        self.global_feature = MLP(global_layers, activation=activation,
                                  generator=generator)

    def forward(self, x, pos, deterministic: bool = True):
        local = self.local_feature(pos)
        g = self.global_feature(torch.cat([local, x], dim=-1))
        g = torch.max(g, dim=-2, keepdim=True).values
        return local, g
