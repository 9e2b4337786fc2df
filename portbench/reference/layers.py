"""The reference's building blocks, shared by the families' forwards
(``families/<family>.py``): plain float32 PyTorch, nothing of the program.

Parameters come as {name: tensor} under the program module's names (the
layout the harness drew them in); each MLP is read by its prefix. Matmuls
run as the caller's context sets them: float32 with TF32 off for the
reference, TF32 or bfloat16 autocast for the lower-precision control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import dropout


def linear(x, params, prefix):
    return F.linear(x, params[f"{prefix}.weight"], params[f"{prefix}.bias"])


def mask(seed, layer, rate, x, case0):
    """The frozen rule's inverted-dropout mask (keep / (1 - rate)) of layer
    ``layer`` for ``x`` (B, N, W), whose cases are the batch's from
    ``case0`` on."""
    m = dropout.keep_mask(seed, layer, x.shape[0], x.shape[-2], x.shape[-1], rate, x.device,
                          case0)
    return m.to(x.dtype)


def mlp(x, params, prefix: str, n_layers: int, last_activation: bool = True,
        rates=None, seed=None, case0: int = 0):
    """``prefix.linear_{i}`` for i < n_layers, SiLU between (and after the
    last one with ``last_activation``), inverted dropout after layer i's
    activation at ``rates[i]`` when ``seed`` is given (``x``'s cases are the
    batch's from ``case0`` on)."""
    for i in range(n_layers):
        x = linear(x, params, f"{prefix}.linear_{i}")
        if i < n_layers - 1 or last_activation:
            x = F.silu(x)
        if seed is not None and rates is not None and rates[i] > 0:
            x = x * mask(seed, i, rates[i], x, case0)
    return x


def field(dataset, data, name):
    """The columns of field or group ``name`` of ``data`` (B, N, F)."""
    c = dataset.cols(name)
    return data[..., c[0]:c[-1] + 1]


def subdomain(data, ids):
    """The rows ``ids`` (B, K) of each case of ``data`` (B, N, F)."""
    return torch.gather(data, 1, ids[..., None].expand(*ids.shape, data.shape[-1]))
