"""A run's seeded draws: the streams of its seed, and the weights.

The data, the weights, the traffic and the check's sample draw from streams
of their own, so that one changes nothing of the others.
"""
from __future__ import annotations

import numpy as np
import torch

DATA, WEIGHTS, TRAFFIC, SAMPLE = 1, 2, 3, 4


def stream(seed: int, k: int) -> int:
    """A 63-bit seed of stream ``k`` of a run's ``seed``."""
    return int(np.random.SeedSequence([int(seed), k]).generate_state(2, np.uint32)
               .view(np.uint64)[0] >> np.uint64(1))


def rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), k]))


def draw_weights(named_params, seed: int, device, bias_scale: float = 0.1) -> dict:
    """Fill the parameters ``named_params`` ((name, tensor) pairs) from
    ``seed`` on ``device`` in one draw: a weight (out, in) is normal with
    variance 1 / in, a bias normal with standard deviation ``bias_scale /
    sqrt(in)`` of its layer's input width. Returns {name: a copy of the
    values drawn}, the harness's own, for the reference."""
    named = list(named_params)
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(stream(seed, WEIGHTS))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    fan_in = {}
    for name, p in named:
        if p.dim() == 2:
            fan_in[name.rsplit(".", 1)[0]] = p.shape[1]
    out, offset = {}, 0
    with torch.no_grad():
        for name, p in named:
            layer = name.rsplit(".", 1)[0]
            scale = fan_in[layer] ** -0.5 * (1.0 if p.dim() == 2 else bias_scale)
            values = z[offset:offset + p.numel()].view_as(p) * scale
            offset += p.numel()
            p.copy_(values)
            out[name] = values
    return out
