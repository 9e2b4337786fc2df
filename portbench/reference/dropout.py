"""The dropout mask rule, frozen.

Copied from ``porous_cfd_tpu_torch/ops/dropout.py`` (``philox4x32_10``,
``keep_threshold``, ``keep_mask``, ``fold_in``) and
``porous_cfd_tpu_torch/ops/neural_op_cuda.py`` (``TRUNK_STREAM``,
``trunk_seed``) at commit 4a0a8ad, so that a later change to the program
cannot move the reference's masks. The keep bit of (layer, case, merged row,
column) is Philox4x32-10 with counter (column // 4, merged row, case, layer)
and key (seed lo, seed hi), its ``column % 4``-th output read as an unsigned
32-bit integer and compared with ``(1 - rate) * 2**32``; a training step's
seed is ``fold_in(run seed, step)`` and the PI-GANO trunk draws from
``fold_in(step seed, TRUNK_STREAM)``.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK64 = (1 << 64) - 1
TRUNK_STREAM = 0x7472756E


def _mulhilo(m: int, b: torch.Tensor):
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32_10(counter, key):
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    return min(MASK32, int((1.0 - rate) * 2 ** 32))


def keep_mask(seed: int, layer: int, n_cases: int, n_rows: int, width: int, rate: float,
              device=None, case0: int = 0) -> torch.Tensor:
    """Inverted-dropout mask (n_cases, n_rows, width) float32 of the batch's
    cases ``case0`` on: ``1 / keep`` where kept, else 0."""
    keep = 1.0 - rate
    quads = torch.arange((width + 3) // 4, device=device)
    rows = torch.arange(n_rows, device=device)[:, None]
    cases = (torch.arange(n_cases, device=device) + case0)[:, None, None]
    outs = philox4x32_10((quads, rows, cases, layer), (seed & MASK32, (seed >> 32) & MASK32))
    bits = torch.stack(torch.broadcast_tensors(*outs), dim=-1)
    bits = bits.reshape(n_cases, n_rows, -1)[..., :width]
    return torch.where(bits < keep_threshold(rate), 1.0 / keep, 0.0).to(torch.float32)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    return _splitmix64(_splitmix64(int(seed) & MASK64) ^ (int(data) & MASK64))


def trunk_seed(seed: int) -> int:
    return fold_in(seed, TRUNK_STREAM)
