"""Counter-based dropout masks shared by the decoder kernel and its plain
version.

The keep bit of (layer, case, merged row, column) is a pure function of a
64-bit seed and those four integers: Philox4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC'11) with

    counter = (column // 4, merged row, case, layer),  key = (seed lo, seed hi)

and the ``column % 4``-th of its four 32-bit outputs. The merged row is ``r``
for internal point ``r`` and ``Ni + r`` for boundary point ``r``, so one mask
spans [internal || boundary] rows, and the value, J and H rows of a point
share it. A column is kept when its 32 bits, read as an **unsigned** integer,
are below ``keep_threshold(rate)``; kept values are scaled by ``1 / keep``.

``csrc/common.cuh`` (``philox4x32_10``) computes the same function on the
card, so both versions draw identical masks on any device. Here it runs in
int64 torch arithmetic: every 32 x 32-bit product is split into 16-bit
halves so that no intermediate leaves int64, and results are masked to 32
bits.

The masks differ from ``jax.random``'s stream by design: parity with the JAX
package is tested with dropout off, and the masks by their statistics.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK64 = (1 << 64) - 1


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant ``m`` and
    the 32-bit values ``b`` (int64 tensors)."""
    p_lo = m * (b & 0xFFFF)                   # < 2^48
    p_hi = m * (b >> 16)                      # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)        # < 2^49
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit values.

    :param counter: four broadcastable tensors (c0, c1, c2, c3).
    :param key: two Python ints (k0, k1), each below 2^32.
    :return: four int64 tensors of 32-bit outputs.
    """
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
    """The unsigned 32-bit threshold below which a column is kept."""
    return min(MASK32, int((1.0 - rate) * 2 ** 32))


def keep_mask(seed: int, layer: int, n_cases: int, n_rows: int, width: int,
              rate: float, device=None) -> torch.Tensor:
    """Inverted-dropout mask (n_cases, n_rows, width) float32 over merged
    rows: ``1 / keep`` where kept, else 0."""
    keep = 1.0 - rate
    # one Philox call per 4 columns; its four outputs are columns 4c .. 4c+3
    quads = torch.arange((width + 3) // 4, device=device)
    rows = torch.arange(n_rows, device=device)[:, None]
    cases = torch.arange(n_cases, device=device)[:, None, None]
    outs = philox4x32_10((quads, rows, cases, layer),
                         (seed & MASK32, (seed >> 32) & MASK32))
    bits = torch.stack(torch.broadcast_tensors(*outs), dim=-1)
    bits = bits.reshape(n_cases, n_rows, -1)[..., :width]
    return torch.where(bits < keep_threshold(rate), 1.0 / keep, 0.0).to(torch.float32)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed derived from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in``): a pure function, so a training step's dropout
    seed depends only on the run's seed and the step number."""
    return _splitmix64(_splitmix64(int(seed) & _MASK64) ^ (int(data) & _MASK64))
