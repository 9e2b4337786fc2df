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

The case and merged row are the whole batch's: a share of it (a sharded
training step) draws its part of the single process's mask at its
``Placement``. ``csrc/common.cuh`` (``philox4x32_10``) computes the same
function on the card, so both versions draw identical masks on any device. Here it runs in
int64 torch arithmetic: every 32 x 32-bit product is split into 16-bit
halves so that no intermediate leaves int64, and results are masked to 32
bits.

The masks differ from ``jax.random``'s stream by design: parity with the JAX
package is tested with dropout off, and the masks by their statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a share of a batch sits in the whole batch. ``case0``: the
    global index of local case 0. With the rows split (``bnd_row0`` set),
    local internal row r is global merged row ``int_row0 + r`` and local
    boundary row r is ``bnd_row0 + r`` (the global internal rows come
    first); ``mesh`` then holds the 'points' group that shares the rows,
    ``n_int`` the share's internal row count and ``whole`` the share's
    cases with all their rows and subdomains (a ``FoamData``), which the
    parts of a model that run whole on each rank read. The default is the
    whole batch."""
    case0: int = 0
    int_row0: int = 0
    bnd_row0: Optional[int] = None
    mesh: Optional[object] = None
    n_int: Optional[int] = None
    whole: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def rows_split(self) -> bool:
        return self.bnd_row0 is not None

    def cases_only(self) -> "Placement":
        """The placement of rows that every rank of the points group holds
        whole (a coarse level of an encoder run whole per rank)."""
        return Placement(case0=self.case0)

    def cloud(self, batch):
        """The share's cases with all their rows: ``whole`` where the rows
        are split, else ``batch`` itself."""
        return self.whole if self.rows_split else batch

    def global_rows(self, rows: torch.Tensor, n_int: Optional[int] = None) -> torch.Tensor:
        """The global merged rows of local merged rows ``rows``, where the
        first ``n_int`` local rows are internal (needed when the rows are
        split; the placement's own ``n_int`` by default)."""
        if not self.rows_split:
            return rows
        n_int = self.n_int if n_int is None else n_int
        if n_int is None:
            raise ValueError("a points-split placement needs the local internal row count")
        return torch.where(rows < n_int, rows + self.int_row0, rows - n_int + self.bnd_row0)

    def launch_row0(self, n_int: int, boundary: bool) -> int:
        """The row offset a kernel launch adds to its merged row (internal
        launch: rows from 0; boundary launch: rows from ``n_int``)."""
        if not self.rows_split:
            return 0
        return self.bnd_row0 - n_int if boundary else self.int_row0


WHOLE = Placement()


def keep_threshold(rate: float) -> int:
    """The unsigned 32-bit threshold below which a column is kept."""
    return min(MASK32, int((1.0 - rate) * 2 ** 32))


def keep_mask(seed: int, layer: int, n_cases: int, n_rows: int, width: int,
              rate: float, device=None, case0: int = 0,
              rows: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted-dropout mask (n_cases, n_rows, width) float32 over merged
    rows: ``1 / keep`` where kept, else 0. A share of a batch draws the
    whole batch's mask at its place: its cases from global case ``case0``
    on, its rows at the global merged rows ``rows`` (n_rows,) (0 .. n_rows
    - 1 when None)."""
    keep = 1.0 - rate
    # one Philox call per 4 columns; its four outputs are columns 4c .. 4c+3
    quads = torch.arange((width + 3) // 4, device=device)
    rows = (torch.arange(n_rows, device=device) if rows is None else rows.to(device))[:, None]
    cases = (torch.arange(n_cases, device=device) + case0)[:, None, None]
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
