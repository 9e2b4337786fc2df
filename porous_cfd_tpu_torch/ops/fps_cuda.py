"""Farthest-point sampling (counterpart of ``porous_cfd_tpu/ops/fps_pallas.py``
and of ``models/neighbors.py:farthest_point_sampling``).

``farthest_point_sampling`` launches the hand-written CUDA kernel
(``csrc/fps.cu``) for CUDA tensors and takes the plain PyTorch version,
``farthest_point_sampling_plain``, for CPU tensors. There is no other
fallback: a CUDA tensor either runs the kernel or raises.

Both versions compute each squared distance in difference form, the
coordinates in order, ``((x - xs)^2 + (y - ys)^2) + ...`` with every
subtraction, product and sum rounded on its own (the kernel uses
``__fsub_rn``/``__fmul_rn``/``__fadd_rn``, so the compiler cannot contract
them into an FMA), and take the first index of the maximum. So the kernel's
indices equal the plain version's: one differing centroid would change
every later level of a SetAbstraction chain.

The kernel has two designs, and ``fps_design`` (a plain host function)
chooses between them by the cloud's size: design A runs a cloud in one
block, its points in registers; design B runs it in a thread-block cluster
of ``CLUSTER`` blocks, each holding a slice. A cloud past ``MAX_POINTS``
(131,072) raises ``ValueError`` before any launch.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from porous_cfd_tpu_torch.ops import build

MAX_DIMS = 3
# points a thread holds in registers: the kernel's instantiations
PER_THREAD = (1, 2, 4, 8, 16, 32)
# threads a block: at most eight warps (one barrier and one warp-wide
# reduction a pick read every warp's candidates)
MAX_THREADS = 256
# design A's block: the fewest points a thread that need no more than four
# warps, one for each of the SM's schedulers
A_THREADS = 128
# design B: CTAs a cluster (a non-portable size on Hopper)
CLUSTER = 16
# the most points a block holds, and design B's limit: a cluster of full blocks
BLOCK_CAPACITY = MAX_THREADS * PER_THREAD[-1]
MAX_POINTS = CLUSTER * BLOCK_CAPACITY
# design A up to this many points, design B past them: from the card's times
# (tools/time_engine.py --parts fps_sweep; the source note of csrc/fps.cu)
CROSSOVER = 2048
# fps_forward's code when no GPC can hold one cluster of the launch
NO_CLUSTER = -1


class Design(NamedTuple):
    """A launch of the kernel: ``kind`` "A" (a block a cloud, ``ctas`` 1) or
    "B" (a cluster of ``ctas`` blocks a cloud); ``threads`` a block and
    ``per_thread`` points a thread in registers."""
    kind: str
    ctas: int
    threads: int
    per_thread: int


def block_shape(points: int) -> tuple[int, int]:
    """(threads, per_thread) of a block holding ``points`` points: the
    fewest points a thread that need at most A_THREADS threads, else the
    most points a thread and more threads."""
    for p in PER_THREAD:
        if points <= A_THREADS * p:
            break
    return 32 * math.ceil(points / (32 * p)), p


def cta_shape(points: int) -> tuple[int, int]:
    """(threads, per_thread) of a cluster's CTA holding ``points`` points:
    one warp while 16 points a lane hold them (no barrier in the CTA), else
    as ``block_shape``."""
    for p in PER_THREAD[:-1]:
        if points <= 32 * p:
            return 32, p
    return block_shape(points)


def fps_design(b: int, n: int, d: int) -> Design:
    """The launch for ``b`` clouds of ``n`` points in ``d`` dimensions:
    design A up to CROSSOVER points, design B past them, up to
    MAX_POINTS; past that it raises ValueError. The batch does not
    change the choice (the source note of ``csrc/fps.cu`` says why)."""
    if not 1 <= d <= MAX_DIMS or n < 1 or b < 1:
        raise ValueError(f"farthest_point_sampling: no design for {b} clouds of {n} "
                         f"points in {d}D")
    if n > MAX_POINTS:
        raise ValueError(f"farthest_point_sampling: {n} points exceed the kernel's limit "
                         f"of {MAX_POINTS} (a cluster of {CLUSTER} blocks of "
                         f"{BLOCK_CAPACITY})")
    if n <= CROSSOVER:
        return Design("A", 1, *block_shape(n))
    return Design("B", CLUSTER, *cta_shape(math.ceil(n / CLUSTER)))


def _sqdist(pts: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, N) of pts (B, N, D) to c (B, D), summed over the
    coordinates in order."""
    d2 = (pts[..., 0] - c[:, None, 0]) ** 2
    for d in range(1, pts.shape[-1]):
        d2 = d2 + (pts[..., d] - c[:, None, d]) ** 2
    return d2


def farthest_point_sampling_plain(pos: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Iterative FPS over pos (..., N, D) -> (..., n_samples) int64 indices,
    starting at point 0: each step lowers the running min-distance-to-selected
    field by the distance to the last pick and picks its first maximum."""
    lead, (n, dims) = pos.shape[:-2], pos.shape[-2:]
    pts = pos.reshape(-1, n, dims)
    rows = torch.arange(pts.shape[0], device=pos.device)
    sel = torch.empty((pts.shape[0], n_samples), dtype=torch.int64, device=pos.device)
    sel[:, 0] = 0
    min_d2 = _sqdist(pts, pts[:, 0])
    for i in range(1, n_samples):
        nxt = torch.argmax(min_d2, dim=-1)
        sel[:, i] = nxt
        min_d2 = torch.minimum(min_d2, _sqdist(pts, pts[rows, nxt]))
    return sel.reshape(*lead, n_samples)


def _library() -> ctypes.CDLL:
    lib = build.library("fps")
    if lib.fps_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fps_forward.argtypes = [p, i, i, i, i, i, i, i, p, p]
        lib.fps_forward.restype = i
    return lib


def launch(pts: torch.Tensor, n_samples: int, design: Design) -> torch.Tensor:
    """One launch of the kernel in ``design`` over pts (B, N, D), contiguous
    f32 on the card -> (B, n_samples) int64. The wrapper passes
    ``fps_design``'s choice; tools/time_engine.py times the others."""
    b, n, dims = pts.shape
    out = torch.empty((b, n_samples), dtype=torch.int64, device=pts.device)
    lib = _library()
    with torch.cuda.device(pts.device):
        code = lib.fps_forward(pts.data_ptr(), b, n, dims, n_samples, design.ctas,
                               design.threads, design.per_thread, out.data_ptr(),
                               torch.cuda.current_stream(pts.device).cuda_stream)
    if code == NO_CLUSTER:
        raise RuntimeError(f"farthest_point_sampling: no GPC of this card holds a cluster "
                           f"of {design.ctas} blocks of {design.threads} threads")
    build.check_launch("farthest_point_sampling", code)
    farthest_point_sampling.launches += 1
    return out


def farthest_point_sampling(pos: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS from point 0 over pos (..., N, D) -> (..., n_samples) int64
    indices, every cloud of the batch in one launch on a CUDA tensor."""
    if pos.device.type == "cpu":
        return farthest_point_sampling_plain(pos, n_samples)
    if pos.device.type != "cuda":
        raise ValueError(f"farthest_point_sampling: no kernel for device {pos.device}")
    lead, (n, dims) = pos.shape[:-2], pos.shape[-2:]
    if pos.dtype != torch.float32 or not 1 <= dims <= MAX_DIMS:
        raise ValueError("farthest_point_sampling: pos must be float32 with 1 to "
                         f"{MAX_DIMS} coordinates, got {tuple(pos.shape)} {pos.dtype}")
    if n < 1 or n_samples < 1:
        raise ValueError(f"farthest_point_sampling: {n_samples} samples of {n} points")
    pts = pos.detach().reshape(-1, n, dims)
    design = fps_design(pts.shape[0], n, dims)
    return launch(pts.contiguous(), n_samples, design).reshape(*lead, n_samples)


farthest_point_sampling.launches = 0
