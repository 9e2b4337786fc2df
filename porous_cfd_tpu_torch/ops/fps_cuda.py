"""Farthest-point sampling (counterpart of ``porous_cfd_tpu/ops/fps_pallas.py``
and of ``models/neighbors.py:farthest_point_sampling``).

``farthest_point_sampling`` launches the hand-written CUDA kernel
(``csrc/fps.cu``) for CUDA tensors and takes the plain PyTorch version,
``farthest_point_sampling_plain``, for CPU tensors. There is no other
fallback: a CUDA tensor either runs the kernel or raises.

Both versions compute each squared distance in difference form, the
coordinates in order, ``((x - xs)^2 + (y - ys)^2) + ...`` with every product
and sum rounded on its own (the kernel uses ``__fmul_rn``/``__fadd_rn``, so
the compiler cannot contract them into an FMA), and take the first index of
the maximum. So the kernel's indices equal the plain version's: one
differing centroid would change every later level of a SetAbstraction chain.
"""
from __future__ import annotations

import ctypes

import torch

from porous_cfd_tpu_torch.ops import build

MAX_DIMS = 3


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
        lib.fps_forward.argtypes = [p, i, i, i, i, p, p]
        lib.fps_forward.restype = i
    return lib


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
    pts = pos.detach().reshape(-1, n, dims).contiguous()
    out = torch.empty((pts.shape[0], n_samples), dtype=torch.int64, device=pos.device)
    lib = _library()
    with torch.cuda.device(pos.device):
        code = lib.fps_forward(pts.data_ptr(), pts.shape[0], n, dims, n_samples,
                               out.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream)
    build.check_launch("farthest_point_sampling", code)
    farthest_point_sampling.launches += 1
    return out.reshape(*lead, n_samples)


farthest_point_sampling.launches = 0
