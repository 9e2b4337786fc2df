"""``pointnet_global``: max over points of an MLP with every layer activated,
plus the first maximal row per channel (counterpart of
``porous_cfd_tpu/ops/pointnet_pallas.py``, forward only).

``pointnet_global`` launches the hand-written CUDA kernel
(``csrc/pointnet_global.cu``) for CUDA tensors and takes the plain PyTorch
version, ``pointnet_global_plain``, for CPU tensors. There is no other
fallback: a CUDA tensor either runs the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from porous_cfd_tpu_torch.ops import build
from porous_cfd_tpu_torch.physics import analytic

ACT_CODES = {"silu": 0, "tanh": 1}


def pointnet_global_plain(linears: Sequence, x: torch.Tensor, activation: str):
    """``analytic.mlp_value`` then ``torch.max`` over the point axis, whose
    index is the first maximal row (never ``amax``, which splits ties).
    Returns (max (B, 1, F) f32, argmax (B, 1, F) int32)."""
    g = analytic.mlp_value(linears, x, activation)
    m, idx = torch.max(g, dim=-2, keepdim=True)
    return m, idx.to(torch.int32)


def _library() -> ctypes.CDLL:
    lib = build.library("pointnet_global")
    if lib.pointnet_global_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pointnet_global_forward.argtypes = [p, i, i, i, p, p, p, i, p, p, p, p, p]
        lib.pointnet_global_forward.restype = i
        lib.pointnet_global_tile_rows.argtypes = []
        lib.pointnet_global_tile_rows.restype = i
    return lib


def _check_inputs(linears, x, activation):
    if activation not in ACT_CODES:
        raise ValueError(f"pointnet_global: unsupported activation {activation!r}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("pointnet_global: x must be a contiguous (B, N, L) "
                         f"float32 tensor, got {tuple(x.shape)} {x.dtype}")
    width = x.shape[-1]
    for i, lin in enumerate(linears):
        w, b = lin.weight, lin.bias
        for t in (w, b):
            if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"pointnet_global: layer {i} parameters must be "
                                 f"contiguous float32 on {x.device}")
        if w.shape[1] != width or b.shape != (w.shape[0],):
            raise ValueError(f"pointnet_global: layer {i} has weight "
                             f"{tuple(w.shape)}, expected (*, {width})")
        width = w.shape[0]


def pointnet_global(linears: Sequence, x: torch.Tensor, activation: str):
    """Fused ``max over points of MLP(x)``: x (B, N, L0) -> (max (B, 1, F)
    float32, argmax (B, 1, F) int32)."""
    if x.device.type == "cpu":
        return pointnet_global_plain(linears, x, activation)
    if x.device.type != "cuda":
        raise ValueError(f"pointnet_global: no kernel for device {x.device}")
    _check_inputs(linears, x, activation)
    lib = _library()
    n_cases, n_pts, _ = x.shape
    # the kernel reads weights as (in, out): nn.Linear's weight transposed
    ws = [lin.weight.t().contiguous() for lin in linears]
    bs = [lin.bias for lin in linears]
    widths = [x.shape[-1]] + [w.shape[1] for w in ws]
    f = widths[-1]
    tile_rows = lib.pointnet_global_tile_rows()
    n_tiles = -(-n_pts // tile_rows)
    part_max = torch.empty((n_cases, n_tiles, f), dtype=torch.float32, device=x.device)
    part_arg = torch.empty((n_cases, n_tiles, f), dtype=torch.int32, device=x.device)
    out_max = torch.empty((n_cases, 1, f), dtype=torch.float32, device=x.device)
    out_arg = torch.empty((n_cases, 1, f), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.pointnet_global_forward(
            x.data_ptr(), n_cases, n_pts, len(ws), build.pointer_array(ws),
            build.pointer_array(bs), build.int_array(widths), ACT_CODES[activation],
            part_max.data_ptr(), part_arg.data_ptr(), out_max.data_ptr(),
            out_arg.data_ptr(), stream)
    build.check_launch("pointnet_global", code)
    pointnet_global.launches += 1
    return out_max, out_arg


pointnet_global.launches = 0
