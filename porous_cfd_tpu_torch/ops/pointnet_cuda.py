"""``pointnet_global``: max over points of an MLP with every layer activated,
plus the first maximal row per channel (counterpart of
``porous_cfd_tpu/ops/pointnet_pallas.py``), forward and backward.

``pointnet_global`` launches the hand-written CUDA kernel
(``csrc/pointnet_global.cu``) for CUDA tensors and takes the plain PyTorch
version, ``pointnet_global_plain``, for CPU tensors. There is no other
fallback: a CUDA tensor either runs the kernel or raises. When a gradient is
wanted the kernel runs inside a ``torch.autograd.Function`` whose backward is
the backward kernel (``pointnet_global_backward``): the pooled cotangent goes
to the first maximal row, the tie rule of the forward's argmax, which is
returned non-differentiable.
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
    index is the first maximal row (never ``amax``, which splits ties); its
    autograd backward routes the cotangent to that row. Returns (max (B, 1,
    F) f32, argmax (B, 1, F) int32)."""
    g = analytic.mlp_value(linears, x, activation)
    m, idx = torch.max(g, dim=-2, keepdim=True)
    return m, idx.to(torch.int32)


def pointnet_global_at(linears: Sequence, x: torch.Tensor, activation: str,
                       argmax: torch.Tensor) -> torch.Tensor:
    """The plain MLP's value at given rows (B, 1, F): with the kernel's
    argmax, the max the kernel returns, and autograd through it is the plain
    version of the backward on the same winners."""
    g = analytic.mlp_value(linears, x, activation)
    return torch.gather(g, -2, argmax.long())


def _library() -> ctypes.CDLL:
    lib = build.library("pointnet_global")
    if lib.pointnet_global_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pointnet_global_forward.argtypes = [p, i, i, i, p, p, p, i, p, p, p, p, p, p]
        lib.pointnet_global_forward.restype = i
        lib.pointnet_global_tile_rows.argtypes = []
        lib.pointnet_global_tile_rows.restype = i
        lib.pointnet_global_backward_workspace.argtypes = [i, i, i, p]
        lib.pointnet_global_backward_workspace.restype = ll
        lib.pointnet_global_backward.argtypes = [p, i, i, i, p, p, p, p, i, p, p, p, p, p,
                                                 p, p, p, p, p, ll, p]
        lib.pointnet_global_backward.restype = i
    return lib


def _check_inputs(weights, biases, x, activation):
    if activation not in ACT_CODES:
        raise ValueError(f"pointnet_global: unsupported activation {activation!r}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("pointnet_global: x must be a contiguous (B, N, L) "
                         f"float32 tensor, got {tuple(x.shape)} {x.dtype}")
    width = x.shape[-1]
    for i, (w, b) in enumerate(zip(weights, biases)):
        for t in (w, b):
            if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"pointnet_global: layer {i} parameters must be "
                                 f"contiguous float32 on {x.device}")
        if w.shape[1] != width or b.shape != (w.shape[0],):
            raise ValueError(f"pointnet_global: layer {i} has weight "
                             f"{tuple(w.shape)}, expected (*, {width})")
        width = w.shape[0]


def _widths(x, weights):
    return [x.shape[-1]] + [w.shape[0] for w in weights]


def _forward(weights, biases, x, activation, stash: bool):
    """One kernel launch; with ``stash`` also the hidden layers'
    pre-activations for the backward. Returns (max, argmax, stash, ws_t)."""
    lib = _library()
    n_cases, n_pts, _ = x.shape
    # the kernel reads weights as (in, out): nn.Linear's weight transposed
    ws_t = [w.detach().t().contiguous() for w in weights]
    widths = _widths(x, weights)
    f = widths[-1]
    tile_rows = lib.pointnet_global_tile_rows()
    n_tiles = -(-n_pts // tile_rows)
    dev = x.device
    part_max = torch.empty((n_cases, n_tiles, f), dtype=torch.float32, device=dev)
    part_arg = torch.empty((n_cases, n_tiles, f), dtype=torch.int32, device=dev)
    out_max = torch.empty((n_cases, 1, f), dtype=torch.float32, device=dev)
    out_arg = torch.empty((n_cases, 1, f), dtype=torch.int32, device=dev)
    z = None
    if stash and len(weights) > 1:
        z = torch.empty(n_cases * n_pts * sum(widths[1:-1]), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pointnet_global_forward(
            x.data_ptr(), n_cases, n_pts, len(ws_t), build.pointer_array(ws_t),
            build.pointer_array(biases), build.int_array(widths), ACT_CODES[activation],
            part_max.data_ptr(), part_arg.data_ptr(), out_max.data_ptr(),
            out_arg.data_ptr(), None if z is None else z.data_ptr(), stream)
    build.check_launch("pointnet_global", code)
    pointnet_global.launches += 1
    return out_max, out_arg, z, ws_t


def pointnet_global_backward(weights, ws_t, biases, x, activation, stash_z, argmax, dm):
    """The backward kernel: (dx (B, N, L0), dW (in, out) per layer, db per
    layer) of ``sum(dm * max)``; ``stash_z`` is the training forward's."""
    lib = _library()
    n_cases, n_pts, _ = x.shape
    widths = _widths(x, weights)
    nl = len(weights)
    dev = x.device
    rows = n_cases * n_pts
    dx = torch.empty_like(x)
    da = torch.empty((rows, widths[-2]), dtype=torch.float32, device=dev) if nl > 1 else None
    gz_last = torch.empty((n_cases, widths[-1]), dtype=torch.float32, device=dev)
    gz_stash = torch.empty_like(stash_z) if nl > 1 else None
    dws = [torch.zeros((widths[i], widths[i + 1]), dtype=torch.float32, device=dev)
           for i in range(nl)]
    dbs = [torch.zeros((widths[i + 1],), dtype=torch.float32, device=dev) for i in range(nl)]
    w_arr = build.int_array(widths)
    n_scratch = lib.pointnet_global_backward_workspace(n_cases, n_pts, nl, w_arr)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pointnet_global_backward(
            x.data_ptr(), n_cases, n_pts, nl, build.pointer_array(ws_t),
            build.pointer_array(weights), build.pointer_array(biases), w_arr,
            ACT_CODES[activation], ptr(stash_z), argmax.data_ptr(), dm.data_ptr(), ptr(da),
            gz_last.data_ptr(), ptr(gz_stash), dx.data_ptr(), build.pointer_array(dws),
            build.pointer_array(dbs), scratch.data_ptr(), n_scratch, stream)
    build.check_launch("pointnet_global backward", code)
    pointnet_global_backward.launches += 1
    return dx, dws, dbs


class _PointnetGlobal(torch.autograd.Function):
    """The forward kernel with its stash, and the backward kernel."""

    @staticmethod
    def forward(ctx, activation, x, *params):
        nl = len(params) // 2
        weights, biases = params[:nl], params[nl:]
        m, arg, z, ws_t = _forward(weights, biases, x, activation, stash=True)
        ctx.activation = activation
        ctx.n_layers = nl
        ctx.save_for_backward(x, arg, z, *weights, *ws_t, *biases)
        ctx.mark_non_differentiable(arg)
        return m, arg

    @staticmethod
    def backward(ctx, dm, _darg):
        nl = ctx.n_layers
        x, arg, z, *rest = ctx.saved_tensors
        weights, ws_t, biases = rest[:nl], rest[nl:2 * nl], rest[2 * nl:]
        dx, dws, dbs = pointnet_global_backward(
            [w.detach() for w in weights], ws_t, [b.detach() for b in biases], x.detach(),
            ctx.activation, z, arg, dm.contiguous())
        return (None, dx, *[dw.t() for dw in dws], *dbs)


def pointnet_global(linears: Sequence, x: torch.Tensor, activation: str):
    """Fused ``max over points of MLP(x)``: x (B, N, L0) -> (max (B, 1, F)
    float32, argmax (B, 1, F) int32). Differentiable in x and the layers'
    parameters; the argmax is not."""
    if x.device.type == "cpu":
        return pointnet_global_plain(linears, x, activation)
    if x.device.type != "cuda":
        raise ValueError(f"pointnet_global: no kernel for device {x.device}")
    weights = [lin.weight for lin in linears]
    biases = [lin.bias for lin in linears]
    _check_inputs(weights, biases, x, activation)
    params = weights + biases
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, *params]):
        return _PointnetGlobal.apply(activation, x, *params)
    return _forward(weights, biases, x, activation, stash=False)[:2]


pointnet_global.launches = 0
pointnet_global_backward.launches = 0
