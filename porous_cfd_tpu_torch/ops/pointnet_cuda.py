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
returned non-differentiable. The forward keeps nothing for the backward but
its argmax: the backward recomputes the chain at the winner rows only, in
the compaction ``pointnet_winner_rows`` computes plainly.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from porous_cfd_tpu_torch.ops import build
from porous_cfd_tpu_torch.physics import analytic

ACT_CODES = {"silu": 0, "tanh": 1}
# scratch floats of each launch shape, asked of the library once
_WORKSPACE: dict = {}


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


def pointnet_winner_rows(argmax: torch.Tensor):
    """The backward's compaction of a forward's argmax ((B, 1, F) or (B,
    F)), plainly: (rows (B, F) int64, each case's distinct winner rows in
    ascending order, then -1; slot (B, F) int64, each channel's index into
    its case's rows; count (B,) int64). A channel's winner is
    ``rows[b, slot[b, c]]``."""
    arg = argmax.reshape(argmax.shape[0], -1).long()
    n_cases, f = arg.shape
    srt, order = torch.sort(arg, dim=1, stable=True)
    starts = torch.ones_like(srt, dtype=torch.bool)
    starts[:, 1:] = srt[:, 1:] != srt[:, :-1]
    slot_sorted = torch.cumsum(starts.long(), dim=1) - 1
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    count = starts.sum(dim=1)
    # each slot's first sorted position writes its row; the others write -1
    # into a spare column
    rows = torch.full((n_cases, f + 1), -1, dtype=torch.long, device=arg.device)
    rows.scatter_(1, torch.where(starts, slot_sorted, f), torch.where(starts, srt, -1))
    rows = rows[:, :f]
    return rows, slot, count


def _library() -> ctypes.CDLL:
    lib = build.library("pointnet_global")
    if lib.pointnet_global_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pointnet_global_forward_workspace.argtypes = [i, i, i, p]
        lib.pointnet_global_forward_workspace.restype = ll
        lib.pointnet_global_blocks.argtypes = [i, p, p]
        lib.pointnet_global_blocks.restype = i
        lib.pointnet_global_forward.argtypes = [p, i, i, i, p, p, p, i, p, ll, p, p, p]
        lib.pointnet_global_forward.restype = i
        lib.pointnet_global_backward_workspace.argtypes = [i, i, i, p, i]
        lib.pointnet_global_backward_workspace.restype = ll
        lib.pointnet_global_backward.argtypes = [p, i, i, i, p, p, p, i, p, p, p, p, p, ll, p,
                                                 p]
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


def blocks(widths):
    """The kernels' blocks at these widths: (the forward's columns a
    warpgroup: 128 when each of its two warpgroups owns 64 rows, 64 when
    both take the same rows; its points a block; its shared bytes; the
    backward tiles' shared bytes)."""
    out = (ctypes.c_int * 4)()
    build.check_launch("pointnet_global blocks", _library().pointnet_global_blocks(
        len(widths) - 1, build.int_array(widths), out))
    return tuple(out)


def _forward(weights, biases, x, activation):
    """The forward kernel (weights transposed and split, the tiles, the fold
    of their partials): (max, argmax)."""
    lib = _library()
    n_cases, n_pts, _ = x.shape
    widths = _widths(x, weights)
    w_arr = build.int_array(widths)
    f = widths[-1]
    dev = x.device
    key = ("fwd", n_cases, n_pts, tuple(widths))
    n_scratch = _WORKSPACE.get(key)
    if n_scratch is None:
        n_scratch = _WORKSPACE[key] = lib.pointnet_global_forward_workspace(
            n_cases, n_pts, len(weights), w_arr)
    if n_scratch < 0:
        raise ValueError(f"pointnet_global: no kernel block fits widths {widths}")
    buf = torch.empty((n_scratch + n_cases * f,), dtype=torch.float32, device=dev)
    out_max = buf[n_scratch:].view(n_cases, 1, f)
    out_arg = torch.empty((n_cases, 1, f), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pointnet_global_forward(
            x.data_ptr(), n_cases, n_pts, len(weights), build.pointer_array(weights),
            build.pointer_array(biases), w_arr, ACT_CODES[activation], buf.data_ptr(),
            n_scratch, out_max.data_ptr(), out_arg.data_ptr(), stream)
    build.check_launch("pointnet_global", code)
    pointnet_global.launches += 1
    return out_max, out_arg


def pointnet_global_backward(weights, biases, x, activation, argmax, dm, need_dx=True,
                             winners=False):
    """The backward kernel on the forward's winners: (dx (B, N, L0) or None,
    dW per layer in nn.Linear's (out, in) layout, db per layer) of
    ``sum(dm * max)``; with ``winners`` also the kernel's compaction as
    ``pointnet_winner_rows`` gives it (rows (B, min(N, F)) int32, slot (B, F)
    int32, count (B,) int32)."""
    lib = _library()
    n_cases, n_pts, _ = x.shape
    widths = _widths(x, weights)
    nl = len(weights)
    dev = x.device
    f = widths[-1]
    w_arr = build.int_array(widths)
    key = ("bwd", n_cases, n_pts, tuple(widths), need_dx)
    n_scratch = _WORKSPACE.get(key)
    if n_scratch is None:
        n_scratch = _WORKSPACE[key] = lib.pointnet_global_backward_workspace(
            n_cases, n_pts, nl, w_arr, int(need_dx))
    # one allocation: dx, then each layer's (in + 1, out) dW with db as its
    # last row, then the scratch
    n_dx = x.numel() if need_dx else 0
    offs, off = [], -(-n_dx // 32) * 32
    for i in range(nl):
        offs.append(off)
        off += -(-(widths[i] + 1) * widths[i + 1] // 32) * 32
    buf = torch.empty((off + n_scratch,), dtype=torch.float32, device=dev)
    dx = buf[:n_dx].view(x.shape) if need_dx else None
    base = buf.data_ptr()
    rcap = min(n_pts, f)
    comp = None
    if winners:
        comp = [torch.empty(s, dtype=torch.int32, device=dev)
                for s in ((n_cases, rcap), (n_cases, f), (n_cases,))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pointnet_global_backward(
            x.data_ptr(), n_cases, n_pts, nl, build.pointer_array(weights),
            build.pointer_array(biases), w_arr, ACT_CODES[activation], argmax.data_ptr(),
            dm.data_ptr(), None if dx is None else base, (ctypes.c_void_p * nl)(
                *[base + 4 * o for o in offs]), base + 4 * off, n_scratch,
            None if comp is None else build.pointer_array(comp), stream)
    build.check_launch("pointnet_global backward", code)
    pointnet_global_backward.launches += 1
    dws = [buf.as_strided((widths[i + 1], widths[i]), (1, widths[i + 1]), o)
           for i, o in enumerate(offs)]
    dbs = [buf.as_strided((widths[i + 1],), (1,), o + widths[i] * widths[i + 1])
           for i, o in enumerate(offs)]
    if not winners:
        return dx, dws, dbs
    rows, crow, count = comp
    slot = crow - (torch.arange(n_cases, device=dev, dtype=torch.int32) * rcap)[:, None]
    return dx, dws, dbs, (rows, slot, count)


class _PointnetGlobal(torch.autograd.Function):
    """The forward kernel, and the backward kernel on its winners: it saves
    x, the argmax and the parameters, no activation."""

    @staticmethod
    def forward(ctx, activation, x, *params):
        nl = len(params) // 2
        weights, biases = params[:nl], params[nl:]
        m, arg = _forward(weights, biases, x, activation)
        ctx.activation = activation
        ctx.n_layers = nl
        ctx.save_for_backward(x, arg, *weights, *biases)
        ctx.mark_non_differentiable(arg)
        return m, arg

    @staticmethod
    def backward(ctx, dm, _darg):
        nl = ctx.n_layers
        x, arg, *rest = ctx.saved_tensors
        weights, biases = rest[:nl], rest[nl:]
        dx, dws, dbs = pointnet_global_backward(
            [w.detach() for w in weights], [b.detach() for b in biases], x.detach(),
            ctx.activation, arg, dm.contiguous(), need_dx=ctx.needs_input_grad[1])
        return (None, dx, *dws, *dbs)


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
    return _forward(weights, biases, x, activation)


pointnet_global.launches = 0
pointnet_global_backward.launches = 0
