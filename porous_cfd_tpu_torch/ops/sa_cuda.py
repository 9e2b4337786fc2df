"""``sa_neighborhood``: one SetAbstraction radius level, the masked max over
each centroid's neighbours of an MLP on ``[x_j || (pos_j - pos_c) / r]``
(counterpart of ``porous_cfd_tpu/ops/sa_pallas.py``), forward and backward,
and ``sa_seq_fused``, the SetAbstraction chain through it.

``sa_neighborhood`` launches the hand-written CUDA kernel
(``csrc/sa_neighborhood.cu``) for CUDA tensors and takes the plain PyTorch
version, ``sa_neighborhood_plain``, for CPU tensors. There is no other
fallback: a CUDA tensor either runs the kernel or raises. Two variants, as
on the TPU:

  * static (``xg`` given): level 0 of a boundary-cloud branch, whose input
    rows are data; they come gathered per neighbourhood once per dataset
    (``models/neighbors.sa_chain_precompute``) and the first layer runs on
    ``[xg || rel]`` directly; gradients go to the layers' parameters only.
  * dynamic: the first layer's feature block runs densely over the source
    points, ``P = x W0x + b0`` (a plain matmul, differentiated by autograd),
    and the kernel gathers P's rows by neighbour index; its backward
    returns dP, so the gradient reaches x.

When a gradient is wanted the kernel runs inside a
``torch.autograd.Function`` whose backward is the backward kernel
(``sa_neighborhood_backward``): the pooled cotangent goes to the first
maximal valid neighbour of each (centroid, channel); empty neighbourhoods
give 0 and no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from porous_cfd_tpu_torch.models.neighbors import masked_max
from porous_cfd_tpu_torch.ops import build, pointnet_cuda
from porous_cfd_tpu_torch.physics import analytic

ACT_CODES = {"silu": 0, "tanh": 1}
MAX_NEIGHBORS = 64          # one kernel tile holds a whole neighbourhood
_BACKWARD_SIZES: dict = {}  # (device, variant, shapes) -> (blocks, gradient floats)


def sa_neighborhood_plain(linears: Sequence, x, idx, mask, rel, activation: str, xg=None):
    """The level in plain PyTorch: the first layer on each neighbour's row
    (static: ``[xg || rel]``; dynamic: ``P[idx] + rel W0r`` with ``P = x W0x +
    b0``), the remaining layers, then ``neighbors.masked_max``. Returns (B, C,
    F)."""
    b_cases, n_cent, k = idx.shape
    w0, b0 = linears[0].weight, linears[0].bias
    if xg is not None:
        h = F.linear(torch.cat([xg.reshape(b_cases, n_cent, k, -1), rel], dim=-1), w0, b0)
    else:
        f_in = x.shape[-1]
        p = F.linear(x, w0[:, :f_in], b0)
        flat = idx.reshape(b_cases, -1)
        pg = torch.gather(p, 1, flat[..., None].expand(*flat.shape, p.shape[-1]))
        h = pg.reshape(b_cases, n_cent, k, -1) + F.linear(rel, w0[:, f_in:])
    h = analytic.ACTIVATIONS[activation](h)
    h = analytic.mlp_value(linears[1:], h, activation)
    return masked_max(h, mask)


def _library() -> ctypes.CDLL:
    lib = build.library("sa_neighborhood")
    if lib.sa_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        common = [i, i, i, i, i, i, i, p, p, p, p, p, i, i, p, p, p]
        lib.sa_forward.argtypes = common + [p, p]
        lib.sa_forward.restype = i
        lib.sa_grad_floats.argtypes = [i, i, p]
        lib.sa_grad_floats.restype = i
        lib.sa_backward_blocks.argtypes = common
        lib.sa_backward_blocks.restype = i
        lib.sa_backward.argtypes = common + [p, p, p, p, i, p, p]
        lib.sa_backward.restype = i
    return lib


def _pointers(tensors) -> ctypes.Array:
    """A C array of device pointers; None gives a null pointer."""
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


class SaCall:
    """The kernel's arguments for one level: the variant, shapes, the
    layers' weights as (in, out) and what the C interface wants beside."""

    def __init__(self, activation, weights, biases, rel, mask, xg=None, p=None, idx=None):
        self.activation = activation
        self.static = xg is not None
        self.b_cases, self.n_cent, self.k, self.d = rel.shape
        self.f_in = xg.shape[-1] if self.static else 0
        self.n_src = 0 if self.static else p.shape[1]
        # layer 0: the whole [W0x; W0r] (static) or W0r (dynamic), as (in, out)
        self.ws_t = [w.detach().t().contiguous() for w in weights]
        self.biases = [None if b is None else b.detach() for b in biases]
        self.weights = [w.detach() for w in weights]
        self.widths = [self.ws_t[0].shape[0]] + [w.shape[1] for w in self.ws_t]
        self.tensors = (xg, rel, mask, p, idx)

    def args(self):
        xg, rel, mask, p, idx = self.tensors
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        return (int(self.static), ACT_CODES[self.activation], self.b_cases, self.n_cent,
                self.k, self.f_in, self.d, ptr(xg), rel.data_ptr(), mask.data_ptr(), ptr(p),
                ptr(idx), self.n_src, len(self.ws_t), _pointers(self.ws_t),
                _pointers(self.biases), build.int_array(self.widths))

    def grad_slices(self, flat):
        """(dW (in, out) per layer, db per layer or None) views of ``flat``."""
        dws, dbs, at = [], [], 0
        for i in range(len(self.ws_t)):
            n_in, n_out = self.widths[i], self.widths[i + 1]
            dws.append(flat[at:at + n_in * n_out].view(n_in, n_out))
            at += n_in * n_out
            if i == 0 and not self.static:
                dbs.append(None)
                continue
            dbs.append(flat[at:at + n_out])
            at += n_out
        return dws, dbs


def _forward(call: SaCall):
    lib = _library()
    dev = call.tensors[1].device
    out = torch.empty((call.b_cases, call.n_cent, call.widths[-1]), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        code = lib.sa_forward(*call.args(), out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("sa_neighborhood", code)
    sa_neighborhood.launches += 1
    return out


def _backward_sizes(lib, call: SaCall, dev) -> tuple:
    """(blocks, floats of one gradient partial) of the backward at
    ``call``'s shapes: the block count (as many as fit on the card at once)
    costs an occupancy query, so it is worked out once per device and
    shapes."""
    key = (dev, call.static, call.activation, call.b_cases, call.n_cent, call.k, call.d,
           call.f_in, call.n_src, tuple(call.widths))
    if key not in _BACKWARD_SIZES:
        n_blocks = lib.sa_backward_blocks(*call.args())
        if n_blocks < 1:
            raise ValueError(f"sa_neighborhood backward: widths {call.widths} do not fit the "
                             "kernel's shared memory")
        n_grad = lib.sa_grad_floats(int(call.static), len(call.ws_t),
                                    build.int_array(call.widths))
        _BACKWARD_SIZES[key] = (n_blocks, n_grad)
    return _BACKWARD_SIZES[key]


def sa_neighborhood_backward(call: SaCall, dout: torch.Tensor):
    """The backward kernel: (dW (in, out) per layer, db per layer (None for
    the dynamic variant's layer 0), dP (B, n_src, F1) or None) of
    ``sum(dout * out)``."""
    lib = _library()
    dev = dout.device
    with torch.cuda.device(dev):
        n_blocks, n_grad = _backward_sizes(lib, call, dev)
        parts = torch.zeros((n_blocks * n_grad,), dtype=torch.float32, device=dev)
        grads = torch.zeros((n_grad,), dtype=torch.float32, device=dev)
        dp = None if call.static else torch.zeros((call.b_cases, call.n_src, call.widths[1]),
                                                  dtype=torch.float32, device=dev)
        code = lib.sa_backward(*call.args(), _pointers(call.weights), dout.data_ptr(),
                               None if dp is None else dp.data_ptr(), parts.data_ptr(),
                               n_blocks, grads.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("sa_neighborhood backward", code)
    sa_neighborhood_backward.launches += 1
    dws, dbs = call.grad_slices(grads)
    return dws, dbs, dp


class _SaStatic(torch.autograd.Function):
    """Inputs: (activation, xg, rel, mask, *weights, *biases) of every
    layer; gradients to the parameters only."""

    @staticmethod
    def forward(ctx, activation, xg, rel, mask, *params):
        nl = len(params) // 2
        call = SaCall(activation, params[:nl], params[nl:], rel, mask, xg=xg)
        ctx.call = call
        return _forward(call)

    @staticmethod
    def backward(ctx, dout):
        dws, dbs, _ = sa_neighborhood_backward(ctx.call, dout.contiguous())
        return (None, None, None, None, *[dw.t() for dw in dws], *dbs)


class _SaDynamic(torch.autograd.Function):
    """Inputs: (activation, p, rel, idx, mask, w0r, *weights 1.., *biases
    1..); gradients to P, W0r and the layers from 1 on."""

    @staticmethod
    def forward(ctx, activation, p, rel, idx, mask, w0r, *rest):
        nl = len(rest) // 2 + 1
        call = SaCall(activation, [w0r, *rest[:nl - 1]], [None, *rest[nl - 1:]], rel, mask,
                     p=p, idx=idx)
        ctx.call = call
        return _forward(call)

    @staticmethod
    def backward(ctx, dout):
        dws, dbs, dp = sa_neighborhood_backward(ctx.call, dout.contiguous())
        return (None, dp, None, None, None, *[dw.t() for dw in dws], *dbs[1:])


def _check(label, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(f"sa_neighborhood: {label} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def sa_neighborhood(linears: Sequence, x, idx, mask, rel, activation: str, xg=None):
    """One SetAbstraction level through the fused kernel.

    :param linears: the level's ``conv_mlp`` layers; layer 0 takes
        ``[x_j || rel_j]`` (F_in + D inputs), every layer is activated.
    :param x: (B, N, F_in) source features (ignored when ``xg`` is given).
    :param idx: (B, C, K) int64 neighbour indices into x; mask (B, C, K) bool.
    :param rel: (B, C, K, D) normalised relative positions (precomputed).
    :param xg: optional (B, C*K, F_in) input rows gathered per neighbourhood
        (data: no gradient), the static variant.
    :return: (B, C, F_last).
    """
    if rel.device.type == "cpu":
        return sa_neighborhood_plain(linears, x, idx, mask, rel, activation, xg)
    if rel.device.type != "cuda":
        raise ValueError(f"sa_neighborhood: no kernel for device {rel.device}")
    if activation not in ACT_CODES:
        raise ValueError(f"sa_neighborhood: unsupported activation {activation!r}")
    dev = rel.device
    b_cases, n_cent, k, d = rel.shape
    if not 1 <= k <= MAX_NEIGHBORS:
        raise ValueError(f"sa_neighborhood: {k} neighbours, the kernel takes 1 to "
                         f"{MAX_NEIGHBORS}")
    _check("rel", rel, (b_cases, n_cent, k, d), torch.float32, dev)
    _check("mask", mask, (b_cases, n_cent, k), torch.bool, dev)
    w0, b0 = linears[0].weight, linears[0].bias
    width = w0.shape[0]
    for i, lin in enumerate(linears[1:], start=1):
        _check(f"linear_{i}.weight", lin.weight, (lin.weight.shape[0], width), torch.float32,
               dev)
        width = lin.weight.shape[0]
    weights = [lin.weight for lin in linears[1:]]
    biases = [lin.bias for lin in linears[1:]]
    grad = torch.is_grad_enabled()
    if xg is not None:
        f_in = w0.shape[1] - d
        _check("xg", xg, (b_cases, n_cent * k, f_in), torch.float32, dev)
        params = [w0, *weights, b0, *biases]
        if grad and any(t.requires_grad for t in params):
            return _SaStatic.apply(activation, xg.detach(), rel, mask, *params)
        return _forward(SaCall(activation, [w0, *weights], [b0, *biases], rel, mask, xg=xg))
    f_in = x.shape[-1]
    if w0.shape[1] != f_in + d:
        raise ValueError(f"sa_neighborhood: linear_0 takes {w0.shape[1]} inputs, not "
                         f"{f_in} + {d}")
    _check("idx", idx, (b_cases, n_cent, k), torch.int64, dev)
    # the dense first-layer feature projection: no K factor, no gather
    p = F.linear(x, w0[:, :f_in], b0).contiguous()
    w0r = w0[:, f_in:]
    if grad and any(t.requires_grad for t in [p, w0r, *weights, *biases]):
        return _SaDynamic.apply(activation, p, rel, idx, mask, w0r, *weights, *biases)
    return _forward(SaCall(activation, [w0r, *weights], [None, *biases], rel, mask, p=p,
                          idx=idx))


def sa_seq_fused(seq, activation: str, x, neighbors):
    """``SetAbstractionSeq`` (``models/set_abstraction.py``) on a precomputed
    chain: each radius level through ``sa_neighborhood`` (level 0 static
    when its entry holds xg), and a trailing GlobalSetAbstraction through
    ``pointnet_cuda.pointnet_global`` on ``[x || pos]``.

    :param neighbors: per level (cent, idx, mask, rel, posc[, xg]), as
        ``neighbors.extract_sa_neighbors`` gives them.
    :return: (B, C_last, F) features; (B, 1, F) after a global level.
    """
    for i in range(len(seq.radius)):
        _, idx, mask, rel, posc = neighbors[i][:5]
        xg = neighbors[i][5] if i == 0 and len(neighbors[i]) > 5 else None
        x = sa_neighborhood(getattr(seq, f"sa_{i}").conv_mlp.linears, x, idx, mask, rel,
                            activation, xg)
        pos = posc
    if seq.has_global:
        x = pointnet_cuda.pointnet_global(seq.global_sa.mlp.linears,
                                          torch.cat([x, pos], dim=-1).contiguous(),
                                          activation)[0]
    return x


sa_neighborhood.launches = 0
sa_neighborhood_backward.launches = 0
