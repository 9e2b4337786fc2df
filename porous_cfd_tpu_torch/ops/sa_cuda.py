"""``sa_neighborhood``: one SetAbstraction radius level, the masked max over
each centroid's neighbours of an MLP on ``[x_j || (pos_j - pos_c) / r]``
(counterpart of ``porous_cfd_tpu/ops/sa_pallas.py``), forward and backward,
``sa_seq_fused``, the SetAbstraction chain through it, and
``sa_mrg_fused``, PIPN++ MRG's encoder through it.

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

The forward returns the max and its argmax, the first maximal valid
neighbour of each (centroid, channel) (-1 for an empty neighbourhood). When
a gradient is wanted the kernel runs inside a ``torch.autograd.Function``
that keeps that argmax and nothing else of the forward; its backward
(``sa_neighborhood_backward``) recomputes the level at the winner rows only,
in the order ``sa_winner_rows`` gives plainly: the pooled cotangent goes to
the argmax; empty neighbourhoods give 0 and no gradient.
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
MAX_NEIGHBORS = 64          # a centroid's winners are one 64-bit mask
_WORKSPACE: dict = {}       # (direction, variant, shapes) -> scratch floats


def _plain_rows(linears: Sequence, x, idx, mask, rel, activation: str, xg=None):
    """The MLP on every neighbour row: the first layer (static: ``[xg ||
    rel]``; dynamic: ``P[idx] + rel W0r`` with ``P = x W0x + b0``), then the
    remaining layers. Returns (B, C, K, F)."""
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
    return analytic.mlp_value(linears[1:], h, activation)


def _first_max(h, mask):
    """(B, C, F) int8: the first maximal valid neighbour of each (centroid,
    channel) of h (B, C, K, F), -1 for an empty neighbourhood."""
    filled = h.detach().masked_fill(~mask[..., None], torch.finfo(h.dtype).min)
    arg = torch.max(filled, dim=-2).indices
    return arg.masked_fill(~mask.any(dim=-1)[..., None], -1).to(torch.int8)


def sa_neighborhood_plain(linears: Sequence, x, idx, mask, rel, activation: str, xg=None,
                          with_argmax: bool = False):
    """The level in plain PyTorch: ``_plain_rows`` then
    ``neighbors.masked_max``. Returns (B, C, F), and with ``with_argmax``
    also the argmax as the kernel gives it."""
    h = _plain_rows(linears, x, idx, mask, rel, activation, xg)
    out = masked_max(h, mask)
    return (out, _first_max(h, mask)) if with_argmax else out


def sa_neighborhood_at(linears: Sequence, x, idx, mask, rel, activation: str, argmax,
                       xg=None):
    """The plain level's values at given neighbours (B, C, F), 0 where the
    argmax is -1: with the kernel's argmax, the max the kernel returns, and
    autograd through it is the plain backward on the same winners (a
    near-tie may make the kernel's argmax another row than torch.max's)."""
    h = _plain_rows(linears, x, idx, mask, rel, activation, xg)
    arg = argmax.long()
    g = torch.gather(h, 2, arg.clamp(min=0)[:, :, None, :]).squeeze(2)
    return g.masked_fill(arg < 0, 0.0)


def sa_winner_rows(argmax, mask):
    """The backward's compaction of a forward's argmax (B, C, F), plainly:
    (rows (B, C * min(K, F)) int64, each case's distinct winner rows c * K +
    k in ascending order, then -1; slot (B, C, F) int64, each channel's index
    into its case's rows, -1 for an empty neighbourhood; count (B,) int64).
    A channel's winner is ``rows[b, slot[b, c, ch]]``."""
    b_cases, n_cent, f = argmax.shape
    k = mask.shape[-1]
    dev = argmax.device
    arg = argmax.long()
    valid = (arg >= 0) & mask.any(dim=-1)[..., None]
    # each centroid's winning k; the invalid channels mark a spare column
    hit = torch.zeros((b_cases, n_cent, k + 1), dtype=torch.bool, device=dev)
    hit.scatter_(2, torch.where(valid, arg, k), True)
    hit = hit[..., :k].reshape(b_cases, n_cent * k)
    count = hit.sum(dim=1)
    pos = torch.cumsum(hit.long(), dim=1) - 1
    rcap = n_cent * min(k, f)
    rows = torch.full((b_cases, rcap + 1), -1, dtype=torch.long, device=dev)
    flat = torch.arange(n_cent * k, device=dev).expand(b_cases, -1)
    rows.scatter_(1, torch.where(hit, pos, rcap), torch.where(hit, flat, -1))
    slot = torch.gather(pos.reshape(b_cases, n_cent, k), 2, arg.clamp(min=0))
    return rows[:, :rcap], torch.where(valid, slot, -1), count


def _library() -> ctypes.CDLL:
    lib = build.library("sa_neighborhood")
    if lib.sa_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        common = [i, i, i, i, i, i, i, p, p, p, p, p, i, i, p, p, p]
        lib.sa_forward_workspace.argtypes = common
        lib.sa_forward_workspace.restype = ll
        lib.sa_forward.argtypes = common + [p, ll, p, p, p]
        lib.sa_forward.restype = i
        lib.sa_backward_workspace.argtypes = common
        lib.sa_backward_workspace.restype = ll
        lib.sa_backward.argtypes = common + [p, p, p, ll, p, p, p, p]
        lib.sa_backward.restype = i
        lib.sa_blocks.argtypes = common + [p]
        lib.sa_blocks.restype = i
    return lib


def _pointers(tensors) -> ctypes.Array:
    """A C array of device pointers; None gives a null pointer."""
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


class SaCall:
    """The kernel's arguments for one level: the variant, shapes, the
    layers' nn.Linear weights (the dynamic layer 0: its W0r block, a view
    into the whole weight) and what the C interface wants beside."""

    def __init__(self, activation, weights, biases, rel, mask, xg=None, p=None, idx=None,
                 f_in=0):
        self.activation = activation
        self.static = xg is not None
        self.b_cases, self.n_cent, self.k, self.d = rel.shape
        self.f_in = xg.shape[-1] if self.static else f_in
        self.n_src = 0 if self.static else p.shape[1]
        self.weights = [w.detach() for w in weights]
        self.biases = [None if b is None else b.detach() for b in biases]
        self.widths = [self.weights[0].shape[1]] + [w.shape[0] for w in self.weights]
        self.tensors = (xg, rel, mask, p, idx)

    def args(self):
        xg, rel, mask, p, idx = self.tensors
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        return (int(self.static), ACT_CODES[self.activation], self.b_cases, self.n_cent,
                self.k, self.f_in, self.d, ptr(xg), rel.data_ptr(), mask.data_ptr(), ptr(p),
                ptr(idx), self.n_src, len(self.weights), _pointers(self.weights),
                _pointers(self.biases), build.int_array(self.widths))

    def key(self):
        return (self.static, self.activation, self.b_cases, self.n_cent, self.k, self.d,
                self.f_in, self.n_src, tuple(self.widths))

    def workspace(self, lib, direction: str) -> int:
        """Scratch floats of the forward or backward at these shapes, asked
        of the library once."""
        key = (direction, *self.key())
        if key not in _WORKSPACE:
            query = lib.sa_forward_workspace if direction == "fwd" else lib.sa_backward_workspace
            _WORKSPACE[key] = query(*self.args())
        if _WORKSPACE[key] < 0:
            raise ValueError(f"sa_neighborhood: no kernel block fits widths {self.widths} "
                             f"at {self.n_cent} centroids of {self.k} neighbours")
        return _WORKSPACE[key]


def level_call(linears: Sequence, x, idx, mask, rel, activation: str, xg=None) -> SaCall:
    """The kernel's arguments for one level as ``sa_neighborhood`` builds
    them (the dynamic variant's P computed here), for calling ``_forward``
    (the max and its argmax), ``sa_neighborhood_backward`` or ``blocks``
    directly."""
    lin = list(linears)
    if xg is not None:
        return SaCall(activation, [t.weight for t in lin], [t.bias for t in lin], rel, mask,
                      xg=xg)
    f_in = x.shape[-1]
    p = F.linear(x, lin[0].weight[:, :f_in], lin[0].bias).contiguous()
    return SaCall(activation, [lin[0].weight[:, f_in:]] + [t.weight for t in lin[1:]],
                  [None] + [t.bias for t in lin[1:]], rel, mask, p=p, idx=idx, f_in=f_in)


def blocks(call: SaCall) -> dict:
    """The kernels' blocks at ``call``'s shapes: the forward's chunk width,
    its weight tiles in shared memory (all of a step's when resident), a
    step's tiles, shared bytes and blocks an SM; the backward tiles' shared
    bytes and blocks an SM; the compaction's shared bytes."""
    out = (ctypes.c_int * 8)()
    build.check_launch("sa_neighborhood blocks", _library().sa_blocks(*call.args(), out))
    keys = ("fwd_chunk", "fwd_slots", "fwd_tiles_a_step", "fwd_smem", "fwd_blocks_per_sm",
            "bwd_smem", "bwd_blocks_per_sm", "prep_smem")
    return dict(zip(keys, out))


def _forward(call: SaCall):
    """The forward kernel (the weights split, the tiles): (max, argmax)."""
    lib = _library()
    dev = call.tensors[1].device
    shape = (call.b_cases, call.n_cent, call.widths[-1])
    n_out = shape[0] * shape[1] * shape[2]
    with torch.cuda.device(dev):
        n_split = call.workspace(lib, "fwd")
        # one allocation: the split weights, the max, the argmax's bytes
        buf = torch.empty((n_split + n_out + -(-n_out // 4),), dtype=torch.float32, device=dev)
        out = buf[n_split:n_split + n_out].view(shape)
        arg = buf[n_split + n_out:].view(torch.int8)[:n_out].view(shape)
        code = lib.sa_forward(*call.args(), buf.data_ptr(), n_split, out.data_ptr(),
                              arg.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("sa_neighborhood", code)
    sa_neighborhood.launches += 1
    return out, arg


def sa_neighborhood_backward(call: SaCall, argmax: torch.Tensor, dout: torch.Tensor,
                             winners: bool = False):
    """The backward kernel on the forward's argmax: (dW (in, out) per layer,
    db per layer (None for the dynamic variant's layer 0), dP (B, n_src, F1)
    or None) of ``sum(dout * out)``; with ``winners`` also the kernel's
    compaction as ``sa_winner_rows`` gives it (rows, slot, count as int32)."""
    lib = _library()
    dev = dout.device
    widths = call.widths
    nl = len(widths) - 1
    with torch.cuda.device(dev):
        n_scratch = call.workspace(lib, "bwd")
        # one allocation: each layer's (in + 1, out) dW with db as its last
        # row, dP, then the scratch
        offs, off = [], 0
        for i in range(nl):
            offs.append(off)
            off += -(-(widths[i] + 1) * widths[i + 1] // 32) * 32
        n_dp = 0 if call.static else call.b_cases * call.n_src * widths[1]
        dp_off = off
        off += -(-n_dp // 32) * 32
        buf = torch.empty((off + n_scratch,), dtype=torch.float32, device=dev)
        base = buf.data_ptr()
        comp = None
        if winners:
            rcap = call.n_cent * min(call.k, widths[-1])
            comp = [torch.empty(s, dtype=torch.int32, device=dev)
                    for s in ((call.b_cases, rcap), (call.b_cases, call.n_cent, widths[-1]),
                              (call.b_cases,))]
        code = lib.sa_backward(*call.args(), argmax.data_ptr(), dout.data_ptr(),
                               base + 4 * off, n_scratch,
                               (ctypes.c_void_p * nl)(*[base + 4 * o for o in offs]),
                               None if call.static else base + 4 * dp_off,
                               None if comp is None else build.pointer_array(comp),
                               torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("sa_neighborhood backward", code)
    sa_neighborhood_backward.launches += 1
    dws, dbs = [], []
    for i, o in enumerate(offs):
        n_w = widths[i] * widths[i + 1]
        dws.append(buf[o:o + n_w].view(widths[i], widths[i + 1]))
        dbs.append(None if i == 0 and not call.static else buf[o + n_w:o + n_w + widths[i + 1]])
    dp = None if call.static else buf[dp_off:dp_off + n_dp].view(call.b_cases, call.n_src,
                                                                  widths[1])
    if not winners:
        return dws, dbs, dp
    return dws, dbs, dp, tuple(comp)


class _SaStatic(torch.autograd.Function):
    """Inputs: (activation, xg, rel, mask, *weights, *biases) of every
    layer; gradients to the parameters only. Keeps the argmax, no
    activation."""

    @staticmethod
    def forward(ctx, activation, xg, rel, mask, *params):
        nl = len(params) // 2
        call = SaCall(activation, params[:nl], params[nl:], rel, mask, xg=xg)
        out, arg = _forward(call)
        ctx.call = call
        ctx.save_for_backward(arg)
        ctx.mark_non_differentiable(arg)
        return out, arg

    @staticmethod
    def backward(ctx, dout, _darg):
        (arg,) = ctx.saved_tensors
        dws, dbs, _ = sa_neighborhood_backward(ctx.call, arg, dout.contiguous())
        return (None, None, None, None, *[dw.t() for dw in dws], *dbs)


class _SaDynamic(torch.autograd.Function):
    """Inputs: (activation, f_in, p, rel, idx, mask, w0r, *weights 1..,
    *biases 1..); gradients to P, W0r and the layers from 1 on. Keeps the
    argmax, no activation."""

    @staticmethod
    def forward(ctx, activation, f_in, p, rel, idx, mask, w0r, *rest):
        nl = len(rest) // 2 + 1
        call = SaCall(activation, [w0r, *rest[:nl - 1]], [None, *rest[nl - 1:]], rel, mask,
                      p=p, idx=idx, f_in=f_in)
        out, arg = _forward(call)
        ctx.call = call
        ctx.save_for_backward(arg)
        ctx.mark_non_differentiable(arg)
        return out, arg

    @staticmethod
    def backward(ctx, dout, _darg):
        (arg,) = ctx.saved_tensors
        dws, dbs, dp = sa_neighborhood_backward(ctx.call, arg, dout.contiguous())
        return (None, None, dp, None, None, None, *[dw.t() for dw in dws], *dbs[1:])


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
    _check("linear_0.weight", w0, w0.shape, torch.float32, dev)
    width = w0.shape[0]
    for i, lin in enumerate(linears[1:], start=1):
        _check(f"linear_{i}.weight", lin.weight, (lin.weight.shape[0], width), torch.float32,
               dev)
        width = lin.weight.shape[0]
    for i, lin in enumerate(linears):
        _check(f"linear_{i}.bias", lin.bias, (lin.weight.shape[0],), torch.float32, dev)
    weights = [lin.weight for lin in linears[1:]]
    biases = [lin.bias for lin in linears[1:]]
    grad = torch.is_grad_enabled()
    if xg is not None:
        f_in = w0.shape[1] - d
        _check("xg", xg, (b_cases, n_cent * k, f_in), torch.float32, dev)
        params = [w0, *weights, b0, *biases]
        if grad and any(t.requires_grad for t in params):
            return _SaStatic.apply(activation, xg.detach(), rel, mask, *params)[0]
        return _forward(SaCall(activation, [w0, *weights], [b0, *biases], rel, mask, xg=xg))[0]
    f_in = x.shape[-1]
    if w0.shape[1] != f_in + d:
        raise ValueError(f"sa_neighborhood: linear_0 takes {w0.shape[1]} inputs, not "
                         f"{f_in} + {d}")
    _check("idx", idx, (b_cases, n_cent, k), torch.int64, dev)
    # the dense first-layer feature projection: no K factor, no gather
    p = F.linear(x, w0[:, :f_in], b0).contiguous()
    w0r = w0[:, f_in:]  # the kernel reads it in place, rows f_in + d apart
    if grad and any(t.requires_grad for t in [p, w0r, *weights, *biases]):
        return _SaDynamic.apply(activation, f_in, p, rel, idx, mask, w0r, *weights, *biases)[0]
    return _forward(SaCall(activation, [w0r, *weights], [None, *biases], rel, mask, p=p,
                           idx=idx, f_in=f_in))[0]


def sa_seq_fused(seq, activation: str, x, neighbors, pos=None, return_skip: bool = False):
    """``SetAbstractionSeq`` (``models/set_abstraction.py``) on a precomputed
    chain: each radius level through ``sa_neighborhood`` (level 0 static
    when its entry holds xg), and a trailing GlobalSetAbstraction through
    ``pointnet_cuda.pointnet_global`` on ``[x || pos]``.

    :param neighbors: per level (cent, idx, mask, rel, posc[, xg]), as
        ``neighbors.extract_sa_neighbors`` gives them.
    :param pos: (B, N, D) the input's positions, needed with
        ``return_skip``.
    :return: (B, C_last, F) features; (B, 1, F) after a global level. With
        ``return_skip``, as the module gives them: ((x, pos), skips), each
        level's input (x, pos), the U-Net decoder's skip connections.
    """
    skips = [(x, pos)]
    for i in range(len(seq.radius)):
        _, idx, mask, rel, posc = neighbors[i][:5]
        xg = neighbors[i][5] if i == 0 and len(neighbors[i]) > 5 else None
        x = sa_neighborhood(getattr(seq, f"sa_{i}").conv_mlp.linears, x, idx, mask, rel,
                            activation, xg)
        pos = posc
        skips.append((x, pos))
    if seq.has_global:
        x = pointnet_cuda.pointnet_global(seq.global_sa.mlp.linears,
                                          torch.cat([x, pos], dim=-1).contiguous(),
                                          activation)[0]
        pos = pos.new_zeros((pos.shape[0], 1, pos.shape[-1]))
        skips.append((x, pos))
    return ((x, pos), skips[:-1]) if return_skip else x


def sa_mrg_fused(mrg, activation: str, x, pos, neighbors):
    """``SetAbstractionMrgSeq`` (``models/set_abstraction.py``) on a
    precomputed 2-level chain: branch 1's two levels and branch 2's through
    ``sa_neighborhood`` (level 0 static when its entry holds xg, and shared
    by both branches), branches 3 and 4 through
    ``pointnet_cuda.pointnet_global``; branch 4 pools branch 1's and branch
    2's outputs beside their centroids, concatenated along the points.

    :param x: (B, N, F_in) input rows, pos (B, N, D) their positions.
    :param neighbors: the chain's two levels (cent, idx, mask, rel, posc[,
        xg]), as ``neighbors.extract_sa_neighbors`` gives them.
    :return: (B, 1, 1024).
    """
    nb0, nb1 = neighbors[:2]
    _, idx0, mask0, rel0, posc0 = nb0[:5]
    _, idx1, mask1, rel1, posc1 = nb1[:5]
    xg = nb0[5] if len(nb0) > 5 else None
    x1 = sa_neighborhood(mrg.branch1_sa0.conv_mlp.linears, x, idx0, mask0, rel0, activation,
                         xg)
    x1 = sa_neighborhood(mrg.branch1_sa1.conv_mlp.linears, x1, idx1, mask1, rel1, activation)
    x2 = sa_neighborhood(mrg.branch2_sa.conv_mlp.linears, x, idx0, mask0, rel0, activation, xg)
    x3 = pointnet_cuda.pointnet_global(mrg.branch3_gsa.mlp.linears,
                                       torch.cat([x, pos], dim=-1).contiguous(), activation)[0]
    x12 = torch.cat([torch.cat([x1, x2], dim=-2), torch.cat([posc1, posc0], dim=-2)], dim=-1)
    x4 = pointnet_cuda.pointnet_global(mrg.branch4_gsa.mlp.linears, x12.contiguous(),
                                       activation)[0]
    return torch.cat([x3, x4], dim=-1)


sa_neighborhood.launches = 0
sa_neighborhood_backward.launches = 0
