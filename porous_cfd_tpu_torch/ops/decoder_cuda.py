"""``decoder_prop``: the decoder MLP on (value, J, H) rows in the decoupled-
context mode, with inverted dropout between layers (counterpart of
``porous_cfd_tpu/ops/decoder_pallas.py``), forward and backward.

``decoder_prop`` launches the hand-written CUDA kernel
(``csrc/decoder_prop.cu``) for CUDA tensors, once for the internal (v, J, H)
rows and once value-only for the boundary rows; CPU tensors take the plain
PyTorch version, ``decoder_prop_plain``. There is no other fallback: a CUDA
tensor either runs the kernel or raises. When a gradient is wanted the
kernel runs inside a ``torch.autograd.Function``: the training forward also
stashes each layer's input rows and pre-activations, and the backward is the
backward kernel (``decoder_prop_backward``, again one internal and one
boundary launch).

Dropout masks come from ``ops/dropout.py``'s counter function in both
versions, so the kernel and the plain version drop the same columns.

Layouts are the JAX package's: ``jt``/``ht`` enter as (B, D, Ni, L), as
``analytic.mlp_prop_t`` emits them; the result is ``(v (B, Ni + Nb, O),
jac (B, Ni, O, D), lap (B, Ni, O, D))``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from porous_cfd_tpu_torch.ops import build, dropout as dropout_mod
from porous_cfd_tpu_torch.physics import analytic

ACT_CODES = {"silu": 0, "tanh": 1}
MAX_DIMS = 3


def dropout_rates(dropout: Optional[Sequence[float]], n_layers: int,
                  deterministic: bool) -> tuple[float, ...]:
    """Per-layer dropout rates in force: all zero when deterministic."""
    if dropout is None or deterministic:
        return (0.0,) * n_layers
    if len(dropout) != n_layers:
        raise ValueError(f"decoder_prop: {len(dropout)} dropout rates for "
                         f"{n_layers} layers")
    return tuple(float(r) for r in dropout)


def decoder_prop_plain(linears: Sequence, n_local: int, v, jt, ht, v_b, g,
                       activation: str, dropout=None, deterministic: bool = True,
                       seed: Optional[int] = None):
    """``analytic.decoder_prop`` in the transposed layout."""
    out, j, h = analytic.decoder_prop(linears, n_local, v, jt.transpose(-3, -2),
                                      ht.transpose(-3, -2), v_b, g, activation,
                                      dropout, deterministic, seed)
    return out, j.transpose(-1, -2), h.transpose(-1, -2)


def _library() -> ctypes.CDLL:
    lib = build.library("decoder_prop")
    if lib.decoder_prop_forward.argtypes is None:
        p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.decoder_prop_forward.argtypes = [i, i, i, p, p, p, i, i, p, i, p, p, p,
                                             p, i, i, p, p, u, u, p, p, p, p, p, p]
        lib.decoder_prop_forward.restype = i
        lib.decoder_prop_backward_workspace.argtypes = [i, ll, i, p]
        lib.decoder_prop_backward_workspace.restype = ll
        lib.decoder_prop_backward.argtypes = [i, i, i, p, i, i, p, p, i, i, i, p, p, p,
                                              u, u, p, p, p, p, p, p, p, p, p, p, p, p,
                                              p, ll, p]
        lib.decoder_prop_backward.restype = i
        lib.decoder_prop_philox.argtypes = [p, p, i, p]
        lib.decoder_prop_philox.restype = i
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"decoder_prop: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


class _Meta:
    """What one call fixes besides its tensors."""

    def __init__(self, n_local, activation, rates, seed, d_dims, b_cases, n_int,
                 n_bnd, widths):
        self.n_local = n_local
        self.activation = activation
        self.rates = rates
        self.seed = 0 if seed is None else int(seed)
        self.d_dims = d_dims
        self.b_cases = b_cases
        self.n_int = n_int
        self.n_bnd = n_bnd
        self.widths = widths                     # (L, F1, ..., O)

    @property
    def n_layers(self):
        return len(self.widths) - 1

    def dropout_args(self):
        """(k0, k1, thresholds, scales, on) for the C interface."""
        nl = self.n_layers
        on = [int(r > 0) for r in self.rates]
        thresh = (ctypes.c_uint * nl)(*[dropout_mod.keep_threshold(r) if r > 0 else 0
                                        for r in self.rates])
        scale = (ctypes.c_float * nl)(*[1.0 / (1.0 - r) if r > 0 else 1.0
                                        for r in self.rates])
        return (self.seed & dropout_mod.MASK32, (self.seed >> 32) & dropout_mod.MASK32,
                thresh, scale, build.int_array(on))

    def stash_floats(self, rows):
        w = self.widths
        return rows * sum(w[:-1]), rows * sum(w[1:-1])


def _forward(meta: _Meta, v, jt, ht, v_b, ctx, weights, biases, stash: bool):
    """Both launches; with ``stash`` also the training stash of each.
    Returns (ov, oj, oh, [a_int, z_int, a_bnd, z_bnd])."""
    dev = v.device
    b_cases, n_int, n_bnd, d_dims = meta.b_cases, meta.n_int, meta.n_bnd, meta.d_dims
    n_out = meta.widths[-1]
    n_local = meta.n_local
    ov = torch.empty((b_cases, n_int + n_bnd, n_out), dtype=torch.float32, device=dev)
    oj = torch.empty((b_cases, n_int, n_out, d_dims), dtype=torch.float32, device=dev)
    oh = torch.empty_like(oj)
    # the kernel reads weights as (in, out): nn.Linear's weight transposed,
    # for layer 0 only its local block
    ws = ([weights[0].detach()[:, :n_local].t().contiguous()]
          + [w.detach().t().contiguous() for w in weights[1:]])
    bs = [ctx] + [b.detach() for b in biases]
    lib = _library()
    args = (build.pointer_array(ws), build.pointer_array(bs), build.int_array(meta.widths))
    drop = meta.dropout_args()
    stashes = []

    def stash_for(rows):
        if not stash:
            return None, None
        na, nz = meta.stash_floats(rows)
        a = torch.empty((na,), dtype=torch.float32, device=dev)
        z = torch.empty((nz,), dtype=torch.float32, device=dev)
        stashes.extend([a, z])
        return a.data_ptr(), z.data_ptr() if nz else None

    act = ACT_CODES[meta.activation]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sa, sz = stash_for(b_cases * n_int * (1 + 2 * d_dims))
        code = lib.decoder_prop_forward(
            d_dims, act, 1, v.data_ptr(), jt.data_ptr(), ht.data_ptr(), b_cases, n_int,
            ctx.data_ptr(), len(ws), *args, ov.data_ptr(), n_int + n_bnd, 0, oj.data_ptr(),
            oh.data_ptr(), *drop, sa, sz, stream)
        build.check_launch("decoder_prop (internal)", code)
        decoder_prop.launches += 1
        if v_b is not None:
            sa, sz = stash_for(b_cases * n_bnd)
            code = lib.decoder_prop_forward(
                d_dims, act, 0, v_b.data_ptr(), None, None, b_cases, n_bnd, ctx.data_ptr(),
                len(ws), *args, ov.data_ptr(), n_int + n_bnd, n_int, None, None, *drop, sa,
                sz, stream)
            build.check_launch("decoder_prop (boundary)", code)
            decoder_prop.launches += 1
    return ov, oj, oh, stashes


def decoder_prop_backward(meta: _Meta, weights, stashes, gv, gj, gh):
    """The backward kernel, internal then boundary launch: (dv, djt, dht,
    dv_b or None, dctx (B, F1), dW per layer ((in, out), layer 0's local
    block), db per layer from 1 on)."""
    dev = gv.device
    b_cases, n_int, n_bnd, d_dims = meta.b_cases, meta.n_int, meta.n_bnd, meta.d_dims
    widths = meta.widths
    nl = meta.n_layers
    lib = _library()
    w_arr = build.int_array(widths)
    ldw = build.int_array([w.shape[1] for w in weights])
    w_ptrs = build.pointer_array(weights)
    dws = [torch.zeros((widths[i], widths[i + 1]), dtype=torch.float32, device=dev)
           for i in range(nl)]
    dbs = [torch.zeros((widths[i + 1],), dtype=torch.float32, device=dev) for i in range(nl)]
    dctx = dbs[0].new_zeros((b_cases, widths[1]))
    # db[0] is not used: dctx takes its place
    db_ptrs = build.pointer_array([dctx] + dbs[1:])
    dw_ptrs = build.pointer_array(dws)
    drop = meta.dropout_args()
    act = ACT_CODES[meta.activation]
    rows_int = b_cases * n_int * (1 + 2 * d_dims)
    rows_bnd = b_cases * n_bnd
    n_scratch = max(lib.decoder_prop_backward_workspace(b_cases, r, nl, w_arr)
                    for r in (rows_int, rows_bnd) if r)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev)
    gz = torch.empty((max(rows_int, rows_bnd) * sum(widths[1:]),), dtype=torch.float32,
                     device=dev)
    dv = torch.empty((b_cases, n_int, widths[0]), dtype=torch.float32, device=dev)
    djt = torch.empty((b_cases, d_dims, n_int, widths[0]), dtype=torch.float32, device=dev)
    dht = torch.empty_like(djt)
    dv_b = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.decoder_prop_backward(
            d_dims, act, 1, gv.data_ptr(), n_int + n_bnd, 0, gj.data_ptr(), gh.data_ptr(),
            b_cases, n_int, nl, w_ptrs, ldw, w_arr, *drop, stashes[0].data_ptr(),
            stashes[1].data_ptr() if stashes[1].numel() else None, gz.data_ptr(),
            dv.data_ptr(), djt.data_ptr(), dht.data_ptr(), dw_ptrs, db_ptrs, dctx.data_ptr(),
            scratch.data_ptr(), n_scratch, stream)
        build.check_launch("decoder_prop backward (internal)", code)
        decoder_prop_backward.launches += 1
        if n_bnd:
            dv_b = torch.empty((b_cases, n_bnd, widths[0]), dtype=torch.float32, device=dev)
            code = lib.decoder_prop_backward(
                d_dims, act, 0, gv.data_ptr(), n_int + n_bnd, n_int, None, None, b_cases,
                n_bnd, nl, w_ptrs, ldw, w_arr, *drop, stashes[2].data_ptr(),
                stashes[3].data_ptr() if stashes[3].numel() else None, gz.data_ptr(),
                dv_b.data_ptr(), None, None, dw_ptrs, db_ptrs, dctx.data_ptr(),
                scratch.data_ptr(), n_scratch, stream)
            build.check_launch("decoder_prop backward (boundary)", code)
            decoder_prop_backward.launches += 1
    return dv, djt, dht, dv_b, dctx, dws, dbs[1:]


class _DecoderProp(torch.autograd.Function):
    """The forward kernel with its stash, and the backward kernel."""

    @staticmethod
    def forward(ctx, meta, v, jt, ht, v_b, cctx, *params):
        nl = meta.n_layers
        weights, biases = params[:nl], params[nl:]
        ov, oj, oh, stashes = _forward(meta, v, jt, ht, v_b, cctx, weights, biases,
                                       stash=True)
        ctx.meta = meta
        ctx.save_for_backward(*weights, *stashes)
        return ov, oj, oh

    @staticmethod
    def backward(ctx, gv, gj, gh):
        meta = ctx.meta
        nl = meta.n_layers
        saved = ctx.saved_tensors
        weights = [w.detach() for w in saved[:nl]]
        dv, djt, dht, dv_b, dctx, dws, dbs = decoder_prop_backward(
            meta, weights, saved[nl:], gv.contiguous(), gj.contiguous(), gh.contiguous())
        # layer 0's kernel gradient covers its local block; the context block
        # gets its gradient through ctx's F.linear
        dw0 = torch.zeros_like(weights[0])
        dw0[:, :meta.n_local] = dws[0].t()
        return (None, dv, djt, dht, dv_b, dctx, dw0,
                *[dw.t() for dw in dws[1:]], *dbs)


def decoder_prop(linears: Sequence, n_local: int, v, jt, ht, v_b, g,
                 activation: str, dropout: Optional[Sequence[float]] = None,
                 deterministic: bool = True, seed: Optional[int] = None):
    """Decoder propagation of internal (v, J, H) rows and boundary value rows.

    :param linears: the decoder's ``nn.Linear`` layers; layer 0 takes
        ``[local (n_local) || context (G)]``; the last layer is linear.
    :param v: (B, Ni, L) internal local features; ``jt``/``ht`` (B, D, Ni, L).
    :param v_b: (B, Nb, L) boundary local features, or None.
    :param g: (B, 1, G) pooled context.
    :param dropout: one rate per layer, applied after the activation of
        each layer unless ``deterministic``; ``seed`` (a 64-bit integer)
        fixes the masks.
    """
    rates = dropout_rates(dropout, len(linears), deterministic)
    if any(rates) and seed is None:
        raise ValueError("decoder_prop: dropout needs a seed")
    if v.device.type == "cpu":
        return decoder_prop_plain(linears, n_local, v, jt, ht, v_b, g, activation,
                                  rates, False, seed)
    if v.device.type != "cuda":
        raise ValueError(f"decoder_prop: no kernel for device {v.device}")
    if activation not in ACT_CODES:
        raise ValueError(f"decoder_prop: unsupported activation {activation!r}")
    if rates[-1] > 0:
        raise ValueError("decoder_prop: no dropout on the last (linear) layer")
    dev = v.device
    b_cases, n_int, _ = v.shape
    d_dims = jt.shape[1]
    if not 1 <= d_dims <= MAX_DIMS:
        raise ValueError(f"decoder_prop: D = {d_dims} not in 1..{MAX_DIMS}")
    _check("v", v, (b_cases, n_int, n_local), dev)
    _check("jt", jt, (b_cases, d_dims, n_int, n_local), dev)
    _check("ht", ht, (b_cases, d_dims, n_int, n_local), dev)
    w0 = linears[0].weight
    ctx_width = w0.shape[1] - n_local
    _check("g", g, (b_cases, 1, ctx_width), dev)
    widths = [n_local] + [lin.weight.shape[0] for lin in linears]
    _check("linear_0.weight", w0, (widths[1], n_local + ctx_width), dev)
    for i, lin in enumerate(linears[1:], start=1):
        _check(f"linear_{i}.weight", lin.weight, (widths[i + 1], widths[i]), dev)
        _check(f"linear_{i}.bias", lin.bias, (widths[i + 1],), dev)
    n_bnd = 0
    if v_b is not None:
        n_bnd = v_b.shape[1]
        _check("v_b", v_b, (b_cases, n_bnd, n_local), dev)

    meta = _Meta(n_local, activation, rates, seed, d_dims, b_cases, n_int, n_bnd,
                 tuple(widths))
    # first-layer split: the per-case context term is one small matmul,
    # differentiated by autograd
    ctx = F.linear(g[:, 0, :], w0[:, n_local:], linears[0].bias).contiguous()
    weights = [lin.weight for lin in linears]
    biases = [lin.bias for lin in linears[1:]]
    tensors = [v, jt, ht, ctx, *weights, *biases] + ([v_b] if v_b is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DecoderProp.apply(meta, v, jt, ht, v_b, ctx, *weights, *biases)
    return _forward(meta, v, jt, ht, v_b, ctx, weights, biases, stash=False)[:3]


def philox(counters: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on the card: ``counters`` (n, 6) int64 rows of 32-bit
    (c0, c1, c2, c3, k0, k1) -> (n, 4) int64 outputs. For the known-answer
    check of the kernels' generator."""
    lib = _library()
    dev = counters.device
    inp = counters.to(torch.int64).to(torch.int32).contiguous()  # same 32 bits
    out = torch.empty((inp.shape[0], 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.decoder_prop_philox(inp.data_ptr(), out.data_ptr(), inp.shape[0],
                                       torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decoder_prop_philox", code)
    return out.to(torch.int64) & dropout_mod.MASK32


decoder_prop.launches = 0
decoder_prop_backward.launches = 0
