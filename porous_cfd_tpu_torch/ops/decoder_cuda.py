"""``decoder_prop``: the decoder MLP on (value, J, H) rows, with inverted
dropout between layers (counterpart of ``porous_cfd_tpu/ops/decoder_pallas.py``),
forward and backward, in its three modes: decoupled context (the pooled
context is constant per case), ``j0_add`` (additive layer-0 J/H terms, the
max-pool-coupled PIPN path) and ``ctx_width`` (J/H rows carry the context
block's input derivatives and go through the full first-layer weight).

``decoder_prop`` launches the hand-written CUDA kernel
(``csrc/decoder_prop.cu``) for CUDA tensors, once for the internal (v, J, H)
rows and once value-only for the boundary rows; CPU tensors take the plain
PyTorch version, ``decoder_prop_plain``. There is no other fallback: a CUDA
tensor either runs the kernel or raises. When a gradient is wanted the
kernel runs inside ``mlp_prop_cuda.MlpProp``, a ``torch.autograd.Function``
whose backward is the backward kernel (``decoder_prop_backward``, again one
internal and one boundary launch).

Dropout masks come from ``ops/dropout.py``'s counter function in both
versions, so the kernel and the plain version drop the same columns.

Layouts are the JAX package's: ``jt``/``ht`` enter as (B, D, Ni, L), as
``analytic.mlp_prop_t`` emits them; the result is ``(v (B, Ni + Nb, O),
jac (B, Ni, O, D), lap (B, Ni, O, D))``. The coupled modes' tensors are f32
on the card as on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from porous_cfd_tpu_torch.ops import build, dropout as dropout_mod, mlp_prop_cuda
from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.ops.mlp_prop_cuda import (ACT_CODES, MAX_DIMS, Meta,
                                                    check_tensor, dropout_rates)
from porous_cfd_tpu_torch.physics import analytic


def _t(x):
    return None if x is None else x.transpose(-3, -2)


def decoder_prop_plain(linears: Sequence, n_local: int, v, jt, ht, v_b, g,
                       activation: str, dropout=None, deterministic: bool = True,
                       seed: Optional[int] = None, jctx_t=None, hctx_t=None, j0_add=None,
                       h0_add=None, placement: Placement = WHOLE):
    """``analytic.decoder_prop`` in the transposed layout."""
    out, j, h = analytic.decoder_prop(linears, n_local, v, _t(jt), _t(ht), v_b, g, activation,
                                      dropout, deterministic, seed, _t(jctx_t), _t(hctx_t),
                                      _t(j0_add), _t(h0_add), placement)
    return out, j.transpose(-1, -2), h.transpose(-1, -2)


def decoder_prop_backward(meta: Meta, weights, stashes, gv, gj, gh):
    """The backward kernel, internal then boundary launch: (dv, djt, dht,
    dv_b or None, dctx (B, F1), dW per layer ((in, out); layer 0's local
    block, or all of it in the ctx_width mode), db per layer from 1 on, dja
    and dha (B, D, Ni, F1) in the j0_add mode, else None)."""
    out = mlp_prop_cuda.backward(DECODER, meta, weights, stashes, gv, gj, gh)
    return out[:7] + out[8:]


def decoder_prop(linears: Sequence, n_local: int, v, jt, ht, v_b, g,
                 activation: str, dropout: Optional[Sequence[float]] = None,
                 deterministic: bool = True, seed: Optional[int] = None,
                 jctx_t=None, hctx_t=None, j0_add=None, h0_add=None,
                 placement: Placement = WHOLE):
    """Decoder propagation of internal (v, J, H) rows and boundary value rows.

    :param linears: the decoder's ``nn.Linear`` layers; layer 0 takes
        ``[local (n_local) || context (G)]``; the last layer is linear.
    :param v: (B, Ni, L) internal local features; ``jt``/``ht`` (B, D, Ni, L).
    :param v_b: (B, Nb, L) boundary local features, or None.
    :param g: (B, 1, G) pooled context.
    :param dropout: one rate per layer, applied after the activation of
        each layer unless ``deterministic``; ``seed`` (a 64-bit integer)
        fixes the masks, drawn at the rows' ``placement`` in their batch
        (the whole batch by default).
    :param jctx_t/hctx_t: (B, D, Ni, G) input derivatives of the context
        block (the ``ctx_width`` mode), or None.
    :param j0_add/h0_add: (B, D, Ni, F1) terms added to layer 0's J/H
        pre-activations (the ``j0_add`` mode), or None. The two modes
        exclude each other.
    """
    rates = dropout_rates(dropout, len(linears), deterministic)
    if any(rates) and seed is None:
        raise ValueError("decoder_prop: dropout needs a seed")
    if (jctx_t is None) != (hctx_t is None) or (j0_add is None) != (h0_add is None):
        raise ValueError("decoder_prop: jctx_t/hctx_t and j0_add/h0_add come in pairs")
    if jctx_t is not None and j0_add is not None:
        raise ValueError("decoder_prop: the ctx_width (jctx_t) and j0_add modes exclude "
                         "each other")
    if v.device.type == "cpu":
        return decoder_prop_plain(linears, n_local, v, jt, ht, v_b, g, activation,
                                  rates, False, seed, jctx_t, hctx_t, j0_add, h0_add,
                                  placement)
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

    def check(label, t, shape):
        check_tensor(label, t, shape, dev, "decoder_prop")

    check("v", v, (b_cases, n_int, n_local))
    check("jt", jt, (b_cases, d_dims, n_int, n_local))
    check("ht", ht, (b_cases, d_dims, n_int, n_local))
    w0 = linears[0].weight
    ctx_width = w0.shape[1] - n_local
    check("g", g, (b_cases, 1, ctx_width))
    widths = [n_local] + [lin.weight.shape[0] for lin in linears]
    check("linear_0.weight", w0, (widths[1], n_local + ctx_width))
    for i, lin in enumerate(linears[1:], start=1):
        check(f"linear_{i}.weight", lin.weight, (widths[i + 1], widths[i]))
        check(f"linear_{i}.bias", lin.bias, (widths[i + 1],))
    n_bnd = 0
    if v_b is not None:
        n_bnd = v_b.shape[1]
        check("v_b", v_b, (b_cases, n_bnd, n_local))
    if (jctx_t is not None or j0_add is not None) and len(linears) < 2:
        raise ValueError("decoder_prop: the coupled modes need an activated layer 0")
    if jctx_t is not None:
        check("jctx_t", jctx_t, (b_cases, d_dims, n_int, ctx_width))
        check("hctx_t", hctx_t, (b_cases, d_dims, n_int, ctx_width))
        # the J/H rows carry the context columns after the local ones
        jt, ht = torch.cat([jt, jctx_t], dim=-1), torch.cat([ht, hctx_t], dim=-1)
    if j0_add is not None:
        check("j0_add", j0_add, (b_cases, d_dims, n_int, widths[1]))
        check("h0_add", h0_add, (b_cases, d_dims, n_int, widths[1]))

    meta = Meta(n_local, activation, rates, seed, d_dims, b_cases, n_int, n_bnd,
                tuple(widths), ctx_width if jctx_t is not None else 0, j0_add is not None,
                placement=placement)
    # first-layer split: the per-case context term is one small matmul,
    # differentiated by autograd
    ctx = F.linear(g[:, 0, :], w0[:, n_local:], linears[0].bias).contiguous()
    return mlp_prop_cuda.run(DECODER, meta, v, jt, ht, v_b, ctx, None,
                             [lin.weight for lin in linears],
                             [lin.bias for lin in linears[1:]], j0_add, h0_add)


def philox(counters: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on the card: ``counters`` (n, 6) int64 rows of 32-bit
    (c0, c1, c2, c3, k0, k1) -> (n, 4) int64 outputs. For the known-answer
    check of the kernels' generator."""
    lib = DECODER.library()
    if lib.decoder_prop_philox.argtypes is None:
        lib.decoder_prop_philox.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p]
        lib.decoder_prop_philox.restype = ctypes.c_int
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
# internal launches of each coupled mode, forward and backward (counted in
# decoder_prop's and decoder_prop_backward's launches too)
MODE_COUNTS = {mode: (mlp_prop_cuda.ModeCount(), mlp_prop_cuda.ModeCount())
               for mode in ("j0_add", "ctx_width")}
DECODER = mlp_prop_cuda.Kernels("decoder_prop", "decoder_prop", False, decoder_prop,
                                decoder_prop_backward, MODE_COUNTS)
