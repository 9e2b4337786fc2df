"""``decoder_prop``: the decoder MLP on (value, J, H) rows in the decoupled-
context mode (counterpart of ``porous_cfd_tpu/ops/decoder_pallas.py``,
forward only, deterministic).

``decoder_prop`` launches the hand-written CUDA kernel
(``csrc/decoder_prop.cu``) for CUDA tensors, once for the internal (v, J, H)
rows and once value-only for the boundary rows; CPU tensors take the plain
PyTorch version, ``decoder_prop_plain``. There is no other fallback: a CUDA
tensor either runs the kernel or raises.

Layouts are the JAX package's: ``jt``/``ht`` enter as (B, D, Ni, L), as
``analytic.mlp_prop_t`` emits them; the result is ``(v (B, Ni + Nb, O),
jac (B, Ni, O, D), lap (B, Ni, O, D))``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from porous_cfd_tpu_torch.ops import build
from porous_cfd_tpu_torch.physics import analytic

ACT_CODES = {"silu": 0, "tanh": 1}
MAX_DIMS = 3


def decoder_prop_plain(linears: Sequence, n_local: int, v, jt, ht, v_b, g,
                       activation: str):
    """``analytic.decoder_prop`` in the transposed layout."""
    out, j, h = analytic.decoder_prop(linears, n_local, v, jt.transpose(-3, -2),
                                      ht.transpose(-3, -2), v_b, g, activation)
    return out, j.transpose(-1, -2), h.transpose(-1, -2)


def _library() -> ctypes.CDLL:
    lib = build.library("decoder_prop")
    if lib.decoder_prop_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decoder_prop_forward.argtypes = [i, i, i, p, p, p, i, i, p, i, p, p, p,
                                             p, i, i, p, p, p]
        lib.decoder_prop_forward.restype = i
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"decoder_prop: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def decoder_prop(linears: Sequence, n_local: int, v, jt, ht, v_b, g,
                 activation: str):
    """Decoder propagation of internal (v, J, H) rows and boundary value rows.

    :param linears: the decoder's ``nn.Linear`` layers; layer 0 takes
        ``[local (n_local) || context (G)]``; the last layer is linear.
    :param v: (B, Ni, L) internal local features; ``jt``/``ht`` (B, D, Ni, L).
    :param v_b: (B, Nb, L) boundary local features, or None.
    :param g: (B, 1, G) pooled context.
    """
    if v.device.type == "cpu":
        return decoder_prop_plain(linears, n_local, v, jt, ht, v_b, g, activation)
    if v.device.type != "cuda":
        raise ValueError(f"decoder_prop: no kernel for device {v.device}")
    if activation not in ACT_CODES:
        raise ValueError(f"decoder_prop: unsupported activation {activation!r}")
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

    # first-layer split: the per-case context term is one small matmul
    ctx = F.linear(g[:, 0, :], w0[:, n_local:], linears[0].bias).contiguous()
    n_out = widths[-1]
    ov = torch.empty((b_cases, n_int + n_bnd, n_out), dtype=torch.float32, device=dev)
    oj = torch.empty((b_cases, n_int, n_out, d_dims), dtype=torch.float32, device=dev)
    oh = torch.empty_like(oj)
    # the kernel reads weights as (in, out): nn.Linear's weight transposed,
    # for layer 0 only its local block
    ws = ([w0[:, :n_local].t().contiguous()]
          + [lin.weight.t().contiguous() for lin in linears[1:]])
    bs = [lin.bias for lin in linears]
    lib = _library()
    args = (build.pointer_array(ws), build.pointer_array(bs), build.int_array(widths))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.decoder_prop_forward(
            d_dims, ACT_CODES[activation], 1, v.data_ptr(), jt.data_ptr(), ht.data_ptr(),
            b_cases, n_int, ctx.data_ptr(), len(ws), *args, ov.data_ptr(),
            n_int + n_bnd, 0, oj.data_ptr(), oh.data_ptr(), stream)
        build.check_launch("decoder_prop (internal)", code)
        decoder_prop.launches += 1
        if v_b is not None:
            code = lib.decoder_prop_forward(
                d_dims, ACT_CODES[activation], 0, v_b.data_ptr(), None, None,
                b_cases, n_bnd, ctx.data_ptr(), len(ws), *args, ov.data_ptr(),
                n_int + n_bnd, n_int, None, None, stream)
            build.check_launch("decoder_prop (boundary)", code)
            decoder_prop.launches += 1
    return ov, oj, oh


decoder_prop.launches = 0
