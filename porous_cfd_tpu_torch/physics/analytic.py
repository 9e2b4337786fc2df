"""Analytic forward propagation of first/second spatial derivatives through
MLP stacks (counterpart of ``porous_cfd_tpu/physics/analytic.py``).

The triple (value, J, H) goes through each layer with closed-form rules:

    Dense W,b:   v' = vW + b        J' = JW           H' = HW
    sigma(.):    v' = s(v)          J' = s'(v) J      H' = s''(v) J*J + s'(v) H

``J``/``H`` hold d/dx_j and d^2/dx_j^2 per input coordinate. Parameters are a
sequence of ``nn.Linear`` layers (``MLP.linears``): ``weight`` is (out, in),
the transpose of the flax kernel. Activations are named: ``"silu"`` or
``"tanh"``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement, keep_mask


def tanh_rules(v):
    t = torch.tanh(v)
    d1 = 1.0 - t * t
    return t, d1, -2.0 * t * d1


def silu_rules(v):
    s = torch.sigmoid(v)
    ds = s * (1.0 - s)
    val = v * s
    d1 = s + v * ds
    d2 = 2.0 * ds + v * ds * (1.0 - 2.0 * s)
    return val, d1, d2


ACTIVATIONS = {"silu": F.silu, "tanh": torch.tanh}
ACTIVATION_RULES = {"silu": silu_rules, "tanh": tanh_rules}


def rules_for(activation: str):
    try:
        return ACTIVATION_RULES[activation]
    except KeyError:
        raise KeyError(f"no analytic derivative rules for activation "
                       f"{activation!r}; known: {sorted(ACTIVATION_RULES)}") from None


def identity_jacobian_t(points: torch.Tensor):
    """Transposed-layout (J0, H0) for raw coordinates: shape (..., D, N, D),
    the derivative-component axis leading the point axis."""
    d = points.shape[-1]
    n = points.shape[-2]
    eye = torch.eye(d, dtype=points.dtype, device=points.device)
    j0 = eye[:, None, :].expand(*points.shape[:-2], d, n, d)
    return j0, torch.zeros_like(j0)


def mlp_prop_t(linears: Sequence, v, jt, ht, activation: str,
               last_activation: bool = True):
    """(v, J, H) through an MLP in the transposed derivative layout: ``v``
    (..., N, F), ``jt``/``ht`` (..., D, N, F)."""
    rules = rules_for(activation)
    n_out = len(linears)
    for i, lin in enumerate(linears):
        v = F.linear(v, lin.weight, lin.bias)
        jt = F.linear(jt, lin.weight)
        ht = F.linear(ht, lin.weight)
        if i < n_out - 1 or last_activation:
            val, d1, d2 = rules(v)
            d1e = d1[..., None, :, :]
            ht = d2[..., None, :, :] * (jt * jt) + d1e * ht
            jt = d1e * jt
            v = val
    return v, jt, ht


def mlp_value(linears: Sequence, v, activation: str,
              last_activation: bool = True):
    """Value-only pass through the same layers (rows whose spatial
    derivatives are not needed)."""
    act = ACTIVATIONS[activation]
    n_out = len(linears)
    for i, lin in enumerate(linears):
        v = F.linear(v, lin.weight, lin.bias)
        if i < n_out - 1 or last_activation:
            v = act(v)
    return v


def dense_prop(linear, v, j, h):
    """(v, J, H) through one ``nn.Linear``: the bias touches values only."""
    return (F.linear(v, linear.weight, linear.bias), F.linear(j, linear.weight),
            F.linear(h, linear.weight))


def context_dense_prop(linear, n_local: int, v, j, h, v_b, g, j_ctx=None, h_ctx=None,
                       j0_add=None, h0_add=None):
    """First dense layer of a decoder whose input is ``[local || context]``,
    with the per-case context ``g`` (..., 1, G) contracted once per case and
    its J/H block skipped unless given. ``j``/``h`` are (..., Ni, D, L);
    ``v_b`` may be None.

    The max-pool coupling of the context (nonzero only at the pooling
    winners' rows) enters in one of two forms: ``j_ctx``/``h_ctx`` (..., Ni,
    D, G), the context block's input derivatives, through the context block
    of the weight; or ``j0_add``/``h0_add`` (..., Ni, D, F1), that product
    already formed, added to the pre-activations."""
    w_local = linear.weight[:, :n_local]
    w_ctx = linear.weight[:, n_local:]
    ctx = F.linear(g, w_ctx, linear.bias)
    v = F.linear(v, w_local) + ctx
    if v_b is not None:
        v_b = F.linear(v_b, w_local) + ctx
    j, h = F.linear(j, w_local), F.linear(h, w_local)
    if j_ctx is not None:
        j, h = j + F.linear(j_ctx, w_ctx), h + F.linear(h_ctx, w_ctx)
    if j0_add is not None:
        j, h = j + j0_add, h + h0_add
    return v, j, h, v_b


def activation_prop_merged(activation: str, v, j, h, n_int: int):
    """Activation rules where ``v`` holds [internal || boundary] rows while
    J/H (..., Ni, D, F) cover only the first ``n_int`` rows."""
    val, d1, d2 = rules_for(activation)(v)
    d1i = d1[..., :n_int, None, :]
    h = d2[..., :n_int, None, :] * (j * j) + d1i * h
    j = d1i * j
    return val, j, h


def merged_mask(seed: int, layer: int, rate: float, v, n_int: Optional[int] = None,
                placement: Placement = WHOLE) -> torch.Tensor:
    """The inverted-dropout mask of ``v`` (..., N, F), whose rows are the
    merged [internal || boundary] rows: ``ops/dropout.py``'s counter function
    of (seed, layer, case, merged row, column), the one the decoder kernel
    draws, at the global cases and rows of ``v``'s ``placement`` in its
    batch (a points-split one needs the ``n_int`` internal rows of ``v``)."""
    n_cases = v[..., 0, 0].numel()
    # a case of the batch axis spans n_cases // B mask cases
    case0 = placement.case0 * (n_cases // v.shape[0]) if v.dim() > 2 else placement.case0
    rows = (placement.global_rows(torch.arange(v.shape[-2], device=v.device), n_int)
            if placement.rows_split else None)
    return keep_mask(seed, layer, n_cases, v.shape[-2], v.shape[-1], rate,
                     v.device, case0, rows).reshape(v.shape).to(v.dtype)


def dropout_prop_merged(seed: int, layer: int, rate: float, v, j, h, n_int: int,
                        placement: Placement = WHOLE):
    """Inverted dropout with one mask over the merged [internal || boundary]
    rows of ``v`` (..., N, F) (``merged_mask``); J/H (..., Ni, D, F) share
    the mask of their internal rows (the derivative of mask * x / keep is
    mask * dx / keep)."""
    mask = merged_mask(seed, layer, rate, v, n_int, placement)
    mask_i = mask[..., :n_int, None, :]
    return v * mask, j * mask_i, h * mask_i


def mlp_prop_merged(linears: Sequence, v, j, h, n_int: int, activation: str,
                    dropout: Optional[Sequence[float]] = None, last_activation: bool = True,
                    deterministic: bool = True, seed: Optional[int] = None,
                    placement: Placement = WHOLE):
    """(v, J, H) through an MLP whose value rows ``v`` (..., N, F) are the
    merged [internal || boundary] rows while J/H (..., Ni, D, F) cover the
    first ``n_int``: one product a layer feeds all rows, and layer i's
    dropout (after its activation, unless ``deterministic``) is
    ``merged_mask(seed, i)`` over the merged rows at their ``placement``,
    the mask ``MLP`` draws on the same rows."""
    n_out = len(linears)
    for i, lin in enumerate(linears):
        v, j, h = dense_prop(lin, v, j, h)
        if i < n_out - 1 or last_activation:
            v, j, h = activation_prop_merged(activation, v, j, h, n_int)
        if dropout is not None and dropout[i] > 0 and not deterministic:
            if seed is None:
                raise ValueError("mlp_prop_merged: dropout needs a seed")
            v, j, h = dropout_prop_merged(seed, i, float(dropout[i]), v, j, h, n_int,
                                          placement)
    return v, j, h


def decoder_prop(linears: Sequence, n_local: int, v, j, h, v_b, g,
                 activation: str, dropout: Optional[Sequence[float]] = None,
                 deterministic: bool = True, seed: Optional[int] = None,
                 j_ctx=None, h_ctx=None, j0_add=None, h0_add=None,
                 placement: Placement = WHOLE):
    """Decoder-stack propagation over ``[local || context]`` inputs with the
    internal and boundary value rows merged into one matmul per layer; the
    last layer is linear.

    :param v/j/h: internal local features + derivatives ((..., Ni, L),
        (..., Ni, D, L)); ``v_b``: boundary local features (..., Nb, L) or
        None; ``g``: pooled context (..., 1, G).
    :param dropout: one rate per layer, applied after each layer's
        activation unless ``deterministic``, with masks fixed by ``seed``
        at the rows' ``placement`` in their batch (``merged_mask``).
    :param j_ctx/h_ctx/j0_add/h0_add: the max-pool coupling of the context
        (``context_dense_prop``), or None.
    :return: (values over [internal || boundary] rows, J, H).
    """
    n_int = v.shape[-2]
    v, j, h, v_b = context_dense_prop(linears[0], n_local, v, j, h, v_b, g, j_ctx, h_ctx,
                                      j0_add, h0_add)
    if v_b is not None:
        v = torch.cat([v, v_b], dim=-2)
    n_out = len(linears)
    for i in range(n_out):
        if i > 0:
            v, j, h = dense_prop(linears[i], v, j, h)
        if i < n_out - 1:
            v, j, h = activation_prop_merged(activation, v, j, h, n_int)
        if dropout is not None and dropout[i] > 0 and not deterministic:
            if seed is None:
                raise ValueError("decoder_prop: dropout needs a seed")
            v, j, h = dropout_prop_merged(seed, i, float(dropout[i]), v, j, h, n_int,
                                          placement)
    return v, j, h
