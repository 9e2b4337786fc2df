"""``neural_ops_prop``: the PI-GANO NeuralOperator trunk and its linear
reduction on (value, J, H) rows (counterpart of
``porous_cfd_tpu/ops/neural_op_pallas.py``), forward and backward.

Each operator is dense -> activation rules -> inverted dropout ->
multiplication of v, J and H by the pooled branch embedding ``par``; the
first operator takes ``[points embedding || geometry embedding]`` and is split
by context, so the geometry block runs once per case and J/H skip it; the
reduction is linear. As in the JAX function, the last operator may be left
without its activation (``last_activation=False``) and the reduction left
out (``reduction=None``: the output is the last operator's, F wide);
PiGanoFull's trunks take both.

``neural_ops_prop`` launches the hand-written CUDA kernel
(``csrc/neural_op_prop.cu``) for CUDA tensors, once for the internal (v, J, H)
rows and once value-only for the boundary rows; CPU tensors take the plain
PyTorch version, ``neural_ops_prop_plain``. There is no other fallback: a
CUDA tensor either runs the kernel or raises. When a gradient is wanted the
kernel runs inside ``mlp_prop_cuda.MlpProp``, a ``torch.autograd.Function``
whose backward is the backward kernel (``neural_ops_prop_backward``), which
also gives the per-case cotangent of ``par``.

Dropout masks come from ``ops/dropout.py``'s counter function over the
merged [internal || boundary] rows in both versions, on a stream of the
trunk's own (``trunk_seed``), so the kernel and the plain version drop the
same columns. Layouts are the decoder's: ``jt``/``ht`` enter as (B, D, Ni,
L); the result is ``(v (B, Ni + Nb, O), jac (B, Ni, O, D), lap (B, Ni, O,
D))``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from porous_cfd_tpu_torch.ops import dropout as dropout_mod, mlp_prop_cuda
from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.ops.mlp_prop_cuda import (ACT_CODES, MAX_DIMS, Meta,
                                                    check_tensor, dropout_rates)
from porous_cfd_tpu_torch.physics import analytic

# fold_in data that gives the trunk's dropout masks a stream of their own
TRUNK_STREAM = 0x7472756E


def trunk_seed(seed: Optional[int]) -> Optional[int]:
    """The seed of the trunk's masks, derived from the step's seed."""
    return None if seed is None else dropout_mod.fold_in(seed, TRUNK_STREAM)


def neural_ops_prop_plain(operators: Sequence, reduction, n_local: int, v, jt, ht, v_b,
                          geom, par, activation: str, dropout=None,
                          deterministic: bool = True, seed: Optional[int] = None,
                          last_activation: bool = True, placement: Placement = WHOLE):
    """The JAX package's ``_neural_ops_prop_ctx`` followed by ``dense_prop``
    through the reduction (none when ``reduction`` is None), in the
    transposed layout, with the port's dropout masks."""
    rates = dropout_rates(dropout, len(operators), deterministic, "neural_ops_prop")
    if any(rates) and seed is None:
        raise ValueError("neural_ops_prop: dropout needs a seed")
    seed = trunk_seed(seed)
    n_int = v.shape[-2]
    par_j = par[..., None, :]
    v, j, h, v_b = analytic.context_dense_prop(operators[0], n_local, v, jt.transpose(-3, -2),
                                               ht.transpose(-3, -2), v_b, geom)
    if v_b is not None:
        v = torch.cat([v, v_b], dim=-2)
    for i, lin in enumerate(operators):
        if i > 0:
            v, j, h = analytic.dense_prop(lin, v, j, h)
        if last_activation or i < len(operators) - 1:
            v, j, h = analytic.activation_prop_merged(activation, v, j, h, n_int)
        if rates[i] > 0:
            v, j, h = analytic.dropout_prop_merged(seed, i, rates[i], v, j, h, n_int,
                                                   placement)
        v, j, h = v * par, j * par_j, h * par_j
    if reduction is not None:
        v, j, h = analytic.dense_prop(reduction, v, j, h)
    return v, j.transpose(-1, -2), h.transpose(-1, -2)


def neural_ops_prop_backward(meta: Meta, weights, par, stashes, gv, gj, gh):
    """The backward kernel, internal then boundary launch: (dv, djt, dht,
    dv_b or None, dctx (B, F), dpar (B, F), dW per layer ((in, out),
    operator 0's local block), db per layer from 1 on)."""
    dv, djt, dht, dv_b, dctx, dws, dbs, dpar = mlp_prop_cuda.backward(
        TRUNK, meta, weights, stashes, gv, gj, gh, par)[:8]
    return dv, djt, dht, dv_b, dctx, dpar, dws, dbs


def neural_ops_prop(operators: Sequence, reduction, n_local: int, v, jt, ht, v_b, geom,
                    par, activation: str, dropout: Optional[Sequence[float]] = None,
                    deterministic: bool = True, seed: Optional[int] = None,
                    last_activation: bool = True, placement: Placement = WHOLE):
    """Trunk + reduction propagation of internal (v, J, H) rows and boundary
    value rows.

    :param operators: the operators' ``nn.Linear`` layers, every one
        activated but, without ``last_activation``, the last; operator 0
        takes ``[local (n_local) || geometry (G)]``, the others are F -> F.
        ``reduction``: the linear F -> O layer, or None (O = F: the last
        operator's output).
    :param v: (B, Ni, L) internal local features; ``jt``/``ht`` (B, D, Ni, L).
    :param v_b: (B, Nb, L) boundary local features, or None.
    :param geom: (B, 1, G) pooled geometry embedding; ``par`` (B, 1, F) the
        pooled branch embedding.
    :param dropout: one rate per operator, applied after its activation
        unless ``deterministic``; ``seed`` (a 64-bit integer) fixes the masks,
        drawn at the rows' ``placement`` in their batch (the whole batch by
        default).
    """
    rates = dropout_rates(dropout, len(operators), deterministic, "neural_ops_prop")
    if any(rates) and seed is None:
        raise ValueError("neural_ops_prop: dropout needs a seed")
    if v.device.type == "cpu":
        return neural_ops_prop_plain(operators, reduction, n_local, v, jt, ht, v_b, geom, par,
                                     activation, rates, False, seed, last_activation,
                                     placement)
    if v.device.type != "cuda":
        raise ValueError(f"neural_ops_prop: no kernel for device {v.device}")
    if activation not in ACT_CODES:
        raise ValueError(f"neural_ops_prop: unsupported activation {activation!r}")
    dev = v.device
    b_cases, n_int, _ = v.shape
    d_dims = jt.shape[1]
    if not 1 <= d_dims <= MAX_DIMS:
        raise ValueError(f"neural_ops_prop: D = {d_dims} not in 1..{MAX_DIMS}")

    def check(label, t, shape):
        check_tensor(label, t, shape, dev, "neural_ops_prop")

    check("v", v, (b_cases, n_int, n_local))
    check("jt", jt, (b_cases, d_dims, n_int, n_local))
    check("ht", ht, (b_cases, d_dims, n_int, n_local))
    w0 = operators[0].weight
    n_feat = w0.shape[0]
    geom_width = w0.shape[1] - n_local
    check("geom", geom, (b_cases, 1, geom_width))
    check("par", par, (b_cases, 1, n_feat))
    check("operator_0.weight", w0, (n_feat, n_local + geom_width))
    for i, lin in enumerate(operators[1:], start=1):
        check(f"operator_{i}.weight", lin.weight, (n_feat, n_feat))
        check(f"operator_{i}.bias", lin.bias, (n_feat,))
    linears = list(operators)
    if reduction is not None:
        n_out = reduction.weight.shape[0]
        check("reduction.weight", reduction.weight, (n_out, n_feat))
        check("reduction.bias", reduction.bias, (n_out,))
        linears.append(reduction)
    n_bnd = 0
    if v_b is not None:
        n_bnd = v_b.shape[1]
        check("v_b", v_b, (b_cases, n_bnd, n_local))

    widths = (n_local,) + tuple(lin.weight.shape[0] for lin in linears)
    meta = Meta(n_local, activation, rates + (0.0,) * (reduction is not None),
                trunk_seed(seed), d_dims, b_cases, n_int, n_bnd, widths,
                reduction=reduction is not None, last_activation=last_activation,
                placement=placement)
    # first-layer split: the per-case context term is one small matmul,
    # differentiated by autograd
    ctx = F.linear(geom[:, 0, :], w0[:, n_local:], operators[0].bias).contiguous()
    return mlp_prop_cuda.run(TRUNK, meta, v, jt, ht, v_b, ctx, par[:, 0, :],
                             [lin.weight for lin in linears], [lin.bias for lin in linears[1:]])


neural_ops_prop.launches = 0
neural_ops_prop_backward.launches = 0
# launches (forward, backward) of the modes besides the default one:
# PiGanoFull's trunks take "linear_last_no_reduction"
MODE_COUNTS = {mode: (mlp_prop_cuda.ModeCount(), mlp_prop_cuda.ModeCount())
               for mode in ("linear_last", "no_reduction", "linear_last_no_reduction")}
TRUNK = mlp_prop_cuda.Kernels("neural_op_prop", "neural_ops_prop", True, neural_ops_prop,
                              neural_ops_prop_backward, MODE_COUNTS)
