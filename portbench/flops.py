"""The yardstick: the operations and bytes the benchmarked work needs, and the
card's published peaks.

The rules are those of ``porous_cfd_tpu_torch/tools/roofline.py``
(``mlp_shapes``, ``decoder_shapes``, ``family_shapes``, ``step_flops``) at
commit 4a0a8ad, frozen here; each family's inventory is in
``families/<family>.py``, built from these pieces. Rows a point: ``1 + 2D``
on the analytic paths' internal points (value, J, the Hessian's diagonal),
one on the boundary; a per-case context block is read once a case; a step is
three times its forward (the forward, dX and dW of each layer). The
per-kernel counts follow the same rules and count each input byte read once
and each output byte written once; a pooling backward is counted at the
winner rows these inputs need. The work is the algorithm's, counted once,
whatever passes a kernel makes (the port's 3xTF32 products count one FLOP
each).

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit): TF32
tensor cores 494.7 TFLOP/s, the ceiling of any implementation that keeps
float32 accuracy, and HBM3 3.35 TB/s.
"""
from __future__ import annotations

PEAK_FLOPS = 494.7e12
PEAK_BYTES = 3.35e12
BWD = 3.0
F32 = 4


def vjh_rows(dims: int, batch: int, n_int: int, n_bnd: int) -> int:
    """Rows of a fused (v, J, H) stack: ``1 + 2D`` an internal point, one a
    boundary point."""
    return batch * (n_int * (1 + 2 * dims) + n_bnd)


def mlp_shapes(widths, rows):
    return [(int(rows), k, n) for k, n in zip(widths[:-1], widths[1:])]


def decoder_shapes(widths, rows, cases, n_local):
    return ([(int(rows), n_local, widths[1]), (int(cases), widths[0] - n_local, widths[1])]
            + mlp_shapes(widths[1:], rows))


def shapes_flops(shapes) -> float:
    return sum(2.0 * m * k * n for m, k, n in shapes)


def forward_flops(spec, batch, n_int, n_bnd) -> float:
    """The forward's matmul FLOPs of a batch (the family's
    ``forward_shapes``)."""
    return shapes_flops(spec.family.forward_shapes(spec.cfg, batch, n_int, n_bnd))


def step_flops(spec, batch, n_int, n_bnd) -> float:
    return BWD * forward_flops(spec, batch, n_int, n_bnd)


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card can take: the larger of the operations at
    the TF32 peak and the bytes at HBM bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def macs(widths):
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def pointnet_fwd(widths, batch, rows):
    """Max over ``rows`` rows of an MLP: (FLOPs, bytes)."""
    n_par = macs(widths) + sum(widths[1:])
    return (2.0 * batch * rows * macs(widths),
            F32 * (batch * rows * widths[0] + n_par + 2 * batch * widths[-1]))


def pointnet_bwd(widths, batch, rows, winners, x_grad):
    """Its backward at ``winners`` distinct winning rows: the lower layers
    recomputed there, the last layer at each (case, channel) winner, then
    dW, db and dX."""
    lower = macs(widths[:-1])
    last = widths[-2] * widths[-1] * batch
    n_par = macs(widths) + sum(widths[1:])
    read = batch * rows * widths[0] + n_par + 3 * batch * widths[-1]
    write = n_par + (batch * rows * widths[0] if x_grad else 0)
    return 2.0 * (winners * lower * 3 + last * 3), F32 * (read + write)


def prop_fwd(macs_row, ctx_flops, batch, n_int, n_bnd, n_in, n_ctx, n_par, n_out, dims):
    """A fused (v, J, H) stack over ``n_int`` internal rows (1 + 2D rows a
    point) and ``n_bnd`` value rows: ``macs_row`` multiply-adds a row, the
    per-case context block ``ctx_flops`` once a case."""
    rows = vjh_rows(dims, batch, n_int, n_bnd)
    read = rows * n_in + batch * n_ctx + n_par
    write = batch * (n_int + n_bnd) * n_out + 2 * batch * n_int * n_out * dims
    return 2.0 * rows * macs_row + batch * ctx_flops, F32 * (read + write)


def prop_bwd(fwd, batch, n_int, n_bnd, n_in, n_ctx, n_par, n_out, dims):
    """Its backward: twice the forward's products (dX and dW); reads the
    forward's inputs and the outputs' cotangents, writes the inputs' and
    the parameters' gradients."""
    flops, _ = fwd
    ins = vjh_rows(dims, batch, n_int, n_bnd) * n_in + batch * n_ctx
    outs = batch * (n_int + n_bnd) * n_out + 2 * batch * n_int * n_out * dims
    return 2.0 * flops, F32 * (2 * ins + n_par * 2 + outs)


def pooled_and_prop_calls(pools, stack, dims, batch, n_int, n_bnd, winners, train: bool):
    """[(kernel, FLOPs, bytes)] of max-pooled MLPs and one fused (v, J, H)
    stack: ``pools`` [(name, widths, rows a case, whether dX is formed)],
    ``stack`` (name, (macs a row, context FLOPs a case, inputs a row,
    context a case, parameters, outputs)); with ``train`` each call's
    backward beside it, a pooling's at its ``winners[name]`` rows."""
    calls = []
    for name, widths, n, x_grad in pools:
        calls.append((f"{name}.fwd", *pointnet_fwd(widths, batch, n)))
        if train:
            calls.append((f"{name}.bwd", *pointnet_bwd(widths, batch, n, winners[name],
                                                       x_grad)))
    name, (macs_row, ctx, n_in, n_ctx, n_par, n_out) = stack
    fwd = prop_fwd(macs_row, ctx, batch, n_int, n_bnd, n_in, n_ctx, n_par, n_out, dims)
    calls.append((f"{name}.fwd", *fwd))
    if train:
        calls.append((f"{name}.bwd", *prop_bwd(fwd, batch, n_int, n_bnd, n_in, n_ctx, n_par,
                                               n_out, dims)))
    return calls


def kernel_calls(spec, batch, n_int, n_bnd, winners, train: bool):
    """The port's kernel calls of one training step (``train``) or one
    verbose prediction of ``batch`` cases: [(kernel, FLOPs, bytes)] (the
    family's ``kernel_calls``). ``winners`` maps each pooling to its
    distinct winning rows (a backward's work)."""
    return spec.family.kernel_calls(spec.cfg, batch, n_int, n_bnd, winners, train)
