#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: TF32 off, card name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port from ``porous_cfd_tpu_torch/ops/csrc``
     (one nvcc per source, side by side) into ``build/porous_cfd_tpu_torch``;
  3. kernels: each kernel against its plain PyTorch version on the card at the
     shapes the main paths give it, timed with CUDA events: (a) pointnet_global
     forward and backward at the pipn shape and (b) at the two pi-gano shapes
     (geometry encoder, branch), (c) decoder_prop forward, (d) decoder_prop
     forward and backward with dropout on and off, the kept fraction of a
     full-size mask and the Philox known answers, (e) neural_ops_prop forward
     and backward with dropout on and off and the kept fraction of a full
     trunk mask, (f) sa_neighborhood forward and backward at PIPN++'s level 0
     (static) and level 1 (dynamic) shapes, and with emptied neighbourhoods,
     (g) FPS at PIPN++'s two levels, indices equal to the plain version's,
     (h) pointnet_global and decoder_prop at PIPN++'s shapes;
  4. pipn prediction: verbose prediction (fields + PDE residuals) of 52
     synthetic cases at 1500/1000/700 internal/boundary/observation points, in
     4 batches of 13, through the full-width duct_fixed_boundary ``pipn``
     model; launch counts, finiteness, and one batch against the same module
     on the CPU; the time per batch is the median of 7 runs of the 52 cases;
  5. pipn training: the same model and cases, Adam with the duct example's
     fixed loss weights, batch 13 (4 steps an epoch): launch counts per step,
     finite non-zero gradients, the loss falling, one step on 2 cases
     against the CPU with dropout on, a Trainer.fit with checkpoints, and
     steps/s over whole epochs (the median of 5 runs of 10 epochs);
  6. pi-gano prediction: phase 4 for the full-width duct_variable_boundary
     ``pi-gano`` model on the same cases (its geometry and branch inputs
     attached once per dataset);
  7. pi-gano training: phase 5 for that model, with the example's fixed loss
     weights;
  8. pipn_pp prediction: phase 4 for the full-width duct_fixed_boundary
     ``pipn-pp`` model (its boundary cloud's SetAbstraction chain attached
     once per dataset, FPS on the card), with the card's chain against the
     CPU's and the mean valid neighbours per level;
  9. pipn_pp training: phase 5 for that model.
Each of phases 4-9 sets every launch count to 0 just before it and reads
them just after. The second-to-last lines are the ``{"kernels": [...]}``
JSON and the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the duct_fixed_boundary "pipn" configuration at full width
NU, D, F = 1489.4e-6, 14000.0, 17.11
N_BID = 4
FE_LOCAL = [2, 64, 64]
FE_GLOBAL = [64 + 1 + N_BID, 96, 128, 1024]
SEG = [1024 + 64, 512, 256, 128, 3]
SEG_DROPOUT = [0.05, 0.05, 0, 0]
# the duct_variable_boundary "pi-gano" configuration at full width
# (examples/duct_variable_boundary/train.py, bench.py's "pi_gano")
PG_BRANCH = [8, 128, 352, 352, 352]
PG_GEOMETRY = [2 + N_BID + 1, 64, 176, 176, 176]
PG_LOCAL = [2, 64, 176, 176, 176]
PG_OPERATORS, PG_DROPOUT = 4, [0, 0.1, 0.1, 0]
# the duct_fixed_boundary "pipn-pp" configuration at full width
# (examples/duct_fixed_boundary/train.py:49-61, bench.py's "pipn_pp"); the
# last conv stack has no radius, a trailing GlobalSetAbstraction
PP_LOCAL = [2, 64, 64]
PP_RADIUS, PP_FRACTION, PP_NEIGHBORS = [0.5, 1], [0.5, 0.25], 64
PP_GLOBAL = [[2 + N_BID + 2, 64, 64], [64 + 2, 128, 128], [128 + 2, 256, 1024]]
PP_SEG = [1024 + 64, 378, 128, 3]
PP_DROPOUT = [0.05, 0, 0]
BATCH, N_INT, N_BND, N_OBS, N_CASES = 13, 1500, 1000, 700, 52
PG_N_BRANCH = N_BND // 4 + N_INT        # branch rows: the inlet patch + internal
SEED = 8421
SLICE_RUNS = 7
# both examples' fixed loss weights: continuity, momentum x/y, boundary u x/y
# and p, observations u x/y and p
LOSS_WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
TRAIN_RUNS, TRAIN_EPOCHS = 5, 10

# Tolerance of every comparison on the card: |a - b| <= RTOL * max|ref|.
# The kernels, cuBLAS and the CPU's BLAS sum the 352- to 1024-wide rows in
# different orders (all in f32), the backward kernels add row chunks in
# another order, and pointnet's winner-row scatter adds with atomics, so
# errors scale with the largest magnitude.
RTOL = 1e-4

# published H100 peaks (NVIDIA data sheets): f32 outside the tensor cores and
# HBM bandwidth, by product name
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60.0e12, 3.9e12), "": (67.0e12, 3.35e12)}

REPLACES = {
    "pointnet_global": "porous_cfd_tpu/ops/pointnet_pallas.py:37 (_fwd_kernel; "
                       "pallas_call at :125)",
    "pointnet_global_bwd": "porous_cfd_tpu/ops/pointnet_pallas.py:70 (_bwd_kernel; "
                           "pallas_call at :146)",
    "decoder_prop": "porous_cfd_tpu/ops/decoder_pallas.py:168 (_fwd_kernel; "
                    "pallas_call at :433), decoupled mode, with dropout",
    "decoder_prop_bwd": "porous_cfd_tpu/ops/decoder_pallas.py:228 (_bwd_kernel; "
                        "pallas_call at :473), decoupled mode, with dropout",
    "neural_ops_prop": "porous_cfd_tpu/ops/neural_op_pallas.py:107 (_fwd_kernel; "
                       "pallas_call at :357), with dropout",
    "neural_ops_prop_bwd": "porous_cfd_tpu/ops/neural_op_pallas.py:154 (_bwd_kernel; "
                           "pallas_call at :391), with dropout",
    "sa_neighborhood": "porous_cfd_tpu/ops/sa_pallas.py:67 (_fwd_kernel; pallas_call at "
                       ":284 through _build_static, the static variant, and at :215 through "
                       "_build, the dynamic one)",
    "sa_neighborhood_bwd": "porous_cfd_tpu/ops/sa_pallas.py:107 (_bwd_kernel; pallas_call "
                           "at :304, static, and :235, dynamic)",
    "farthest_point_sampling": "porous_cfd_tpu/ops/fps_pallas.py:26 (_fps_kernel; "
                               "pallas_call at :76)",
}
SOURCES = {"pointnet_global": "porous_cfd_tpu_torch/ops/csrc/pointnet_global.cu",
           "pointnet_global_bwd": "porous_cfd_tpu_torch/ops/csrc/pointnet_global.cu",
           "decoder_prop": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "decoder_prop_bwd": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "neural_ops_prop": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "neural_ops_prop_bwd": "porous_cfd_tpu_torch/ops/csrc/neural_op_prop.cu",
           "sa_neighborhood": "porous_cfd_tpu_torch/ops/csrc/sa_neighborhood.cu",
           "sa_neighborhood_bwd": "porous_cfd_tpu_torch/ops/csrc/sa_neighborhood.cu",
           "farthest_point_sampling": "porous_cfd_tpu_torch/ops/csrc/fps.cu"}


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key and key in name:
            return val
    return PEAKS[""]


def time_ms(torch, fn, n=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_err(a, ref):
    """(max |a - ref|, allowed) for one tensor pair."""
    err = (a.double() - ref.double()).abs().max().item()
    return err, RTOL * max(ref.double().abs().max().item(), 1e-30)


def check_close(name, pairs, quiet=False):
    worst = 0.0
    for label, a, ref in pairs:
        if tuple(a.shape) != tuple(ref.shape):
            fail(f"{name} {label}: shape {tuple(a.shape)} != {tuple(ref.shape)}")
        if not bool(a.isfinite().all()):
            fail(f"{name} {label}: non-finite values")
        err, allowed = max_err(a, ref)
        if not quiet:
            log(f"  {name} {label}: max|err| {err:.3e} (allowed {allowed:.3e})")
        if err > allowed:
            fail(f"{name} {label}: max|err| {err:.3e} > {allowed:.3e}")
        worst = max(worst, err)
    if quiet:
        log(f"  {name}: {len(pairs)} tensors, worst max|err| {worst:.3e}")
    return worst


def bound(flops, nbytes, peak_flops, peak_bw):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes_of(tensors) -> int:
    return sum(4 * t.numel() for t in tensors if t is not None)


def entry(name, err, ms, plain_ms, flops, nbytes, pk, **extra):
    b_ms, b_by = bound(flops, nbytes, *pk)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
            "tolerance": f"{RTOL} * max|ref|", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "flop": flops, "bytes": nbytes, **extra}


def shape_timing(res, pk):
    """ms, plain ms and bound of one kernel check at one shape."""
    b_ms, b_by = bound(res["flops"], res["nbytes"], *pk)
    return {"ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "flop": res["flops"], "bytes": res["nbytes"],
            "max_abs_err": res["err"]}


def adam_first_step_spread(g, tau, lr, eps):
    """The most Adam's first step lr g / (|g| + eps) changes when each
    gradient moves by up to tau (float64)."""
    g = g.double()

    def u(x):
        return lr * x / (x.abs() + eps)

    return (u(g + tau) - u(g)).abs().maximum((u(g - tau) - u(g)).abs())


def check_pointnet(layers, n_pts, x_grad, gen, tag):
    """pointnet_global forward (max and argmax) and backward against the
    plain version at (BATCH, n_pts, layers[0]), timed. Returns the forward's
    and the backward's (err, ms, plain ms, flops, bytes)."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.ops import pointnet_cuda
    from porous_cfd_tpu_torch.physics import analytic
    dev = torch.device("cuda", 0)
    name = f"pointnet_global {tag}"
    mlp = MLP(layers, activation="silu", generator=gen).to(dev)
    x = torch.randn((BATCH, n_pts, layers[0]), generator=gen).to(dev)
    lin = mlp.linears
    with torch.no_grad():
        m_k, a_k = pointnet_cuda.pointnet_global(lin, x, "silu")
        torch.cuda.synchronize()
        m_p, a_p = pointnet_cuda.pointnet_global_plain(lin, x, "silu")
        torch.cuda.synchronize()
        err_f = check_close(name, [("max", m_k, m_p)])
        g_full = analytic.mlp_value(lin, x, "silu")
        top2 = torch.topk(g_full, 2, dim=-2).values
        decided = (top2[:, 0] - top2[:, 1]) > RTOL * m_p.abs().max()
        mismatch = int(((a_k[:, 0] != a_p[:, 0]) & decided).sum())
        log(f"  {name} argmax: {int(decided.sum())} of {decided.numel()} "
            f"channels decided, {mismatch} disagree")
        if mismatch:
            fail(f"{name} argmax disagrees with the plain version")
        del g_full, top2
        ms_f = time_ms(torch, lambda: pointnet_cuda.pointnet_global(lin, x, "silu"))
        ms_fp = time_ms(torch, lambda: pointnet_cuda.pointnet_global_plain(lin, x, "silu"))
    macs = sum(a * b for a, b in zip(layers[:-1], layers[1:]))
    fwd = {"err": err_f, "ms": ms_f, "plain_ms": ms_fp,
           "flops": 2.0 * BATCH * n_pts * macs,
           "nbytes": 4 * (x.numel() + sum(p.numel() for p in mlp.parameters())
                          + 2 * BATCH * layers[-1])}

    # backward on the kernel's winners (near-ties may legitimately pick
    # another row than torch.max); the pi-gano inputs need no gradient
    params = list(mlp.parameters())
    xg = x.clone().requires_grad_(x_grad)
    wrt = ([xg] if x_grad else []) + params
    m_k, a_k = pointnet_cuda.pointnet_global(lin, xg, "silu")
    cot = torch.randn((BATCH, 1, layers[-1]), generator=gen).to(dev)
    got = torch.autograd.grad((m_k * cot).sum(), wrt)
    torch.cuda.synchronize()
    m_ref = pointnet_cuda.pointnet_global_at(lin, xg, "silu", a_k)
    loss_ref = (m_ref * cot).sum()
    ref = torch.autograd.grad(loss_ref, wrt, retain_graph=True)
    names = (["dx"] if x_grad else []) + [f"d{n}" for n, _ in mlp.named_parameters()]
    err_b = check_close(f"{name} backward", list(zip(names, got, ref)))
    with torch.no_grad():
        _, arg_s, z_s, ws_t = pointnet_cuda._forward([lin_.weight for lin_ in lin],
                                                     [lin_.bias for lin_ in lin], x, "silu",
                                                     stash=True)
    w_g = [lin_.weight.detach() for lin_ in lin]
    b_g = [lin_.bias.detach() for lin_ in lin]
    dm = cot.contiguous()
    ms_b = time_ms(torch, lambda: pointnet_cuda.pointnet_global_backward(
        w_g, ws_t, b_g, x, "silu", z_s, arg_s, dm))
    ms_bp = time_ms(torch, lambda: torch.autograd.grad(loss_ref, wrt, retain_graph=True))
    # the work these inputs need: recompute the lower layers at the winner
    # rows, z at each (case, channel) winner, then dW, db and the scatter of
    # the last layer and dX, dW of the lower layers at the winners
    winners = sum(int(torch.unique(a_k[b, 0]).numel()) for b in range(BATCH))
    lower = sum(a * b for a, b in zip(layers[:-2], layers[1:-1]))
    last = layers[-2] * layers[-1] * BATCH
    bwd = {"err": err_b, "ms": ms_b, "plain_ms": ms_bp,
           "flops": 2.0 * (winners * lower * 3 + last * 3),
           "nbytes": nbytes_of([x, *params, m_k, cot, *got]) + 4 * a_k.numel(),
           "winner_rows": winners}
    return fwd, bwd


def check_trunk(gen):
    """neural_ops_prop forward and backward against the plain version at the
    pi-gano envelope, dropout on and off, timed. Returns the forward's and
    the backward's (err, ms, plain ms, flops, bytes, extra timings)."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import NeuralOperatorSequential, dense
    from porous_cfd_tpu_torch.ops import dropout, mlp_prop_cuda, neural_op_cuda
    dev = torch.device("cuda", 0)
    n_local, f = PG_LOCAL[-1], PG_BRANCH[-1]
    ops = NeuralOperatorSequential(PG_OPERATORS, f, PG_DROPOUT, "silu", generator=gen).to(dev)
    red = dense(f, 3, gen).to(dev)
    linears = ops.linears + [red]
    params = [p for lin in linears for p in (lin.weight, lin.bias)]

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v, v_b = rnd(BATCH, N_INT, n_local), rnd(BATCH, N_BND, n_local)
    jt, ht = rnd(BATCH, 2, N_INT, n_local, scale=0.5), rnd(BATCH, 2, N_INT, n_local, scale=0.5)
    geom = rnd(BATCH, 1, PG_GEOMETRY[-1])
    par = (torch.rand((BATCH, 1, f), generator=gen) + 0.5).to(dev)

    seed = neural_op_cuda.trunk_seed(SEED)
    mask = dropout.keep_mask(seed, 1, BATCH, N_INT + N_BND, f, 0.1, dev)
    kept = float((mask > 0).float().mean())
    log(f"  kept fraction of a ({BATCH}, {N_INT + N_BND}, {f}) trunk mask at rate 0.1: "
        f"{kept:.6f}")
    if abs(kept - 0.9) > 0.002:
        fail(f"trunk kept fraction {kept} not within 0.9 +- 0.002")
    del mask

    leaves = [t.clone().requires_grad_() for t in (v, jt, ht, v_b, geom, par)]
    names = ["dv", "djt", "dht", "dv_b", "dgeom", "dpar"] + [
        f"d{n}" for n, _ in ops.named_parameters()] + [f"dreduction.{n}" for n, _ in
                                                       red.named_parameters()]
    errs, timing = [], {}
    for drop in (PG_DROPOUT, None):
        tag = "dropout 0.1" if drop else "no dropout"
        dargs = (ops.linears, red, n_local, *leaves, "silu", drop, drop is None, SEED)
        out_k = neural_op_cuda.neural_ops_prop(*dargs)
        cots = [torch.randn(o.shape, generator=gen).to(dev) for o in out_k]
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out_k, cots)),
                                  leaves + params)
        torch.cuda.synchronize()
        out_p = neural_op_cuda.neural_ops_prop_plain(*dargs)
        errs.append(check_close(f"neural_ops_prop forward, {tag}",
                                list(zip(("v", "jac", "lap"), out_k, out_p))))
        loss_ref = sum((o * c).sum() for o, c in zip(out_p, cots))
        ref = torch.autograd.grad(loss_ref, leaves + params, retain_graph=True)
        errs.append(check_close(f"neural_ops_prop backward, {tag}",
                                list(zip(names, got, ref))))
        with torch.no_grad():
            timing[f"ms_{tag}"] = time_ms(torch, lambda: neural_op_cuda.neural_ops_prop(*dargs))
            timing[f"plain_ms_{tag}"] = time_ms(
                torch, lambda: neural_op_cuda.neural_ops_prop_plain(*dargs), n=5)
        if drop:
            timing["plain_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                loss_ref, leaves + params, retain_graph=True), n=5)
            widths = (n_local,) + (f,) * PG_OPERATORS + (3,)
            rates = mlp_prop_cuda.dropout_rates(drop, PG_OPERATORS, False) + (0.0,)
            meta = mlp_prop_cuda.Meta(n_local, "silu", rates, seed, 2, BATCH, N_INT, N_BND,
                                      widths)
            with torch.no_grad():
                weights = [lin.weight.detach() for lin in linears]
                biases = [lin.bias.detach() for lin in linears[1:]]
                ctx = torch.nn.functional.linear(
                    geom[:, 0], linears[0].weight[:, n_local:], linears[0].bias).contiguous()
                par2 = par[:, 0].contiguous()
                _, _, _, stashes = mlp_prop_cuda.forward(neural_op_cuda.TRUNK, meta, v, jt, ht,
                                                         v_b, ctx, weights, biases, True, par2)
                gv, gj, gh = (c.contiguous() for c in cots)
                timing["bwd_ms"] = time_ms(torch, lambda: neural_op_cuda.neural_ops_prop_backward(
                    meta, weights, par2, stashes, gv, gj, gh))
                meta_int = mlp_prop_cuda.Meta(n_local, "silu", rates, seed, 2, BATCH, N_INT, 0,
                                              widths)
                gv_int = gv[:, :N_INT].contiguous()
                timing["bwd_internal_ms"] = time_ms(
                    torch, lambda: neural_op_cuda.neural_ops_prop_backward(
                        meta_int, weights, par2, stashes[:2], gv_int, gj, gh))
            bwd_bytes = nbytes_of([v, jt, ht, v_b, geom, par, *params, *cots, *got])
            del stashes
        del out_k, out_p, got, ref, loss_ref
    with torch.no_grad():
        args_int = (ops.linears, red, n_local, v, jt, ht, None, geom, par, "silu")
        timing["ms_internal_launch_no_dropout"] = time_ms(
            torch, lambda: neural_op_cuda.neural_ops_prop(*args_int))
    macs = n_local * f + (PG_OPERATORS - 1) * f * f + f * 3
    rows = BATCH * N_INT * 5 + BATCH * N_BND
    flops = 2.0 * rows * macs + 2.0 * BATCH * PG_GEOMETRY[-1] * f
    fwd_bytes = nbytes_of([v, jt, ht, v_b, geom, par, *params]) + 4 * (
        BATCH * (N_INT + N_BND) * 3 + 2 * BATCH * N_INT * 3 * 2)
    fwd = {"err": max(errs[0], errs[2]), "ms": timing["ms_dropout 0.1"],
           "plain_ms": timing["plain_ms_dropout 0.1"], "flops": flops, "nbytes": fwd_bytes,
           "extra": {"ms_no_dropout": timing["ms_no dropout"],
                     "plain_ms_no_dropout": timing["plain_ms_no dropout"],
                     "ms_internal_launch_no_dropout":
                         timing["ms_internal_launch_no_dropout"]}}
    bwd = {"err": max(errs[1], errs[3]), "ms": timing["bwd_ms"],
           "plain_ms": timing["plain_bwd_ms"], "flops": 2.0 * flops, "nbytes": bwd_bytes,
           "extra": {"ms_internal_launch": timing["bwd_internal_ms"]}}
    return fwd, bwd


def check_decoder(seg, seg_dropout, gen, tag):
    """decoder_prop against the plain version at ``seg`` widths over BATCH
    cases of N_INT internal and N_BND boundary rows: forward without dropout
    (both launches, and the internal launch alone), then forward and
    backward with ``seg_dropout`` and without, timed. Returns the forward's
    and the backward's (err, ms, plain ms, flops, bytes, extra timings)."""
    import torch
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.ops import decoder_cuda, mlp_prop_cuda
    dev = torch.device("cuda", 0)
    dec = MLP(seg, seg_dropout, "silu", last_activation=False, generator=gen).to(dev)
    lin_d = dec.linears
    n_local, dims = FE_LOCAL[-1], 2

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v = rnd(BATCH, N_INT, n_local)
    jt = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    ht = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    v_b = rnd(BATCH, N_BND, n_local)
    g = rnd(BATCH, 1, seg[0] - n_local)
    args = (lin_d, n_local, v, jt, ht, v_b, g, "silu")
    with torch.no_grad():
        out_k = decoder_cuda.decoder_prop(*args)
        torch.cuda.synchronize()
        out_p = decoder_cuda.decoder_prop_plain(*args)
        torch.cuda.synchronize()
        err_dec = check_close(f"decoder_prop {tag}", list(zip(("v", "jac", "lap"), out_k,
                                                              out_p)))
        ms_dec = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args))
        ms_dec_p = time_ms(torch, lambda: decoder_cuda.decoder_prop_plain(*args))
        args_int = (lin_d, n_local, v, jt, ht, None, g, "silu")
        ms_dec_int = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args_int))
    macs_d = n_local * seg[1] + sum(a * b for a, b in zip(seg[1:-1], seg[2:]))
    rows = BATCH * N_INT * (1 + 2 * dims) + BATCH * N_BND
    flops = 2.0 * rows * macs_d + 2.0 * BATCH * (seg[0] - n_local) * seg[1]
    fwd_bytes = nbytes_of([v, jt, ht, v_b, g, *dec.parameters(), *out_k])
    del out_k, out_p

    leaves = [t.clone().requires_grad_() for t in (v, jt, ht, v_b, g)]
    params_d = list(dec.parameters())
    names = ["dv", "djt", "dht", "dv_b", "dg"] + [f"d{n}" for n, _ in dec.named_parameters()]
    errs, timing = [], {}
    rate = max(seg_dropout)
    for drop in (seg_dropout, None):
        dtag = f"dropout {rate}" if drop else "no dropout"
        dargs = (lin_d, n_local, *leaves, "silu", drop, drop is None, SEED)
        out_k = decoder_cuda.decoder_prop(*dargs)
        cots = [torch.randn(o.shape, generator=gen).to(dev) for o in out_k]
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out_k, cots)),
                                  leaves + params_d)
        torch.cuda.synchronize()
        out_p = decoder_cuda.decoder_prop_plain(*dargs)
        errs.append(check_close(f"decoder_prop {tag} forward, {dtag}",
                                list(zip(("v", "jac", "lap"), out_k, out_p))))
        loss_ref = sum((o * c).sum() for o, c in zip(out_p, cots))
        ref = torch.autograd.grad(loss_ref, leaves + params_d, retain_graph=True)
        errs.append(check_close(f"decoder_prop {tag} backward, {dtag}",
                                list(zip(names, got, ref))))
        if drop:
            with torch.no_grad():
                timing["ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop(*dargs))
                timing["plain_ms"] = time_ms(torch,
                                             lambda: decoder_cuda.decoder_prop_plain(*dargs))
            timing["plain_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                loss_ref, leaves + params_d, retain_graph=True))
            meta = mlp_prop_cuda.Meta(n_local, "silu", tuple(float(r) for r in drop), SEED,
                                      dims, BATCH, N_INT, N_BND, tuple([n_local] + seg[1:]))
            with torch.no_grad():
                weights = [p.detach() for p in (lin.weight for lin in lin_d)]
                ctx = torch.nn.functional.linear(g[:, 0], lin_d[0].weight[:, n_local:],
                                                 lin_d[0].bias).contiguous()
                _, _, _, stashes = mlp_prop_cuda.forward(
                    decoder_cuda.DECODER, meta, v, jt, ht, v_b, ctx, weights,
                    [lin.bias.detach() for lin in lin_d[1:]], True)
                gv, gj, gh = (c.contiguous() for c in cots)
                timing["bwd_ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop_backward(
                    meta, weights, stashes, gv, gj, gh))
                gj_none = torch.zeros_like(gj)
                timing["bwd_internal_ms"] = time_ms(
                    torch, lambda: decoder_cuda.decoder_prop_backward(
                        mlp_prop_cuda.Meta(n_local, "silu", meta.rates, SEED, dims, BATCH,
                                           N_INT, 0, meta.widths),
                        weights, stashes[:2], gv[:, :N_INT].contiguous(), gj_none, gj_none))
            bwd_bytes = nbytes_of([v, jt, ht, v_b, g, *params_d, *cots, *got])
            del stashes
        del out_k, out_p, got, ref, loss_ref
    fwd = {"err": max(err_dec, errs[0], errs[2]), "ms": timing["ms"],
           "plain_ms": timing["plain_ms"], "flops": flops, "nbytes": fwd_bytes,
           "extra": {"ms_no_dropout": ms_dec, "plain_ms_no_dropout": ms_dec_p,
                     "ms_internal_launch_no_dropout": ms_dec_int}}
    bwd = {"err": max(errs[1], errs[3]), "ms": timing["bwd_ms"],
           "plain_ms": timing["plain_bwd_ms"], "flops": 2.0 * flops, "nbytes": bwd_bytes,
           "extra": {"ms_internal_launch": timing["bwd_internal_ms"]}}
    return fwd, bwd


def sa_winners(linears, x, idx, mask, rel, xg):
    """(winners, winner rows) of one sa_neighborhood level: the (case,
    centroid, channel) maxima of the non-empty neighbourhoods, and the
    distinct neighbour rows that hold one or more of them. The rows are the
    plain version's first maximal valid neighbours, which the kernels pick
    too except where two rows tie within rounding; the count sizes the
    backward's work, it is not compared."""
    import torch
    import torch.nn.functional as F
    from porous_cfd_tpu_torch.physics import analytic
    with torch.no_grad():
        b_cases, n_cent, k = mask.shape
        w0, b0 = linears[0].weight, linears[0].bias
        if xg is not None:
            h = F.linear(torch.cat([xg.reshape(b_cases, n_cent, k, -1), rel], dim=-1), w0, b0)
        else:
            f_in = x.shape[-1]
            p = F.linear(x, w0[:, :f_in], b0)
            flat = idx.reshape(b_cases, -1)
            h = torch.gather(p, 1, flat[..., None].expand(*flat.shape, p.shape[-1])).reshape(
                b_cases, n_cent, k, -1) + F.linear(rel, w0[:, f_in:])
        h = analytic.mlp_value(linears[1:], analytic.ACTIVATIONS["silu"](h), "silu")
        h = h.masked_fill(~mask[..., None], torch.finfo(h.dtype).min)
        arg = h.max(dim=2).indices                                  # (B, C, F)
        hit = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
        hit.scatter_(2, arg, True)
        full = mask.any(-1)
        return int(full.sum()) * h.shape[-1], int((hit & full[..., None]).sum())


def sa_backward_flops(widths, flops_f, winners, winner_rows):
    """The backward's work as pointnet_global_bwd's is counted: the forward
    over every valid row (it finds the winners), then, from the top, the
    last layer's dW, db and GZ W^T at each (centroid, channel) winner, and
    each lower layer's dW, db (the dynamic layer 0: dP's scatter) and, above
    layer 0, GZ W^T at the distinct winner rows."""
    flops = flops_f
    n_layers = len(widths) - 1
    for j in range(n_layers - 1, -1, -1):
        if j == n_layers - 1:
            macs, outs = winners * widths[j], winners
        else:
            macs, outs = winner_rows * widths[j] * widths[j + 1], winner_rows * widths[j + 1]
        flops += 2.0 * macs + outs
        if j > 0:
            flops += 2.0 * macs
    return flops


def check_sa(model, chain, gen, pk):
    """sa_neighborhood against the plain version on the card at PIPN++'s two
    levels: level 0 static on ``chain`` (the model's precompute of BATCH
    cases: xg, rel, mask), level 1 dynamic on random level-0 features with
    the chain's idx, rel and mask; forward and backward (every parameter
    gradient, and dx through dP), and level 1 again with every seventh
    neighbourhood emptied (0 out, no gradient). Timed with CUDA events; the
    work counts the valid neighbour rows. Returns (fwd, bwd) dicts with the
    two levels summed and each level's numbers in ``extra``; the backward's
    work counts the winners as pointnet_global_bwd's does."""
    import torch
    import torch.nn.functional as F
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
    from porous_cfd_tpu_torch.ops import sa_cuda
    dev = torch.device("cuda", 0)
    seq = model.module.feature_extract.global_feature
    nbrs = extract_sa_neighbors(chain, len(PP_RADIUS))
    res = {"fwd": {}, "bwd": {}}
    for i, tag in ((0, "level 0 static"), (1, "level 1 dynamic")):
        lin = getattr(seq, f"sa_{i}").conv_mlp.linears
        _, idx, mask, rel, _ = nbrs[i][:5]
        static = i == 0
        xg = nbrs[0][5] if static else None
        f_in = lin[0].weight.shape[1] - rel.shape[-1]
        x = None
        if not static:
            n_src = nbrs[i - 1][0].shape[1]
            x = torch.randn((BATCH, n_src, f_in), generator=gen).to(dev).requires_grad_()
        params = [t for layer in lin for t in (layer.weight, layer.bias)]
        wrt = params + ([] if static else [x])
        names = [f"d{n}" for n, _ in getattr(seq, f"sa_{i}").conv_mlp.named_parameters()]
        names += [] if static else ["dx"]
        out = sa_cuda.sa_neighborhood(lin, x, idx, mask, rel, "silu", xg)
        cot = torch.randn(out.shape, generator=gen).to(dev)
        got = torch.autograd.grad((out * cot).sum(), wrt)
        torch.cuda.synchronize()
        ref_out = sa_cuda.sa_neighborhood_plain(lin, x, idx, mask, rel, "silu", xg)
        err_f = check_close(f"sa_neighborhood {tag}", [("out", out.detach(), ref_out.detach())])
        loss_ref = (ref_out * cot).sum()
        ref = torch.autograd.grad(loss_ref, wrt, retain_graph=True)
        err_b = check_close(f"sa_neighborhood {tag} backward", list(zip(names, got, ref)))
        with torch.no_grad():
            ms_f = time_ms(torch, lambda: sa_cuda.sa_neighborhood(lin, x, idx, mask, rel, "silu",
                                                                  xg))
            ms_fp = time_ms(torch, lambda: sa_cuda.sa_neighborhood_plain(lin, x, idx, mask, rel,
                                                                         "silu", xg))
            if static:
                call = sa_cuda.SaCall("silu", [t.weight for t in lin], [t.bias for t in lin],
                                      rel, mask, xg=xg)
            else:
                p = F.linear(x, lin[0].weight[:, :f_in], lin[0].bias).contiguous()
                call = sa_cuda.SaCall("silu", [lin[0].weight[:, f_in:]] + [t.weight for t in
                                                                            lin[1:]],
                                      [None] + [t.bias for t in lin[1:]], rel, mask, p=p,
                                      idx=idx)
            ms_b = time_ms(torch, lambda: sa_cuda.sa_neighborhood_backward(call, cot))
        ms_bp = time_ms(torch, lambda: torch.autograd.grad(loss_ref, wrt, retain_graph=True),
                        n=5)
        # the forward's work: the valid neighbour rows through the first
        # layer on [xg || rel] (static) or rel (dynamic, P's row is added)
        # and the other layers; the backward's as pointnet_global_bwd's
        rows = int(mask.sum())
        widths = call.widths
        macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        flops_f = 2.0 * rows * macs + (0.0 if static else rows * widths[1])
        winners, winner_rows = sa_winners(lin, x, idx, mask, rel, xg)
        flops_b = sa_backward_flops(widths, flops_f, winners, winner_rows)
        inputs = [xg if static else call.tensors[3], rel, *params]
        side = mask.numel() + (0 if static else 8 * idx.numel())
        bytes_f = nbytes_of(inputs + [out]) + side
        bytes_b = nbytes_of(inputs + [cot, *got]) + side
        mean_nbrs = float(mask.sum(-1).float().mean())
        shape = {"centroids": list(mask.shape[:2]), "neighbors": mask.shape[2],
                 "widths": widths, "valid_rows": rows, "mean_valid_neighbors": mean_nbrs}
        shapes = {"fwd": shape, "bwd": {**shape, "winners": winners,
                                        "winner_rows": winner_rows}}
        for key, err, ms, pms, fl, by in (("fwd", err_f, ms_f, ms_fp, flops_f, bytes_f),
                                          ("bwd", err_b, ms_b, ms_bp, flops_b, bytes_b)):
            res[key][tag] = {**shapes[key], **shape_timing({"err": err, "ms": ms,
                                                            "plain_ms": pms, "flops": fl,
                                                            "nbytes": by}, pk)}
        log(f"  sa_neighborhood {tag}: {rows} valid rows, {mean_nbrs:.2f} valid neighbours "
            f"per centroid, {winner_rows} distinct winner rows; forward {ms_f:.4f} ms (plain "
            f"{ms_fp:.4f}), backward {ms_b:.4f} ms (plain {ms_bp:.4f})")
        if not static:  # every seventh neighbourhood emptied
            empty = mask.clone()
            empty[:, ::7] = False
            out_e = sa_cuda.sa_neighborhood(lin, x, idx, empty, rel, "silu")
            got_e = torch.autograd.grad((out_e * cot).sum(), wrt)
            ref_e = sa_cuda.sa_neighborhood_plain(lin, x, idx, empty, rel, "silu")
            ref_ge = torch.autograd.grad((ref_e * cot).sum(), wrt)
            check_close("sa_neighborhood emptied", [("out", out_e.detach(), ref_e.detach())]
                        + list(zip(names, got_e, ref_ge)), quiet=True)
            if not bool((out_e.detach()[:, ::7] == 0).all()):
                fail("sa_neighborhood: an empty neighbourhood did not give 0")
            log("  sa_neighborhood: every seventh level-1 neighbourhood emptied gives 0")
        del out, got, ref, ref_out, loss_ref, call
    summed = []
    for key in ("fwd", "bwd"):
        levels = res[key].values()
        summed.append({"err": max(v["max_abs_err"] for v in levels),
                       "ms": sum(v["ms"] for v in levels),
                       "plain_ms": sum(v["plain_ms"] for v in levels),
                       "flops": sum(v["flop"] for v in levels),
                       "nbytes": sum(v["bytes"] for v in levels),
                       "extra": {"levels": res[key]}})
    return summed


def check_fps(data, levels):
    """FPS on the card at PIPN++'s two levels over every case of ``data``:
    its boundary cloud, then the level-0 centroids. The kernel's indices
    must EQUAL the plain version's. Returns (ms, plain ms, flops, bytes and
    each level's numbers) summed over the levels."""
    import torch
    from porous_cfd_tpu_torch.models.neighbors import gather_points
    from porous_cfd_tpu_torch.ops import fps_cuda
    dev = torch.device("cuda", 0)
    pos = data.data[:, N_INT:, data.column_indices("C")].contiguous().to(dev)
    out = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "nbytes": 0, "extra": {}}
    for i, n_samples in enumerate(levels):
        cent = fps_cuda.farthest_point_sampling(pos, n_samples)
        plain = fps_cuda.farthest_point_sampling_plain(pos, n_samples)
        torch.cuda.synchronize()
        if not torch.equal(cent, plain):
            fail(f"FPS level {i}: {int((cent != plain).sum())} of {cent.numel()} picks differ "
                 "from the plain version")
        ms = time_ms(torch, lambda: fps_cuda.farthest_point_sampling(pos, n_samples))
        pms = time_ms(torch, lambda: fps_cuda.farthest_point_sampling_plain(pos, n_samples),
                      n=3, warmup=1)
        b, n, d = pos.shape
        # per pick and point: d subtractions, d products, d sums, a min and
        # a compare
        flops = float(b * (n_samples - 1) * n * (3 * d + 2))
        nbytes = 4 * pos.numel() + 8 * cent.numel()
        log(f"  FPS level {i}: ({b}, {n}, {d}) -> {n_samples}, indices equal to the plain "
            f"version's; {ms:.4f} ms (plain {pms:.2f} ms)")
        out["extra"][f"level_{i}"] = {"input": [b, n, d], "samples": n_samples, "ms": ms,
                                      "plain_ms": pms, "flop": flops, "bytes": nbytes}
        for key, val in (("ms", ms), ("plain_ms", pms), ("flops", flops), ("nbytes", nbytes)):
            out[key] += val
        pos = gather_points(pos, cent)
    return out


def check_chain(model, cpu_model, data):
    """The boundary chain of every case of ``data`` on the card (FPS kernel,
    cuBLAS distances) against the CPU's (plain FPS, the CPU's BLAS): the
    centroids must be equal; the (centroid, slot) entries whose index or
    mask differ are counted (a point within about 1e-6 of r may fall on
    either side), and the float entries compared where the indices agree.
    Also the mean valid neighbours per level."""
    import torch
    dev = torch.device("cuda", 0)
    card = {k: v.cpu() for k, v in model.neighbor_precompute(data.to(dev)).items()}
    cpu = cpu_model.neighbor_precompute(data)
    report = {}
    for i in range(len(PP_RADIUS)):
        if not torch.equal(card[f"_sa_cent_{i}"], cpu[f"_sa_cent_{i}"]):
            fail(f"chain level {i}: the card's centroids differ from the CPU's")
        differ = ((card[f"_sa_idx_{i}"] != cpu[f"_sa_idx_{i}"])
                  | (card[f"_sa_mask_{i}"] != cpu[f"_sa_mask_{i}"]))
        same = ~differ.any(-1)                       # centroids with equal neighbourhoods
        rel_err = float((card[f"_sa_rel_{i}"] - cpu[f"_sa_rel_{i}"])[same].abs().max())
        posc_err = float((card[f"_sa_posc_{i}"] - cpu[f"_sa_posc_{i}"]).abs().max())
        mean_nbrs = float(card[f"_sa_mask_{i}"].sum(-1).float().mean())
        report[f"level_{i}"] = {"centroids": list(card[f"_sa_cent_{i}"].shape),
                                "entries_differing": int(differ.sum()),
                                "entries": differ.numel(), "rel_max_abs_diff": rel_err,
                                "posc_max_abs_diff": posc_err,
                                "mean_valid_neighbors": mean_nbrs}
        log(f"  chain level {i}: centroids equal; {int(differ.sum())} of {differ.numel()} "
            f"(centroid, slot) entries differ between the card and the CPU; rel within "
            f"{rel_err:.2e}, posc within {posc_err:.2e}; {mean_nbrs:.2f} valid neighbours per "
            f"centroid (cap {PP_NEIGHBORS})")
    same0 = (card["_sa_idx_0"] == cpu["_sa_idx_0"]) & (card["_sa_mask_0"] == cpu["_sa_mask_0"])
    report["xg_max_abs_diff"] = float((card["_sa_xg_0"] - cpu["_sa_xg_0"])
                                      .reshape(*same0.shape, -1)[same0].abs().max())
    log(f"  chain level 0: xg within {report['xg_max_abs_diff']:.2e} where the entries agree")
    return report


def prediction_phase(label, model, cpu_model, data, scalers, counters, want, name, smi,
                     per_evaluate=None, share_aux=False):
    """Verbose prediction of every case in batches of BATCH through
    ``evaluate``: launch counts per batch (``want``; ``per_evaluate`` more per
    call, from its ``attach_neighbors``), shapes, finiteness, the median time
    per batch of SLICE_RUNS runs, and one batch against the same module on
    the CPU, which builds its own per-dataset aux unless ``share_aux``."""
    import torch
    from porous_cfd_tpu_torch.pipelines.evaluation import evaluate
    from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
    dev = model.device
    evaluate(model, gather_cases(data, torch.arange(BATCH)), BATCH, scalers)  # warm-up

    for c in counters.values():
        c.launches = 0
    ev = evaluate(model, data, BATCH, scalers)
    counts = {k: c.launches for k, c in counters.items()}
    n_batches = len(ev.predictions)
    log(f"{label} prediction: {n_batches} batches, launches {counts}")
    per_evaluate = per_evaluate or {}
    if counts != {k: n * n_batches + per_evaluate.get(k, 0) for k, n in want.items()}:
        fail(f"{label} launch counts {counts} != {want} per batch over {n_batches} batches "
             f"and {per_evaluate} per evaluate")
    for i, (pred, extras) in enumerate(ev.predictions):
        if tuple(pred.data.shape) != (BATCH, N_INT + N_BND, 3):
            fail(f"{label} batch {i}: fields shape {tuple(pred.data.shape)}")
        if tuple(extras.data.shape) != (BATCH, N_INT, 3):
            fail(f"{label} batch {i}: residual shape {tuple(extras.data.shape)}")
        if not (bool(pred.data.isfinite().all()) and bool(extras.data.isfinite().all())):
            fail(f"{label} batch {i}: non-finite fields or residuals")
    for key, val in ev.results.items():
        if val is not None and not bool(torch.isfinite(torch.as_tensor(val)).all()):
            fail(f"{label} evaluation result {key!r} is not finite")
    # the host-clock window is short, so the run is repeated and the median
    # reported with the spread
    runs_ms = sorted(t / n_batches * 1e3 for t in [ev.inference_time] + [
        evaluate(model, data, BATCH, scalers).inference_time
        for _ in range(SLICE_RUNS - 1)])
    ms_batch = statistics.median(runs_ms)
    cases_s = BATCH / ms_batch * 1e3
    log(f"{label} prediction: verbose prediction {ms_batch:.3f} ms per batch of {BATCH} "
        f"(median of {SLICE_RUNS} runs, {runs_ms[0]:.3f} to {runs_ms[-1]:.3f}), "
        f"{cases_s:.1f} cases/s ({name}; {smi})")

    # one batch on the card (with the model's per-dataset aux, as evaluate
    # runs it) against the same module and batch on the CPU, with the aux
    # the CPU builds itself; or with the card's (``share_aux``: a neighbour
    # chain built on each side may differ where a point lies within rounding
    # of a radius, and check_chain counts such entries)
    batch = gather_cases(data, torch.arange(BATCH))
    on_card = model.attach_neighbors(batch.to(dev))
    on_cpu = on_card.to("cpu") if share_aux else cpu_model.attach_neighbors(batch)
    with torch.no_grad():
        out_g = model.derivative_apply(on_card)
    pred_g, extras_g = make_predict_functions(model).predict_batch(on_card, True)
    cpu_model.module.load_state_dict(copy.deepcopy(model.module).cpu().state_dict())
    with torch.no_grad():
        out_c = cpu_model.derivative_apply(on_cpu)
    pred_c, extras_c = make_predict_functions(cpu_model).predict_batch(on_cpu, True)
    check_close(f"{label} prediction card-vs-CPU", [
        ("fields", out_g[0].cpu(), out_c[0]), ("jac", out_g[1].cpu(), out_c[1]),
        ("lap", out_g[2].cpu(), out_c[2]),
        ("Momentum", extras_g["Momentum"].cpu(), extras_c["Momentum"]),
        ("div", extras_g["div"].cpu(), extras_c["div"]),
        ("predicted fields", pred_g.data.cpu(), pred_c.data)])
    return {"ms_per_batch": ms_batch, "cases_per_s": cases_s, "runs_ms_per_batch": runs_ms,
            "batches": n_batches, "batch_size": BATCH, "points": [N_INT, N_BND, N_OBS],
            "launches_per_batch": {k: (v - per_evaluate.get(k, 0)) // n_batches
                                   for k, v in counts.items()},
            "launches_per_evaluate": per_evaluate}


def training_phase(label, full_model, data, counters, want, name, smi, model_type,
                   want_attach=None, share_aux=False):
    """Training of ``full_model(device)`` with the fixed loss weights at
    batch BATCH: launch counts of ``attach_neighbors`` (``want_attach``,
    default none) and per step (``want``), finite non-zero gradients in
    every parameter, the loss falling, steps/s over whole epochs (median of
    TRAIN_RUNS runs of TRAIN_EPOCHS epochs), one step on 2 cases against the
    CPU with dropout on (each side with its own per-dataset aux, or both
    with the card's if ``share_aux``), and a Trainer.fit whose checkpoints
    restore."""
    import numpy as np
    import torch
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.train.engine import (gather_cases, make_optimizer,
                                                   make_train_functions)
    from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig, load_checkpoint
    dev = torch.device("cuda", 0)
    scaler = FixedLossScaler(LOSS_WEIGHTS)
    steps_per_epoch = N_CASES // BATCH
    model = full_model(dev)
    train_fns = make_train_functions(model, make_optimizer(model, steps_per_epoch), scaler)
    state = train_fns.init_state(seed=SEED)
    host_rng = np.random.default_rng(SEED)

    def perm():
        return host_rng.permutation(N_CASES).reshape(steps_per_epoch, BATCH)

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    def read_counts():
        return {k: c.launches for k, c in counters.items()}

    # the per-dataset aux, once
    reset_counts()
    dataset = model.attach_neighbors(data.to(dev))
    torch.cuda.synchronize()
    attach_counts = read_counts()
    want_attach = want_attach or {k: 0 for k in counters}
    log(f"{label} training: attach_neighbors of {N_CASES} cases, launches {attach_counts}")
    if attach_counts != want_attach:
        fail(f"{label} launch counts of attach_neighbors {attach_counts} != {want_attach}")

    # one step: launches and gradients
    reset_counts()
    state, m = train_fns.train_step(state, gather_cases(dataset, torch.as_tensor(perm()[0])))
    torch.cuda.synchronize()
    step_counts = read_counts()
    log(f"{label} training: one step, launches {step_counts}")
    if step_counts != want:
        fail(f"{label} launch counts per step {step_counts} != {want}")
    groups = {}
    for pname, p in model.module.named_parameters():
        if p.grad is None or not bool(p.grad.isfinite().all()):
            fail(f"{label} parameter {pname}: no finite gradient")
        if not bool((p.grad != 0).any()):
            fail(f"{label} parameter {pname}: gradient is zero")
        group = pname.split(".")[0]
        groups[group] = groups.get(group, 0) + 1
    log(f"  every parameter ({len(list(model.module.parameters()))}; by group {groups}) has "
        f"a finite, non-zero gradient; step-1 total loss {float(m[0]):.6f}")

    # steps/s as bench.py measures it: whole epochs between two syncs, after
    # a warm-up epoch; the median of TRAIN_RUNS runs of TRAIN_EPOCHS epochs
    state, m_warm = train_fns.train_epoch(state, dataset, perm())
    epoch_totals = [float(m_warm[0])]
    run_ms = []
    reset_counts()
    for _ in range(TRAIN_RUNS):
        perms = [perm() for _ in range(TRAIN_EPOCHS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m_epochs = train_fns.train_epochs(state, dataset, perms)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3 / (TRAIN_EPOCHS * steps_per_epoch))
        epoch_totals += m_epochs[:, 0].cpu().tolist()
    train_counts = read_counts()
    n_steps = TRAIN_RUNS * TRAIN_EPOCHS * steps_per_epoch
    if train_counts != {k: n * n_steps for k, n in want.items()}:
        fail(f"{label} launch counts {train_counts} over {n_steps} steps != {want} per step")
    if not all(map(lambda t: t == t and abs(t) < float("inf"), epoch_totals)):
        fail(f"{label}: non-finite epoch loss")
    log(f"  epoch mean total loss: first {epoch_totals[0]:.6f}, last "
        f"{epoch_totals[-1]:.6f} over {len(epoch_totals)} epochs")
    if not epoch_totals[-1] < epoch_totals[0]:
        fail(f"{label}: the total loss did not fall")
    ms_step = statistics.median(run_ms)
    steps_s = 1e3 / ms_step
    run_ms.sort()
    log(f"{label} training: {ms_step:.3f} ms per step, {steps_s:.2f} steps/s at batch "
        f"{BATCH} (median of {TRAIN_RUNS} runs of {TRAIN_EPOCHS} epochs x "
        f"{steps_per_epoch} steps, {run_ms[0]:.3f} to {run_ms[-1]:.3f} ms/step; "
        f"{name}; {smi})")
    per_step = {k: v // n_steps for k, v in train_counts.items()}
    del state, train_fns, model, dataset

    # one step on 2 cases, card against CPU, dropout on
    two = gather_cases(data, torch.arange(2))
    res, two_card = [], None
    for device in (dev, torch.device("cpu")):
        mdl = full_model(device)
        if share_aux and two_card is not None:
            two_dev = two_card.to(device)
        else:
            two_dev = two_card = mdl.attach_neighbors(two.to(device))
        f2 = make_train_functions(mdl, make_optimizer(mdl, steps_per_epoch), scaler)
        st = f2.init_state(seed=SEED)
        st, mt = f2.train_step(st, two_dev)
        lr, eps = mdl.learning_rate, mdl.adam_eps
        res.append((mt.cpu(), [p.grad.cpu() for p in mdl.module.parameters()],
                    [p.detach().cpu() for p in mdl.module.parameters()],
                    [n for n, _ in mdl.module.named_parameters()]))
    (m_g, gr_g, p_g, pnames), (m_c, gr_c, p_c, _) = res
    check_close(f"{label} train step card-vs-CPU metrics", [("metrics", m_g, m_c)])
    check_close(f"{label} train step card-vs-CPU gradients",
                [(f"grad {n}", a, r) for n, a, r in zip(pnames, gr_g, gr_c)], quiet=True)
    # Adam's first step moves each weight by u(g) = -lr g / (|g| + eps). The
    # gradients agree within tau = RTOL * max|g|; the weights may then differ
    # by the most u changes when g moves by tau (up to 2 lr where tau covers
    # g's sign, steep where |g| is near eps), on top of RTOL * max|w|.
    undetermined = 0
    for n, a, r, gc in zip(pnames, p_g, p_c, gr_c):
        spread = adam_first_step_spread(gc, RTOL * float(gc.abs().max()), lr, eps)
        err = (a.double() - r.double()).abs()
        allowed = RTOL * float(r.abs().max()) + spread
        undetermined += int((spread > RTOL * float(r.abs().max())).sum())
        if bool((err > allowed).any()):
            i = int(torch.argmax(err - allowed))
            fail(f"{label} train step card-vs-CPU parameter {n}: |err| "
                 f"{float(err.flatten()[i]):.3e} > {float(allowed.flatten()[i]):.3e}")
    log(f"  {label} train step card-vs-CPU parameters agree ({undetermined} of "
        f"{sum(p.numel() for p in p_c)} weights have a gradient within tolerance of 0 "
        "or of Adam's eps)")

    # Trainer.fit: 3 epochs, checkpoints every 2, restored by load_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        mdl = full_model(dev)
        trainer = Trainer(mdl, data, gather_cases(data, torch.arange(BATCH)),
                          TrainerConfig(epochs=3, batch_size=BATCH, logs_dir=tmp,
                                        name="smoke", checkpoint_every=2, seed=SEED),
                          loss_scaler=scaler, model_type=model_type)
        trainer.write_model_meta(N_INT, N_BND, N_OBS)
        st = trainer.fit()
        log_dir = Path(tmp) / "lightning_logs" / "smoke"
        written = sorted(p.name for p in log_dir.iterdir())
        log(f"  {label} Trainer.fit wrote {written}")
        for fname in ("checkpoint-epoch=2.ckpt", "model.ckpt", "best.ckpt",
                      "model_meta.json"):
            if not (log_dir / fname).exists():
                fail(f"{label} Trainer.fit did not write {fname}")
        restored, epoch = load_checkpoint(log_dir / "model.ckpt", full_model(dev), None,
                                          scaler, steps_per_epoch)
        if epoch != 3 or restored.step != st.step:
            fail(f"{label} load_checkpoint: epoch {epoch}, step {restored.step}")
        for a, b in zip(restored.module.parameters(), st.module.parameters()):
            if not torch.equal(a, b):
                fail(f"{label} load_checkpoint did not restore the trained weights")
        at2, epoch2 = load_checkpoint(log_dir / "checkpoint-epoch=2.ckpt", full_model(dev),
                                      None, scaler, steps_per_epoch)
        if epoch2 != 2 or at2.step != 2 * steps_per_epoch:
            fail(f"{label} checkpoint-epoch=2: epoch {epoch2}, step {at2.step}")
    log(f"  {label} Trainer.fit checkpoints written and restored")
    return {"ms_per_step": ms_step, "steps_per_s": steps_s, "runs_ms_per_step": run_ms,
            "epochs_per_run": TRAIN_EPOCHS, "steps_per_epoch": steps_per_epoch,
            "batch_size": BATCH, "epoch_totals_first_last": [epoch_totals[0],
                                                             epoch_totals[-1]],
            "launches_per_step": per_step, "launches_per_attach": attach_counts}


def main() -> int:
    if not (ROOT / "porous_cfd_tpu_torch").is_dir():
        print("chip_smoke: porous_cfd_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                     make_scalers)
    from porous_cfd_tpu_torch.models.neighbors import fps_count
    from porous_cfd_tpu_torch.models.pi_gano import pi_gano
    from porous_cfd_tpu_torch.models.pipn import pipn_foam, pipn_foam_pp
    from porous_cfd_tpu_torch.ops import (build, decoder_cuda, dropout, fps_cuda,
                                          neural_op_cuda, pointnet_cuda, sa_cuda)
    from porous_cfd_tpu_torch.train.engine import gather_cases

    counters = {"pointnet_global": pointnet_cuda.pointnet_global,
                "pointnet_global_bwd": pointnet_cuda.pointnet_global_backward,
                "decoder_prop": decoder_cuda.decoder_prop,
                "decoder_prop_bwd": decoder_cuda.decoder_prop_backward,
                "neural_ops_prop": neural_op_cuda.neural_ops_prop,
                "neural_ops_prop_bwd": neural_op_cuda.neural_ops_prop_backward,
                "sa_neighborhood": sa_cuda.sa_neighborhood,
                "sa_neighborhood_bwd": sa_cuda.sa_neighborhood_backward,
                "farthest_point_sampling": fps_cuda.farthest_point_sampling}

    def counts(**nonzero):
        return {k: nonzero.get(k, 0) for k in counters}

    # ---- 1. device ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    pk = peaks(name)
    log(f"device: {name} (count {torch.cuda.device_count()}); torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    log(f"peaks used for bounds: {pk[0] / 1e12:.1f} TFLOP/s f32, {pk[1] / 1e12:.2f} TB/s")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for src in build.SOURCES:
        report = build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "spill" in line and "0 bytes spill stores" not in line:
                    log(f"  ptxas {src}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    kernels = {}

    def add_entry(key, res, **extra):
        kernels[key] = entry(key, res["err"], res["ms"], res["plain_ms"], res["flops"],
                             res["nbytes"], pk, **res.get("extra", {}), **extra)

    # ---- 3a, 3b. pointnet_global forward and backward, all three shapes -----
    n_pts = N_INT + N_BND
    pn_fwd, pn_bwd = check_pointnet(FE_GLOBAL, n_pts, True, gen, "pipn")
    pg_shapes = {"geometry_encoder": (PG_GEOMETRY, n_pts), "branch": (PG_BRANCH, PG_N_BRANCH)}
    pg_pn = {k: check_pointnet(layers, n, False, gen, f"pi-gano {k}")
             for k, (layers, n) in pg_shapes.items()}
    for i, (key, res) in enumerate((("pointnet_global", pn_fwd), ("pointnet_global_bwd",
                                                                  pn_bwd))):
        at_pg = {k: {"input": [BATCH, pg_shapes[k][1], pg_shapes[k][0][0]],
                     "widths": pg_shapes[k][0], **shape_timing(v[i], pk)}
                 for k, v in pg_pn.items()}
        extra = {"winner_rows": res["winner_rows"]} if "winner_rows" in res else {}
        kernels[key] = entry(key, max([res["err"]] + [v[i]["err"] for v in pg_pn.values()]),
                             res["ms"], res["plain_ms"], res["flops"], res["nbytes"], pk,
                             at_pi_gano_shapes=at_pg, **extra)

    # ---- 3c, 3d. decoder_prop forward and backward, dropout on and off ---------
    if decoder_cuda.philox(torch.tensor(
            [[0, 0, 0, 0, 0, 0], [0xFFFFFFFF] * 6,
             [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0]],
            dtype=torch.int64, device=dev)).cpu().tolist() != [
            [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
            [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD],
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]]:
        fail("the kernels' Philox4x32-10 misses Random123's known answers")
    log("  Philox4x32-10 on the card: Random123 known answers match")
    mask = dropout.keep_mask(SEED, 0, BATCH, N_INT + N_BND, SEG[1], 0.05, dev)
    kept = float((mask > 0).float().mean())
    log(f"  kept fraction of a ({BATCH}, {N_INT + N_BND}, {SEG[1]}) mask at rate 0.05: "
        f"{kept:.6f}")
    if abs(kept - 0.95) > 0.002:
        fail(f"kept fraction {kept} not within 0.95 +- 0.002")
    del mask
    dec_fwd, dec_bwd = check_decoder(SEG, SEG_DROPOUT, gen, "pipn")
    add_entry("decoder_prop", dec_fwd)
    add_entry("decoder_prop_bwd", dec_bwd)

    # ---- 3e. neural_ops_prop forward and backward, dropout on and off ---------
    tr_fwd, tr_bwd = check_trunk(gen)
    add_entry("neural_ops_prop", tr_fwd)
    add_entry("neural_ops_prop_bwd", tr_bwd)
    torch.cuda.empty_cache()

    data = make_foam_batch(N_CASES, N_INT, N_BND, N_OBS, seed=SEED)
    scalers = make_scalers()

    def pipn_model(device):
        return pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, scalers,
                         seg_dropout=SEG_DROPOUT,
                         generator=torch.Generator().manual_seed(SEED), device=device)

    def pi_gano_model(device):
        return pi_gano(NU, 3, PG_BRANCH, PG_GEOMETRY, PG_LOCAL, PG_OPERATORS, PG_DROPOUT,
                       scalers, VARIABLE_BOUNDARIES,
                       generator=torch.Generator().manual_seed(SEED), device=device)

    def pipn_pp_model(device):
        return pipn_foam_pp(NU, D, F, PP_LOCAL, PP_GLOBAL, PP_RADIUS, PP_FRACTION, PP_SEG,
                            scalers, seg_dropout=PP_DROPOUT, max_neighbors=PP_NEIGHBORS,
                            generator=torch.Generator().manual_seed(SEED), device=device)

    # ---- 3f. sa_neighborhood at PIPN++'s level shapes, on a real chain --------
    pp_card = pipn_pp_model(dev)
    chain = pp_card.neighbor_precompute(gather_cases(data, torch.arange(BATCH)).to(dev))
    sa_fwd, sa_bwd = check_sa(pp_card, chain, gen, pk)
    add_entry("sa_neighborhood", sa_fwd)
    add_entry("sa_neighborhood_bwd", sa_bwd)
    del pp_card, chain

    # ---- 3g. FPS at PIPN++'s two levels, every case ---------------------------
    n_cent = [fps_count(N_BND, PP_FRACTION[0])]
    n_cent.append(fps_count(n_cent[0], PP_FRACTION[1]))
    add_entry("farthest_point_sampling", check_fps(data, n_cent), exact="indices equal")

    # ---- 3h. pointnet_global and decoder_prop at PIPN++'s shapes -----------------
    pp_pn = check_pointnet(PP_GLOBAL[-1], n_cent[1], True, gen, "pipn_pp global")
    pp_dec = check_decoder(PP_SEG, PP_DROPOUT, gen, "pipn_pp")
    shapes = {"pointnet_global": {"input": [BATCH, n_cent[1], PP_GLOBAL[-1][0]],
                                  "widths": PP_GLOBAL[-1]},
              "decoder_prop": {"widths": PP_SEG, "dropout": PP_DROPOUT}}
    for key, pair in (("pointnet_global", pp_pn), ("decoder_prop", pp_dec)):
        for i, k in enumerate((key, f"{key}_bwd")):
            kernels[k]["at_pipn_pp_shape"] = {**shapes[key], **shape_timing(pair[i], pk),
                                              **pair[i].get("extra", {})}
            kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], pair[i]["err"])
    for kern in kernels.values():
        log(json.dumps({"kernel_timing": kern}))
    torch.cuda.empty_cache()

    # ---- 4, 5. pipn: verbose prediction, then training -------------------------
    pipn_pred = prediction_phase("pipn", pipn_model(dev), pipn_model("cpu"), data, scalers,
                                 counters, counts(pointnet_global=1, decoder_prop=2),
                                 name, smi)
    pipn_train = training_phase("pipn", pipn_model, data, counters,
                                counts(pointnet_global=1, pointnet_global_bwd=1,
                                       decoder_prop=2, decoder_prop_bwd=2),
                                name, smi, "pipn")
    torch.cuda.empty_cache()

    # ---- 6, 7. pi-gano: verbose prediction, then training -----------------------
    pg_pred = prediction_phase("pi-gano", pi_gano_model(dev), pi_gano_model("cpu"), data,
                               scalers, counters, counts(pointnet_global=2, neural_ops_prop=2),
                               name, smi)
    pg_train = training_phase("pi-gano", pi_gano_model, data, counters,
                              counts(pointnet_global=2, pointnet_global_bwd=2,
                                     neural_ops_prop=2, neural_ops_prop_bwd=2),
                              name, smi, "pi-gano")
    torch.cuda.empty_cache()

    # ---- 8, 9. pipn_pp: the chain, verbose prediction, then training ------------
    log("pipn_pp boundary chain, card against CPU:")
    pp_chain = check_chain(pipn_pp_model(dev), pipn_pp_model("cpu"), data)
    pp_pred = prediction_phase("pipn_pp", pipn_pp_model(dev), pipn_pp_model("cpu"), data,
                               scalers, counters,
                               counts(sa_neighborhood=2, pointnet_global=1, decoder_prop=2),
                               name, smi, per_evaluate=counts(farthest_point_sampling=2),
                               share_aux=True)
    pp_train = training_phase("pipn_pp", pipn_pp_model, data, counters,
                              counts(sa_neighborhood=2, sa_neighborhood_bwd=2,
                                     pointnet_global=1, pointnet_global_bwd=1,
                                     decoder_prop=2, decoder_prop_bwd=2),
                              name, smi, "pipn-pp",
                              want_attach=counts(farthest_point_sampling=2), share_aux=True)

    # launches on each kernel's main path (per training step; FPS per
    # attach_neighbors, the only place it runs), and per path
    paths = {"pipn": (pipn_pred, pipn_train), "pi_gano": (pg_pred, pg_train),
             "pipn_pp": (pp_pred, pp_train)}
    for k, kern in kernels.items():
        main_path = ("pi_gano" if k.startswith("neural_ops") else
                     "pipn_pp" if k.startswith(("sa_", "farthest")) else "pipn")
        tr = paths[main_path][1]
        kern["launches"] = (tr["launches_per_attach"] if k == "farthest_point_sampling"
                            else tr["launches_per_step"])[k]
        kern["launches_by_path"] = {
            p: {"train_step": tr_["launches_per_step"][k],
                "predict_batch": pr["launches_per_batch"][k],
                "attach_neighbors": tr_["launches_per_attach"][k]}
            for p, (pr, tr_) in paths.items()}
    log(json.dumps({"slice": pipn_pred}))
    log(json.dumps({"train": pipn_train}))
    log(json.dumps({"pi_gano_slice": pg_pred}))
    log(json.dumps({"pi_gano_train": pg_train}))
    log(json.dumps({"pipn_pp_chain": pp_chain}))
    log(json.dumps({"pipn_pp_slice": pp_pred}))
    log(json.dumps({"pipn_pp_train": pp_train}))
    log(json.dumps({"kernels": list(kernels.values())}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
