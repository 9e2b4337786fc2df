#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: TF32 off, card name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port from ``porous_cfd_tpu_torch/ops/csrc``
     (one nvcc per source, side by side) into ``build/porous_cfd_tpu_torch``;
  3. kernels: each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, timed with CUDA events: (a)
     pointnet_global forward, (b) decoder_prop forward, (c) pointnet_global
     backward, (d) decoder_prop forward and backward with dropout on and off,
     the kept fraction of a full-size mask and the Philox known answers;
  4. prediction slice: verbose prediction (fields + PDE residuals) of 52
     synthetic cases at 1500/1000/700 internal/boundary/observation points, in
     4 batches of 13, through the full-width duct_fixed_boundary ``pipn``
     model; launch counts, finiteness, and one batch against the same module
     on the CPU; the time per batch is the median of 7 runs of the 52 cases;
  5. training slice: the same model and cases, Adam with the duct example's
     fixed loss weights, batch 13 (4 steps an epoch): launch counts per step,
     finite non-zero gradients, the loss falling, one step on 2 cases
     against the CPU with dropout on, a Trainer.fit with checkpoints, and
     steps/s over whole epochs (the median of 5 runs of 10 epochs).
The second-to-last lines are the ``{"kernels": [...]}`` JSON and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
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
BATCH, N_INT, N_BND, N_OBS, N_CASES = 13, 1500, 1000, 700, 52
SEED = 8421
SLICE_RUNS = 7
# examples/duct_fixed_boundary/train.py: continuity, momentum x/y, boundary
# u x/y and p, observations u x/y and p
LOSS_WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
TRAIN_RUNS, TRAIN_EPOCHS = 5, 10

# Tolerance of every comparison on the card: |a - b| <= RTOL * max|ref|.
# The kernels, cuBLAS and the CPU's BLAS sum the 512- and 1024-wide rows in
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
}
SOURCES = {"pointnet_global": "porous_cfd_tpu_torch/ops/csrc/pointnet_global.cu",
           "pointnet_global_bwd": "porous_cfd_tpu_torch/ops/csrc/pointnet_global.cu",
           "decoder_prop": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
           "decoder_prop_bwd": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu"}


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


def main() -> int:
    if not (ROOT / "porous_cfd_tpu_torch").is_dir():
        print("chip_smoke: porous_cfd_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.models.pipn import pipn_foam
    from porous_cfd_tpu_torch.ops import build, decoder_cuda, dropout, pointnet_cuda
    from porous_cfd_tpu_torch.physics import analytic
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.pipelines.evaluation import evaluate
    from porous_cfd_tpu_torch.train.engine import (gather_cases, make_optimizer,
                                                   make_predict_functions,
                                                   make_train_functions)
    from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig, load_checkpoint

    counters = {"pointnet_global": pointnet_cuda.pointnet_global,
                "pointnet_global_bwd": pointnet_cuda.pointnet_global_backward,
                "decoder_prop": decoder_cuda.decoder_prop,
                "decoder_prop_bwd": decoder_cuda.decoder_prop_backward}

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    def read_counts():
        return {k: c.launches for k, c in counters.items()}

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

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    # ---- 3a. pointnet_global forward at the main-path shapes ------------------
    n_pts = N_INT + N_BND
    mlp_g = MLP(FE_GLOBAL, activation="silu", generator=gen).to(dev)
    x = torch.randn((BATCH, n_pts, FE_GLOBAL[0]), generator=gen).to(dev)
    lin_g = mlp_g.linears
    with torch.no_grad():
        m_k, a_k = pointnet_cuda.pointnet_global(lin_g, x, "silu")
        torch.cuda.synchronize()
        m_p, a_p = pointnet_cuda.pointnet_global_plain(lin_g, x, "silu")
        torch.cuda.synchronize()
        err_pn = check_close("pointnet_global", [("max", m_k, m_p)])
        g_full = analytic.mlp_value(lin_g, x, "silu")
        top2 = torch.topk(g_full, 2, dim=-2).values
        decided = (top2[:, 0] - top2[:, 1]) > RTOL * m_p.abs().max()
        mismatch = int(((a_k[:, 0] != a_p[:, 0]) & decided).sum())
        log(f"  pointnet_global argmax: {int(decided.sum())} of {decided.numel()} "
            f"channels decided, {mismatch} disagree")
        if mismatch:
            fail("pointnet_global argmax disagrees with the plain version")
        del g_full, top2
        ms_k = time_ms(torch, lambda: pointnet_cuda.pointnet_global(lin_g, x, "silu"))
        ms_p = time_ms(torch, lambda: pointnet_cuda.pointnet_global_plain(lin_g, x, "silu"))
    macs_g = sum(a * b for a, b in zip(FE_GLOBAL[:-1], FE_GLOBAL[1:]))
    flops = 2.0 * BATCH * n_pts * macs_g
    nbytes = 4 * (x.numel() + sum(p.numel() for p in mlp_g.parameters())
                  + 2 * BATCH * FE_GLOBAL[-1])
    kernels["pointnet_global"] = entry("pointnet_global", err_pn, ms_k, ms_p, flops,
                                       nbytes, pk)
    log(json.dumps({"kernel_timing": kernels["pointnet_global"]}))

    # ---- 3b. decoder_prop forward (internal + boundary launches) --------------
    dec = MLP(SEG, SEG_DROPOUT, "silu", last_activation=False, generator=gen).to(dev)
    lin_d = dec.linears
    n_local = FE_LOCAL[-1]
    dims = 2
    v = rnd(BATCH, N_INT, n_local)
    jt = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    ht = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    v_b = rnd(BATCH, N_BND, n_local)
    g = rnd(BATCH, 1, SEG[0] - n_local)
    args = (lin_d, n_local, v, jt, ht, v_b, g, "silu")
    with torch.no_grad():
        out_k = decoder_cuda.decoder_prop(*args)
        torch.cuda.synchronize()
        out_p = decoder_cuda.decoder_prop_plain(*args)
        torch.cuda.synchronize()
        err_dec = check_close("decoder_prop", list(zip(("v", "jac", "lap"), out_k, out_p)))
        ms_dec = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args))
        ms_dec_p = time_ms(torch, lambda: decoder_cuda.decoder_prop_plain(*args))
        args_int = (lin_d, n_local, v, jt, ht, None, g, "silu")
        ms_dec_int = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args_int))
    macs_d = n_local * SEG[1] + sum(a * b for a, b in zip(SEG[1:-1], SEG[2:]))
    rows = BATCH * N_INT * (1 + 2 * dims) + BATCH * N_BND
    flops_dec = 2.0 * rows * macs_d + 2.0 * BATCH * (SEG[0] - n_local) * SEG[1]
    bytes_dec = nbytes_of([v, jt, ht, v_b, g, *dec.parameters(), *out_k])
    del out_k, out_p

    # ---- 3c. pointnet_global backward at the main-path shapes -----------------
    xg = x.clone().requires_grad_()
    params_g = list(mlp_g.parameters())
    m_k, a_k = pointnet_cuda.pointnet_global(lin_g, xg, "silu")
    cot = rnd(BATCH, 1, FE_GLOBAL[-1])
    got = torch.autograd.grad((m_k * cot).sum(), [xg, *params_g])
    torch.cuda.synchronize()
    # the plain version of the backward on the kernel's winners (near-ties
    # may legitimately pick another row than torch.max)
    m_ref = pointnet_cuda.pointnet_global_at(lin_g, xg, "silu", a_k)
    loss_ref = (m_ref * cot).sum()
    ref = torch.autograd.grad(loss_ref, [xg, *params_g], retain_graph=True)
    err_pb = check_close("pointnet_global backward",
                         list(zip(["dx"] + [f"d{n}" for n, _ in mlp_g.named_parameters()],
                                  got, ref)))
    with torch.no_grad():
        _, arg_s, z_s, ws_t = pointnet_cuda._forward([lin.weight for lin in lin_g],
                                                     [lin.bias for lin in lin_g], x, "silu",
                                                     stash=True)
    w_g = [lin.weight.detach() for lin in lin_g]
    b_g = [lin.bias.detach() for lin in lin_g]
    dm = cot.contiguous()
    ms_k = time_ms(torch, lambda: pointnet_cuda.pointnet_global_backward(
        w_g, ws_t, b_g, x, "silu", z_s, arg_s, dm))
    ms_p = time_ms(torch, lambda: torch.autograd.grad(loss_ref, [xg, *params_g],
                                                      retain_graph=True))
    # the work these inputs need: recompute the lower layers at the winner
    # rows, z at each (case, channel) winner, then dW, db and the scatter of
    # the last layer and dX, dW of the lower layers at the winners
    winners = sum(int(torch.unique(a_k[b, 0]).numel()) for b in range(BATCH))
    lower = sum(a * b for a, b in zip(FE_GLOBAL[:-2], FE_GLOBAL[1:-1]))
    last = FE_GLOBAL[-2] * FE_GLOBAL[-1] * BATCH
    flops = 2.0 * (winners * lower * 3 + last * 3)
    nbytes = nbytes_of([x, *params_g, m_k, cot, *got]) + 4 * a_k.numel()
    kernels["pointnet_global_bwd"] = entry("pointnet_global_bwd", err_pb, ms_k, ms_p,
                                           flops, nbytes, pk, winner_rows=winners)
    log(json.dumps({"kernel_timing": kernels["pointnet_global_bwd"]}))
    del got, ref, m_ref, loss_ref, z_s

    # ---- 3d. decoder_prop forward and backward, dropout on and off ------------
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
    leaves = [t.clone().requires_grad_() for t in (v, jt, ht, v_b, g)]
    params_d = list(dec.parameters())
    errs = []
    for drop in (SEG_DROPOUT, None):
        tag = "dropout 0.05" if drop else "no dropout"
        dargs = (lin_d, n_local, *leaves, "silu", drop, drop is None, SEED)
        out_k = decoder_cuda.decoder_prop(*dargs)
        cots = [torch.randn(o.shape, generator=gen).to(dev) for o in out_k]
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out_k, cots)),
                                  leaves + params_d)
        torch.cuda.synchronize()
        out_p = decoder_cuda.decoder_prop_plain(*dargs)
        errs.append(check_close(f"decoder_prop forward, {tag}",
                                list(zip(("v", "jac", "lap"), out_k, out_p))))
        loss_ref = sum((o * c).sum() for o, c in zip(out_p, cots))
        ref = torch.autograd.grad(loss_ref, leaves + params_d, retain_graph=True)
        names = ["dv", "djt", "dht", "dv_b", "dg"] + [f"d{n}" for n, _ in
                                                      dec.named_parameters()]
        errs.append(check_close(f"decoder_prop backward, {tag}", list(zip(names, got, ref))))
        if drop:
            with torch.no_grad():
                ms_fwd = time_ms(torch, lambda: decoder_cuda.decoder_prop(*dargs))
                ms_fwd_p = time_ms(torch, lambda: decoder_cuda.decoder_prop_plain(*dargs))
            ms_bwd_p = time_ms(torch, lambda: torch.autograd.grad(
                loss_ref, leaves + params_d, retain_graph=True))
            meta = decoder_cuda._Meta(n_local, "silu", tuple(float(r) for r in drop), SEED,
                                      dims, BATCH, N_INT, N_BND,
                                      tuple([n_local] + SEG[1:]))
            with torch.no_grad():
                weights = [p.detach() for p in (lin.weight for lin in lin_d)]
                ctx = torch.nn.functional.linear(g[:, 0], lin_d[0].weight[:, n_local:],
                                                 lin_d[0].bias).contiguous()
                _, _, _, stashes = decoder_cuda._forward(
                    meta, v, jt, ht, v_b, ctx, weights,
                    [lin.bias.detach() for lin in lin_d[1:]], stash=True)
                gv, gj, gh = (c.contiguous() for c in cots)
                ms_bwd = time_ms(torch, lambda: decoder_cuda.decoder_prop_backward(
                    meta, weights, stashes, gv, gj, gh))
                gj_none = torch.zeros_like(gj)
                ms_bwd_int = time_ms(torch, lambda: decoder_cuda.decoder_prop_backward(
                    decoder_cuda._Meta(n_local, "silu", meta.rates, SEED, dims, BATCH,
                                       N_INT, 0, meta.widths),
                    weights, stashes[:2], gv[:, :N_INT].contiguous(), gj_none, gj_none))
            bwd_bytes = nbytes_of([v, jt, ht, v_b, g, *params_d, *cots, *got])
            del stashes
        del out_k, out_p, got, ref, loss_ref
    kernels["decoder_prop"] = entry("decoder_prop", max(err_dec, errs[0], errs[2]), ms_fwd,
                                    ms_fwd_p, flops_dec, bytes_dec, pk,
                                    ms_no_dropout=ms_dec, plain_ms_no_dropout=ms_dec_p,
                                    ms_internal_launch_no_dropout=ms_dec_int)
    kernels["decoder_prop_bwd"] = entry("decoder_prop_bwd", max(errs[1], errs[3]), ms_bwd,
                                        ms_bwd_p, 2.0 * flops_dec, bwd_bytes, pk,
                                        ms_internal_launch=ms_bwd_int)
    for k in ("decoder_prop", "decoder_prop_bwd"):
        log(json.dumps({"kernel_timing": kernels[k]}))
    del leaves

    # ---- 4. the prediction slice: verbose prediction, 4 batches of 13 ---------
    data = make_foam_batch(N_CASES, N_INT, N_BND, N_OBS, seed=SEED)
    scalers = make_scalers()

    def full_model(device):
        return pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, scalers,
                         seg_dropout=SEG_DROPOUT,
                         generator=torch.Generator().manual_seed(SEED), device=device)

    model = full_model(dev)
    warm = gather_cases(data, torch.arange(BATCH))
    evaluate(model, warm, BATCH, scalers)            # warm-up, not counted

    reset_counts()
    ev = evaluate(model, data, BATCH, scalers)
    pred_counts = read_counts()
    n_batches = len(ev.predictions)
    log(f"prediction slice: {n_batches} batches, launches {pred_counts}")
    if pred_counts != {"pointnet_global": n_batches, "pointnet_global_bwd": 0,
                       "decoder_prop": 2 * n_batches, "decoder_prop_bwd": 0}:
        fail(f"launch counts {pred_counts} != 1 and 2 forward per batch over "
             f"{n_batches} batches and no backward")
    for i, (pred, extras) in enumerate(ev.predictions):
        if tuple(pred.data.shape) != (BATCH, N_INT + N_BND, 3):
            fail(f"batch {i}: fields shape {tuple(pred.data.shape)}")
        if tuple(extras.data.shape) != (BATCH, N_INT, 3):
            fail(f"batch {i}: residual shape {tuple(extras.data.shape)}")
        if not (bool(pred.data.isfinite().all()) and bool(extras.data.isfinite().all())):
            fail(f"batch {i}: non-finite fields or residuals")
    for key, val in ev.results.items():
        if val is not None and not bool(torch.isfinite(torch.as_tensor(val)).all()):
            fail(f"evaluation result {key!r} is not finite")
    # the host-clock window is short, so the run is repeated and the median
    # reported with the spread
    runs_ms = sorted(t / n_batches * 1e3 for t in [ev.inference_time] + [
        evaluate(model, data, BATCH, scalers).inference_time
        for _ in range(SLICE_RUNS - 1)])
    ms_batch = statistics.median(runs_ms)
    cases_s = BATCH / ms_batch * 1e3
    log(f"prediction slice: verbose prediction {ms_batch:.3f} ms per batch of {BATCH} "
        f"(median of {SLICE_RUNS} runs, {runs_ms[0]:.3f} to {runs_ms[-1]:.3f}), "
        f"{cases_s:.1f} cases/s ({name}; {smi})")

    # one batch on the card against the same module and batch on the CPU
    batch = gather_cases(data, torch.arange(BATCH))
    fns = make_predict_functions(model)
    with torch.no_grad():
        out_g = model.derivative_apply(batch.to(dev))
    pred_g, extras_g = fns.predict_batch(batch.to(dev), True)
    cpu_model = full_model("cpu")
    cpu_model.module.load_state_dict(copy.deepcopy(model.module).cpu().state_dict())
    with torch.no_grad():
        out_c = cpu_model.derivative_apply(batch)
    pred_c, extras_c = make_predict_functions(cpu_model).predict_batch(batch, True)
    check_close("prediction card-vs-CPU", [
        ("fields", out_g[0].cpu(), out_c[0]), ("jac", out_g[1].cpu(), out_c[1]),
        ("lap", out_g[2].cpu(), out_c[2]),
        ("Momentum", extras_g["Momentum"].cpu(), extras_c["Momentum"]),
        ("div", extras_g["div"].cpu(), extras_c["div"]),
        ("predicted fields", pred_g.data.cpu(), pred_c.data)])
    del model, cpu_model, out_g, out_c

    # ---- 5. the training slice -----------------------------------------------
    scaler = FixedLossScaler(LOSS_WEIGHTS)
    steps_per_epoch = N_CASES // BATCH
    model = full_model(dev)
    train_fns = make_train_functions(model, make_optimizer(model, steps_per_epoch), scaler)
    state = train_fns.init_state(seed=SEED)
    dataset = data.to(dev)
    host_rng = np.random.default_rng(SEED)

    def perm():
        return host_rng.permutation(N_CASES).reshape(steps_per_epoch, BATCH)

    # one step: launches and gradients
    reset_counts()
    state, m = train_fns.train_step(state, gather_cases(dataset, torch.as_tensor(perm()[0])))
    torch.cuda.synchronize()
    step_counts = read_counts()
    log(f"training slice: one step, launches {step_counts}")
    want = {"pointnet_global": 1, "pointnet_global_bwd": 1, "decoder_prop": 2,
            "decoder_prop_bwd": 2}
    if step_counts != want:
        fail(f"launch counts per step {step_counts} != {want}")
    for pname, p in model.module.named_parameters():
        if p.grad is None or not bool(p.grad.isfinite().all()):
            fail(f"parameter {pname}: no finite gradient")
        if not bool((p.grad != 0).any()):
            fail(f"parameter {pname}: gradient is zero")
    log(f"  every parameter ({len(list(model.module.parameters()))}) has a finite, "
        f"non-zero gradient; step-1 total loss {float(m[0]):.6f}")

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
        fail(f"launch counts {train_counts} over {n_steps} steps != {want} per step")
    if not all(map(lambda t: t == t and abs(t) < float("inf"), epoch_totals)):
        fail("non-finite epoch loss")
    log(f"  epoch mean total loss: first {epoch_totals[0]:.6f}, last "
        f"{epoch_totals[-1]:.6f} over {len(epoch_totals)} epochs")
    if not epoch_totals[-1] < epoch_totals[0]:
        fail("the total loss did not fall")
    ms_step = statistics.median(run_ms)
    steps_s = 1e3 / ms_step
    run_ms.sort()
    log(f"training slice: {ms_step:.3f} ms per step, {steps_s:.2f} steps/s at batch "
        f"{BATCH} (median of {TRAIN_RUNS} runs of {TRAIN_EPOCHS} epochs x "
        f"{steps_per_epoch} steps, {run_ms[0]:.3f} to {run_ms[-1]:.3f} ms/step; "
        f"{name}; {smi})")
    per_step = {k: v // n_steps for k, v in train_counts.items()}
    del state, train_fns, model

    # one step on 2 cases, card against CPU, dropout on
    two = gather_cases(data, torch.arange(2))
    res = {}
    for device in (dev, torch.device("cpu")):
        mdl = full_model(device)
        f2 = make_train_functions(mdl, make_optimizer(mdl, steps_per_epoch), scaler)
        st = f2.init_state(seed=SEED)
        st, mt = f2.train_step(st, two.to(device))
        lr = mdl.learning_rate
        res[device.type] = (mt.cpu(), [p.grad.cpu() for p in mdl.module.parameters()],
                            [p.detach().cpu() for p in mdl.module.parameters()],
                            [n for n, _ in mdl.module.named_parameters()])
    (m_g, gr_g, p_g, pnames), (m_c, gr_c, p_c, _) = res["cuda"], res["cpu"]
    check_close("train step card-vs-CPU metrics", [("metrics", m_g, m_c)])
    check_close("train step card-vs-CPU gradients",
                [(f"grad {n}", a, r) for n, a, r in zip(pnames, gr_g, gr_c)], quiet=True)
    # Adam's first step moves each weight by lr * sign(g): where a gradient
    # lies within its tolerance of zero its sign is not determined, and those
    # weights may differ by 2 lr; all others must agree within RTOL.
    undetermined = 0
    for n, a, r, gc in zip(pnames, p_g, p_c, gr_c):
        free = gc.abs() <= RTOL * gc.abs().max()
        undetermined += int(free.sum())
        err, allowed = max_err(a[~free], r[~free])
        if err > allowed:
            fail(f"train step card-vs-CPU parameter {n}: max|err| {err:.3e} > {allowed:.3e}")
        if bool(free.any()) and float((a[free] - r[free]).abs().max()) > 2 * lr * (1 + 1e-3):
            fail(f"train step card-vs-CPU parameter {n}: an undetermined weight moved "
                 "more than 2 lr")
    log(f"  train step card-vs-CPU parameters agree ({undetermined} of "
        f"{sum(p.numel() for p in p_c)} weights have a gradient within tolerance of 0)")

    # Trainer.fit: 3 epochs, checkpoints every 2, restored by load_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        mdl = full_model(dev)
        trainer = Trainer(mdl, data, gather_cases(data, torch.arange(BATCH)),
                          TrainerConfig(epochs=3, batch_size=BATCH, logs_dir=tmp,
                                        name="smoke", checkpoint_every=2, seed=SEED),
                          loss_scaler=scaler, model_type="pipn")
        trainer.write_model_meta(N_INT, N_BND, N_OBS)
        st = trainer.fit()
        log_dir = Path(tmp) / "lightning_logs" / "smoke"
        written = sorted(p.name for p in log_dir.iterdir())
        log(f"  Trainer.fit wrote {written}")
        for fname in ("checkpoint-epoch=2.ckpt", "model.ckpt", "best.ckpt",
                      "model_meta.json"):
            if not (log_dir / fname).exists():
                fail(f"Trainer.fit did not write {fname}")
        restored, epoch = load_checkpoint(log_dir / "model.ckpt", full_model(dev), None,
                                          scaler, steps_per_epoch)
        if epoch != 3 or restored.step != st.step:
            fail(f"load_checkpoint: epoch {epoch}, step {restored.step}")
        for a, b in zip(restored.module.parameters(), st.module.parameters()):
            if not torch.equal(a, b):
                fail("load_checkpoint did not restore the trained weights")
        at2, epoch2 = load_checkpoint(log_dir / "checkpoint-epoch=2.ckpt", full_model(dev),
                                      None, scaler, steps_per_epoch)
        if epoch2 != 2 or at2.step != 2 * steps_per_epoch:
            fail(f"checkpoint-epoch=2: epoch {epoch2}, step {at2.step}")
    log("  Trainer.fit checkpoints written and restored")

    for k, kern in kernels.items():
        kern["launches"] = per_step[k]
        if k in ("pointnet_global", "decoder_prop"):
            kern["launches_per_predict_batch"] = pred_counts[k] // n_batches
    log(json.dumps({"slice": {"ms_per_batch": ms_batch, "cases_per_s": cases_s,
                              "runs_ms_per_batch": runs_ms,
                              "batches": n_batches, "batch_size": BATCH,
                              "points": [N_INT, N_BND, N_OBS]}}))
    log(json.dumps({"train": {"ms_per_step": ms_step, "steps_per_s": steps_s,
                              "runs_ms_per_step": run_ms, "epochs_per_run": TRAIN_EPOCHS,
                              "steps_per_epoch": steps_per_epoch, "batch_size": BATCH,
                              "epoch_totals_first_last": [epoch_totals[0],
                                                          epoch_totals[-1]],
                              "launches_per_step": per_step}}))
    log(json.dumps({"kernels": list(kernels.values())}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
