#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: TF32 off, card name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port from ``porous_cfd_tpu_torch/ops/csrc``
     (one nvcc per source, side by side) into ``build/porous_cfd_tpu_torch``;
  3. kernels: each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, timed with CUDA events;
  4. slice: verbose prediction (fields + PDE residuals) of 52 synthetic cases
     at 1500/1000/700 internal/boundary/observation points, in 4 batches of 13,
     through the full-width duct_fixed_boundary ``pipn`` model; launch counts,
     finiteness, and one batch against the same module on the CPU; the
     prediction time per batch is the median of 7 runs of the 52 cases.
The second-to-last lines are the ``{"kernels": [...]}`` JSON and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
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

# Tolerance of every comparison on the card: |a - b| <= RTOL * max|ref|.
# The kernels, cuBLAS and the CPU's BLAS sum the 512- and 1024-wide rows in
# different orders (all in f32), so errors scale with the largest magnitude.
RTOL = 1e-4

# published H100 peaks (NVIDIA data sheets): f32 outside the tensor cores and
# HBM bandwidth, by product name
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60.0e12, 3.9e12), "": (67.0e12, 3.35e12)}

REPLACES = {
    "pointnet_global": "porous_cfd_tpu/ops/pointnet_pallas.py:37 (_fwd_kernel; "
                       "pallas_call at :125)",
    "decoder_prop": "porous_cfd_tpu/ops/decoder_pallas.py:168 (_fwd_kernel; "
                    "pallas_call at :433), decoupled mode",
}


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


def check_close(name, pairs):
    worst = 0.0
    for label, a, ref in pairs:
        if tuple(a.shape) != tuple(ref.shape):
            fail(f"{name} {label}: shape {tuple(a.shape)} != {tuple(ref.shape)}")
        if not bool(a.isfinite().all()):
            fail(f"{name} {label}: non-finite values")
        err, allowed = max_err(a, ref)
        log(f"  {name} {label}: max|err| {err:.3e} (allowed {allowed:.3e})")
        if err > allowed:
            fail(f"{name} {label}: max|err| {err:.3e} > {allowed:.3e}")
        worst = max(worst, err)
    return worst


def bound(flops, nbytes, peak_flops, peak_bw):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.models.pipn import pipn_foam
    from porous_cfd_tpu_torch.ops import build, decoder_cuda, pointnet_cuda
    from porous_cfd_tpu_torch.physics import analytic
    from porous_cfd_tpu_torch.pipelines.evaluation import evaluate
    from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions

    # ---- 1. device ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    peak_flops, peak_bw = peaks(name)
    log(f"device: {name} (count {torch.cuda.device_count()}); torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    log(f"peaks used for bounds: {peak_flops / 1e12:.1f} TFLOP/s f32, "
        f"{peak_bw / 1e12:.2f} TB/s")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for src in build.SOURCES:
        report = build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {src}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    kernels = []

    # ---- 3a. pointnet_global at the main-path shapes -------------------------
    n_pts = N_INT + N_BND
    mlp_g = MLP(FE_GLOBAL, activation="silu", generator=gen).to(dev)
    x = torch.randn((BATCH, n_pts, FE_GLOBAL[0]), generator=gen).to(dev)
    lin_g = mlp_g.linears
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
    macs = sum(a * b for a, b in zip(FE_GLOBAL[:-1], FE_GLOBAL[1:]))
    flops = 2.0 * BATCH * n_pts * macs
    nbytes = 4 * (x.numel() + sum(p.numel() for p in mlp_g.parameters())
                  + 2 * BATCH * FE_GLOBAL[-1])
    b_ms, b_by = bound(flops, nbytes, peak_flops, peak_bw)
    kernels.append({"name": "pointnet_global", "route": "cuda",
                    "source": "porous_cfd_tpu_torch/ops/csrc/pointnet_global.cu",
                    "replaces": REPLACES["pointnet_global"], "launches": None,
                    "max_abs_err": err_pn, "tolerance": f"{RTOL} * max|ref|",
                    "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None,
                    "flop": flops, "bytes": nbytes})
    log(json.dumps({"kernel_timing": kernels[-1]}))

    # ---- 3b. decoder_prop (internal + boundary launches) ---------------------
    dec = MLP(SEG, SEG_DROPOUT, "silu", last_activation=False, generator=gen).to(dev)
    lin_d = dec.linears
    n_local = FE_LOCAL[-1]
    dims = 2

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v = rnd(BATCH, N_INT, n_local)
    jt = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    ht = rnd(BATCH, dims, N_INT, n_local, scale=0.5)
    v_b = rnd(BATCH, N_BND, n_local)
    g = rnd(BATCH, 1, SEG[0] - n_local)
    args = (lin_d, n_local, v, jt, ht, v_b, g, "silu")
    out_k = decoder_cuda.decoder_prop(*args)
    torch.cuda.synchronize()
    out_p = decoder_cuda.decoder_prop_plain(*args)
    torch.cuda.synchronize()
    err_dec = check_close("decoder_prop", list(zip(("v", "jac", "lap"), out_k, out_p)))
    ms_k = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args))
    ms_p = time_ms(torch, lambda: decoder_cuda.decoder_prop_plain(*args))
    args_int = (lin_d, n_local, v, jt, ht, None, g, "silu")
    ms_int = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args_int))
    macs = n_local * SEG[1] + sum(a * b for a, b in zip(SEG[1:-1], SEG[2:]))
    rows = BATCH * N_INT * (1 + 2 * dims) + BATCH * N_BND
    flops = 2.0 * rows * macs + 2.0 * BATCH * (SEG[0] - n_local) * SEG[1]
    nbytes = 4 * (v.numel() + jt.numel() + ht.numel() + v_b.numel() + g.numel()
                  + sum(p.numel() for p in dec.parameters())
                  + sum(t.numel() for t in out_k))
    b_ms, b_by = bound(flops, nbytes, peak_flops, peak_bw)
    kernels.append({"name": "decoder_prop", "route": "cuda",
                    "source": "porous_cfd_tpu_torch/ops/csrc/decoder_prop.cu",
                    "replaces": REPLACES["decoder_prop"], "launches": None,
                    "max_abs_err": err_dec, "tolerance": f"{RTOL} * max|ref|",
                    "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None,
                    "ms_internal_launch": ms_int,
                    "ms_boundary_launch": ms_k - ms_int,
                    "flop": flops, "bytes": nbytes})
    log(json.dumps({"kernel_timing": kernels[-1]}))
    del out_k, out_p

    # ---- 4. the slice: verbose prediction, 4 batches of 13 -------------------
    data = make_foam_batch(N_CASES, N_INT, N_BND, N_OBS, seed=SEED)
    scalers = make_scalers()
    model = pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, scalers,
                      seg_dropout=SEG_DROPOUT,
                      generator=torch.Generator().manual_seed(SEED), device=dev)
    warm = gather_cases(data, torch.arange(BATCH))
    evaluate(model, warm, BATCH, scalers)            # warm-up, not counted

    pointnet_cuda.pointnet_global.launches = 0
    decoder_cuda.decoder_prop.launches = 0
    ev = evaluate(model, data, BATCH, scalers)
    launches = {"pointnet_global": pointnet_cuda.pointnet_global.launches,
                "decoder_prop": decoder_cuda.decoder_prop.launches}
    n_batches = len(ev.predictions)
    log(f"slice: {n_batches} batches, launches {launches}")
    if launches != {"pointnet_global": n_batches, "decoder_prop": 2 * n_batches}:
        fail(f"launch counts {launches} != 1 and 2 per batch over {n_batches} batches")
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
    log(f"slice: verbose prediction {ms_batch:.3f} ms per batch of {BATCH} "
        f"(median of {SLICE_RUNS} runs, {runs_ms[0]:.3f} to {runs_ms[-1]:.3f}), "
        f"{cases_s:.1f} cases/s ({name}; {smi})")

    # one batch on the card against the same module and batch on the CPU
    batch = gather_cases(data, torch.arange(BATCH))
    fns = make_predict_functions(model)
    with torch.no_grad():
        out_g = model.derivative_apply(batch.to(dev))
    pred_g, extras_g = fns.predict_batch(batch.to(dev), True)
    cpu_model = pipn_foam(NU, D, F, FE_LOCAL, FE_GLOBAL, SEG, scalers,
                          seg_dropout=SEG_DROPOUT,
                          generator=torch.Generator().manual_seed(SEED), device="cpu")
    cpu_model.module.load_state_dict(copy.deepcopy(model.module).cpu().state_dict())
    with torch.no_grad():
        out_c = cpu_model.derivative_apply(batch)
    pred_c, extras_c = make_predict_functions(cpu_model).predict_batch(batch, True)
    check_close("slice card-vs-CPU", [
        ("fields", out_g[0].cpu(), out_c[0]), ("jac", out_g[1].cpu(), out_c[1]),
        ("lap", out_g[2].cpu(), out_c[2]),
        ("Momentum", extras_g["Momentum"].cpu(), extras_c["Momentum"]),
        ("div", extras_g["div"].cpu(), extras_c["div"]),
        ("predicted fields", pred_g.data.cpu(), pred_c.data)])

    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"slice": {"ms_per_batch": ms_batch, "cases_per_s": cases_s,
                              "runs_ms_per_batch": runs_ms,
                              "batches": n_batches, "batch_size": BATCH,
                              "points": [N_INT, N_BND, N_OBS]}}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
