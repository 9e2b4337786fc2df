"""The training step's matmul inventory at the bench envelope, and its
per-layer dot-model floor measured on the card (counterpart of
``tools/roofline.py``).

    python -m porous_cfd_tpu_torch.tools.roofline [--families pipn,...]
        [--measured JSON] [--peak-tflops T] [--update FILE]

Method:
  1. ``family_shapes`` lists each family's matmuls with the rows the port
     computes them on, the FLOP count the port's MFU rests on (``mfu``,
     ``profile_step``): no profiler sees into the hand-written kernels, and
     the port has no XLA ``cost_analysis``. Two differences from the JAX
     tool's count (``tools/roofline.py:46-97``), both what the port's paths
     compute: (a) ``1 + 2D`` rows an internal point on the analytic paths
     (value, J, and the Hessian's diagonal; the JAX tool counts the whole
     symmetric Hessian, ``1 + D + D(D+1)/2``); (b) on ``pipn``,
     ``pipn_coupled`` and ``pipn_pp`` the decoder's first layer takes its
     ``n_local`` (64) columns on every row and its 1024 context columns once
     a case (the JAX tool counts all 1088 on every row). ``pipn_exact``
     keeps the JAX count: that path replays the whole MLP ``1 + D + D^2``
     times. Every other row count is the JAX tool's, among them
     PI-GANO's branch at 1,600 rows a case and the SA levels' padded K
     slots. A step is 3 times its forward (dX and dW a layer).
  2. ``measure_dot_rate`` gives each distinct (M, K, N) product's sustained
     rate on the device by a delta: r and then 2r serially dependent
     products (``c += a @ b``) between CUDA events, in full f32 (TF32 off,
     the accuracy the port's 3xTF32 kernels are held to), so that the fixed
     cost of a timing drops out.
  3. ``dot_model_ms`` is the sum over the inventory of FLOPs over rate: the
     floor of running the same products layer by layer. With ``--measured``
     steps/s it adds the measured ms, the fused speed-up over the dot model,
     the achieved TFLOP/s and its share of the measured f32 matmul peak
     (an 8192-square product, or ``--peak-tflops``).

Beyond ``tools/time_engine.py`` (each hand-written kernel at the paths'
shapes), it gives the floor of the same products run layer by layer in
cuBLAS, the yardstick of the fused kernels' worth. Prints one JSON line,
with the card's name and power limit. ``--update FILE`` rewrites the
ROOFLINE block (between ``<!-- ROOFLINE:begin -->`` and
``<!-- ROOFLINE:end -->``) of FILE, and appends one where it has none. Runs
on the CUDA card; ``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import torch

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.neighbors import fps_count
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, SEED, Envelope, header

DIMS = 2
VJH = 1 + 2 * DIMS        # value, J and the Hessian's diagonal: difference (a)
BWD = 3.0                 # a step's products: the forward, dX and dW
F_GLOBAL = 1024           # PIPN's pooled feature
N_LOCAL = 64              # PIPN's local feature, the decoder's per-row columns
K_NEIGHBORS = 64          # PIPN++'s neighbourhood slots
FAMILIES = ("pipn", "pipn_coupled", "pipn_exact", "pipn_pp", "pi_gano")
# the bench zoo's widths (porous_cfd_tpu_torch/bench.py: the examples' get_model)
PIPN_LOCAL, PIPN_GLOBAL = [2, 64, 64], [69, 96, 128, 1024]
PIPN_SEG = [1088, 512, 256, 128, 3]
PP_SA = ([8, 64, 64], [66, 128, 128], [130, 256, 1024])
PP_FRACTION = (0.5, 0.25)
PP_SEG = [1088, 378, 128, 3]
PG_BRANCH, PG_GEOMETRY = [8, 128, 352, 352, 352], [7, 64, 176, 176, 176]
PG_LOCAL, PG_TRUNK, PG_REDUCTION = [2, 64, 176, 176, 176], [352] * 5, [352, 3]
# the rate a timing is sized by (FLOP/s), a device type's
ASSUMED_RATE = {"cuda": 50e12, "cpu": 50e9}
BEGIN, END = "<!-- ROOFLINE:begin -->", "<!-- ROOFLINE:end -->"
PEAK_SIZE = 8192          # the square product of the matmul peak
PG_BRANCH_ROWS = 1600     # PI-GANO's branch rows a case, as the JAX tool counts them


def mlp_shapes(widths, rows):
    """[(M, K, N)] of a Dense stack applied to ``rows`` rows."""
    return [(int(rows), k, n) for k, n in zip(widths[:-1], widths[1:])]


def decoder_shapes(widths, rows, cases, n_local=N_LOCAL):
    """A decoder whose first layer reads ``n_local`` columns a row and a
    per-case context (difference (b)): the local block on every row, the
    context block once a case, then the rest on every row."""
    return ([(int(rows), n_local, widths[1]), (int(cases), widths[0] - n_local, widths[1])]
            + mlp_shapes(widths[1:], rows))


def rows(env: Envelope = ENVELOPE) -> dict:
    """The row pools of the envelope's batch: the analytic paths' (v, J,
    H-diag) rows on the internal points and value rows on the boundary, the
    value rows of every point, the exact path's replays, the coupled path's
    winner chains."""
    b = env.batch
    return {"vjh": b * (env.n_int * VJH + env.n_bnd), "all": b * (env.n_int + env.n_bnd),
            "exact": b * (env.n_int + env.n_bnd) * (1 + DIMS + DIMS ** 2),
            "winner": b * F_GLOBAL * VJH}


def family_shapes(family: str, env: Envelope = ENVELOPE):
    """The family's matmuls (M, K, N), forward, at ``env``; in the JAX
    tool's order."""
    r = rows(env)
    b = env.batch
    if family == "pipn":
        return (mlp_shapes(PIPN_LOCAL, r["vjh"]) + mlp_shapes(PIPN_GLOBAL, r["all"])
                + decoder_shapes(PIPN_SEG, r["vjh"], b))
    if family == "pipn_coupled":
        return (mlp_shapes(PIPN_LOCAL, r["vjh"]) + mlp_shapes(PIPN_GLOBAL, r["all"])
                + mlp_shapes(PIPN_GLOBAL[:-1], r["winner"])
                + decoder_shapes(PIPN_SEG, r["vjh"], b))
    if family == "pipn_exact":
        return (mlp_shapes(PIPN_LOCAL, r["exact"]) + mlp_shapes(PIPN_GLOBAL, r["exact"])
                + mlp_shapes(PIPN_SEG, r["exact"]))
    if family == "pipn_pp":
        c1 = fps_count(env.n_bnd, PP_FRACTION[0])
        c2 = fps_count(c1, PP_FRACTION[1])
        return (mlp_shapes(PIPN_LOCAL, r["vjh"])
                + mlp_shapes(PP_SA[0], b * c1 * K_NEIGHBORS)
                + mlp_shapes(PP_SA[1], b * c2 * K_NEIGHBORS)
                + mlp_shapes(PP_SA[2], b * c2)
                + decoder_shapes(PP_SEG, r["vjh"], b))
    if family == "pi_gano":
        return (mlp_shapes(PG_BRANCH, b * PG_BRANCH_ROWS)
                + mlp_shapes(PG_GEOMETRY, r["all"])
                + mlp_shapes(PG_LOCAL, r["vjh"])
                + mlp_shapes(PG_TRUNK, r["vjh"])
                + mlp_shapes(PG_REDUCTION, r["vjh"]))
    raise KeyError(f"no matmul inventory for {family!r}; families: {', '.join(FAMILIES)}")


def shapes_flops(shapes) -> float:
    return sum(2.0 * m * k * n for m, k, n in shapes)


def step_flops(family: str, env: Envelope = ENVELOPE) -> float:
    """A training step's matmul FLOPs: 3 times the forward inventory."""
    return BWD * shapes_flops(family_shapes(family, env))


def decoder_fwd_flops(family: str, env: Envelope = ENVELOPE) -> float:
    """The forward FLOPs of a PIPN family's decoder (one ``decoder_prop``
    call, both launches), as the inventory counts them."""
    seg = {"pipn": PIPN_SEG, "pipn_coupled": PIPN_SEG, "pipn_pp": PP_SEG}[family]
    return shapes_flops(decoder_shapes(seg, rows(env)["vjh"], env.batch))


def time_ms(fn, device) -> float:
    """The ms of one ``fn()`` on ``device``: between two CUDA events on the
    card, on the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def tf32(allowed: bool):
    """TF32 products allowed or not inside the block (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def measure_dot_rate(m: int, k: int, n: int, device) -> float:
    """Sustained FLOP/s of (m, k) @ (k, n) in full f32 by the delta method:
    the extra work of 2r over r serially dependent products (``c += a @
    b``), over the extra time (the best of two timings each). Where noise
    leaves no positive delta, the 2r products over their own time, fixed
    cost included: a lower bound."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    a = torch.rand((m, k), generator=gen, device=device)
    b = torch.rand((k, n), generator=gen, device=device) / k
    c = torch.zeros((m, n), device=device)
    flops = 2.0 * m * k * n

    def timed(reps):
        def run():
            for _ in range(reps):
                c.addmm_(a, b)
        run()
        return min(time_ms(run, device) for _ in range(2)) / 1e3

    with tf32(False):
        reps = int(min(8192, max(8, 0.05 * ASSUMED_RATE[device.type] / flops)))
        t1, t2 = timed(reps), timed(2 * reps)
        if t2 - t1 < 0.02:       # faster than assumed: grow once and take the delta again
            reps *= 8
            t1, t2 = timed(reps), timed(2 * reps)
    if t2 <= t1:                 # noise left no delta: 2r products, their fixed cost included
        return flops * 2 * reps / t2
    return flops * reps / (t2 - t1)


def block(report: dict, peak_tflops: float, card) -> str:
    """The ROOFLINE block's markdown."""
    lines = [BEGIN, f"Generated by `python -m porous_cfd_tpu_torch.tools.roofline` on {card} "
             f"(f32 matmul peak {peak_tflops:.2f} TFLOP/s, measured).", "",
             "| Family | matmul GF/step (port inventory) | per-layer dot-model ms | measured ms "
             "| fused speed-up vs dot model | achieved TF/s | % of measured f32 matmul peak |",
             "|---|---|---|---|---|---|---|"]
    def cell(e, key, fmt):
        return format(e[key], fmt) if key in e else "not measured"

    for fam, e in report.items():
        lines.append(f"| {fam} | {e['matmul_gflops_per_step']:.1f} | {e['dot_model_ms']:.3f} "
                     f"| {cell(e, 'measured_ms', '.3f')} "
                     f"| {cell(e, 'fusion_speedup_vs_dot_model', '.3f')} "
                     f"| {cell(e, 'achieved_tflops', '.2f')} "
                     f"| {cell(e, 'pct_of_matmul_peak', '.1f')} |")
    lines.append(END)
    return "\n".join(lines)


def update_block(path, text: str, begin: str, end: str) -> None:
    """Replace the block between ``begin`` and ``end`` in ``path`` by
    ``text`` (which holds both markers), or append it."""
    path = Path(path)
    doc = path.read_text() if path.exists() else ""
    if begin in doc and end in doc:
        doc = doc[:doc.index(begin)] + text + doc[doc.index(end) + len(end):]
    else:
        doc = doc.rstrip("\n") + ("\n\n" if doc else "") + text + "\n"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(doc)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--measured", default=None,
                   help="JSON object family -> measured steps/s")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="the f32 matmul peak; default: measure an 8192-square product")
    p.add_argument("--update", default=None, metavar="FILE",
                   help="rewrite the ROOFLINE block in FILE")
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """The inventory and dot model on ``device`` (the CUDA card unless
    ``"cpu"`` is asked for); prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    measured = json.loads(args.measured) if args.measured else {}
    peak = args.peak_tflops
    if peak is None:
        peak = measure_dot_rate(PEAK_SIZE, PEAK_SIZE, PEAK_SIZE, device) / 1e12
    rates = {}
    report = {}
    for family in args.families.split(","):
        dot_s = flops = 0.0
        for shape in family_shapes(family, envelope):
            if shape not in rates:
                rates[shape] = measure_dot_rate(*shape, device)
            f = 2.0 * shape[0] * shape[1] * shape[2] * BWD
            flops += f
            dot_s += f / rates[shape]
        entry = {"matmul_gflops_per_step": flops / 1e9, "dot_model_ms": dot_s * 1e3}
        if family in ("pipn", "pipn_coupled", "pipn_pp"):
            entry["decoder_fwd_gflops"] = decoder_fwd_flops(family, envelope) / 1e9
        if family in measured:
            ms = 1e3 / measured[family]
            entry.update(measured_steps_per_sec=measured[family], measured_ms=ms,
                         fusion_speedup_vs_dot_model=entry["dot_model_ms"] / ms,
                         achieved_tflops=flops / (ms / 1e3) / 1e12,
                         pct_of_matmul_peak=100 * flops / (ms / 1e3) / (peak * 1e12))
        report[family] = entry
    out = {**header("roofline", device), "envelope": vars(envelope) | {"vjh_rows": VJH},
           "matmul_peak_f32_tflops": peak, "per_family": report,
           "measured_dot_tflops_by_shape": {f"{m}x{k}x{n}": r / 1e12
                                            for (m, k, n), r in sorted(rates.items())}}
    if args.update:
        update_block(args.update, block(report, peak, out["card"] or str(device)), BEGIN, END)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()
