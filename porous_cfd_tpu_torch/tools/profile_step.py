"""The training step's time and MFU on the card at the bench envelope
(counterpart of ``tools/profile_step.py``).

    python -m porous_cfd_tpu_torch.tools.profile_step [--family pipn|pipn_exact|pipn_pp|pi_gano]

Measures on the card:
  1. the matmul peak at an (8192, 2048) @ (2048, 2048) product (20 runs after 3
     warm-ups, synchronized), with TF32 allowed and with it off: the
     counterparts of the JAX tool's default and highest precision;
  2. the value-only forward (``eval_batch``) and the full step (``train_step``:
     the gradients and Adam), each as device ms and CUDA-event wall ms per
     call (``profiling.device_ms``), and the step's steps/s
     (``profiling.steps_per_sec``, 20 steps);
  3. the step's FLOPs from the port's matmul inventory
     (``roofline.step_flops``, where the JAX tool reads XLA's
     ``cost_analysis``), its achieved TFLOP/s and its MFU against both
     peaks.

Beyond ``profile_predict`` (where a step's device time goes, kernel by
kernel) it gives the step's rate against the card's measured matmul peak.
Prints one JSON line, with the card's name and power limit. Runs on the
CUDA card; ``run(argv, device="cpu")`` on the CPU, with host times only.
"""
from __future__ import annotations

import argparse
import json

import torch

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools import roofline
from porous_cfd_tpu_torch.tools.pieces import (ENVELOPE, SEED, Envelope, header, load_subject,
                                               time_piece)
from porous_cfd_tpu_torch.utils import profiling

FAMILIES = ("pipn", "pipn_exact", "pipn_pp", "pi_gano")
PEAK_SHAPE = (8192, 2048, 2048)     # (M, K, N) of the peak's product


def matmul_rate(device, m: int, k: int, n: int, tf32: bool) -> float:
    """FLOP/s of one (m, k) @ (k, n) product, the mean of 20 after 3
    warm-ups, with TF32 allowed or not."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    a = torch.randn((m, k), generator=gen, device=device)
    b = torch.randn((k, n), generator=gen, device=device)
    with roofline.tf32(tf32):
        seconds, _ = profiling.timed(torch.matmul, a, b, n=20, warmup=3)
    return 2.0 * m * k * n / seconds


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", default="pipn", choices=FAMILIES)
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """Profile on ``device`` (the CUDA card unless ``"cpu"`` is asked for);
    prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    m, k, n = PEAK_SHAPE
    peak_tf32 = matmul_rate(device, m, k, n, True)
    peak_f32 = matmul_rate(device, m, k, n, False)
    s = load_subject(args.family, device, envelope)
    pieces = {"eval_fwd": time_piece(lambda: s.fns.eval_batch(s.batch), device),
              "step": time_piece(lambda: s.fns.train_step(s.state, s.batch)[1], device)}
    rate, s.state = profiling.steps_per_sec(s.fns.train_step, s.state, s.batch, n_steps=20)
    flops = roofline.step_flops(args.family, envelope)
    report = {**header("profile_step", device, family=args.family),
              "matmul_shape": [m, k, n], "matmul_peak_tf32_tflops": peak_tf32 / 1e12,
              "matmul_peak_f32_tflops": peak_f32 / 1e12, "pieces": pieces,
              "train_step_ms": 1e3 / rate, "train_steps_per_sec": rate,
              "inventory_step_gflops": flops / 1e9, "achieved_tflops": flops * rate / 1e12,
              "mfu_vs_f32_peak_pct": 100 * flops * rate / peak_f32,
              "mfu_vs_tf32_peak_pct": 100 * flops * rate / peak_tf32}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    run()
