"""The training step's model-FLOP utilization on the card (counterpart of
``tools/mfu.py``).

    python -m porous_cfd_tpu_torch.tools.mfu [--families pipn,pipn_exact,pipn_pp,pi_gano]
        [--update FILE]

Measures on the card:
  1. the matmul peak: a chain of 8 products of 8192-square matrices
     (each the next one's input) in f32 with TF32 off and in bf16, between
     two CUDA events after a warm-up chain;
  2. each family's steps/s at the bench envelope (``profiling.steps_per_sec``
     over 30 steps of ``train_step`` on its first batch of 13 cases);
  3. MFU = the step's FLOPs x steps/s / each peak.

A step's FLOPs are the port's matmul inventory
(``roofline.step_flops``), where the JAX tool reads XLA's
``cost_analysis``: the port compiles no XLA program, and
``torch.utils.flop_counter`` cannot see the hand-written kernels. Beyond
``tools/tc_ceiling.py`` (the tensor cores' TF32 ceiling) and
``profile_predict`` (a step's device time kernel by kernel), it gives the
share of the card's measured matmul peaks that whole training steps reach.

Prints one JSON line, with the card's name and power limit. ``--update
FILE`` rewrites the MFU block (between ``<!-- MFU:begin -->`` and
``<!-- MFU:end -->``) of FILE, and appends one where it has none. Runs on
the CUDA card; ``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import argparse
import json

import torch

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools import roofline
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, SEED, Envelope, header, load_subject
from porous_cfd_tpu_torch.utils import profiling

BEGIN, END = "<!-- MFU:begin -->", "<!-- MFU:end -->"


def measure_matmul_peak(device, n: int = roofline.PEAK_SIZE, iters: int = 8) -> dict:
    """FLOP/s of a chain of ``iters`` (n, n) products, f32 (TF32 off) and
    bf16."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a = torch.randn((n, n), generator=gen, device=device).to(dtype)
        b = (torch.randn((n, n), generator=gen, device=device) / n ** 0.5).to(dtype)

        def chain():
            y = a
            for _ in range(iters):
                y = y @ b
            return y

        with roofline.tf32(False):
            chain()
            ms = roofline.time_ms(chain, device)
        out[name] = 2.0 * n ** 3 * iters / (ms / 1e3)
    return out


def measure_family(family: str, device, env: Envelope, n_steps: int = 30) -> dict:
    s = load_subject(family, device, env)
    rate, _ = profiling.steps_per_sec(s.fns.train_step, s.state, s.batch, n_steps=n_steps)
    flops = roofline.step_flops(family, env)
    return {"steps_per_sec": rate, "flops_per_step": flops,
            "achieved_flops_per_sec": flops * rate}


def block(result: dict) -> str:
    """The MFU block's markdown."""
    peak = result["matmul_peak_tflops"]
    lines = [BEGIN, f"Generated by `python -m porous_cfd_tpu_torch.tools.mfu` on "
             f"{result['card'] or result['device']}: measured matmul peak {peak['f32']:.2f} "
             f"TFLOP/s (f32, TF32 off) / {peak['bf16']:.2f} TFLOP/s (bf16). FLOPs a step: the "
             "port's matmul inventory (`roofline.step_flops`).", "",
             "| Family | steps/s | inventory GFLOP/step | achieved TFLOP/s "
             "| MFU (f32 peak) | MFU (bf16 peak) |", "|---|---|---|---|---|---|"]
    for fam, r in result["families"].items():
        lines.append(f"| {fam} | {r['steps_per_sec']:.2f} | {r['flops_per_step'] / 1e9:.1f} "
                     f"| {r['achieved_flops_per_sec'] / 1e12:.2f} "
                     f"| {100 * r['mfu_vs_f32_peak']:.1f}% | {100 * r['mfu_vs_bf16_peak']:.2f}% |")
    lines.append(END)
    return "\n".join(lines)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--families", default="pipn,pipn_exact,pipn_pp,pi_gano")
    p.add_argument("--update", default=None, metavar="FILE",
                   help="rewrite the MFU block in FILE")
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """MFU on ``device`` (the CUDA card unless ``"cpu"`` is asked for);
    prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    peak = measure_matmul_peak(device)
    result = {**header("mfu", device),
              "matmul_peak_tflops": {k: v / 1e12 for k, v in peak.items()},
              "flops_source": "roofline.step_flops (the port's matmul inventory)",
              "families": {}}
    for family in args.families.split(","):
        r = measure_family(family, device, envelope)
        r["mfu_vs_f32_peak"] = r["achieved_flops_per_sec"] / peak["f32"]
        r["mfu_vs_bf16_peak"] = r["achieved_flops_per_sec"] / peak["bf16"]
        result["families"][family] = r
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.update:
        roofline.update_block(args.update, block(result), BEGIN, END)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    run()
