"""Training steps/s of the two U-Nets at the bench envelope (counterpart of
``tools/measure_full_rates.py``).

    python -m porous_cfd_tpu_torch.tools.measure_full_rates [--steps 8]
        [--families pipn_pp_full,pi_gano_pp_full]

``pipn_pp_full`` and ``pi_gano_pp_full`` from the bench zoo (the examples'
``pipn-pp-full`` and ``pi-gano-pp-full`` at full width, their analytic
paths, the examples' fixed loss weights), on 13 cases of the envelope's
points (one batch, one step an epoch), as the JAX tool writes them out by
hand: ``profiling.steps_per_sec`` over --steps steps after a warm-up step.
Prints one JSON line, with the card's name and power limit. Runs on the
CUDA card; ``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, Envelope, header, load_subject
from porous_cfd_tpu_torch.utils import profiling


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--families", default="pipn_pp_full,pi_gano_pp_full")
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """The rates on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for); prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    env = dataclasses.replace(envelope, cases=envelope.batch)
    rates = {}
    for family in args.families.split(","):
        s = load_subject(family, device, env, steps_per_epoch=1)
        rates[family], _ = profiling.steps_per_sec(s.fns.train_step, s.state, s.batch,
                                                   n_steps=args.steps)
        del s
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {**header("measure_full_rates", device), "batch": env.batch,
           "steps_per_sec": rates}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()
