"""The same-card framework ratio: the reference formulation's step in plain
PyTorch autograd against the port's own steps, on one device (counterpart
of ``tools/samehost_ratio.py``, whose "same host" becomes the same card).

    python -m porous_cfd_tpu_torch.tools.samehost_ratio [--torch-steps 2]
        [--port-steps 20] [--port-exact-steps 5]

Both sides run the same mathematical step at the duct_fixed_boundary
envelope (batch 13, 1500 / 1000 / 700 points, the PIPN topology,
second-order residuals, the composite loss, Adam) on the same device.
``torch_baseline`` runs in a subprocess of its own (its allocator and
thread pools apart), with seven ``create_graph`` replays; the port is
measured twice in this process: ``pipn_exact``, its exact autodiff path
(the same formulation), and ``pipn``, its default decoupled analytic path
on the hand-written kernels (what a user gets). Each rate is steps over the
host's time between two device syncs, after one warm-up step. Prints one
JSON line with the JAX tool's keys, ``jax_`` renamed ``port_``, and the
card's name and power limit. Runs on the CUDA card; ``run(argv,
device="cpu")`` on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, Envelope, header, load_subject
from porous_cfd_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]


def measure_port(family: str, device, env: Envelope, steps: int) -> float:
    """steps/s of the port's ``family`` on the envelope's first batch."""
    s = load_subject(family, device, env)
    s.state, m = s.fns.train_step(s.state, s.batch)
    profiling.sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        s.state, m = s.fns.train_step(s.state, s.batch)
    profiling.sync(device)
    return steps / (time.perf_counter() - t0)


def measure_torch(device, steps: int, shape) -> float:
    """steps/s of ``torch_baseline`` in a subprocess on ``device``."""
    code = ("from porous_cfd_tpu_torch.tools import torch_baseline; "
            f"torch_baseline.run(['--steps', '{steps}'], device={str(device)!r}, "
            f"shape={tuple(shape)!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, check=True, timeout=3600)
    line = next(l for l in reversed(proc.stdout.splitlines()) if l.startswith("{"))
    return json.loads(line)["steps_per_sec"]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--torch-steps", type=int, default=2)
    p.add_argument("--port-steps", type=int, default=20)
    p.add_argument("--port-exact-steps", type=int, default=5)
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """The ratio on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for); prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    torch_sps = measure_torch(device, args.torch_steps,
                              (envelope.batch, envelope.n_int, envelope.n_bnd, envelope.n_obs))
    port_exact = measure_port("pipn_exact", device, envelope, args.port_exact_steps)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    port_default = measure_port("pipn", device, envelope, args.port_steps)
    out = {**header("samehost_ratio", device),
           "host": "same-card measured pair (no estimates)" if device.type == "cuda"
           else "same-CPU measured pair (no estimates)",
           "torch_reference_steps_per_sec": torch_sps,
           "port_exact_autodiff_steps_per_sec": port_exact,
           "port_default_steps_per_sec": port_default,
           "ratio_exact_formulation": port_exact / torch_sps,
           "ratio_default_path": port_default / torch_sps}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()
