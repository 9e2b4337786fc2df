"""Where the PI-GANO training step's milliseconds go on the card at the
bench envelope (counterpart of ``tools/profile_gano.py``).

    python -m porous_cfd_tpu_torch.tools.profile_gano

Times, as device ms and CUDA-event wall ms per call
(``profiling.device_ms``, the port's stand-in for the JAX tool's scan
delta): the derivative forward, the points encoder and trunk (the local
(v, J, H) and ``neural_ops_prop`` on fixed geometry and branch embeddings),
the points encoder's (v, J, H) alone, the geometry encoder and the branch
(each ``pointnet_global``), and the loss gradient. The full step's ms and
steps/s come from ``profiling.steps_per_sec`` (20 steps). Beyond
``profile_predict`` (the kernels' device time of a whole step) it splits
the step into the encoders. Prints one JSON line, with the card's name and
power limit. Runs on the CUDA card; ``run(argv, device="cpu")`` on the CPU,
with host times only.
"""
from __future__ import annotations

import argparse
import json

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, Envelope, header, load_subject, time_pieces
from porous_cfd_tpu_torch.utils import profiling

PIECE_NAMES = ("derivative_fwd", "local+trunk_fwd", "local_vjh_fwd", "geometry_fwd",
               "branch_fwd", "loss_grad")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """Profile on ``device`` (the CUDA card unless ``"cpu"`` is asked for);
    prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    s = load_subject("pi_gano", device, envelope)
    rate, s.state = profiling.steps_per_sec(s.fns.train_step, s.state, s.batch, n_steps=20)
    report = {**header("profile_gano", device, family="pi_gano"),
              "train_step_ms": 1e3 / rate, "train_steps_per_sec": rate,
              "pieces": time_pieces(s, PIECE_NAMES)}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    run()
