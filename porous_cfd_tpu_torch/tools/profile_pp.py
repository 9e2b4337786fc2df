"""Where the PIPN++ (or PI-GANO) training step's milliseconds go on the card
at the bench envelope (counterpart of ``tools/profile_pp.py``).

    python -m porous_cfd_tpu_torch.tools.profile_pp [--family pipn_pp|pi_gano|pi_gano_pp]

Times, as device ms and CUDA-event wall ms per call
(``profiling.device_ms``): the derivative forward; where the family pools
its geometry through a SetAbstraction chain, that chain's forward and
forward+backward twice, through its kernels (``sa_seq_fused``:
sa_neighborhood a radius level, pointnet_global for the global level; the
JAX tool's ``sa_seq_fused``) and through the module's plain PyTorch forward
(the JAX tool's "xla" sequence); and for ``pipn_pp`` the local chain and
the decoder (``_decoder_prop_dispatch``: decoder_prop), forward and
forward+backward. The full step's ms and steps/s come from
``profiling.steps_per_sec`` (20 steps). ``pi_gano`` pools its geometry
through pointnet_global alone, so it has no SetAbstraction chain to time
(the JAX tool reads PI-GANO++'s chain there); ``pi_gano_pp`` times its.
Beyond ``profile_predict`` (the kernels' device time of a whole step) it
times the SA chain's kernels beside their plain version. Prints one JSON
line, with the card's name and power limit. Runs on the CUDA card;
``run(argv, device="cpu")`` on the CPU, with host times only.
"""
from __future__ import annotations

import argparse
import json

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, Envelope, header, load_subject, time_pieces
from porous_cfd_tpu_torch.utils import profiling

FAMILIES = ("pipn_pp", "pi_gano", "pi_gano_pp")
SA_PIECES = ("sa_fwd", "sa_fwdbwd", "sa_plain_fwd", "sa_plain_fwdbwd")


def piece_names(family: str) -> list:
    names = ["derivative_fwd"]
    if family != "pi_gano":
        names += SA_PIECES
    if family == "pipn_pp":
        names += ["local+decoder_fwd", "local+decoder_fwdbwd"]
    return names


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", default="pipn_pp", choices=FAMILIES)
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """Profile on ``device`` (the CUDA card unless ``"cpu"`` is asked for);
    prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    s = load_subject(args.family, device, envelope)
    rate, s.state = profiling.steps_per_sec(s.fns.train_step, s.state, s.batch, n_steps=20)
    report = {**header("profile_pp", device, family=args.family),
              "train_step_ms": 1e3 / rate, "train_steps_per_sec": rate,
              "pieces": time_pieces(s, piece_names(args.family))}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    run()
