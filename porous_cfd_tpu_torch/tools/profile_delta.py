"""The PIPN, PIPN++ and PI-GANO training steps taken apart on the card at
the bench envelope (counterpart of ``tools/profile_delta.py``).

    python -m porous_cfd_tpu_torch.tools.profile_delta [--family pipn_pp|pi_gano|pipn] [--n 10]

Times every piece that the JAX tool times (``pieces.py``; each a plain
function of the subject, which the tests hold to the JAX package's
sub-programs), as device ms and CUDA-event wall ms per call
(``profiling.device_ms``), on the batch with the model's
``attach_neighbors`` applied: the step, the loss gradient, the losses'
forward, the derivative forward and forward+backward, the local (v, J, H);
for ``pipn_pp`` the SA chain forward and forward+backward and the local
chain with the decoder; for ``pipn`` the local chain with pointnet_global
(the argmax rows too), with the winner chain (``_winner_gather_ctx``), and
the whole coupled and decoupled paths, forward and forward+backward; for
``pi_gano`` the geometry encoder, the branch and the local chain with the
trunk. The JAX tool's scan delta (n against 2n iterations of one jitted
scan) has no PyTorch counterpart; the kernel sum under ``torch.profiler`` is
its device ms per iteration. Beyond ``profile_predict`` (the kernels of a
whole step) it times the step's sub-programs one by one. Prints one JSON
line, with the card's name and power limit. Runs on the CUDA card;
``run(argv, device="cpu")`` on the CPU, with host times only.
"""
from __future__ import annotations

import argparse
import json

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, Envelope, header, load_subject, time_pieces

COMMON = ("step", "loss_grad", "losses_fwd", "derivative_fwd", "derivative_fwdbwd",
          "local_vjh_fwd")
FAMILY_PIECES = {
    "pipn_pp": COMMON + ("sa_fwd", "sa_fwdbwd", "local+decoder_fwd", "local+decoder_fwdbwd"),
    "pipn": COMMON + ("local+pointnet_fwd", "local+winnerctx_fwd", "local+winnerctx_fwdbwd",
                      "full_coupled_fwd", "full_coupled_fwdbwd", "full_decoupled_fwd",
                      "full_decoupled_fwdbwd"),
    "pi_gano": COMMON + ("geometry_fwd", "branch_fwd", "local+trunk_fwd", "local+trunk_fwdbwd"),
}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", default="pipn_pp", choices=tuple(FAMILY_PIECES))
    p.add_argument("--n", type=int, default=10, help="calls a timed piece")
    return p


def run(argv=None, device=None, envelope: Envelope = ENVELOPE) -> dict:
    """Profile on ``device`` (the CUDA card unless ``"cpu"`` is asked for);
    prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    s = load_subject(args.family, device, envelope)
    report = {**header("profile_delta", device, family=args.family),
              "pieces": time_pieces(s, FAMILY_PIECES[args.family], args.n)}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    run()
