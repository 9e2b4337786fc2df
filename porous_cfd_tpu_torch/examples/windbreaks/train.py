"""windbreaks training: rows of porous trees around a solid house in 3D,
per-case Darcy-Forchheimer coefficients and a variable inlet speed, the
PI-GANO family with the physics losses weighted 10 (the port's counterpart
of ``examples/windbreaks/train.py``, the same model zoo at full width and
the same loss scalers).

    python -m porous_cfd_tpu_torch.examples.windbreaks.train \\
        --model pi-gano --train-dir data/train --val-dir data/val

``pi-gano`` takes its analytic derivative path, as the reference zoo asks;
``pi-gano-pp`` and ``pi-gano-pp-full`` (the U-Net, on its
decoupled-hierarchy path) their analytic defaults. From the command line it
trains on the CUDA card; ``run(argv, device="cpu")`` trains on the CPU.
"""
from __future__ import annotations

import torch

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import make_datasets
from porous_cfd_tpu_torch.models.pi_gano import pi_gano, pi_gano_pp, pi_gano_pp_full
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler, RelobraloScaler
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, spawn_workers, train

NU = 14.61e-6
VARIABLE_BOUNDARIES = {"Subdomains": ["inlet", "internal"],
                       "Features": ["Ux-inlet", "d", "f"]}
N_DIM = 3
N_BOUNDARY_ID = 5
SEED = 8421


def get_loss_scaler(args):
    """The physics losses weighted 10 (windbreaks/train.py:23-31)."""
    if args.loss_scaler == "relobralo":
        return RelobraloScaler(12, alpha=1 - 0.995)
    return FixedLossScaler.from_dict({"continuity": [10],
                                      "momentum": [10] * 3,
                                      "boundary": [1] * 4,
                                      "observations": [1] * 4})


def get_model(args, normalizers, device=None, fast_derivatives: bool = True):
    """The reference zoo (windbreaks/train.py:33-76), weights drawn from seed
    8421. ``fast_derivatives`` picks ``pi-gano-pp-full``'s path (the CLI
    trains the analytic one; the exact one runs in micro-batches of 2)."""
    n, b = N_DIM, N_BOUNDARY_ID
    base = dict(nu=NU, out_features=n + 1, scalers=normalizers,
                variable_boundaries=VARIABLE_BOUNDARIES,
                generator=torch.Generator().manual_seed(SEED), device=device)
    common = dict(base, branch_layers=[10, 256, 256, 512], local_layers=[n, 256, 256, 256],
                  n_operators=4, operator_dropout=[0, 0.15, 0.15, 0])
    match args.model:
        case "pi-gano":
            return pi_gano(geometry_layers=[b + n + 1, 256, 256, 256], fast_derivatives=True,
                           **common)
        case "pi-gano-pp":
            return pi_gano_pp(geometry_layers=[[n * 2 + b, 64, 128],
                                               [128 + n, 128],
                                               [128 + n, 256, 256]],
                              geometry_radius=[0.5, 1], geometry_fraction=[0.5, 0.25],
                              **common)
        case "pi-gano-pp-full":
            return pi_gano_pp_full(
                branch_layers=[10, 256, 256, 256],
                enc_layers=[[n * 2 + 1 + b, 64, 64, 128],
                            [128 + n, 128, 128, 256],
                            [256 + n, 512, 1024]],
                enc_radius=[0.5, 1], enc_fraction=[0.5, 0.25],
                dec_layers=[[1024 + 256, 256, 256],
                            [128 + 256, 128, 128],
                            [128 + n + 1 + b, 128, 128, 128, 4]],
                dec_k=[3, 3, 3], fp_dropout=[0.0, 0.0, [0.0, 0.2, 0.2, 0.0]],
                fast_derivatives=fast_derivatives, **base)
        case _:
            raise NotImplementedError(args.model)


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the splits and
    train on ``device`` (the CUDA card unless ``"cpu"`` is asked for).
    Returns the model, its module trained in place (None where
    ``--mesh-data`` / ``--mesh-points`` spawned the ranks: ``spawn_workers``)."""
    args = build_arg_parser().parse_args(argv)
    if spawn_workers(run, argv, args, device):
        return None
    device = resolve_device(device)
    train_data, val_data = make_datasets(args)
    model = get_model(args, train_data.normalizers, device)
    train(args, model, train_data, val_data, get_loss_scaler(args), device)
    return model


if __name__ == "__main__":
    run()
