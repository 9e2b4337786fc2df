"""duct_variable_boundary training: variable inlet velocity and per-case
Darcy-Forchheimer coefficients, the PI-GANO family (the port's counterpart
of ``examples/duct_variable_boundary/train.py``, the same model zoo at full
width and the same loss scalers).

    python -m porous_cfd_tpu_torch.examples.duct_variable_boundary.train \\
        --model pi-gano-full --train-dir data/train --val-dir data/val

``pi-gano-pp-full`` is the U-Net, on its decoupled-hierarchy analytic
path. From the command line it trains on the CUDA card; ``run(argv,
device="cpu")`` trains on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.pi_gano import pi_gano, pi_gano_pp, pi_gano_pp_full
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler, RelobraloScaler
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, spawn_workers, train

NU = 1489.4e-6
VARIABLE_BOUNDARIES = {"Subdomains": ["inlet", "internal"],
                       "Features": ["U-inlet", "d", "f"]}
N_DIM = 2
N_BOUNDARY_ID = 4
SEED = 8421


def get_loss_scaler(args):
    if args.loss_scaler == "relobralo":
        return RelobraloScaler(9, alpha=1 - 0.995)
    return FixedLossScaler.from_dict({"continuity": [1],
                                      "momentum": [1] * 2,
                                      "boundary": [1] * 3,
                                      "observations": [100] * 3})


def get_model(args, normalizers, device=None, fast_derivatives: bool = True):
    """The reference zoo (duct_variable_boundary/train.py:21-83), weights
    drawn from seed 8421. ``fast_derivatives`` picks ``pi-gano-pp-full``'s
    path (the CLI trains the analytic one)."""
    n_dim, n_bid = N_DIM, N_BOUNDARY_ID
    base = dict(nu=NU, out_features=3, scalers=normalizers,
                variable_boundaries=VARIABLE_BOUNDARIES,
                generator=torch.Generator().manual_seed(SEED), device=device)
    common = dict(base, branch_layers=[8, 128, 352, 352, 352],
                  local_layers=[n_dim, 64, 176, 176, 176], n_operators=4,
                  operator_dropout=[0, 0.1, 0.1, 0])
    match args.model:
        case "pi-gano":
            return pi_gano(geometry_layers=[n_dim + n_bid + 1, 64, 176, 176, 176],
                           fast_derivatives=True, **common)
        case "pi-gano-full":
            return pi_gano(geometry_layers=[n_dim + n_bid + 1, 64, 176, 176, 176], full=True,
                           fast_derivatives=True, **common)
        case "pi-gano-pp":
            return pi_gano_pp(geometry_layers=[[n_dim * 2 + n_bid, 64, 64],
                                               [64 + n_dim, 176, 176],
                                               [176 + n_dim, 176, 176]],
                              geometry_radius=[0.5, 1], geometry_fraction=[0.5, 0.25],
                              max_neighbors=32, **common)
        case "pi-gano-pp-full":
            return pi_gano_pp_full(
                branch_layers=[8, 128, 256, 256, 256],
                enc_layers=[[n_dim * 2 + n_bid + 1, 64, 64, 128],
                            [128 + n_dim, 128, 128, 256],
                            [256 + n_dim, 512]],
                enc_radius=[0.5, 1], enc_fraction=[0.5, 0.25],
                dec_layers=[[512 + 256, 256, 256],
                            [128 + 256, 128, 128],
                            [128 + n_dim + n_bid + 1, 128, 128, 128, 3]],
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
    rng = np.random.default_rng(SEED)
    train_data = FoamDataset(args.train_dir, args.n_internal, args.n_boundary,
                             args.n_observations, rng=rng)
    val_data = FoamDataset(args.val_dir, args.n_internal, args.n_boundary,
                           args.n_observations, rng=rng, meta_dir=args.train_dir)
    model = get_model(args, train_data.normalizers, device)
    train(args, model, train_data, val_data, get_loss_scaler(args), device)
    return model


if __name__ == "__main__":
    run()
