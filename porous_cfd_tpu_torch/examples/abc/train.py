"""abc training: 3D CAD objects of the ABC dataset aligned in a cylindrical
duct, a variable inlet speed in the data and fixed porosity coefficients,
the PIPN family with data and physics losses (the port's counterpart of
``examples/abc/train.py``, the same model zoo at full width and the same
loss scalers).

    python -m porous_cfd_tpu_torch.examples.abc.train \\
        --model pipn --train-dir data/train --val-dir data/val

``pipn`` takes the decoupled analytic derivative path by default,
``--coupled-context`` the max-pool-coupled one and ``--exact-derivatives``
the exact autodiff operator; ``pipn-pp``, ``pipn-pp-mrg`` and
``pipn-pp-full`` (the U-Net, on its decoupled-hierarchy path) take their
analytic paths. From the command line it trains on the CUDA card;
``run(argv, device="cpu")`` trains on the CPU.
"""
from __future__ import annotations

import torch

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import make_datasets
from porous_cfd_tpu_torch.models.pipn import (pipn_foam, pipn_foam_pp, pipn_foam_pp_full,
                                              pipn_foam_pp_mrg)
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler, RelobraloScaler
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, spawn_workers, train

NU, D, F = 1489.4e-6, 30000.0, 79.731
N_DIMS = 3
N_BOUNDARY_IDS = 4
SEED = 8421


def get_loss_scaler(args):
    """Observation weight 100 over 4 outputs (abc/train.py:22-30)."""
    if args.loss_scaler == "relobralo":
        return RelobraloScaler(12, alpha=1 - 0.995)
    return FixedLossScaler.from_dict({"continuity": [1],
                                      "momentum": [1] * 3,
                                      "boundary": [1] * 4,
                                      "observations": [100] * 4})


def get_model(args, normalizers, device=None, fast_derivatives: bool = True):
    """The reference zoo (abc/train.py:32-86), weights drawn from seed 8421.
    ``fast_derivatives`` picks ``pipn-pp-full``'s path (the CLI trains the
    analytic one; the exact one runs in micro-batches of 2)."""
    n, b = N_DIMS, N_BOUNDARY_IDS
    common = dict(nu=NU, d=D, f=F, scalers=normalizers, activation="silu",
                  generator=torch.Generator().manual_seed(SEED), device=device)
    match args.model:
        case "pipn":
            return pipn_foam(fe_local_layers=[n, 64, 64],
                             fe_global_layers=[64 + b + 1, 96, 128, 1024],
                             seg_layers=[1024 + 64, 512, 256, 128, n + 1],
                             seg_dropout=[0.03, 0.02, 0, 0],
                             fast_derivatives=not getattr(args, "exact_derivatives", False),
                             coupled_context=getattr(args, "coupled_context", False),
                             **common)
        case "pipn-pp":
            return pipn_foam_pp(fe_local_layers=[n, 64, 64],
                                seg_layers=[1024 + 64, 384, 128, n + 1],
                                seg_dropout=[0.03, 0, 0],
                                fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
                                fe_global_layers=[[n + b + n, 64, 128],
                                                  [128 + n, 128, 256],
                                                  [256 + n, 256, 1024]],
                                max_neighbors=16, **common)
        case "pipn-pp-mrg":
            return pipn_foam_pp_mrg(n_dims=n, mrg_in_features=b + n,
                                    fe_local_layers=[n, 64, 64],
                                    seg_layers=[1024 + 64, 384, 128, n + 1],
                                    seg_dropout=[0.03, 0, 0], max_neighbors=16, **common)
        case "pipn-pp-full":
            return pipn_foam_pp_full(
                enc_layers=[[n + b + 1 + n, 64, 64, 128],
                            [128 + n, 128, 128, 256],
                            [256 + n, 1024]],
                enc_radius=[0.4, 0.8], enc_fraction=[0.5, 0.25],
                dec_layers=[[1024 + 256, 256, 256],
                            [128 + 256, 128, 128],
                            [128 + n + b + 1, 128, 128, 128, n + 1]],
                dec_k=[3, 3, 3], dec_dropout=[0.0, 0.0, [0.0, 0.2, 0.2, 0.0]],
                max_neighbors=16, fast_derivatives=fast_derivatives, **common)
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
