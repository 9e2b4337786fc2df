"""duct_fixed_boundary training: a 2D duct with a porous obstacle, a fixed
inlet and fixed porosity coefficients, the PIPN family with data and physics
losses (the port's counterpart of ``examples/duct_fixed_boundary/train.py``,
the same model zoo at full width and the same loss scalers).

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary.train \\
        --model pipn --train-dir data/train --val-dir data/val

``pipn`` takes the decoupled analytic derivative path by default,
``--coupled-context`` the max-pool-coupled one and ``--exact-derivatives``
the exact autodiff operator; ``pipn-pp``, ``pipn-pp-mrg`` and
``pipn-pp-full`` (the U-Net, on its decoupled-hierarchy path) take their
analytic paths. From the command line it trains on the CUDA card;
``run(argv, device="cpu")`` trains on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.pipn import (pipn_foam, pipn_foam_pp, pipn_foam_pp_full,
                                              pipn_foam_pp_mrg)
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler, RelobraloScaler
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, spawn_workers, train

NU, D, F = 1489.4e-6, 14000.0, 17.11
N_DIM = 2
N_BOUNDARY_IDS = 4
SEED = 8421


def get_loss_scaler(args):
    """Observation weight 100 (duct_fixed_boundary/train.py:10-17)."""
    if args.loss_scaler == "relobralo":
        return RelobraloScaler(9, alpha=1 - 0.995)
    return FixedLossScaler.from_dict({"continuity": [1],
                                      "momentum": [1] * 2,
                                      "boundary": [1] * 3,
                                      "observations": [100] * 3})


def get_model(args, normalizers, device=None, fast_derivatives: bool = True):
    """The reference zoo (duct_fixed_boundary/train.py:20-80), weights drawn
    from seed 8421. ``fast_derivatives`` picks ``pipn-pp-full``'s path (the
    CLI trains the analytic one)."""
    n_dim, n_bid = N_DIM, N_BOUNDARY_IDS
    common = dict(nu=NU, d=D, f=F, fe_local_layers=[n_dim, 64, 64], scalers=normalizers,
                  activation="silu", generator=torch.Generator().manual_seed(SEED),
                  device=device)
    match args.model:
        case "pipn":
            return pipn_foam(fe_global_layers=[64 + 1 + n_bid, 96, 128, 1024],
                             seg_layers=[1024 + 64, 512, 256, 128, 3],
                             seg_dropout=[0.05, 0.05, 0, 0],
                             fast_derivatives=not getattr(args, "exact_derivatives", False),
                             coupled_context=getattr(args, "coupled_context", False),
                             **common)
        case "pipn-pp":
            return pipn_foam_pp(fe_global_layers=[[n_dim + n_bid + 2, 64, 64],
                                                  [64 + n_dim, 128, 128],
                                                  [128 + n_dim, 256, 1024]],
                                fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
                                seg_layers=[1024 + 64, 378, 128, 3], seg_dropout=[0.05, 0, 0],
                                **common)
        case "pipn-pp-mrg":
            return pipn_foam_pp_mrg(n_dims=n_dim, mrg_in_features=n_bid + n_dim,
                                    seg_layers=[1024 + 64, 384, 128, 3],
                                    seg_dropout=[0.05, 0, 0], **common)
        case "pipn-pp-full":
            return pipn_foam_pp_full(
                enc_layers=[[n_dim * 2 + 1 + n_bid, 64, 64, 128],
                            [128 + n_dim, 128, 128, 256],
                            [256 + n_dim, 1024]],
                enc_radius=[0.4, 0.8], enc_fraction=[0.5, 0.25],
                dec_layers=[[1024 + 256, 256, 256],
                            [128 + 256, 128, 128],
                            [128 + n_bid + n_dim + 1, 128, 128, 128, 3]],
                dec_k=[3, 3, 3], dec_dropout=[0.0, 0.0, [0.15, 0.15, 0.0, 0.0]],
                fast_derivatives=fast_derivatives,
                **{k: v for k, v in common.items() if k != "fe_local_layers"})
        case _:
            raise NotImplementedError(args.model)


def make_datasets(args, dataset_cls=FoamDataset):
    """The training split and the validation split as ``dataset_cls``es, the
    latter normalised with the former's statistics, both sampled from one
    rng of seed 8421."""
    rng = np.random.default_rng(SEED)
    train_data = dataset_cls(args.train_dir, args.n_internal, args.n_boundary,
                             args.n_observations, rng=rng)
    val_data = dataset_cls(args.val_dir, args.n_internal, args.n_boundary,
                           args.n_observations, rng=rng, meta_dir=args.train_dir)
    return train_data, val_data


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
