"""manufactured_solutions training: the physics-only PIPN and PIPN++ checked
against the analytic Navier-Stokes-Darcy solution, with no CFD solver (the
port's counterpart of ``examples/manufactured_solutions/train.py``, the same
model zoo at full width).

    python -m porous_cfd_tpu_torch.examples.manufactured_solutions.generate_data
    python -m porous_cfd_tpu_torch.examples.manufactured_solutions.train \\
        --model pipn-pp --train-dir data/train --val-dir data/val \\
        --n-internal 200 --n-boundary 80 --n-observations 0

``pipn`` takes the exact autodiff operator (``pipn_manufactured``'s default,
as the JAX CLI trains it), ``pipn-pp`` its analytic path, which is exact for
that family. The cases of ``generate_data`` hold 200 internal and 80
boundary points, so sample at most that many. From the command line it
trains on the CUDA card; ``run(argv, device="cpu")`` trains on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from porous_cfd_tpu_torch.data.manufactured import ManufacturedDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.pipn import pipn_manufactured, pipn_manufactured_pp
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, spawn_workers, train

NU, D, F = 0.01, 50.0, 1.0
N_DIM = 2
N_BOUNDARY_IDS = 2
SEED = 8421


def get_model(name: str, d: float = D, f: float = F, device=None):
    """The reference zoo (manufactured_solutions/train.py:9-29), weights
    drawn from seed 8421, on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for)."""
    n_dim, n_bid = N_DIM, N_BOUNDARY_IDS
    common = dict(nu=NU, d=d, f=f, fe_local_layers=[n_dim, 64, 64],
                  seg_layers=[1024 + 64, 512, 256, 128, 3], activation="tanh",
                  generator=torch.Generator().manual_seed(SEED), device=device)
    match name:
        case "pipn":
            return pipn_manufactured(fe_global_layers=[64 + n_bid + 1, 64, 128, 1024],
                                     **common)
        case "pipn-pp":
            return pipn_manufactured_pp(fe_global_layers=[[n_dim * 2 + n_bid, 64],
                                                          [64 + n_dim, 128],
                                                          [128 + n_dim, 1024]],
                                        fe_global_radius=[0.6, 1.2],
                                        fe_global_fraction=[0.5, 0.25], **common)
        case _:
            raise NotImplementedError(name)


def make_datasets(args):
    """The training split and the validation split (sampled with the
    training split's meta), both from one rng of seed 8421."""
    rng = np.random.default_rng(SEED)
    train_data = ManufacturedDataset(args.train_dir, args.n_internal, args.n_boundary, D, F,
                                     rng=rng)
    val_data = ManufacturedDataset(args.val_dir, args.n_internal, args.n_boundary, D, F,
                                   rng=rng, meta_dir=args.train_dir)
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
    model = get_model(args.model, D, F, device)
    train(args, model, train_data, val_data, None, device)
    return model


if __name__ == "__main__":
    run()
