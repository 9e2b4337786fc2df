"""duct_fixed_boundary_hard training (the port's counterpart of
``examples/duct_fixed_boundary_hard/train.py``): composed multi-primitive
porous obstacles, the duct_fixed_boundary zoo and datasets with the
observation loss weights [30, 30, 100].

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard.train \\
        --model pipn --train-dir data/train --val-dir data/val

From the command line it trains on the CUDA card; ``run(argv,
device="cpu")`` trains on the CPU.
"""
from __future__ import annotations

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import get_model, make_datasets
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler, RelobraloScaler
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, spawn_workers, train


def get_loss_scaler(args):
    """Observation weights [30, 30, 100] (duct_fixed_boundary_hard/train.py:10-17)."""
    if args.loss_scaler == "relobralo":
        return RelobraloScaler(9, alpha=1 - 0.995)
    return FixedLossScaler.from_dict({"continuity": [1],
                                      "momentum": [1] * 2,
                                      "boundary": [1] * 3,
                                      "observations": [30, 30, 100]})


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
