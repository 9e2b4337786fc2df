"""vertical_duct_fixed_boundary training (the port's counterpart of
``examples/vertical_duct_fixed_boundary/train.py``): the duct with a second
inlet on top, read through ``VerticalDuctDataset`` (the top inlet folded
into the inlet's id), the duct_fixed_boundary zoo and loss weights. It
fine-tunes: ``--checkpoint`` names a duct_fixed_boundary checkpoint, whose
weights, optimizer state and epoch the run resumes from (the shuffles of
the epochs before it replayed), so ``--epochs`` counts on from that epoch.

    python -m porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.train \\
        --model pipn --train-dir data/train --val-dir data/val \\
        --checkpoint lightning_logs/FIXED/model.ckpt --epochs 4000

From the command line it trains on the CUDA card; ``run(argv,
device="cpu")`` trains on the CPU.
"""
from __future__ import annotations

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import (get_loss_scaler, get_model,
                                                                     make_datasets)
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.vertical_duct_dataset import \
    VerticalDuctDataset
from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, spawn_workers, train


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the splits and
    train on ``device`` (the CUDA card unless ``"cpu"`` is asked for) from
    ``--checkpoint``. Returns the model, its module trained in place (None where
    ``--mesh-data`` / ``--mesh-points`` spawned the ranks: ``spawn_workers``)."""
    args = build_arg_parser().parse_args(argv)
    if spawn_workers(run, argv, args, device):
        return None
    device = resolve_device(device)
    train_data, val_data = make_datasets(args, VerticalDuctDataset)
    model = get_model(args, train_data.normalizers, device)
    train(args, model, train_data, val_data, get_loss_scaler(args), device)
    return model


if __name__ == "__main__":
    run()
