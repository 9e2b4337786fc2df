"""duct_fixed_boundary inference (the port's counterpart of
``examples/duct_fixed_boundary/inference.py``): restore a checkpoint the
training CLI wrote and predict every case of a split, one at a time.

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary.inference \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

The model type comes from the ``model_meta.json`` beside the checkpoint.
From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU. The field plots (``--save-plots``) are not ported yet.
"""
from __future__ import annotations

from argparse import Namespace

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.data.parser import parse_model_type
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import SEED, get_model
from porous_cfd_tpu_torch.pipelines.inference import build_arg_parser, predict
from porous_cfd_tpu_torch.train.trainer import load_checkpoint


def load_model_and_params(args: Namespace, data: FoamDataset, device=None):
    """The model of the checkpoint's type built over ``data``'s normalizers
    on ``device`` (the CUDA card unless ``"cpu"`` is asked for), with the
    checkpoint's weights restored into its module. Returns (model, state)."""
    model = get_model(Namespace(**{**vars(args), "model": parse_model_type(args.checkpoint),
                                   "loss_scaler": "fixed"}),
                      data.normalizers, resolve_device(device))
    state, _ = load_checkpoint(args.checkpoint, model)
    return model, state


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split and
    predict each case on ``device``; returns the predictions."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = FoamDataset(args.data_dir, args.n_internal, args.n_boundary, args.n_observations,
                       np.random.default_rng(SEED), args.meta_dir)
    model, _ = load_model_and_params(args, data, device=device)
    return predict(args, model, data)


if __name__ == "__main__":
    run()
