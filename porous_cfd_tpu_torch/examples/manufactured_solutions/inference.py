"""manufactured_solutions inference (the port's counterpart of
``examples/manufactured_solutions/inference.py``): restore a checkpoint the
training CLI wrote and predict every case of a split, one at a time; with
``--save-plots`` each case's predicted, ground-truth and absolute-error
fields are drawn under ``<checkpoint parent>/plots/<split>/<case>/``
(matplotlib).

    python -m porous_cfd_tpu_torch.examples.manufactured_solutions.inference \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train --n-internal 200 --n-boundary 80

The model type comes from the ``model_meta.json`` beside the checkpoint.
From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from __future__ import annotations

from argparse import Namespace

import numpy as np

from porous_cfd_tpu_torch.data.manufactured import ManufacturedDataset
from porous_cfd_tpu_torch.data.parser import parse_model_type
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.inference import plot_case_fields
from porous_cfd_tpu_torch.examples.manufactured_solutions.train import D, F, SEED, get_model
from porous_cfd_tpu_torch.pipelines.inference import build_arg_parser, predict
from porous_cfd_tpu_torch.train.trainer import load_checkpoint


def sample_process_fn(data, target, predicted, case_path, plot_path):
    """Predicted / ground truth / absolute error field plots, in the
    dataset's own units (manufactured_solutions/inference.py:18-28);
    nothing without a plot directory."""
    if plot_path is not None:
        plot_case_fields(data, target, predicted, plot_path, denormalise=False)


def load_split(args: Namespace) -> ManufacturedDataset:
    """The ``--data-dir`` split, sampled with the ``--meta-dir`` meta from
    an rng of seed 8421."""
    return ManufacturedDataset(args.data_dir, args.n_internal, args.n_boundary, D, F,
                               rng=np.random.default_rng(SEED), meta_dir=args.meta_dir)


def load_model(args: Namespace, device=None):
    """The model of the checkpoint's type on ``device``, the checkpoint's
    weights restored into its module. Returns (model, state)."""
    model = get_model(parse_model_type(args.checkpoint), D, F, resolve_device(device))
    state, _ = load_checkpoint(args.checkpoint, model)
    return model, state


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split and
    predict each case on ``device``; returns the predictions."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = load_split(args)
    model, _ = load_model(args, device)
    return predict(args, model, data, sample_process_fn)


if __name__ == "__main__":
    run()
