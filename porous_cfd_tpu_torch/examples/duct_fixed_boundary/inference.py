"""duct_fixed_boundary inference (the port's counterpart of
``examples/duct_fixed_boundary/inference.py``): restore a checkpoint the
training CLI wrote and predict every case of a split, one at a time; with
``--save-plots`` each case's denormalised predicted, ground-truth and
absolute-error fields are drawn under
``<checkpoint parent>/plots/<split>/<case>/`` (matplotlib).

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary.inference \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

The model type comes from the ``model_meta.json`` beside the checkpoint.
From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from __future__ import annotations

from argparse import Namespace

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import SEED, get_model
from porous_cfd_tpu_torch.pipelines import inference
from porous_cfd_tpu_torch.pipelines.evaluation import inverse_transform
from porous_cfd_tpu_torch.viz.viz2d import plot_fields


def plot_case_fields(data, target, predicted, plot_path, title="Predicted",
                     denormalise=True):
    """A case's predicted (titled ``title``), ground-truth and
    absolute-error field plots under ``plot_path``, in the units of
    ``data``'s normalizers' inverse, or in the dataset's own units without
    ``denormalise``."""
    tgt = target.numpy()

    def field(case, key):
        x = np.asarray(case[key])
        return inverse_transform(data.normalizers[key], x) if denormalise else x

    pts, zone = field(tgt, "C"), np.asarray(tgt["cellToRegion"])
    pred_u, pred_p = field(predicted, "U"), field(predicted, "p")
    tgt_u, tgt_p = field(tgt, "U"), field(tgt, "p")

    plot_fields(title, pts, pred_u, pred_p, zone, save_path=plot_path)
    plot_fields("Ground truth", pts, tgt_u, tgt_p, zone, save_path=plot_path)
    plot_fields("Absolute error", pts, np.abs(pred_u - tgt_u),
                np.abs(pred_p - tgt_p), zone, plot_streams=False,
                save_path=plot_path)


def sample_process_fn(data, target, predicted, case_path, plot_path):
    """Predicted / ground truth / absolute error field plots
    (duct_fixed_boundary/inference.py:28-59); nothing without a plot
    directory."""
    if plot_path is not None:
        plot_case_fields(data, target, predicted, plot_path)


def load_model_and_params(args: Namespace, data: FoamDataset, device=None):
    """The model of the checkpoint's type built over ``data``'s normalizers
    on ``device`` (the CUDA card unless ``"cpu"`` is asked for), with the
    checkpoint's weights restored into its module. Returns (model, state)."""
    return inference.restore(args, data, get_model, device)


def run(argv=None, device=None, dataset_cls=FoamDataset):
    """Parse ``argv`` (the command line when None), load the split as a
    ``dataset_cls`` and predict each case on ``device``; returns the
    predictions."""
    return inference.run(argv, get_model, SEED, device, dataset_cls, sample_process_fn)


if __name__ == "__main__":
    run()
