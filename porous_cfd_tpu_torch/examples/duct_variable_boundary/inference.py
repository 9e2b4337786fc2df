"""duct_variable_boundary inference (the port's counterpart of
``examples/duct_variable_boundary/inference.py``): restore a checkpoint the
training CLI wrote and predict every case of a split, one at a time; with
``--save-plots`` each case's denormalised predicted (titled with its d and
f), ground-truth and absolute-error fields are drawn under
``<checkpoint parent>/plots/<split>/<case>/`` (matplotlib).

    python -m porous_cfd_tpu_torch.examples.duct_variable_boundary.inference \\
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
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.inference import plot_case_fields
from porous_cfd_tpu_torch.examples.duct_variable_boundary.train import SEED, get_model
from porous_cfd_tpu_torch.pipelines import inference
from porous_cfd_tpu_torch.pipelines.evaluation import inverse_transform


def sample_process_fn(data, target, predicted, case_path, plot_path):
    """The field plots of the duct_fixed_boundary experiment, the predicted
    one titled with the case's d and f (duct_variable_boundary/inference.py
    :29-60); nothing without a plot directory."""
    if plot_path is None:
        return
    n, tgt = data.normalizers, target.numpy()
    d = float(np.max(inverse_transform(n["d"], tgt["d"])))
    f = float(np.max(inverse_transform(n["f"], tgt["f"])))
    plot_case_fields(data, target, predicted, plot_path, f"Predicted D={d:.0f} F={f:.2f}")


def load_model_and_params(args: Namespace, data: FoamDataset, device=None):
    """The model of the checkpoint's type built over ``data``'s normalizers
    on ``device`` (the CUDA card unless ``"cpu"`` is asked for), with the
    checkpoint's weights restored into its module. Returns (model, state)."""
    return inference.restore(args, data, get_model, device)


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split and
    predict each case on ``device``; returns the predictions."""
    return inference.run(argv, get_model, SEED, device, result_process_fn=sample_process_fn)


if __name__ == "__main__":
    run()
