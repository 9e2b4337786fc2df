"""abc inference (the port's counterpart of ``examples/abc/inference.py``):
restore a checkpoint the training CLI wrote and predict every case of a
split, one at a time; with ``--save-plots`` each case's denormalised
predicted, ground-truth and absolute-error fields are drawn as 3D scatters
under ``<checkpoint parent>/plots/<split>/<case>/`` (matplotlib).

    python -m porous_cfd_tpu_torch.examples.abc.inference \\
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
from porous_cfd_tpu_torch.examples.abc.train import SEED, get_model
from porous_cfd_tpu_torch.pipelines import inference
from porous_cfd_tpu_torch.pipelines.evaluation import inverse_transform
from porous_cfd_tpu_torch.viz.viz3d import plot_fields_3d


def load_model_and_params(args: Namespace, data: FoamDataset, device=None):
    """The model of the checkpoint's type built over ``data``'s normalizers
    on ``device`` (the CUDA card unless ``"cpu"`` is asked for), with the
    checkpoint's weights restored into its module. Returns (model, state)."""
    return inference.restore(args, data, get_model, device)


def sample_process_fn(data, target, predicted, case_path, plot_path):
    """Predicted / ground truth / absolute error 3D scatters
    (abc/inference.py:26-37); nothing without a plot directory."""
    if plot_path is None:
        return
    n, tgt = data.normalizers, target.numpy()
    pts = inverse_transform(n["C"], tgt["C"])
    pred_u = inverse_transform(n["U"], predicted["U"])
    pred_p = inverse_transform(n["p"], predicted["p"])
    tgt_u = inverse_transform(n["U"], tgt["U"])
    tgt_p = inverse_transform(n["p"], tgt["p"])
    plot_fields_3d("Predicted", pts, pred_u, pred_p, save_path=plot_path)
    plot_fields_3d("Ground truth", pts, tgt_u, tgt_p, save_path=plot_path)
    plot_fields_3d("Absolute error", pts, np.abs(pred_u - tgt_u),
                   np.abs(pred_p - tgt_p), save_path=plot_path)


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split and
    predict each case on ``device``; returns the predictions."""
    return inference.run(argv, get_model, SEED, device, result_process_fn=sample_process_fn)


if __name__ == "__main__":
    run()
