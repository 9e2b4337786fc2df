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

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import SEED, get_model
from porous_cfd_tpu_torch.pipelines import inference


def load_model_and_params(args: Namespace, data: FoamDataset, device=None):
    """The model of the checkpoint's type built over ``data``'s normalizers
    on ``device`` (the CUDA card unless ``"cpu"`` is asked for), with the
    checkpoint's weights restored into its module. Returns (model, state)."""
    return inference.restore(args, data, get_model, device)


def run(argv=None, device=None, dataset_cls=FoamDataset):
    """Parse ``argv`` (the command line when None), load the split as a
    ``dataset_cls`` and predict each case on ``device``; returns the
    predictions."""
    return inference.run(argv, get_model, SEED, device, dataset_cls)


if __name__ == "__main__":
    run()
