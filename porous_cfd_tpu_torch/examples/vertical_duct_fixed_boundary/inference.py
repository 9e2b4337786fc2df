"""vertical_duct_fixed_boundary inference (the port's counterpart of
``examples/vertical_duct_fixed_boundary/inference.py``): the
duct_fixed_boundary pipeline over a ``VerticalDuctDataset``.

    python -m porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.inference \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from __future__ import annotations

from porous_cfd_tpu_torch.examples.duct_fixed_boundary import inference
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.vertical_duct_dataset import \
    VerticalDuctDataset


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split and
    predict each case on ``device``; returns the predictions."""
    return inference.run(argv, device, VerticalDuctDataset)


if __name__ == "__main__":
    run()
