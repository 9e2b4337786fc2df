"""vertical_duct_fixed_boundary comparison (the port's counterpart of
``examples/vertical_duct_fixed_boundary/compare.py``): the
duct_fixed_boundary comparison over a ``VerticalDuctDataset``.

    python -m porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.compare \\
        --checkpoint lightning_logs/A/model.ckpt \\
        --checkpoint-other lightning_logs/B/model.ckpt \\
        --data-dir data/val --meta-dir data/train

From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from __future__ import annotations

from porous_cfd_tpu_torch.examples.duct_fixed_boundary import compare
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.vertical_duct_dataset import \
    VerticalDuctDataset


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split, restore
    both checkpoints and compare them on ``device``; returns the
    comparison."""
    return compare.run(argv, device, VerticalDuctDataset)


if __name__ == "__main__":
    run()
