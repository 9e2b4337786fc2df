"""duct_fixed_boundary two-checkpoint comparison (the port's counterpart of
``examples/duct_fixed_boundary/compare.py``): both checkpoints evaluated on
one split, the statistical tests over their errors written to ``Test.csv``
and ``Shapiro.csv`` under
``<lightning_logs>/comparisons/<name 1> vs <name 2>/<split>/``.

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary.compare \\
        --checkpoint lightning_logs/A/model.ckpt \\
        --checkpoint-other lightning_logs/B/model.ckpt \\
        --data-dir data/val --meta-dir data/train

It prints the tests' p-values and, last, one JSON line with them and each
model's inference time per case. From the command line it runs on the CUDA
card; ``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import SEED, get_model
from porous_cfd_tpu_torch.pipelines import compare


def run(argv=None, device=None, dataset_cls=FoamDataset):
    """Parse ``argv`` (the command line when None), load the split as a
    ``dataset_cls``, restore both checkpoints and compare them on
    ``device``; returns the comparison."""
    return compare.run(argv, get_model, SEED, device, dataset_cls)


if __name__ == "__main__":
    run()
