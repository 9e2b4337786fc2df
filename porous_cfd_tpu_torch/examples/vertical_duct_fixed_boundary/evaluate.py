"""vertical_duct_fixed_boundary evaluation (the port's counterpart of
``examples/vertical_duct_fixed_boundary/evaluate.py``): the
duct_fixed_boundary evaluation over a ``VerticalDuctDataset`` with the
``momentError`` and ``div(phi)`` fields. It prints one JSON line: the mean
absolute errors of U and p, the pressure drops and the inference time per
case.

    python -m porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.evaluate \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from __future__ import annotations

from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.vertical_duct_dataset import \
    VerticalDuctDataset


def run(argv=None, device=None) -> dict:
    """Parse ``argv`` (the command line when None), evaluate the split on
    ``device`` and print (and return) the summary line."""
    return evaluate.run(argv, device, VerticalDuctDataset)


if __name__ == "__main__":
    run()
