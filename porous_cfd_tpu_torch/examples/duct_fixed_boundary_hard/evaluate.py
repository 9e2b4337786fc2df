"""duct_fixed_boundary_hard evaluation: the duct_fixed_boundary pipeline
(the port's counterpart of ``examples/duct_fixed_boundary_hard/evaluate.py``).
It prints one JSON line: the mean absolute errors of U and p, the pressure
drops and the inference time per case.

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard.evaluate \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.evaluate import run

__all__ = ["run"]

if __name__ == "__main__":
    run()
