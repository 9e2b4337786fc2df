"""duct_fixed_boundary_hard comparison: the duct_fixed_boundary pipeline
(the port's counterpart of ``examples/duct_fixed_boundary_hard/compare.py``).

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard.compare \\
        --checkpoint lightning_logs/A/model.ckpt \\
        --checkpoint-other lightning_logs/B/model.ckpt \\
        --data-dir data/val --meta-dir data/train

From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.compare import run

__all__ = ["run"]

if __name__ == "__main__":
    run()
