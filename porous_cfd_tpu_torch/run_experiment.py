"""Stage runner (the port's counterpart of the root ``run_experiment.py``;
reference run_singularity.py:9-15): imports
``porous_cfd_tpu_torch.examples.<EXPERIMENT>.<RUNCMD>`` and calls its
``run()`` after chdir'ing into the experiment's directory,
``examples/<EXPERIMENT>/`` at the repository root (where its ``assets/`` and
the git-ignored ``data/`` and ``lightning_logs/`` live), so relative paths
match the reference layout.

Usage:  EXPERIMENT=duct_fixed_boundary RUNCMD=train \\
            python -m porous_cfd_tpu_torch.run_experiment [args...]

``porous_cfd_tpu_torch/launch.sh`` runs several stages through it.
"""
import importlib
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    experiment = os.environ["EXPERIMENT"]
    runcmd = os.environ["RUNCMD"]
    module = importlib.import_module(
        f"porous_cfd_tpu_torch.examples.{experiment}.{runcmd}")
    os.chdir(ROOT / "examples" / experiment)
    return module.run()


if __name__ == "__main__":
    main()
