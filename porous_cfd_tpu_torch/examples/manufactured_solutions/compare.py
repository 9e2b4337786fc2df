"""manufactured_solutions two-checkpoint comparison (the port's counterpart
of ``examples/manufactured_solutions/compare.py``): both checkpoints
evaluated on one ``ManufacturedDataset`` split, the statistical tests over
their errors written to ``Test.csv`` and ``Shapiro.csv`` under
``<lightning_logs>/comparisons/<name 1> vs <name 2>/<split>/``.

    python -m porous_cfd_tpu_torch.examples.manufactured_solutions.compare \\
        --checkpoint lightning_logs/A/model.ckpt \\
        --checkpoint-other lightning_logs/B/model.ckpt \\
        --data-dir data/val --meta-dir data/train --n-internal 200 --n-boundary 80

It prints the tests' p-values and, last, one JSON line with them and each
model's inference time per case. From the command line it runs on the CUDA
card; ``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

from argparse import Namespace

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.manufactured_solutions.inference import (load_model,
                                                                            load_split)
from porous_cfd_tpu_torch.pipelines.compare import build_arg_parser, compare, report


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split, restore
    both checkpoints and compare them on ``device``; returns the
    comparison."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = load_split(args)
    model1, _ = load_model(args, device)
    model2, _ = load_model(Namespace(**{**vars(args), "checkpoint": args.checkpoint_other}),
                           device)
    return report(compare(args, model1, model2, data))


if __name__ == "__main__":
    run()
