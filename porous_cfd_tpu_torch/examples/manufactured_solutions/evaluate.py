"""manufactured_solutions evaluation (the port's counterpart of
``examples/manufactured_solutions/evaluate.py``): verbose prediction of a
split from a checkpoint against the analytic solution, with no solver
timing to compare (the JAX CLI passes ``enable_timing=False``).

    python -m porous_cfd_tpu_torch.examples.manufactured_solutions.evaluate \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train --n-internal 200 --n-boundary 80

It prints one JSON line: the mean absolute errors of U and p, their
relative L2 errors over the split, the mean absolute momentum and
continuity residuals, the error table's rows (``errors``: label -> one
value a field) and the inference time per case (the verbose prediction of
every batch, ending in a device sync). With ``--save-plots`` the plots and
``Errors.csv`` go under ``<checkpoint parent>/plots/<split>/stats/``
(matplotlib). From the command line it runs on the CUDA card;
``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import json

import numpy as np

from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.manufactured_solutions.inference import (load_model,
                                                                            load_split)
from porous_cfd_tpu_torch.pipelines.evaluation import build_arg_parser, evaluate_split


def sample_process(normalizers, predicted, target, extras):
    """Per case, the squared error and the squared reference of U and p,
    summed over the points: the parts of the split's relative L2 error."""
    pred, tgt = predicted.numpy(), target.numpy()
    out = {}
    for field in ("U", "p"):
        p, t = np.asarray(pred[field]), np.asarray(tgt[field])
        out[f"{field} squared error"] = np.sum((p - t) ** 2, axis=(-2, -1))
        out[f"{field} squared reference"] = np.sum(t ** 2, axis=(-2, -1))
    return out


def run(argv=None, device=None) -> dict:
    """Parse ``argv`` (the command line when None), evaluate the split on
    ``device`` and print (and return) the summary line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = load_split(args)
    model, _ = load_model(args, device)
    ev = evaluate_split(args, model, data, sample_process)
    res = ev.results

    def rel_l2(field):
        return float(np.sqrt(np.sum(res[f"{field} squared error"])
                             / np.sum(res[f"{field} squared reference"])))

    summary = {"cases": len(data),
               "U_mae": float(np.mean(res["U error"])),
               "p_mae": float(np.mean(res["p error"])),
               "U_rel_l2": rel_l2("U"), "p_rel_l2": rel_l2("p"),
               "momentum_mae": float(np.mean(np.abs(res["Predicted momentum"]))),
               "divergence_mae": float(np.mean(np.abs(res["Predicted divergence"]))),
               "errors": ev.errors,
               "inference_ms_per_case": ev.avg_inference_time * 1e3}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    run()
