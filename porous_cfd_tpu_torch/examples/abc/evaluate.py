"""abc evaluation (the port's counterpart of ``examples/abc/evaluate.py``):
verbose prediction of a split from a checkpoint, the common error
statistics and the mean absolute error per inlet speed.

    python -m porous_cfd_tpu_torch.examples.abc.evaluate \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

It prints one JSON line: the mean absolute errors of U and p (denormalised),
the MAE of each field (Ux, Uy, Uz, p) at each inlet speed (each case's
speed snapped to 0.025, the per-case MAEs averaged over the cases of a
speed: the numbers of the reference's "MAE by inlet speed" plot), the
error table's rows (``errors``: label -> one value a field) and the
inference time per case. With ``--save-plots`` the plots, the timing
against the solver's and ``Errors.csv`` go under
``<checkpoint parent>/plots/<split>/stats/`` (matplotlib). From the command
line it runs on the CUDA card; ``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import json

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.abc.inference import load_model_and_params
from porous_cfd_tpu_torch.examples.abc.train import SEED
from porous_cfd_tpu_torch.pipelines.evaluation import (build_arg_parser, evaluate_split,
                                                       extract_u_magnitude, mae_by, per_case_mae)
from porous_cfd_tpu_torch.viz.common import plot_errors_vs_var


def sample_process(normalizers, predicted, target, extras):
    """Each case's inlet speed (abc/evaluate.py:17-20)."""
    return {"U inlet": extract_u_magnitude(target.numpy()["inlet"]["U"], normalizers["U"],
                                           0.025)}


def postprocess_fn(data, results, plots_path=None):
    """The per-case MAE of each field by inlet speed, and its plot under
    ``--save-plots`` (abc/evaluate.py:23-28)."""
    results["MAE by inlet speed"] = mae_by(results, ["U inlet"])
    if plots_path is not None:
        u_inlet = np.asarray(results["U inlet"]).flatten()
        plot_errors_vs_var("MAE by inlet speed", per_case_mae(results), u_inlet,
                           ["U inlet", "MAE"], plots_path)


def run(argv=None, device=None) -> dict:
    """Parse ``argv`` (the command line when None), evaluate the split on
    ``device`` and print (and return) the summary line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = FoamDataset(args.data_dir, args.n_internal, args.n_boundary, args.n_observations,
                       np.random.default_rng(SEED), args.meta_dir,
                       extra_fields=["momentError", "div(phi)"])
    model, _ = load_model_and_params(args, data, device=device)
    ev = evaluate_split(args, model, data, sample_process, postprocess_fn, enable_timing=True)
    res = ev.results
    summary = {"cases": len(data),
               "U_mae": float(np.mean(res["U error"])),
               "p_mae": float(np.mean(res["p error"])),
               "mae_by_inlet_speed": res["MAE by inlet speed"],
               "errors": ev.errors,
               "inference_ms_per_case": ev.avg_inference_time * 1e3}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    run()
