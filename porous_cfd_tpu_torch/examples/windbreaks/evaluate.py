"""windbreaks evaluation (the port's counterpart of
``examples/windbreaks/evaluate.py``): verbose prediction of a split from a
checkpoint, the common error statistics, the errors on the house's surface
(the ``solid`` patch) and the mean absolute error per (d, inlet speed).

    python -m porous_cfd_tpu_torch.examples.windbreaks.evaluate \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

It prints one JSON line: the mean absolute errors of U and p
(denormalised); the mean absolute error of each field (Ux, Uy, Uz, p) over
the house's surface points of every case (the reference's "Solid Average
relative error"); the MAE of each field at each (d, inlet speed), the
per-case MAEs averaged over the cases of a pair (the numbers of the
reference's "MAE heatmap"); the error table's rows (``errors``: label ->
one value a field); and the inference time per case. With ``--save-plots``
the plots (the house's error distribution and bars, the MAE heatmap among
them), the timing against the solver's and ``Errors.csv`` go under
``<checkpoint parent>/plots/<split>/stats/`` (matplotlib). From the command
line it runs on the CUDA card; ``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import json

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.windbreaks.inference import load_model_and_params
from porous_cfd_tpu_torch.examples.windbreaks.train import SEED
from porous_cfd_tpu_torch.pipelines.evaluation import (build_arg_parser, evaluate_split,
                                                       extract_coef, extract_u_magnitude,
                                                       inverse_transform, mae_by, per_case_mae)
from porous_cfd_tpu_torch.viz.common import (plot_data_dist, plot_errors,
                                             plot_errors_vs_multi_vars)


def sample_process(normalizers, predicted, target, extras):
    """The house's surface errors and each case's d, f and inlet speed
    (windbreaks/evaluate.py:19-35)."""
    u_s, p_s = normalizers["U"], normalizers["p"]
    pred, tgt = predicted.numpy(), target.numpy()
    solid_u_err = np.abs(inverse_transform(u_s, pred["solid"]["U"])
                         - inverse_transform(u_s, tgt["solid"]["U"]))
    solid_p_err = np.abs(inverse_transform(p_s, pred["solid"]["p"])
                         - inverse_transform(p_s, tgt["solid"]["p"]))
    d = np.round(extract_coef(tgt["d"], normalizers["d"])).astype(np.int64)
    f = extract_coef(tgt["f"], normalizers["f"])
    u_mag = extract_u_magnitude(tgt["inlet"]["Ux-inlet"], u_s[0], 1e-6)
    return {"U error solid": solid_u_err, "p error solid": solid_p_err,
            "d": d, "f": f, "U inlet": u_mag}


def postprocess_fn(data, results, plots_path=None):
    """The house's surface mean errors and the MAE by (d, inlet speed), and
    their plots under ``--save-plots`` (windbreaks/evaluate.py:38-53)."""
    solid = np.concatenate([results["U error solid"], results["p error solid"]], -1)
    results["Solid mean error"] = np.mean(solid.reshape(-1, solid.shape[-1]), axis=0)
    results["MAE by d and inlet speed"] = mae_by(results, ["d", "U inlet"])
    if plots_path is not None:
        u_solid = np.concatenate(results["U error solid"])
        p_solid = np.concatenate(results["p error solid"])
        plot_data_dist("Solid Absolute error distribution", u_solid, p_solid,
                       save_path=plots_path)
        plot_errors("Solid Average relative error", results["Solid mean error"].tolist(),
                    save_path=plots_path)
        d = np.asarray(results["d"]).flatten()
        u_inlet = np.asarray(results["U inlet"]).flatten()
        plot_errors_vs_multi_vars("MAE heatmap", per_case_mae(results), d.astype(np.int64),
                                  u_inlet, ["D", "U"], plots_path)


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
               "solid_mae": [float(x) for x in res["Solid mean error"]],
               "mae_by_d_and_inlet_speed": res["MAE by d and inlet speed"],
               "errors": ev.errors,
               "inference_ms_per_case": ev.avg_inference_time * 1e3}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    run()
