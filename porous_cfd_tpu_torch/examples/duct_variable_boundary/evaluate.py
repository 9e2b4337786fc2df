"""duct_variable_boundary evaluation (the port's counterpart of
``examples/duct_variable_boundary/evaluate.py``): verbose prediction of a
split from a checkpoint, the common error statistics, each case's d, f,
inlet speed and angle, the MAE by inlet angle and by (d, inlet speed), and
the pressure drop across the duct.

    python -m porous_cfd_tpu_torch.examples.duct_variable_boundary.evaluate \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

It prints one JSON line: the mean absolute errors of U and p
(denormalised); the MAE of each field (Ux, Uy, p) at each inlet angle and
at each (d, inlet speed) (the per-case MAEs averaged over the cases that
share them: the numbers of the reference's "MAE by inlet angle" curve and
"MAE heatmap"); the predicted and target pressure drops and their absolute
difference; the error table's rows (``errors``: label -> one value a field,
null where empty, the pressure drop's row included); and the inference time
per case. With ``--save-plots`` the plots (the MAE by inlet angle, the MAE
heatmap, the pressure-drop bars among them), the timing against the
solver's and ``Errors.csv`` go under ``<checkpoint parent>/plots/<split>/stats/``
(matplotlib). From the command line it runs on the CUDA card;
``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import json

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.evaluate import add_pressure_drop
from porous_cfd_tpu_torch.examples.duct_variable_boundary.inference import load_model_and_params
from porous_cfd_tpu_torch.examples.duct_variable_boundary.train import SEED
from porous_cfd_tpu_torch.pipelines.evaluation import (build_arg_parser, evaluate_split,
                                                       extract_angle, extract_coef,
                                                       extract_u_magnitude, get_pressure_drop,
                                                       inverse_transform, mae_by, per_case_mae)
from porous_cfd_tpu_torch.viz.common import plot_errors_vs_multi_vars, plot_errors_vs_var


def sample_process(normalizers, predicted, target, extras):
    """Each case's d, f, inlet speed and angle, and the pressure drops
    (duct_variable_boundary/evaluate.py:33-54)."""
    pred, tgt = predicted.numpy(), target.numpy()
    p_s = normalizers["p"]

    def drop(side):
        return get_pressure_drop(inverse_transform(p_s, side["inlet"]["p"]),
                                 inverse_transform(p_s, side["outlet"]["p"]))

    return {"d": np.round(extract_coef(tgt["d"], normalizers["d"])).astype(np.int64),
            "f": extract_coef(tgt["f"], normalizers["f"]),
            "U inlet": extract_u_magnitude(tgt["inlet"]["U-inlet"], normalizers["U"], 0.025),
            "Angle": extract_angle(tgt["inlet"]["U"], normalizers["U"]),
            "Predicted drop": np.asarray([drop(pred)]), "Target drop": np.asarray([drop(tgt)])}


def postprocess_fn(data, results, plots_path=None):
    """The MAE by inlet angle and by (d, inlet speed), and the pressure drop
    error, with their plots under ``--save-plots``
    (duct_variable_boundary/evaluate.py:57-74)."""
    results["MAE by inlet angle"] = mae_by(results, ["Angle"])
    results["MAE by d and inlet speed"] = mae_by(results, ["d", "U inlet"])
    if plots_path is not None:
        by_angle = results["MAE by inlet angle"]
        plot_errors_vs_var("MAE by inlet angle", np.array([e["mae"] for e in by_angle]),
                           np.array([e["Angle"] for e in by_angle]), ["Angle", "MAE"],
                           plots_path)
        d = np.asarray(results["d"]).flatten()
        u_inlet = np.asarray(results["U inlet"]).flatten()
        plot_errors_vs_multi_vars("MAE heatmap", per_case_mae(results), d.astype(np.int64),
                                  u_inlet, ["D", "U"], plots_path)
    add_pressure_drop(results, plots_path)


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
               "mae_by_inlet_angle": res["MAE by inlet angle"],
               "mae_by_d_and_inlet_speed": res["MAE by d and inlet speed"],
               "pressure_drop_predicted": float(np.mean(res["Predicted drop"])),
               "pressure_drop_target": float(np.mean(res["Target drop"])),
               "pressure_drop_error": float(res["Pressure drop"][0]),
               "errors": ev.errors,
               "inference_ms_per_case": ev.avg_inference_time * 1e3}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    run()
