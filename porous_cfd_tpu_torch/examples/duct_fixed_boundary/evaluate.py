"""duct_fixed_boundary evaluation (the port's counterpart of
``examples/duct_fixed_boundary/evaluate.py``): verbose prediction of a
split from a checkpoint, the common error table and the pressure drop across
the duct; with ``--save-plots`` the plots, the timing against the solver's
and ``Errors.csv`` (the pressure drop's row included) under
``<checkpoint parent>/plots/<split>/stats/`` (matplotlib).

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary.evaluate \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

It prints one JSON line: the mean absolute errors of U and p (denormalised),
the predicted and target pressure drops, the error table's rows
(``errors``: label -> one value a field, null where empty) and the
inference time per case (the verbose prediction of every batch, ending in a
device sync). From the command line it runs on the CUDA card;
``run(argv, device="cpu")`` on the CPU.
"""
from __future__ import annotations

import json

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.inference import load_model_and_params
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.train import SEED
from porous_cfd_tpu_torch.pipelines.evaluation import (build_arg_parser, evaluate_split,
                                                       get_pressure_drop, inverse_transform)
from porous_cfd_tpu_torch.viz.common import plot_multi_bar


def sample_process(normalizers, predicted, target, extras):
    """The pressure drop between inlet and outlet of a batch
    (duct_fixed_boundary/evaluate.py:29-38)."""
    p_s = normalizers["p"]
    pred, tgt = predicted.numpy(), target.numpy()

    def drop(side):
        return get_pressure_drop(inverse_transform(p_s, side["inlet"]["p"]),
                                 inverse_transform(p_s, side["outlet"]["p"]))

    return {"Predicted drop": np.asarray([drop(pred)]), "Target drop": np.asarray([drop(tgt)])}


def add_pressure_drop(results, plots_path):
    """The mean pressure drops, their bars under ``--save-plots``, and
    their absolute difference as the error table's ``Pressure drop`` row,
    in ``$p$`` only (duct_fixed_boundary/evaluate.py:41-50). Each bar
    carries its own mean: the JAX example swaps the two."""
    pred, tgt = np.mean(results["Predicted drop"]), np.mean(results["Target drop"])
    if plots_path is not None:
        plot_multi_bar("Pressure drop", {"Predicted": [pred], "True": [tgt]}, ["$p$"],
                       plots_path)
    results["Pressure drop"] = np.asarray([abs(pred - tgt)])
    errors = results["Errors"]
    errors["Pressure drop"] = [None] * (len(errors["MAE"]) - 1) + [float(abs(pred - tgt))]


def postprocess_fn(data, results, plots_path=None):
    """The pressure drop's bars and ``Errors.csv`` row
    (duct_fixed_boundary/evaluate.py:41-50)."""
    add_pressure_drop(results, plots_path)


def run(argv=None, device=None, dataset_cls=FoamDataset) -> dict:
    """Parse ``argv`` (the command line when None), load the split as a
    ``dataset_cls``, evaluate it on ``device`` and print (and return) the
    summary line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = dataset_cls(args.data_dir, args.n_internal, args.n_boundary, args.n_observations,
                       np.random.default_rng(SEED), args.meta_dir,
                       extra_fields=["momentError", "div(phi)"])
    model, _ = load_model_and_params(args, data, device=device)
    ev = evaluate_split(args, model, data, sample_process, postprocess_fn, enable_timing=True)
    res = ev.results
    summary = {"cases": len(data),
               "U_mae": float(np.mean(res["U error"])),
               "p_mae": float(np.mean(res["p error"])),
               "pressure_drop_predicted": float(np.mean(res["Predicted drop"])),
               "pressure_drop_target": float(np.mean(res["Target drop"])),
               "pressure_drop_error": float(res["Pressure drop"][0]),
               "errors": ev.errors,
               "inference_ms_per_case": ev.avg_inference_time * 1e3}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    run()
