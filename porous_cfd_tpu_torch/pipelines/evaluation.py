"""Evaluation (counterpart of ``porous_cfd_tpu/pipelines/evaluation.py``):
the core, ``evaluate``, predicts every case verbosely, batch by batch, timed
with a real device synchronization, then extracts errors and residuals per
batch on the host and builds the error table (``error_table``: the JAX
``plot_common_data``'s numbers); the CLI side, ``build_arg_parser`` and
``evaluate_split``, runs it over a loaded ``FoamDataset`` with the
experiment's hooks, and under ``--save-plots`` draws the plots and writes
``Errors.csv`` under ``<checkpoint parent>/plots/<split>/stats``.

The numbers need numpy only. The drawing imports matplotlib, and only under
``--save-plots``; the tables are written with the ``csv`` module in the
layout ``pandas.DataFrame.to_csv`` writes.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import time
from argparse import ArgumentParser, Namespace
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.pipelines.inference import default_checkpoint
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
from porous_cfd_tpu_torch.utils import profiling
from porous_cfd_tpu_torch.viz import common as viz


def create_plots_root_dir(save_plots: bool, data_dir: str, checkpoint: str) -> Path | None:
    """``<checkpoint parent>/plots/<split>/stats``, made, under
    ``--save-plots`` (evaluation.py:31-39), with matplotlib on its Agg
    backend; None without. Raises the ``ImportError`` that names matplotlib
    when the machine has none, before anything is predicted."""
    if not save_plots:
        return None
    viz.require_matplotlib().use("Agg")
    path = Path(checkpoint).parent / "plots" / Path(data_dir).name / "stats"
    path.mkdir(exist_ok=True, parents=True)
    return path


def inverse_transform(scaler, x) -> np.ndarray:
    """``scaler``'s inverse of ``x`` (an array or a tensor) on the host."""
    return scaler.to("cpu").inverse_transform(torch.as_tensor(np.asarray(x))).numpy()


def extract_coef(coef, scaler) -> np.ndarray:
    """The largest denormalised coefficient of each case: (B, N, D) ->
    (B, 1, 1), from the first column."""
    coef = inverse_transform(scaler, coef)[..., 0:1]
    return np.max(coef, axis=-2, keepdims=True)


def extract_u_magnitude(u, scaler, spacing: float) -> np.ndarray:
    """The inlet speed of each case (the largest denormalised |U| of its
    rows), snapped to multiples of ``spacing``: (B, N, D) -> (B, 1, 1)."""
    u_mag = np.linalg.norm(inverse_transform(scaler, u), axis=-1, keepdims=True)
    u_mag = np.max(u_mag, axis=-2, keepdims=True)
    return np.round(u_mag / spacing) * spacing


def extract_angle(u, scaler) -> np.ndarray:
    """The signed inlet angle of each case in degrees, from its denormalised
    U rows: (B, N, D) -> (B, 1, 1)."""
    u = inverse_transform(scaler, u)
    u_mag = np.linalg.norm(u, axis=-1, keepdims=True)
    a = np.arccos(u[..., 0:1] / u_mag)
    a = np.max(a, axis=-2, keepdims=True)
    a = a * np.max(np.sign(u[..., -1:]), axis=-2, keepdims=True)
    return np.rad2deg(a)


def per_case_mae(results: dict) -> np.ndarray:
    """Each case's mean absolute error of each field: (C, F)."""
    return np.mean(np.concatenate([results["U error"], results["p error"]], -1), axis=-2)


def mae_by(results: dict, keys: list[str]) -> list[dict]:
    """The per-case MAE of each field averaged over the cases that share the
    values of ``keys`` (one per case in ``results``): one entry a distinct
    tuple of values, in sorted order, ``{key: value, ..., "cases": n,
    "mae": [per field]}``. These are the numbers the reference's MAE-by-
    variable plots and heatmaps draw."""
    mae = per_case_mae(results)
    values = np.stack([np.asarray(results[k], np.float64).reshape(len(mae)) for k in keys], -1)
    out = []
    for row in np.unique(values, axis=0):
        sel = np.all(values == row, axis=-1)
        out.append({**{k: float(v) for k, v in zip(keys, row)}, "cases": int(sel.sum()),
                    "mae": [float(x) for x in np.mean(mae[sel], axis=0)]})
    return out


def get_normalized_signed_distance(points: np.ndarray, target: np.ndarray
                                   ) -> np.ndarray:
    """Min distance of each point from the target cloud, max-normalized."""
    d = np.linalg.norm(points[..., :, None, :] - target[..., None, :, :],
                       axis=-1)
    d = np.min(d, axis=-1)[..., None]
    return d / np.max(d)


def get_mean_max_error_distance(errors: np.ndarray, quantile: float,
                                interface_dist: np.ndarray) -> np.ndarray:
    """Mean interface distance of top-quantile errors, averaged over cases
    (evaluation.py:76-86)."""
    q_mask = errors > np.quantile(errors, quantile, axis=-2, keepdims=True)
    per_case = []
    for mask, dist in zip(q_mask, interface_dist):
        dims = np.split(mask, errors.shape[-1], axis=-1)
        per_case.append(np.array(
            [np.mean(dist[m.flatten()]) for m in dims]))
    return np.mean(np.stack(per_case), axis=0)


def get_common_data(normalizers: dict, predicted: FoamData, target: FoamData,
                    extras: FoamData) -> dict[str, Any]:
    """Per-batch error/residual extraction on numpy containers
    (``FoamData.numpy()``)."""
    predicted_u, predicted_p = np.asarray(predicted["U"]), np.asarray(predicted["p"])
    target_u, target_p = np.asarray(target["U"]), np.asarray(target["p"])
    if "U" in normalizers:
        predicted_u = inverse_transform(normalizers["U"], predicted_u)
        target_u = inverse_transform(normalizers["U"], target_u)
    if "p" in normalizers:
        predicted_p = inverse_transform(normalizers["p"], predicted_p)
        target_p = inverse_transform(normalizers["p"], target_p)

    u_error = np.abs(predicted_u - target_u)
    p_error = np.abs(predicted_p - target_p)

    predicted_div = np.asarray(extras["div"])
    predicted_momentum = np.asarray(extras["Momentum"])
    target_div = np.zeros_like(predicted_div)
    target_momentum = np.zeros_like(predicted_momentum)
    if "momentError" in target and "div(phi)" in target:
        target_div = np.asarray(target["internal"]["div(phi)"])
        target_momentum = np.asarray(target["internal"]["momentError"])

    if "interface" in target.domain:
        all_points = np.asarray(target["C"])
        interface_points = np.asarray(target["interface"]["C"])
        if "C" in normalizers:
            all_points = inverse_transform(normalizers["C"], all_points)
            interface_points = inverse_transform(normalizers["C"], interface_points)
        interface_dist = get_normalized_signed_distance(all_points,
                                                        interface_points)
    else:
        interface_dist = None

    return {"U error": u_error,
            "p error": p_error,
            "Predicted momentum": predicted_momentum,
            "Predicted divergence": predicted_div,
            "Target momentum": target_momentum,
            "Target divergence": target_div,
            "Region id": np.asarray(target["cellToRegion"]),
            "Interface distance": interface_dist}


def get_pressure_drop(inlet_p, outlet_p) -> float:
    """Mean inlet pressure less mean outlet pressure."""
    return np.mean(inlet_p) - np.mean(outlet_p)


def common_stats(results: dict) -> dict[str, Any]:
    """The numbers behind the JAX ``plot_common_data``
    (evaluation.py:156-227), from the concatenated per-case results: per-case
    max and mean errors, the top-20% mean errors, their mean distance from
    the interface (None without an interface patch), the flattened absolute
    errors, the MAE over all, fluid and porous points, and the predicted and
    target residuals."""
    errors = np.concatenate([results["U error"], results["p error"]], axis=-1)
    n_dims = errors.shape[-1] - 1
    s = {"labels": viz.get_fields_names(errors), "n_dims": n_dims,
         "max_per_case": np.max(errors, axis=1)}

    quantiles = np.quantile(errors, 0.8, axis=-2, keepdims=True)
    top_errors = []
    for q, e in zip(quantiles, errors):
        keep = np.transpose(e > q)
        per_field = [f[k] for f, k in zip(np.transpose(e), keep)]
        top_errors.append(np.array([np.mean(ce, axis=-1) for ce in per_field]))
    s["top_errors"] = np.mean(np.array(top_errors), axis=0)
    s["mean_per_case"] = np.mean(errors, axis=-2)
    s["interface"] = (None if results["Interface distance"] is None else
                      get_mean_max_error_distance(errors, 0.8, results["Interface distance"]))

    s["u_errors"] = np.concatenate(results["U error"])
    s["p_errors"] = np.concatenate(results["p error"])
    flat = np.concatenate([s["u_errors"], s["p_errors"]], -1)
    s["mae"] = np.mean(flat, axis=0)
    zones = results["Region id"].flatten()
    s["fluid_mae"] = np.mean(flat[zones < 1, :], axis=0)
    s["porous_mae"] = np.mean(flat[zones > 0, :], axis=0)

    s["predicted_div"] = np.concatenate(results["Predicted divergence"])
    s["predicted_momentum"] = np.concatenate(results["Predicted momentum"])
    target_res = np.concatenate([np.concatenate(results["Target momentum"]),
                                 np.concatenate(results["Target divergence"])], axis=-1)
    predicted_res = np.concatenate([s["predicted_momentum"], s["predicted_div"]], axis=-1)
    s["predicted_residuals"] = np.mean(np.abs(predicted_res), axis=0)
    s["target_residuals"] = np.mean(np.abs(target_res), axis=0)
    return s


def error_table(s: dict) -> tuple[list[str], dict[str, list[float | None]]]:
    """The JAX evaluation's error table (its ``eval_df``) from the
    ``common_stats`` ``s``: the column labels (``$U_x$``, ``$U_y$``
    [, ``$U_z$``], ``$p$``) and the rows, label -> one value a column, in
    the JAX order; the interface row only when the split has an interface
    patch."""
    rows = {"Average max errors": np.mean(s["max_per_case"], axis=0),
            "Top 20": s["top_errors"]}
    if s["interface"] is not None:
        rows["Top errors distance from interface"] = s["interface"]
    rows.update({"MAE": s["mae"], "Fluid MAE": s["fluid_mae"], "Porous MAE": s["porous_mae"],
                 "Residuals": s["predicted_residuals"]})
    return s["labels"], {k: [float(x) for x in v] for k, v in rows.items()}


def plot_common_data(s: dict, plots_path) -> None:
    """The JAX ``plot_common_data``'s figures, in its order, from the
    ``common_stats`` ``s``, under ``plots_path`` (matplotlib;
    ``--save-plots`` only)."""
    labels, n_dims = s["labels"], s["n_dims"]
    viz.box_plot("Maximum errors per case", [*np.hsplit(s["max_per_case"], n_dims + 1)],
                 labels, plots_path)
    viz.plot_per_case("Per case max errors", s["max_per_case"], plots_path)
    viz.plot_errors("Top 20% mean errors", s["top_errors"].tolist(), save_path=plots_path)
    viz.plot_per_case("Per case mean errors", s["mean_per_case"], plots_path)
    if s["interface"] is not None:
        viz.plot_errors("Errors mean normalized distance from interface", s["interface"],
                        save_path=plots_path)
    viz.plot_data_dist("Absolute error distribution", s["u_errors"], s["p_errors"],
                       save_path=plots_path)
    viz.plot_errors("Average relative error", s["mae"].tolist(), save_path=plots_path)
    viz.plot_errors("Fluid region MAE", s["fluid_mae"].tolist(), save_path=plots_path)
    viz.plot_errors("Porous region MAE", s["porous_mae"].tolist(), save_path=plots_path)
    viz.plot_data_dist("Absolute residuals", np.abs(s["predicted_momentum"]),
                       np.abs(s["predicted_div"]), save_path=plots_path)
    viz.plot_multi_bar("Absolute average residuals",
                       {"Predicted": s["predicted_residuals"].tolist(),
                        "Target": s["target_residuals"].tolist()},
                       ["Momentum x", "Momentum y", "Momentum z"][:n_dims] + ["Continuity"],
                       save_path=plots_path)


def write_table(path, columns: list[str], rows: dict[str, list]) -> None:
    """A table as ``pandas.DataFrame.to_csv`` writes it: a header row whose
    first cell is empty, then a row a label, an empty cell for a missing
    (None) value."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["", *columns])
        for label, values in rows.items():
            out.writerow([label, *("" if v is None else float(v) for v in values)])


def read_table(path) -> tuple[list[str], dict[str, list[float]]]:
    """The columns and rows of a table ``write_table`` (or
    ``DataFrame.to_csv``) wrote; an empty cell reads as NaN."""
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    return header[1:], {r[0]: [float(v) if v else float("nan") for v in r[1:]] for r in body}


@dataclasses.dataclass
class Evaluation:
    results: dict
    inference_time: float       # seconds for all cases, ending in a sync
    avg_inference_time: float   # seconds per case
    predictions: list           # per batch: (predicted FoamData, extras FoamData)
    stats: dict                 # common_stats(results), which the table and plots read
    # the error table: its column labels, and its rows (label -> one value a
    # column, None where empty; evaluate_split also hands them to its hook
    # as results["Errors"])
    error_columns: list
    errors: dict


SampleFn = Callable[[dict, FoamData, FoamData, FoamData], dict]


def evaluate(model: PinnModel, dataset: FoamData, batch_size: int,
             normalizers: dict,
             sample_process_fn: SampleFn | None = None) -> Evaluation:
    """Verbose prediction of every case of ``dataset`` (stacked (C, N, F)),
    in batches of ``batch_size``, on the model's device, with the model's
    per-dataset aux attached first (``attach_neighbors``). The timing covers
    the prediction of all batches and ends in ``torch.cuda.synchronize()``."""
    device = model.device
    fns = make_predict_functions(model)
    stacked = model.attach_neighbors(dataset.to(device))
    n = len(stacked)
    batches = [torch.arange(s, min(s + batch_size, n), device=device)
               for s in range(0, n, batch_size)]

    profiling.sync(device)
    start = time.perf_counter()
    predictions = [fns.predict_batch(gather_cases(stacked, idx), True)
                   for idx in batches]
    profiling.sync(device)
    inference_time = time.perf_counter() - start

    results: dict | None = None
    for idx, (pde, extras) in zip(batches, predictions):
        target = gather_cases(stacked, idx)
        sample = get_common_data(normalizers, pde.numpy(), target.numpy(),
                                 extras.numpy())
        if sample_process_fn:
            sample.update(sample_process_fn(normalizers, pde, target, extras))
        if results is None:
            results = {k: [] for k in sample}
        for k, v in sample.items():
            if v is not None:
                results[k].append(np.asarray(v))
    results = {k: np.concatenate(v) if v else None for k, v in results.items()}
    stats = common_stats(results)
    return Evaluation(results, inference_time, inference_time / n, predictions, stats,
                      *error_table(stats))


def build_arg_parser() -> ArgumentParser:
    """Reference CLI (evaluation.py:112-133)."""
    p = argparse.ArgumentParser()
    p.add_argument("--save-plots", action="store_true", default=False,
                   help="save the plots and Errors.csv (needs matplotlib)")
    p.add_argument("--checkpoint", type=str, default=default_checkpoint())
    p.add_argument("--data-dir", type=str, default="data/test")
    p.add_argument("--meta-dir", type=str, default="data/train")
    p.add_argument("--n-internal", type=int, default=1000)
    p.add_argument("--n-boundary", type=int, default=200)
    p.add_argument("--n-observations", type=int, default=500)
    p.add_argument("--precision", type=str, default="bf16-mixed")
    p.add_argument("--batch-size", type=int, default=4)
    return p


# (dataset, results, plots directory or None) -> None; it may add rows to
# results["Errors"], the error table, before Errors.csv is written
PostFn = Callable[[FoamDataset, dict, "Path | None"], None]


def evaluate_split(args: Namespace, model: PinnModel, data: FoamDataset,
                   sample_process_fn: SampleFn | None = None,
                   postprocess_fn: PostFn | None = None,
                   enable_timing: bool = False) -> Evaluation:
    """The CLI's evaluation loop (evaluation.py:260-328): ``evaluate`` over
    every case of ``data`` in batches of ``--batch-size``, each batch's
    extraction extended by ``sample_process_fn``, then ``postprocess_fn``
    on the concatenated results, which it may extend in place. Under
    ``--save-plots`` (matplotlib checked before anything is predicted): the
    timing bars against the solver's ``meta["Timing"]`` when
    ``enable_timing``, the common plots, the hook's plots, then
    ``Errors.csv`` with the hook's rows under
    ``<checkpoint parent>/plots/<split>/stats``."""
    plots_path = create_plots_root_dir(args.save_plots, data.data_dir, args.checkpoint)
    ev = evaluate(model, data.stacked(), args.batch_size, data.normalizers, sample_process_fn)
    if plots_path is not None:
        if enable_timing:
            cfd = data.meta["Timing"]
            viz.plot_timing([ev.inference_time, cfd["Total"] / 1e3],
                            [ev.avg_inference_time, cfd["Average"] / 1e3], plots_path)
        plot_common_data(ev.stats, plots_path)
    ev.results["Errors"] = ev.errors
    if postprocess_fn:
        postprocess_fn(data, ev.results, plots_path)
    if plots_path is not None:
        write_table(plots_path / "Errors.csv", ev.error_columns, ev.errors)
    return ev
