"""Evaluation (counterpart of ``porous_cfd_tpu/pipelines/evaluation.py``):
the core, ``evaluate``, predicts every case verbosely, batch by batch, timed
with a real device synchronization, then extracts errors and residuals per
batch on the host; the CLI side, ``build_arg_parser`` and
``evaluate_split``, runs it over a loaded ``FoamDataset`` with the
experiment's hooks.

The plots and ``Errors.csv`` (``--save-plots``) are not ported yet: the
flag raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from argparse import ArgumentParser, Namespace
from typing import Any, Callable

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.device import not_ported
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.pipelines.inference import default_checkpoint
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
from porous_cfd_tpu_torch.utils import profiling


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


def mae_by(results: dict, keys: list[str]) -> list[dict]:
    """The per-case MAE of each field averaged over the cases that share the
    values of ``keys`` (one per case in ``results``): one entry a distinct
    tuple of values, in sorted order, ``{key: value, ..., "cases": n,
    "mae": [per field]}``. These are the numbers the reference's MAE-by-
    variable plots and heatmaps draw."""
    mae = np.mean(np.concatenate([results["U error"], results["p error"]], -1), axis=-2)
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


@dataclasses.dataclass
class Evaluation:
    results: dict
    inference_time: float       # seconds for all cases, ending in a sync
    avg_inference_time: float   # seconds per case
    predictions: list           # per batch: (predicted FoamData, extras FoamData)


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
    return Evaluation(results, inference_time, inference_time / n, predictions)


def build_arg_parser() -> ArgumentParser:
    """Reference CLI (evaluation.py:112-133)."""
    p = argparse.ArgumentParser()
    p.add_argument("--save-plots", action="store_true", default=False,
                   help="save the plots and Errors.csv (not ported yet)")
    p.add_argument("--checkpoint", type=str, default=default_checkpoint())
    p.add_argument("--data-dir", type=str, default="data/test")
    p.add_argument("--meta-dir", type=str, default="data/train")
    p.add_argument("--n-internal", type=int, default=1000)
    p.add_argument("--n-boundary", type=int, default=200)
    p.add_argument("--n-observations", type=int, default=500)
    p.add_argument("--precision", type=str, default="bf16-mixed")
    p.add_argument("--batch-size", type=int, default=4)
    return p


PostFn = Callable[[FoamDataset, dict], None]


def evaluate_split(args: Namespace, model: PinnModel, data: FoamDataset,
                   sample_process_fn: SampleFn | None = None,
                   postprocess_fn: PostFn | None = None) -> Evaluation:
    """The CLI's evaluation loop (evaluation.py:260-328): ``evaluate`` over
    every case of ``data`` in batches of ``--batch-size``, each batch's
    extraction extended by ``sample_process_fn``, then ``postprocess_fn``
    on the concatenated results, which it may extend in place."""
    if args.save_plots:
        raise not_ported("the evaluation plots and Errors.csv (--save-plots)")
    ev = evaluate(model, data.stacked(), args.batch_size, data.normalizers, sample_process_fn)
    if postprocess_fn:
        postprocess_fn(data, ev.results)
    return ev
