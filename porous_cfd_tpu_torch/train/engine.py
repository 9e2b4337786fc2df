"""Prediction and validation step functions (counterpart of the prediction
half of ``porous_cfd_tpu/train/engine.py``). The training functions
(losses, Adam with per-epoch ExpLR, train_step/train_epoch) come with the
training slice.

PyTorch runs eagerly, so the functions here are plain calls under
``torch.no_grad()`` on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.device import not_ported
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.physics.losses import mae, vector_loss
from porous_cfd_tpu_torch.physics.operators import split_derivatives


def gather_cases(dataset: FoamData, idxs) -> FoamData:
    """Select a batch of cases from the stacked (C, N, F) dataset."""
    return FoamData(dataset.data[idxs], dataset.labels,
                    {k: v[idxs] for k, v in dataset.domain.items()})


def compute_errors(model: PinnModel, predicted: FoamData, target: FoamData):
    """Full-domain denormalized MAEs: (u_error (D,), p_error scalar)."""
    pu, pp = model.postprocess_out(predicted["U"], predicted["p"])
    tu, tp = model.postprocess_out(target["U"], target["p"])
    return vector_loss(pu, tu, "mae"), mae(pp, tp)


@dataclasses.dataclass(frozen=True)
class PredictFunctions:
    eval_batch: Callable
    predict_batch: Callable


def make_predict_functions(model: PinnModel) -> PredictFunctions:
    """``eval_batch(batch) -> [p_error, *u_errors]`` and
    ``predict_batch(batch, verbose=False)``; with ``verbose`` the latter also
    returns the residual fields (channels [Momentum.., div]) on the internal
    rows, from the model's analytic derivative path."""

    def forward(batch: FoamData):
        return model.module(batch["C"], batch, deterministic=True).float()

    @torch.no_grad()
    def eval_batch(batch: FoamData):
        predicted = FoamData(forward(batch), model.predicted_labels, batch.domain)
        u_err, p_err = compute_errors(model, predicted, batch)
        return torch.cat([p_err[None], u_err])

    @torch.no_grad()
    def predict_batch(batch: FoamData, verbose: bool = False):
        if not verbose:
            return FoamData(forward(batch), model.predicted_labels, batch.domain)
        if model.derivative_apply is None:
            raise not_ported("verbose prediction through the exact autodiff "
                             "operator (a model without derivative_apply)")
        internal = batch["internal"]
        out, jac, lap = model.derivative_apply(batch, True)
        predicted = FoamData(out, model.predicted_labels, batch.domain)
        u_jac, u_lap, p_grad = split_derivatives(jac, lap, model.dims)
        div = model.continuity_loss.residual(u_jac)
        momentum = model.momentum_loss.residual(
            internal, predicted["internal"]["U"], u_jac, u_lap, p_grad)
        residuals = torch.cat([momentum, div[..., None]], dim=-1)
        extras = FoamData(residuals, model.extra_labels,
                          {"internal": batch.domain["internal"]})
        return predicted, extras

    return PredictFunctions(eval_batch=eval_batch, predict_batch=predict_batch)
