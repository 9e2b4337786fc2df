"""Training, validation and prediction step functions (counterpart of
``porous_cfd_tpu/train/engine.py``).

PyTorch runs eagerly and updates in place, so the JAX package's pure jitted
functions become plain calls on the model's device: ``train_step`` runs the
loss, ``backward()`` and one Adam update, mutates ``TrainState`` (module
parameters, optimizer moments, step, loss-scaler state) and returns it with
the step's metric vector. An epoch is a Python loop over the shuffled
batches, with no host sync inside it: metrics stay on the device until the
caller reads them.

The step's dropout seed is a pure function of the run's seed and the step
(``ops/dropout.fold_in``, the counterpart of ``jax.random.fold_in``), so a
resumed run repeats an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.device import not_ported
from porous_cfd_tpu_torch.models.base import PinnModel, error_labels, loss_labels
from porous_cfd_tpu_torch.ops import dropout
from porous_cfd_tpu_torch.physics.losses import mae, mse, vector_loss
from porous_cfd_tpu_torch.physics.operators import pinn_derivatives, split_derivatives
from porous_cfd_tpu_torch.physics.scaling import LossScaler


@dataclasses.dataclass
class TrainState:
    """What training carries from step to step. ``module`` is the model's own
    module (trained in place); ``seed`` fixes every step's dropout masks and
    loss-scaler draw."""
    step: int
    module: nn.Module
    optimizer: torch.optim.Optimizer
    seed: int
    scaler_state: Any = None


@dataclasses.dataclass(frozen=True)
class AdamExpLR:
    """Adam with a staircase exponential decay per epoch:
    lr(t) = lr0 * gamma ** (t // steps_per_epoch) at 0-based step t, as
    ``optax.exponential_decay(staircase=True)`` gives it."""
    learning_rate: float
    lr_gamma: float
    eps: float
    steps_per_epoch: int

    def create(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.learning_rate, eps=self.eps)

    def lr(self, step: int) -> float:
        return self.learning_rate * self.lr_gamma ** (step // max(1, self.steps_per_epoch))


def make_optimizer(model: PinnModel, steps_per_epoch: int) -> AdamExpLR:
    """Adam + per-epoch exponential LR decay (every reference model's
    recipe)."""
    return AdamExpLR(model.learning_rate, model.lr_gamma, model.adam_eps, steps_per_epoch)


def gather_cases(dataset: FoamData, idxs) -> FoamData:
    """Select a batch of cases from the stacked (C, N, F) dataset."""
    return FoamData(dataset.data[idxs], dataset.labels,
                    {k: v[idxs] for k, v in dataset.domain.items()})


def _index_tensor(idx, device) -> torch.Tensor:
    """Case indices (array, nested list or tensor) on ``device``."""
    if not torch.is_tensor(idx):
        idx = torch.as_tensor(np.asarray(idx))
    return idx.to(device)


def _take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (..., K) of ``x`` (..., N, C)."""
    return torch.gather(x, -2, ids[..., None].expand(*ids.shape, x.shape[-1]))


def model_derivatives(model: PinnModel, batch: FoamData, deterministic: bool,
                      seed: Optional[int] = None):
    """(out_full, jac, lap) on [internal || boundary] rows: the model's
    analytic path, or else the exact autodiff operator on its module, whose
    decoder dropout draws the analytic path's masks for the same seed."""
    if model.derivative_apply is not None:
        return model.derivative_apply(batch, deterministic, seed)
    internal, boundary = split_contiguous(batch)
    boundary_pts = boundary["C"]

    def apply_fn(pts):
        return model.module(torch.cat([pts, boundary_pts], dim=-2), batch, deterministic,
                            seed=seed)

    return pinn_derivatives(apply_fn, internal["C"])


def compute_losses(model: PinnModel, batch: FoamData, deterministic: bool = False,
                   seed: Optional[int] = None):
    """The reference training-step body: the forward with derivatives on
    [internal || boundary] rows (``model_derivatives``), boundary MSEs,
    continuity and momentum residuals, observation MSEs. Returns the
    unscaled loss vector [continuity, momentum.., boundary_u.., boundary_p,
    obs_u.., obs_p] and the full-domain predictions."""
    internal, boundary = split_contiguous(batch)
    n_int = internal.data.shape[-2]
    labels = model.predicted_labels
    out, jac, lap = model_derivatives(model, batch, deterministic, seed)
    predicted = FoamData(out, labels, batch.domain)
    pred_internal = FoamData(out[..., :n_int, :], labels,
                             {"internal": internal.domain["internal"]})
    pred_boundary = FoamData(out[..., n_int:, :], labels,
                             {"boundary": boundary.domain["boundary"]})

    boundary_p_loss = mse(pred_boundary["p"], boundary["p"])
    boundary_u_loss = vector_loss(pred_boundary["U"], boundary["U"])

    u_jac, u_lap, p_grad = split_derivatives(jac, lap, model.dims)
    continuity = model.continuity_loss(u_jac)
    momentum = model.momentum_loss(internal, pred_internal["U"], u_jac, u_lap, p_grad)

    losses = [continuity[None], momentum, boundary_u_loss, boundary_p_loss[None]]
    if model.enable_data_loss:
        # observation rows: a random subset of the internal rows, gathered by
        # index; the targets carry no gradient
        ids = batch.domain["obs"]
        pred_obs = FoamData(_take_rows(out[..., :n_int, :], ids), labels, {})
        tgt = _take_rows(torch.cat([internal["U"], internal["p"]], dim=-1).detach(), ids)
        obs_u_loss = vector_loss(pred_obs["U"], tgt[..., :model.dims])
        obs_p_loss = mse(pred_obs["p"], tgt[..., model.dims:model.dims + 1])
        losses += [obs_u_loss, obs_p_loss[None]]
    return torch.cat(losses), predicted


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
    rows, from the model's analytic derivative path or the exact operator."""

    def forward(batch: FoamData):
        # forward-only: in the model's eval precision (bf16 autocast under
        # --precision bf16-mixed), reduced in f32
        with torch.autocast(batch.data.device.type, dtype=model.eval_dtype,
                            enabled=model.eval_dtype is not None):
            out = model.module(batch["C"], batch, deterministic=True)
        return out.float()

    @torch.no_grad()
    def eval_batch(batch: FoamData):
        predicted = FoamData(forward(batch), model.predicted_labels, batch.domain)
        u_err, p_err = compute_errors(model, predicted, batch)
        return torch.cat([p_err[None], u_err])

    @torch.no_grad()
    def predict_batch(batch: FoamData, verbose: bool = False):
        if not verbose:
            return FoamData(forward(batch), model.predicted_labels, batch.domain)
        internal = batch["internal"]
        out, jac, lap = model_derivatives(model, batch, True)
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


@dataclasses.dataclass(frozen=True)
class TrainFunctions:
    """The step functions; the metric vector is [total, *scaled losses,
    p_error, *u_errors]. ``init_state`` is bound to the same loss scaler as
    the steps."""
    train_step: Callable
    train_epoch: Callable
    train_epochs: Callable
    eval_batch: Callable
    predict_batch: Callable
    metric_labels: tuple[str, ...]
    init_state: Callable


def make_train_functions(model: PinnModel, tx: AdamExpLR,
                         loss_scaler: Optional[LossScaler] = None,
                         mesh=None, shard_points: bool = False) -> TrainFunctions:
    if mesh is not None or shard_points:
        raise not_ported("multi-device training (mesh / shard_points)")
    loss_scaler = loss_scaler or LossScaler()
    predict = make_predict_functions(model)

    def grads_of(state: TrainState, batch: FoamData, seed: int, scaler_seed: int):
        """Back-propagate one batch's weighted loss into the parameters'
        ``.grad`` (adding to what is there). Returns (metrics, raw losses,
        the scaler's next state)."""
        losses, predicted = compute_losses(model, batch, deterministic=False, seed=seed)
        raw = losses.detach()
        weights, scaler_state = loss_scaler(state.scaler_state, raw, state.step, scaler_seed)
        total = torch.sum(weights * losses)
        total.backward()
        with torch.no_grad():
            pred = FoamData(predicted.data.detach(), predicted.labels, predicted.domain)
            u_err, p_err = compute_errors(model, pred, batch)
            metrics = torch.cat([total.detach()[None], weights * raw, p_err[None], u_err])
        return metrics, raw, scaler_state

    def accumulated_grads(state: TrainState, batch: FoamData, seed: int, scaler_seed: int):
        """Micro-batch accumulation (the JAX engine's ``_accumulated_grads``):
        the cases in groups of the largest size <= ``model.microbatch`` that
        divides the batch (13 cases with 2 give groups of 1), so that one
        group's second-order graph is alive at a time. Every group weighs
        its losses from the step's starting scaler state with the one scaler
        seed, and drops with its own seed; the gradients and metrics are the
        groups' means, and the scaler advances once, on the mean raw
        losses."""
        b = batch.data.shape[0]
        m = next(m for m in range(min(model.microbatch, b), 0, -1) if b % m == 0)
        groups = b // m
        metrics = raw_sum = 0.0
        for i in range(groups):
            mb = gather_cases(batch, slice(i * m, (i + 1) * m))
            mets, raw, _ = grads_of(state, mb, dropout.fold_in(seed, i), scaler_seed)
            metrics, raw_sum = metrics + mets, raw_sum + raw
        for p in state.module.parameters():
            if p.grad is not None:
                p.grad.div_(groups)
        _, scaler_state = loss_scaler(state.scaler_state, raw_sum / groups, state.step,
                                      scaler_seed)
        return metrics / groups, scaler_state

    def train_step(state: TrainState, batch: FoamData):
        """One step on ``batch``; updates ``state`` in place and returns it
        with the metric vector (on the device)."""
        seed = dropout.fold_in(state.seed, state.step)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        if model.microbatch and model.microbatch < batch.data.shape[0]:
            metrics, scaler_state = accumulated_grads(state, batch, seed,
                                                      dropout.fold_in(seed, 1))
        else:
            metrics, _, scaler_state = grads_of(state, batch, seed, dropout.fold_in(seed, 1))
        for group in opt.param_groups:
            group["lr"] = tx.lr(state.step)
        opt.step()
        state.step += 1
        state.scaler_state = scaler_state
        return state, metrics

    def train_epoch(state: TrainState, dataset: FoamData, perm):
        """One epoch: ``perm`` (S, B) case indices, one step per row.
        Returns the state and the mean metric vector. The indices go to the
        device in one copy; the steps then queue without waiting on it."""
        perm = _index_tensor(perm, dataset.data.device)
        metrics = []
        for idxs in perm:
            state, m = train_step(state, gather_cases(dataset, idxs))
            metrics.append(m)
        return state, torch.stack(metrics).mean(dim=0)

    def train_epochs(state: TrainState, dataset: FoamData, perms):
        """K epochs: ``perms`` (K, S, B), copied to the device at once.
        Returns per-epoch mean metrics (K, M), so the caller reads them with
        one sync."""
        perms = _index_tensor(perms, dataset.data.device)
        out = []
        for perm in perms:
            state, m = train_epoch(state, dataset, perm)
            out.append(m)
        return state, torch.stack(out)

    labels = (["Total loss"] + loss_labels(model.dims, model.enable_data_loss)
              + [f"Train {label}" for label in error_labels(model.dims)])

    def init_state(sample_batch: Optional[FoamData] = None, seed: int = 8421) -> TrainState:
        """A fresh state around the model's module (its weights as built)."""
        return TrainState(0, model.module, tx.create(model.module.parameters()), int(seed),
                          loss_scaler.init_state(model.device))

    return TrainFunctions(train_step=train_step, train_epoch=train_epoch,
                          train_epochs=train_epochs, eval_batch=predict.eval_batch,
                          predict_batch=predict.predict_batch,
                          metric_labels=tuple(labels), init_state=init_state)
