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

With a ``mesh`` (``parallel/mesh.py``) every rank gets the global batch and
runs its share of it (``shard_batch``): its cases on the 'data' axis and,
with ``shard_points``, its slice of every case's rows on the 'points' axis
(every family and derivative path: the models pool over the points group
through ``parallel.mesh.points_max``, run the encoders that read the whole
cloud whole on each rank of it, and their (v, J, H) kernels on the share's
rows alone). Each loss and error is a mean over cases
and rows, so a rank weighs its share's means by the share's fraction of
the batch and the weighted terms are summed over the ranks: uneven shares
(13 cases over 2 ranks: 7 / 6) give the single process's means. The
loss scaler then advances on the global raw losses with the step's one
seed, identically on every rank, and each rank back-propagates its own
weighted terms; one SUM all-reduce of the ``.grad``s after the backward
gives every rank the single process's gradient. The dropout masks are
drawn at the share's global cases and rows (its ``ops/dropout.Placement``,
handed down to the masks and kernels), so a sharded step drops what the
single process drops. Without a mesh the share is the whole batch and the
all-reduces are skipped: one step path serves both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from porous_cfd_tpu_torch.data.foam_data import FoamData, split_contiguous
from porous_cfd_tpu_torch.models.base import PinnModel, error_labels, loss_labels
from porous_cfd_tpu_torch.ops import dropout
from porous_cfd_tpu_torch.ops.dropout import WHOLE, Placement
from porous_cfd_tpu_torch.parallel.mesh import Mesh, share
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


@dataclasses.dataclass(frozen=True)
class Share:
    """Where a rank's part of a global batch sits in it (``placement``: its
    global cases and rows) and the fractions of the batch's cases, internal
    rows, boundary rows and all rows that it holds. The default is the
    whole batch."""
    placement: Placement = WHOLE
    cases: float = 1.0
    internal: float = 1.0
    boundary: float = 1.0
    rows: float = 1.0


def _row_aux(domain: dict) -> set:
    """The per-case aux keys of a domain (``attach_neighbors``) that hold one
    entry a row of the batch, [internal || boundary]: PI-GANO's geometry
    input and the U-Nets' last FeaturePropagation level's kNN indices (its
    queries are every row). Every other aux key is whole-cloud (a neighbour
    chain, the branch input)."""
    fp = sorted(int(k[len("_fp_idx_"):]) for k in domain if k.startswith("_fp_idx_"))
    last = {f"_fp_idx_{fp[-1]}"} if fp else set()
    return {k for k in domain if k == "_gano_geom_in"} | last


def batch_share(batch: FoamData, mesh: Optional[Mesh], shard_points: bool = False,
                unit: int = 1) -> tuple[FoamData, Share]:
    """This rank's part of ``batch`` and its ``Share``: the cases of its
    'data' coordinate (``parallel.mesh.share``, whole groups of ``unit``
    cases) and, with ``shard_points``, the slice of its 'points' coordinate
    of every case's internal rows and of its boundary rows. A points share
    keeps the subdomains ``internal`` and ``boundary`` (its own rows) and
    ``obs`` (global internal rows, which ``compute_losses`` selects through
    the placement), every per-row aux entry sliced to its rows (``_row_aux``)
    and every whole-cloud one whole; its placement's ``whole`` is its cases
    with all their rows and subdomains, for the encoders that run whole on
    each rank. Without a mesh, the batch and the whole ``Share()``."""
    if mesh is None:
        return batch, Share()
    n_cases = batch.data.shape[0]
    c0, c1 = share(n_cases, mesh.shape["data"], mesh.index("data"), unit)
    cases = gather_cases(batch, slice(c0, c1))
    if not shard_points or mesh.shape["points"] == 1:
        return cases, Share(Placement(case0=c0), (c1 - c0) / n_cases)
    part, sh = rows_share(cases, mesh, c0)
    return part, dataclasses.replace(sh, cases=(c1 - c0) / n_cases)


def rows_share(cases: FoamData, mesh: Mesh, case0: int = 0) -> tuple[FoamData, Share]:
    """The rows of this rank's 'points' coordinate of every case of
    ``cases`` (``batch_share``'s points share; local case 0 is global case
    ``case0``), and its ``Share`` of them (``cases`` 1)."""
    n_parts, k = mesh.shape["points"], mesh.index("points")
    n_int = cases.domain["internal"].shape[-1]
    n_bnd = cases.data.shape[-2] - n_int
    if min(n_int, n_bnd) < n_parts:
        raise ValueError(f"shard_batch: {n_int} internal and {n_bnd} boundary rows do not "
                         f"split over {n_parts} points ranks")
    i0, i1 = share(n_int, n_parts, k)
    b0, b1 = share(n_bnd, n_parts, k)

    def rows(x):
        return torch.cat([x[:, i0:i1], x[:, n_int + b0:n_int + b1]], dim=1)

    data = rows(cases.data)
    dev, b = data.device, data.shape[0]
    ni, nb = i1 - i0, b1 - b0
    dom = {"internal": torch.arange(ni, device=dev).expand(b, ni),
           "boundary": torch.arange(ni, ni + nb, device=dev).expand(b, nb)}
    if "obs" in cases.domain:
        dom["obs"] = cases.domain["obs"]
    per_row = _row_aux(cases.domain)
    dom.update({key: rows(v) if key in per_row else v
                for key, v in cases.domain.items() if key.startswith("_")})
    return (FoamData(data, cases.labels, dom),
            Share(Placement(case0, i0, n_int + b0, mesh, ni, cases), 1.0, ni / n_int,
                  nb / n_bnd, (ni + nb) / (n_int + n_bnd)))


def shard_batch(batch: FoamData, mesh: Optional[Mesh] = None,
                shard_points: bool = False) -> FoamData:
    """This rank's share of the global batch (``batch_share``); the batch
    itself without a mesh."""
    return batch_share(batch, mesh, shard_points)[0]


def reduce_grads(module: nn.Module, mesh: Optional[Mesh], groups: int = 1) -> None:
    """Sum every parameter's ``.grad`` over the ranks of ``mesh`` (one
    all-reduce of them all, flattened; none without a mesh), divided by
    ``groups``."""
    params = [p for p in module.parameters() if p.requires_grad]
    if mesh is None:
        for p in params:
            if p.grad is not None and groups != 1:
                p.grad.div_(groups)
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    mesh.all_reduce(flat, "sum")
    if groups != 1:
        flat.div_(groups)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


def _index_tensor(idx, device) -> torch.Tensor:
    """Case indices (array, nested list or tensor) on ``device``."""
    if not torch.is_tensor(idx):
        idx = torch.as_tensor(np.asarray(idx))
    return idx.to(device)


def _take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (..., K) of ``x`` (..., N, C)."""
    return torch.gather(x, -2, ids[..., None].expand(*ids.shape, x.shape[-1]))


def model_derivatives(model: PinnModel, batch: FoamData, deterministic: bool,
                      seed: Optional[int] = None, placement: Placement = WHOLE):
    """(out_full, jac, lap) on [internal || boundary] rows: the model's
    analytic path, or else the exact autodiff operator on its module, whose
    decoder dropout draws the analytic path's masks for the same seed, at
    the rows' ``placement`` in the whole batch."""
    if model.derivative_apply is not None:
        return model.derivative_apply(batch, deterministic, seed, placement)
    internal, boundary = split_contiguous(batch)
    boundary_pts = boundary["C"]

    def apply_fn(pts):
        return model.module(torch.cat([pts, boundary_pts], dim=-2), batch, deterministic,
                            seed=seed, placement=placement)

    return pinn_derivatives(apply_fn, internal["C"])


def compute_losses(model: PinnModel, batch: FoamData, deterministic: bool = False,
                   seed: Optional[int] = None, share: Share = Share()):
    """The reference training-step body: the forward with derivatives on
    [internal || boundary] rows (``model_derivatives``), boundary MSEs,
    continuity and momentum residuals, observation MSEs. Returns the
    unscaled loss vector [continuity, momentum.., boundary_u.., boundary_p,
    obs_u.., obs_p] and the full-domain predictions.

    With the ``share`` of a larger batch that ``batch`` is (``batch_share``),
    each term is the share's part of the whole batch's: its mean over the
    share's rows times the share's fraction of the batch's cases and of the
    term's rows (internal, boundary; the observations' mean stays over all
    of them), so that the shares' terms sum to the batch's; the dropout
    masks are drawn at the share's placement."""
    internal, boundary = split_contiguous(batch)
    n_int = internal.data.shape[-2]
    labels = model.predicted_labels
    pl = share.placement
    out, jac, lap = model_derivatives(model, batch, deterministic, seed, pl)
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

    f_int, f_bnd = share.cases * share.internal, share.cases * share.boundary
    losses = [continuity[None] * f_int, momentum * f_int, boundary_u_loss * f_bnd,
              boundary_p_loss[None] * f_bnd]
    if model.enable_data_loss:
        # observation rows: a random subset of the internal rows, gathered by
        # index; the targets carry no gradient
        ids = batch.domain["obs"]
        owned = None
        if pl.rows_split:
            # a share of the rows: the observations among its internal rows
            # count, the others weigh 0 (the mean stays over all of them)
            ids = ids - pl.int_row0
            owned = ((ids >= 0) & (ids < n_int)).to(out.dtype)[..., None]
            ids = ids.clamp(0, n_int - 1)
        pred_rows = _take_rows(out[..., :n_int, :], ids)
        tgt = _take_rows(torch.cat([internal["U"], internal["p"]], dim=-1).detach(), ids)
        if owned is not None:
            pred_rows, tgt = pred_rows * owned, tgt * owned
        pred_obs = FoamData(pred_rows, labels, {})
        obs_u_loss = vector_loss(pred_obs["U"], tgt[..., :model.dims])
        obs_p_loss = mse(pred_obs["p"], tgt[..., model.dims:model.dims + 1])
        losses += [obs_u_loss * share.cases, obs_p_loss[None] * share.cases]
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


def make_predict_functions(model: PinnModel, mesh: Optional[Mesh] = None) -> PredictFunctions:
    """``eval_batch(batch) -> [p_error, *u_errors]`` and
    ``predict_batch(batch, verbose=False)``; with ``verbose`` the latter also
    returns the residual fields (channels [Momentum.., div]) on the internal
    rows, from the model's analytic derivative path or the exact operator.

    With a ``mesh`` both split the batch's cases over the 'data' axis (a
    points group runs its share whole: a forward needs no point sharding):
    ``eval_batch`` gives the case-weighted mean of the shares' errors and
    ``predict_batch`` the whole batch, gathered from the shares."""

    def forward(batch: FoamData):
        # forward-only: in the model's eval precision (bf16 autocast under
        # --precision bf16-mixed), reduced in f32
        with torch.autocast(batch.data.device.type, dtype=model.eval_dtype,
                            enabled=model.eval_dtype is not None):
            out = model.module(batch["C"], batch, deterministic=True)
        return out.float()

    def errors(batch: FoamData):
        predicted = FoamData(forward(batch), model.predicted_labels, batch.domain)
        u_err, p_err = compute_errors(model, predicted, batch)
        return torch.cat([p_err[None], u_err])

    def predict(batch: FoamData, verbose: bool):
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

    def gathered(batch: FoamData, verbose: bool):
        """``predict`` of this rank's share, gathered over the 'data' axis
        (each share padded to the largest) into the whole batch."""
        n_cases, n_data = batch.data.shape[0], mesh.shape["data"]
        if n_cases < n_data:
            raise ValueError(f"predict_batch: {n_cases} cases do not split over {n_data} "
                             "data ranks")
        out = predict(batch_share(batch, mesh)[0], verbose)
        bounds = [share(n_cases, n_data, i) for i in range(n_data)]
        width = bounds[0][1] - bounds[0][0]
        whole = []
        for part in (out if verbose else (out,)):
            pad = part.data.new_zeros((width - part.data.shape[0], *part.data.shape[1:]))
            pieces = mesh.all_gather(torch.cat([part.data, pad]), "data")
            data = torch.cat([x[:stop - start] for x, (start, stop) in zip(pieces, bounds)])
            whole.append(FoamData(data, part.labels, {k: batch.domain[k] for k in part.domain}))
        return tuple(whole) if verbose else whole[0]

    @torch.no_grad()
    def eval_batch(batch: FoamData):
        if mesh is None:
            return errors(batch)
        part, sh = batch_share(batch, mesh)
        if part.data.shape[0] == 0:
            errs = batch.data.new_zeros((1 + model.dims,))
        else:
            errs = errors(part) * sh.cases
        return mesh.all_reduce(errs, "sum", "data")

    @torch.no_grad()
    def predict_batch(batch: FoamData, verbose: bool = False):
        return predict(batch, verbose) if mesh is None else gathered(batch, verbose)

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
                         mesh: Optional[Mesh] = None,
                         shard_points: bool = False) -> TrainFunctions:
    """The step functions of ``model``; with a ``mesh`` each rank runs its
    share of every batch (the module docstring), with ``shard_points`` also
    its share of the rows. Every rank calls each function with the same
    global batch."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"make_train_functions: mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if shard_points and mesh is None:
        raise ValueError("make_train_functions: shard_points needs a mesh")
    loss_scaler = loss_scaler or LossScaler()
    predict = make_predict_functions(model, mesh)

    n_metrics = 1 + model.num_losses + 1 + model.dims

    def grads_of(state: TrainState, batch: FoamData, seed: int, scaler_seed: int,
                 share: Share = Share(), over: Optional[Mesh] = None,
                 axis: Optional[str] = None):
        """Back-propagate the weighted loss of ``batch``, the ``share`` of
        the step's batch that it is, into the parameters' ``.grad`` (adding
        to what is there). Returns (metrics, raw losses, the scaler's next
        state) of the step's batch. Over a mesh ``over`` the share's loss
        terms and errors (its parts of the batch's, ``compute_losses``) are
        summed over the ranks (of its ``axis`` group, all when None) before
        the scaler weighs them, and each rank back-propagates its own part."""
        if batch.data.shape[0]:
            losses, predicted = compute_losses(model, batch, False, seed, share)
            with torch.no_grad():
                pred = FoamData(predicted.data.detach(), predicted.labels, predicted.domain)
                u_err, p_err = compute_errors(model, pred, batch)
                parts = torch.cat([losses.detach(),
                                   torch.cat([p_err[None], u_err]) * (share.cases * share.rows)])
        else:                           # a rank with no case of this batch
            losses, parts = None, batch.data.new_zeros((n_metrics - 1,))
        if over is not None:
            over.all_reduce(parts, "sum", axis)
        raw, errors = parts[:model.num_losses], parts[model.num_losses:]
        weights, scaler_state = loss_scaler(state.scaler_state, raw, state.step, scaler_seed)
        if losses is not None:
            torch.sum(weights * losses).backward()
        total = torch.sum(weights * raw)
        return torch.cat([total[None], weights * raw, errors]), raw, scaler_state

    def accumulated_grads(state: TrainState, batch: FoamData, seed: int, scaler_seed: int):
        """Micro-batch accumulation (the JAX engine's ``_accumulated_grads``):
        the cases in groups of the largest size <= ``model.microbatch`` that
        divides the batch (13 cases with 2 give groups of 1), so that one
        group's second-order graph is alive at a time. Every group weighs
        its losses from the step's starting scaler state with the one scaler
        seed, and drops with its own seed; the gradients and metrics are the
        groups' means, and the scaler advances once, on the mean raw
        losses. On a mesh whole groups go to a 'data' rank, each stepped as
        one process steps it (its seed from its index in the batch, its cases
        from 0), with ``shard_points`` its rows split over the 'points'
        group (each group's terms summed over it before the scaler weighs
        them, as one step's are); the groups' sums are summed over the
        'data' ranks."""
        b = batch.data.shape[0]
        m = next(m for m in range(min(model.microbatch, b), 0, -1) if b % m == 0)
        groups = b // m
        part, sh = batch_share(batch, mesh, unit=m)
        first = sh.placement.case0 // m
        split = shard_points and mesh.shape["points"] > 1
        sums = batch.data.new_zeros((n_metrics + model.num_losses,))
        for i in range(part.data.shape[0] // m):
            mb = gather_cases(part, slice(i * m, (i + 1) * m))
            seed_i = dropout.fold_in(seed, first + i)
            if split:
                mb, mb_share = rows_share(mb, mesh)
                mets, raw, _ = grads_of(state, mb, seed_i, scaler_seed, mb_share, mesh,
                                        "points")
            else:
                mets, raw, _ = grads_of(state, mb, seed_i, scaler_seed)
            sums = sums + torch.cat([mets, raw])
        if mesh is not None:
            mesh.all_reduce(sums, "sum", "data" if split else None)
        sums = sums / groups
        reduce_grads(state.module, mesh, groups)
        _, scaler_state = loss_scaler(state.scaler_state, sums[n_metrics:], state.step,
                                      scaler_seed)
        return sums[:n_metrics], scaler_state

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
            part, sh = batch_share(batch, mesh, shard_points)
            metrics, _, scaler_state = grads_of(state, part, seed, dropout.fold_in(seed, 1),
                                                sh, mesh)
            reduce_grads(state.module, mesh)
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
