"""Host-side training loop: epochs, shuffling, validation, TensorBoard
scalars, periodic checkpoints with exact resume (counterpart of
``porous_cfd_tpu/train/trainer.py``).

The observable contract is the JAX trainer's:

  * seed 8421 by default; batches shuffled by ``np.random.default_rng(seed)``
    with the last short batch kept; metrics of an epoch are batch-size
    weighted;
  * per-epoch scalars under the reference's metric names, plus ``lr-Adam``,
    written with ``torch.utils.tensorboard.SummaryWriter`` (imported when the
    first scalar is written);
  * ``checkpoint-epoch=N.ckpt`` every ``checkpoint_every`` epochs, a final
    ``model.ckpt`` and, with validation data, ``best.ckpt`` (the full state
    at the best validation epoch) under ``<logs_dir>/lightning_logs/<name>/``.
    Each is one ``torch.save`` file holding the module, the optimizer, the
    step, the seed, the loss-scaler state and the epoch;
  * ``model_meta.json`` with the model type and sampling parameters;
  * ``log_every`` > 1 runs that many epochs per ``train_epochs`` call and
    reads their metrics with one sync; ``val_every`` sets the validation
    cadence; ``resample_every`` swaps in ``resample_fn(round)``'s point cloud.

With a ``mesh`` every rank runs this loop on the same global batches (the
seeded permutation is the same on every rank; the engine gives each rank
its share), validation goes through the sharded ``eval_batch``, a resume
loads the checkpoint on every rank, and rank 0 alone writes: checkpoints,
``model_meta.json``, TensorBoard and the printed progress.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.models.base import PinnModel, error_labels
from porous_cfd_tpu_torch.physics.scaling import LossScaler, RelobraloScaler, RelobraloState
from porous_cfd_tpu_torch.train.engine import (TrainState, gather_cases, make_optimizer,
                                               make_train_functions)


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 3000
    batch_size: int = 13
    logs_dir: str = "."
    name: Optional[str] = None
    checkpoint_every: int = 500
    seed: int = 8421
    log_every: int = 1
    print_every: int = 50
    resample_every: int = 0  # epochs between point-cloud resamples (0 = off)
    # validation (and best-checkpoint) cadence in epochs; 0 = once per
    # log_every chunk
    val_every: int = 0


def _state_payload(state: TrainState, epoch: int) -> dict:
    scaler = state.scaler_state
    return {"module": state.module.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "seed": int(state.seed),
            "scaler_state": None if scaler is None else dataclasses.asdict(scaler),
            "epoch": int(epoch)}


def _restore(payload: dict, state: TrainState) -> tuple[TrainState, int]:
    state.module.load_state_dict(payload["module"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    state.seed = payload["seed"]
    scaler = payload["scaler_state"]
    state.scaler_state = None if scaler is None else RelobraloState(**scaler)
    return state, payload["epoch"]


def _read(path, device) -> dict:
    return torch.load(Path(path), map_location=device, weights_only=True)


class _NoWriter:
    """The TensorBoard writer of a rank other than 0: writes nothing."""

    def add_scalar(self, *args, **kwargs):
        pass

    add_scalars = add_scalar
    flush = add_scalar


class Trainer:
    def __init__(self, model: PinnModel,
                 train_data: FoamData,
                 val_data: Optional[FoamData],
                 config: TrainerConfig,
                 loss_scaler: Optional[LossScaler] = None,
                 mesh=None,
                 shard_points: bool = False,
                 model_type: str = "model",
                 resample_fn=None):
        """
        :param train_data: stacked (C, N, F) FoamData.
        :param resample_fn: optional ``round_idx -> FoamData`` giving a fresh
            stacked point subsample of the same shapes, called when training
            crosses a ``config.resample_every`` epoch boundary (round_idx =
            epoch // resample_every, so a resume replays the same samples).
        :param mesh/shard_points: train on a mesh of ranks
            (``parallel/mesh.py``), each rank on its share of every batch.
        """
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        self.model = model
        self.train_data = train_data
        self.resample_fn = resample_fn
        self.val_data = val_data
        self.config = config
        self.model_type = model_type

        self.n_cases = len(train_data.data)
        b = min(config.batch_size, self.n_cases)
        self.batch_size = b
        self.full_steps = self.n_cases // b
        self.remainder = self.n_cases % b
        self.steps_per_epoch = self.full_steps + (1 if self.remainder else 0)

        if isinstance(loss_scaler, RelobraloScaler) and loss_scaler.update_period == 1:
            loss_scaler = dataclasses.replace(loss_scaler,
                                              update_period=self.steps_per_epoch)
        self.loss_scaler = loss_scaler
        self.tx = make_optimizer(model, self.steps_per_epoch)
        self.fns = make_train_functions(model, self.tx, loss_scaler, mesh, shard_points)

        name = config.name or time.strftime("version_%Y%m%d-%H%M%S")
        self.log_dir = Path(config.logs_dir) / "lightning_logs" / name
        if self.writes:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        self._writer = None if self.writes else _NoWriter()

    # -- logging ------------------------------------------------------------
    @property
    def writer(self):
        if self._writer is None:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(log_dir=str(self.log_dir))
        return self._writer

    def write_model_meta(self, n_internal=None, n_boundary=None, n_obs=None,
                         precision="32"):
        if not self.writes:
            return
        meta = {"Model type": self.model_type,
                "N internal": n_internal,
                "N boundary": n_boundary,
                "N observations": n_obs,
                "Precision": precision,
                "Batch size": self.batch_size}
        with open(self.log_dir / "model_meta.json", "w") as f:
            f.write(json.dumps(meta, indent=4))

    # -- checkpointing -------------------------------------------------------
    def save_checkpoint(self, state: TrainState, epoch: int, name: str,
                        payload: Optional[dict] = None):
        if self.writes:
            torch.save(payload or _state_payload(state, epoch), self.log_dir / name)

    def _print(self, *args):
        if self.writes:
            print(*args)

    def restore_checkpoint(self, path, state: TrainState):
        """Restore (state, epoch) into ``state``."""
        return _restore(_read(path, self.model.device), state)

    # -- training ------------------------------------------------------------
    def _epoch_perm(self, rng: np.random.Generator):
        perm = rng.permutation(self.n_cases)
        full = perm[:self.full_steps * self.batch_size]
        rem = perm[self.full_steps * self.batch_size:]
        return full.reshape(self.full_steps, self.batch_size), rem

    @staticmethod
    def _combine(mean_full, n_full, m_rem, n_rem):
        if n_rem == 0:
            return mean_full
        if n_full == 0:
            return m_rem
        return (mean_full * n_full + m_rem * n_rem) / (n_full + n_rem)

    def validate(self) -> np.ndarray:
        """Batch-size-weighted validation errors [p, ux, uy, (uz)]."""
        n = len(self.val_data.data)
        b = self.batch_size
        totals, count = 0.0, 0
        for s in range(0, n, b):
            idx = torch.arange(s, min(s + b, n), device=self.val_data.data.device)
            errs = self.fns.eval_batch(gather_cases(self.val_data, idx))
            totals = totals + errs.cpu().numpy() * len(idx)
            count += len(idx)
        return totals / count

    def fit(self, resume_from=None) -> TrainState:
        cfg = self.config
        device = self.model.device
        dataset = self.model.attach_neighbors(self.train_data.to(device))
        if self.val_data is not None:
            self.val_data = self.model.attach_neighbors(self.val_data.to(device))
        state = self.fns.init_state(seed=cfg.seed)
        start_epoch = 0
        if resume_from:
            state, start_epoch = self.restore_checkpoint(resume_from, state)
            self._print(f"resumed from {resume_from} at epoch {start_epoch}")

        host_rng = np.random.default_rng(cfg.seed)
        for _ in range(start_epoch):  # replay shuffles so resume == uninterrupted
            self._epoch_perm(host_rng)
        best, best_val = None, float("inf")
        t0 = time.time()
        # with log_every > 1 and no remainder batch, that many epochs run per
        # train_epochs call and their metrics are read with one sync
        chunk_base = (min(cfg.log_every, cfg.val_every) if cfg.val_every
                      else cfg.log_every)
        chunk_size = chunk_base if (self.remainder == 0 and chunk_base > 1) else 1
        val_every = cfg.val_every or cfg.log_every
        resample = (cfg.resample_every
                    if cfg.resample_every > 0 and self.resample_fn else 0)
        sample_round = 0
        epoch = start_epoch
        while epoch < cfg.epochs:
            if resample and epoch // resample != sample_round:
                sample_round = epoch // resample
                dataset = self.model.attach_neighbors(
                    self.resample_fn(sample_round).to(device))
            k = min(chunk_size, cfg.epochs - epoch,
                    cfg.checkpoint_every - epoch % cfg.checkpoint_every)
            if resample:
                k = min(k, resample - epoch % resample)
            if k > 1:
                perms = np.stack([self._epoch_perm(host_rng)[0] for _ in range(k)])
                state, m_epochs = self.fns.train_epochs(state, dataset, perms)
                m_epochs = m_epochs.cpu().numpy()          # (k, M), one sync
            else:
                perm, rem = self._epoch_perm(host_rng)
                m_full = m_rem = None
                if self.full_steps:
                    state, m_full = self.fns.train_epoch(state, dataset, perm)
                if len(rem):
                    idx = torch.as_tensor(rem, device=dataset.data.device)
                    state, m_rem = self.fns.train_step(state, gather_cases(dataset, idx))
                m_epochs = self._combine(
                    m_full.cpu().numpy() if m_full is not None else 0.0,
                    self.full_steps * self.batch_size,
                    m_rem.cpu().numpy() if m_rem is not None else 0.0, len(rem))[None]
            last = epoch + k  # 1-based epoch index of the chunk's last epoch
            metrics = m_epochs[-1]

            for i in range(k):
                if (epoch + i + 1) % cfg.log_every == 0 or k > 1:
                    for label, v in zip(self.fns.metric_labels, m_epochs[i]):
                        self.writer.add_scalar(label, float(v), epoch + i)
            crossed_log = (last // cfg.log_every) > (epoch // cfg.log_every)
            if crossed_log or k > 1:
                self.writer.add_scalar("lr-Adam", self.tx.lr(state.step), last - 1)
                if state.scaler_state is not None:
                    lam = state.scaler_state.lambda_ema.cpu().numpy()
                    self.writer.add_scalars(
                        "Loss weights",
                        dict(zip(self.fns.metric_labels[1:1 + len(lam)], lam.tolist())),
                        last - 1)
            crossed_val = (last // val_every) > (epoch // val_every)
            if self.val_data is not None and crossed_val:
                val = self.validate()
                for label, v in zip([f"Validation {label}"
                                     for label in error_labels(self.model.dims)], val):
                    self.writer.add_scalar(label, float(v), last - 1)
                val_mean = float(np.mean(val))
                if val_mean < best_val:
                    # the FULL state at this epoch, so best.ckpt resumes like
                    # a checkpoint written then
                    best_val = val_mean
                    if self.writes:
                        best = copy.deepcopy(_state_payload(state, last))

            if last % cfg.checkpoint_every == 0:
                self.save_checkpoint(state, last, f"checkpoint-epoch={last}.ckpt")
            if last % cfg.print_every < k or epoch == start_epoch:
                rate = ((last - start_epoch) * self.steps_per_epoch
                        / max(time.time() - t0, 1e-9))
                self._print(f"epoch {last}/{cfg.epochs} "
                            f"total={metrics[0]:.5f} ({rate:.1f} steps/s)")
            if epoch == start_epoch:  # the first chunk holds the start-up
                first_epochs, t_first = last - start_epoch, time.time()
            epoch = last

        if cfg.epochs > start_epoch:
            end = time.time()
            seconds = end - t0
            rest = cfg.epochs - start_epoch - first_epochs
            self._print(f"fit: {cfg.epochs - start_epoch} epochs in {seconds:.3f} s, "
                        f"{seconds * 1e3 / (cfg.epochs - start_epoch):.3f} ms per epoch"
                        + (f"; the first {first_epochs} in {t_first - t0:.3f} s, then "
                           f"{(end - t_first) * 1e3 / rest:.3f} ms per epoch"
                           if rest else ""))
        self.save_checkpoint(state, cfg.epochs, "model.ckpt")
        if best is not None:
            self.save_checkpoint(state, best["epoch"], "best.ckpt", payload=best)
        if self._writer is not None:
            self._writer.flush()
        return state


def load_checkpoint(path, model: PinnModel, sample_batch: Optional[FoamData] = None,
                    loss_scaler: Optional[LossScaler] = None, steps_per_epoch: int = 1):
    """Restore a saved training state outside a Trainer, into ``model``'s
    module. Returns (state, epoch)."""
    fns = make_train_functions(model, make_optimizer(model, steps_per_epoch), loss_scaler)
    state = fns.init_state(sample_batch)
    return _restore(_read(path, model.device), state)
