"""Training pipeline: the CLI's flags and the orchestration (the port's
counterpart of ``porous_cfd_tpu/pipelines/training.py``).

The same CLI contract (flags, defaults: batch 13, bf16-mixed, 3000 epochs,
checkpoint every 500, loss-scaler 'fixed') and the same artifacts
(``lightning_logs/<name>/model_meta.json``, periodic and final
checkpoints), driven by the port's ``Trainer``. ``--precision bf16*`` runs
the forward-only surfaces (validation) in bfloat16; training stays f32.
Multi-device execution (``--mesh-data``, ``--mesh-points``) is not ported.
"""
from __future__ import annotations

import argparse
import os
from argparse import ArgumentParser, Namespace
from typing import Optional

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import not_ported, resolve_device
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.physics.scaling import LossScaler
from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig


def build_arg_parser() -> ArgumentParser:
    """Reference CLI (training.py:21-47)."""
    p = argparse.ArgumentParser()
    p.add_argument("--n-internal", type=int, default=1000,
                   help="number of internal points to sample")
    p.add_argument("--n-boundary", type=int, default=200,
                   help="number of boundary points to sample")
    p.add_argument("--n-observations", type=int, default=500,
                   help="number of observation points to sample")
    p.add_argument("--batch-size", type=int, default=13)
    p.add_argument("--precision", type=str, default="bf16-mixed",
                   help="model weight precision. Supports mixed precision")
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--logs-dir", type=str, default=os.getcwd(),
                   help="base directory to save model weights")
    p.add_argument("--train-dir", type=str, default="data/train")
    p.add_argument("--val-dir", type=str, default="data/val")
    p.add_argument("--model", type=str,
                   help="model type. The available models depend on the experiment")
    p.add_argument("--name", type=str, default=None,
                   help="experiment name; results saved under this directory")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint path to resume/finetune from")
    p.add_argument("--fast-derivatives", action="store_true",
                   help="DEPRECATED no-op: the analytic (v,J,H) derivative "
                        "propagation (physics/analytic.py) is the default "
                        "where the model family supports it; see "
                        "--exact-derivatives to opt out")
    p.add_argument("--exact-derivatives", action="store_true",
                   help="replay the reference's exact nested-autodiff "
                        "semantics instead of the analytic (v,J,H) "
                        "propagation (parity mode, several times slower)")
    p.add_argument("--decoupled-context", action="store_true",
                   help="DEPRECATED no-op: the decoupled-context speed mode "
                        "is the plain-PIPN default (accuracy-equivalent at "
                        "reference data scale, CONVERGENCE.md); see "
                        "--coupled-context to opt into max-pool-coupled "
                        "derivatives")
    p.add_argument("--coupled-context", action="store_true",
                   help="with the analytic path on plain PIPN: propagate "
                        "the TRUE max-pool coupling of the pooled global "
                        "feature through the per-point derivatives "
                        "(reference-exactness knob, slower than the "
                        "default decoupled mode)")
    p.add_argument("--loss-scaler", type=str, default="fixed",
                   help="loss scaler. Supports fixed and relobralo")
    p.add_argument("--log-every", type=int, default=1,
                   help="epochs per logging/validation sync; values > 1 also "
                        "run that many epochs between two reads of the "
                        "metrics (train scalars are still logged per epoch)")
    p.add_argument("--val-every", type=int, default=0,
                   help="epochs between validation passes (and best.ckpt "
                        "selection); 0 = once per --log-every chunk")
    p.add_argument("--resample-every", type=int, default=0,
                   help="epochs between fresh point-cloud subsamples of the "
                        "training cases (0 = reference behavior: sample once "
                        "at load); deterministic in the epoch index "
                        "(resume-safe)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="devices on the 'data' mesh axis; multi-device "
                        "training is not ported (0 = single device)")
    p.add_argument("--mesh-points", type=int, default=1,
                   help="devices on the 'points' mesh axis; multi-device "
                        "training is not ported (1 = single device)")
    return p



def train(args: Namespace, model: PinnModel, train_data: FoamDataset,
          val_data: Optional[FoamDataset], loss_scaler: Optional[LossScaler] = None,
          device=None) -> None:
    """Train with a checkpoint every 500 epochs and a final model.ckpt
    (training.py:50-85) on ``device``, the CUDA card unless ``"cpu"`` is
    asked for, where ``model`` must have been built: the stacked cases move
    there once. ``--resample-every`` redraws the training cases' points from
    the dataset's cached parses, deterministically in the round."""
    if getattr(args, "mesh_data", 0) or getattr(args, "mesh_points", 1) > 1:
        raise not_ported("multi-device training (--mesh-data / --mesh-points)")
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"train: the model lives on {model.device}, not on {device}")
    cfg = TrainerConfig(epochs=args.epochs, batch_size=args.batch_size,
                        logs_dir=args.logs_dir, name=args.name,
                        log_every=getattr(args, "log_every", 1),
                        val_every=getattr(args, "val_every", 0),
                        resample_every=getattr(args, "resample_every", 0))

    def resample_fn(round_idx: int):
        train_data.resample(np.random.default_rng((cfg.seed, round_idx)))
        return train_data.stacked()

    model = model.with_precision(args.precision)
    trainer = Trainer(model, train_data.stacked(),
                      val_data.stacked() if val_data is not None else None,
                      cfg, loss_scaler, model_type=args.model, resample_fn=resample_fn)
    trainer.write_model_meta(args.n_internal, args.n_boundary, args.n_observations,
                             args.precision)
    trainer.fit(resume_from=args.checkpoint)
