"""Training pipeline: the CLI's flags and the orchestration (the port's
counterpart of ``porous_cfd_tpu/pipelines/training.py``).

The same CLI contract (flags, defaults: batch 13, bf16-mixed, 3000 epochs,
checkpoint every 500, loss-scaler 'fixed') and the same artifacts
(``lightning_logs/<name>/model_meta.json``, periodic and final
checkpoints), driven by the port's ``Trainer``. ``--precision bf16*`` runs
the forward-only surfaces (validation) in bfloat16; training stays f32.

``--mesh-data`` / ``--mesh-points`` train on a ('data', 'points') mesh of
processes (``parallel/mesh.py``), one a device: under ``torchrun`` each
process takes its rank from the environment; otherwise the experiment's
``run`` spawns the ``data x points`` ranks itself (``spawn_workers``,
``torch.multiprocessing`` with a ``file://`` store under ``--logs-dir``, no
network). A mesh of one needs no second process; it still trains through
a process group of one.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from argparse import ArgumentParser, Namespace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.parallel.mesh import (INIT_METHOD_ENV, Mesh, default_devices,
                                                launched_ranks, make_mesh, mesh_shape)
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
                   help="devices on the 'data' mesh axis (geometry-batch "
                        "data parallelism: each rank steps its share of the "
                        "batch's cases and the gradients are summed over the "
                        "ranks). 0 = single device; -1 = all available "
                        "devices not used by --mesh-points")
    p.add_argument("--mesh-points", type=int, default=1,
                   help="devices on the 'points' mesh axis (point-cloud "
                        "sharding: each rank holds a slice of every case's "
                        "rows and the global max-pool is a MAX all-reduce "
                        "over this axis; pipn on its decoupled path)")
    return p


def mesh_dims(args: Namespace, n_devices: int) -> Optional[tuple[int, int]]:
    """(data, points) that --mesh-data / --mesh-points ask for over
    ``n_devices``, or None for a single device: 0 means a single device on
    the data axis, so --mesh-points alone gives (1, P); -1 fills the data
    axis; --mesh-data 1 gives a mesh of one (the JAX package's
    ``mesh_from_args``)."""
    data = getattr(args, "mesh_data", 0)
    points = getattr(args, "mesh_points", 1)
    if not data and points <= 1:
        return None
    return mesh_shape(None if data == -1 else max(1, data), max(1, points), n_devices)


def _n_devices(args: Namespace, device) -> int:
    """The devices a mesh may take: the launcher's ranks, else the visible
    CUDA devices, else (on the CPU, where processes are the only bound) as
    many as the flags ask for."""
    launched = launched_ranks()
    if launched:
        return launched[1]
    if device is None or torch.device(device).type == "cuda":
        return len(default_devices())
    if getattr(args, "mesh_data", 0) == -1:
        raise ValueError("--mesh-data -1 counts CUDA devices or a launcher's ranks; on the "
                         "CPU give the size")
    return max(1, getattr(args, "mesh_data", 0)) * max(1, getattr(args, "mesh_points", 1))


def mesh_from_args(args: Namespace, device=None) -> tuple[Optional[Mesh], bool]:
    """(mesh, shard_points) from the --mesh-data/--mesh-points flags; (None,
    False) when multi-device execution is not requested. ``device`` None
    puts a rank on each CUDA device; ``"cpu"`` puts every rank on the CPU.
    Without a launcher's environment a mesh of one makes its process group
    through a file store under --logs-dir."""
    dims = mesh_dims(args, _n_devices(args, device))
    if dims is None:
        return None, False
    n = dims[0] * dims[1]
    devices = (default_devices()[:n] if device is None or torch.device(device).type == "cuda"
               else [torch.device(device)] * n)
    init_method = None
    if not launched_ranks() and not torch.distributed.is_initialized():
        init_method = _file_store(args)
    return make_mesh(dims[0], dims[1], devices, init_method), dims[1] > 1


def _file_store(args: Namespace) -> str:
    """A fresh ``file://`` init method under --logs-dir."""
    root = Path(getattr(args, "logs_dir", None) or os.getcwd())
    root.mkdir(parents=True, exist_ok=True)
    return f"file://{root.resolve()}/.dist_store_{os.getpid()}_{time.time_ns()}"


def _cli_worker(rank: int, world: int, init_method: str, run, argv, device) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), **{INIT_METHOD_ENV: init_method})
    if device is None and torch.cuda.is_available():
        torch.cuda.set_device(rank)
    run(argv, device)


def spawn_workers(run, argv, args: Namespace, device=None) -> bool:
    """Spawn the ranks of the mesh that --mesh-data / --mesh-points ask for,
    each calling ``run(argv, device)``, and wait for them; True when it did.
    False (and nothing spawned) without a mesh, for a mesh of one, and in a
    process a launcher (torchrun, or this function) started, which it puts
    on its own CUDA device (``LOCAL_RANK``) when ``device`` is None."""
    launched = launched_ranks()
    if launched or torch.distributed.is_initialized():
        if launched and device is None and torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", launched[0])))
        return False
    dims = mesh_dims(args, _n_devices(args, device))
    if dims is None or dims[0] * dims[1] == 1:
        return False
    n = dims[0] * dims[1]
    argv = list(sys.argv[1:] if argv is None else argv)
    torch.multiprocessing.spawn(_cli_worker, args=(n, _file_store(args), run, argv, device),
                                nprocs=n, join=True)
    return True



def train(args: Namespace, model: PinnModel, train_data: FoamDataset,
          val_data: Optional[FoamDataset], loss_scaler: Optional[LossScaler] = None,
          device=None, mesh: Optional[Mesh] = None, shard_points: bool = False) -> None:
    """Train with a checkpoint every 500 epochs and a final model.ckpt
    (training.py:50-85) on ``device``, the CUDA card unless ``"cpu"`` is
    asked for, where ``model`` must have been built: the stacked cases move
    there once. ``--resample-every`` redraws the training cases' points from
    the dataset's cached parses, deterministically in the round. A ``mesh``
    comes from the argument or from --mesh-data / --mesh-points
    (``mesh_from_args``; the ranks are this process and those that
    ``spawn_workers`` or a launcher started)."""
    owns_group = mesh is None and not torch.distributed.is_initialized()
    if mesh is None:
        mesh, flag_shard_points = mesh_from_args(args, device)
        shard_points = shard_points or flag_shard_points
    try:
        _train(args, model, train_data, val_data, loss_scaler, device, mesh, shard_points)
    finally:
        if owns_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, model, train_data, val_data, loss_scaler, device, mesh, shard_points):
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"train: the model lives on {model.device}, not on {device}")
    if mesh is not None and mesh.rank == 0:
        print(f"mesh ({mesh.shape['data']} x {mesh.shape['points']}): backend {mesh.backend}, "
              f"{mesh.size} rank(s), rank 0 on {mesh.device}"
              + (", points split" if shard_points else ""))
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
                      cfg, loss_scaler, mesh, shard_points, model_type=args.model,
                      resample_fn=resample_fn)
    trainer.write_model_meta(args.n_internal, args.n_boundary, args.n_observations,
                             args.precision)
    trainer.fit(resume_from=args.checkpoint)
