"""Dry-run entry points (the port's counterpart of the repository's
``__graft_entry__.py``): the flagship forward, and one training step on a
('data', 'points') mesh of CPU processes held to one process.

    python -m porous_cfd_tpu_torch.dryrun [--device cpu] [--devices 8]

runs ``entry()``'s forward (on the CUDA card unless ``--device cpu``) and
then ``dryrun_multichip(8)``, which is a CPU check by design: gloo
processes on one host, no card and no network.

The flagship is the JAX dry run's own model and path: the manufactured PIPN
(``pipn_manufactured``, the duct's widths: ``fe_global_layers`` [64 + 3, 96,
128, 1024], ``seg_layers`` [1024 + 64, 512, 256, 128, 3]) on its exact
autodiff path, the manufactured CLI's default, on a small
``make_manufactured_batch``; the mesh splits its cases and its points.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.pipn import pipn_manufactured
from porous_cfd_tpu_torch.parallel.mesh import make_mesh
from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions

SEED = 8421


def _flagship(n_internal=64, n_boundary=32, batch=4, device="cpu"):
    """The JAX dry run's manufactured PIPN at the duct's widths on its exact
    path, weights from seed 8421, and its batch (``make_manufactured_batch``
    from ``default_rng(8421)``)."""
    model = pipn_manufactured(0.01, 50.0, 1.0, fe_local_layers=[2, 64, 64],
                              fe_global_layers=[64 + 3, 96, 128, 1024],
                              seg_layers=[1024 + 64, 512, 256, 128, 3],
                              generator=torch.Generator().manual_seed(SEED), device=device)
    return model, make_manufactured_batch(np.random.default_rng(SEED), batch, n_internal,
                                          n_boundary)


def entry(device=None):
    """(fn, example_args): the flagship forward ``fn(module, batch)`` ->
    (B, N, 3) predicted [Ux, Uy, p], on ``device`` (the CUDA card unless
    ``"cpu"`` is asked for), as the JAX entry's."""
    model, batch = _flagship(device=resolve_device(device))

    def fn(module, batch):
        return module(batch["C"], batch, deterministic=True)

    return fn, (model.module, batch.to(model.device))


def _step(model, batch, mesh=None):
    """One training step's metric vector (on the CPU)."""
    fns = make_train_functions(model, make_optimizer(model, 1), mesh=mesh,
                               shard_points=mesh is not None)
    _, metrics = fns.train_step(fns.init_state(seed=SEED), batch)
    return metrics.cpu()


def _worker(rank: int, world: int, init_method: str, shape: tuple, sizes: tuple,
            out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    mesh = make_mesh(*shape, devices=["cpu"] * world, init_method=init_method)
    try:
        metrics = _step(*_flagship(*sizes), mesh)
        if rank == 0:
            torch.save(metrics, out)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int) -> dict:
    """One training step of the flagship over an ``n_devices`` mesh of gloo
    processes on the CPU, the data x points grid and the batch of the JAX
    dry run (``n_data = max(1, n // 2)``, ``n_pts = n // n_data``; n_data
    cases of 8 * n_pts internal and 4 * n_pts boundary points), with its
    points split (``shard_points``); raises on a non-finite loss or one
    that differs from the same step in one process. Returns the mesh and
    both metric vectors."""
    n_data = max(1, n_devices // 2)
    n_pts = n_devices // n_data
    world = n_data * n_pts
    sizes = (8 * n_pts, 4 * n_pts, n_data)
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "metrics.pt")
        torch.multiprocessing.spawn(
            _worker, args=(world, f"file://{tmp}/store", (n_data, n_pts), sizes, out),
            nprocs=world, join=True)
        metrics = torch.load(out, weights_only=True)
    single = _step(*_flagship(*sizes))
    total = float(metrics[0])
    if not torch.isfinite(metrics).all():
        raise RuntimeError(f"non-finite loss in multichip dryrun: {total}")
    # each entry within 1e-4 of its own magnitude plus 1e-4 relative (the
    # weighted total dwarfs the errors)
    if not torch.allclose(metrics, single, rtol=2e-4, atol=0.0):
        raise RuntimeError(f"multichip dryrun: metrics {metrics.tolist()} differ from one "
                           f"process's {single.tolist()}")
    print(f"dryrun_multichip({n_devices}): mesh=({n_data}x{n_pts}) total loss {total:.4f} OK "
          f"(one process {float(single[0]):.4f})")
    return {"mesh": (n_data, n_pts), "metrics": metrics, "single": single}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="the forward's device (the card by default)")
    p.add_argument("--devices", type=int, default=8, help="ranks of the CPU mesh")
    args = p.parse_args(argv)
    fn, (module, batch) = entry(args.device)
    with torch.no_grad():
        out = fn(module, batch)
    print("entry() forward:", tuple(out.shape))
    dryrun_multichip(args.devices)


if __name__ == "__main__":
    main()
