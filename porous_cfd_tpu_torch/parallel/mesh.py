"""Process groups over a ('data', 'points') mesh (the port's counterpart of
``porous_cfd_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets XLA
insert the collectives. Here every device of the mesh is one process (a
rank) of ``torch.distributed``, and the training engine calls the
collectives itself:

  * the 'data' axis splits each batch's cases over ranks (data parallelism:
    the gradients, raw losses and metrics are summed as case-weighted
    means);
  * the 'points' axis splits every case's internal and boundary rows over
    ranks: a global max-pool over the rows becomes a MAX all-reduce over
    the points group (``points_max``), and an encoder that reads every
    point's differentiated coordinates gathers them (``points_gather``);
    both are differentiable to the order the exact paths need.

Rank ``r`` sits at mesh coordinates ``(r // points, r % points)``, as the
JAX mesh reshapes its device list to (data, points). Each rank has one
process group a mesh axis: the ranks that share its other coordinate.

The backend follows the devices, chosen before the group is made and never
after a failure: NCCL when every rank has a CUDA device of its own; gloo on
the CPU; gloo too when ranks share a card, which NCCL refuses (two ranks on
one device). gloo takes CUDA tensors in every collective the port calls
(``all_reduce`` SUM / MAX / MIN and ``all_gather``, probed on an H100 with
torch 2.11), so none is staged through the host.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "points")
# the init method a self-spawned worker finds in its environment (torchrun
# sets MASTER_ADDR / MASTER_PORT instead, read through "env://")
INIT_METHOD_ENV = "PCT_INIT_METHOD"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def default_devices() -> list[torch.device]:
    """The visible CUDA devices, one a rank."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def choose_backend(devices: Sequence) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    devs = [_device(d) for d in devices]
    if devs and all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def launched_ranks() -> Optional[tuple[int, int]]:
    """(rank, world size) that a launcher (torchrun, or ``spawn_workers``)
    put in this process's environment, or None."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return int(env["RANK"]), int(env["WORLD_SIZE"])
    return None


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` for a multi-process run.

    The rank and world size come from the arguments, or else from the
    environment a launcher sets (``RANK``, ``WORLD_SIZE``); the init method
    from the argument, ``$PCT_INIT_METHOD`` or torchrun's ``env://``. A
    single process with nothing configured is a no-op, as the JAX version is
    on a single host; so is a process whose group is already initialized.
    ``backend`` defaults to ``choose_backend`` over the visible CUDA devices
    (gloo where there are fewer than ranks).
    """
    if dist.is_initialized():
        return
    launched = launched_ranks()
    if world_size is None and launched:
        world_size = launched[1]
    if rank is None and launched:
        rank = launched[0]
    if init_method is None:
        init_method = os.environ.get(INIT_METHOD_ENV) or (
            "env://" if "MASTER_ADDR" in os.environ else None)
    if init_method is None:
        if (world_size or 1) == 1:
            return
        raise ValueError(f"initialize_distributed: a world of {world_size} ranks needs an "
                         "init method (torchrun's environment or init_method=)")
    world_size = world_size or 1
    if backend is None:
        cuda = default_devices()
        backend = choose_backend(cuda[:world_size] if len(cuda) >= world_size else ["cpu"])
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank or 0)


def mesh_shape(data: Optional[int], points: int, n_devices: int) -> tuple[int, int]:
    """(data, points) of a mesh over ``n_devices``: ``data`` defaults to
    ``n_devices // points``; a mesh larger than the devices is a
    ``ValueError``, as in the JAX package."""
    if data is None:
        data = n_devices // points
    if data < 1 or points < 1 or data * points > n_devices:
        raise ValueError(f"mesh ({data} x {points}) needs {data * points} devices, "
                         f"have {n_devices}")
    return data, points


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ('data', 'points') mesh: the axis sizes
    (``shape``), its coordinates, one process group a mesh axis (None in a
    world of one process, where every collective is the identity), its
    device and the backend."""
    shape: dict
    rank: int
    coords: tuple
    device: torch.device
    backend: Optional[str]
    groups: dict

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["points"]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def _group(self, axis: Optional[str]):
        return self.groups.get(axis or "world")

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """``t`` reduced in place over the ``axis`` group (every rank when
        None) with ``op`` ('sum', 'max' or 'min'); returns ``t``."""
        if self.groups["world"] is not None:
            dist.all_reduce(t, _OPS[op], group=self._group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: Optional[str] = None) -> list:
        """Every rank's ``t`` (all of one shape) over the ``axis`` group, in
        group order."""
        if self.groups["world"] is None:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.shape[axis] if axis else self.size)]
        dist.all_gather(parts, t.contiguous(), group=self._group(axis))
        return parts


def make_mesh(data: Optional[int] = None, points: int = 1,
              devices: Optional[Sequence] = None, init_method: Optional[str] = None) -> Mesh:
    """Build a ('data', 'points') mesh over ``devices``, one a rank.

    :param data: size of the data axis; defaults to n_devices // points.
    :param points: size of the point-sharding axis (1 = pure data parallel).
    :param devices: the ranks' devices in rank order; the visible CUDA
        devices by default. A list may repeat a device (ranks sharing a
        card) or name ``"cpu"``.
    :param init_method: passed to ``initialize_distributed`` when no process
        group exists yet (a launcher's environment serves otherwise).

    The process group must hold ``data * points`` ranks; a mesh of one
    needs none.
    """
    devs = [_device(d) for d in devices] if devices is not None else default_devices()
    data, points = mesh_shape(data, points, len(devs))
    n = data * points
    devs = devs[:n]
    backend = choose_backend(devs)
    if n > 1 or init_method is not None or launched_ranks():
        initialize_distributed(init_method, world_size=n, backend=backend)
    rank, size = world()
    if size != n:
        raise ValueError(f"mesh ({data} x {points}) needs a process group of {n} ranks, "
                         f"have {size}")
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend == "nccl" and choose_backend(devs) != "nccl":
            raise ValueError(f"mesh over {[str(d) for d in devs]}: NCCL needs a CUDA device "
                             "a rank; initialize the group with gloo")
    else:
        backend = None
    device = devs[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    groups = {"world": dist.group.WORLD if dist.is_initialized() else None}
    if dist.is_initialized():
        # every rank makes every group, in one order
        for d in range(data):
            g = dist.new_group([d * points + p for p in range(points)])
            if d == rank // points:
                groups["points"] = g
        for p in range(points):
            g = dist.new_group([d * points + p for d in range(data)])
            if p == rank % points:
                groups["data"] = g
    return Mesh({"data": data, "points": points}, rank, (rank // points, rank % points),
                device, backend, groups)


def share(n: int, parts: int, index: int, unit: int = 1) -> tuple[int, int]:
    """[start, stop) of part ``index`` when ``n`` items (whole ``unit``s)
    go to ``parts`` parts as evenly as can be, the first parts one unit
    larger: 13 over 2 gives 7 / 6, over 4 gives 4 / 3 / 3 / 3."""
    if n % unit:
        raise ValueError(f"share: {n} items are not whole units of {unit}")
    base, extra = divmod(n // unit, parts)
    start = (index * base + min(index, extra)) * unit
    return start, start + (base + (index < extra)) * unit


def shard_dataset_for_ranks(dataset, mesh: Mesh):
    """This rank's data-axis slice of the stacked (C, N, F) cases (the
    counterpart of the JAX ``shard_dataset_for_hosts``: each process loads
    its share of the case list)."""
    from porous_cfd_tpu_torch.data.foam_data import FoamData
    start, stop = share(len(dataset.data), mesh.shape["data"], mesh.index("data"))
    return FoamData(dataset.data[start:stop], dataset.labels,
                    {k: v[start:stop] for k, v in dataset.domain.items()})


class _SumOwned(torch.autograd.Function):
    """y = own * (the SUM of x over the points group): the pooled cotangent,
    every rank's part summed, kept by the ranks that own its channel.
    Linear in x, so its backward is its adjoint, ``_OwnedSum``; each is the
    other's backward, so the pool's derivatives cross ranks to any order."""

    @staticmethod
    def forward(ctx, x, own, mesh):
        ctx.own, ctx.mesh = own, mesh
        return mesh.all_reduce(x.contiguous().clone(), "sum", "points") * own

    @staticmethod
    def backward(ctx, dy):
        return _OwnedSum.apply(dy, ctx.own, ctx.mesh), None, None


class _OwnedSum(torch.autograd.Function):
    """y = the SUM of own * x over the points group: ``_SumOwned``'s
    adjoint."""

    @staticmethod
    def forward(ctx, x, own, mesh):
        ctx.own, ctx.mesh = own, mesh
        return mesh.all_reduce((x * own).contiguous(), "sum", "points")

    @staticmethod
    def backward(ctx, dy):
        return _SumOwned.apply(dy, ctx.own, ctx.mesh), None, None


def owners(g_local: torch.Tensor, winner_rows: torch.Tensor, mesh):
    """(g, own): the MAX all-reduce ``g`` of each rank's local pool over the
    points group and, per channel, 1 on the rank whose local winner is the
    first maximal GLOBAL row (``winner_rows``: the lowest index among the
    ranks that hold the maximum, as the kernels and ``torch.max`` break
    ties), else 0."""
    g_local = g_local.detach()
    g = mesh.all_reduce(g_local.clone(), "max", "points")
    big = torch.iinfo(torch.int64).max
    cand = torch.where(g_local == g, winner_rows, torch.full_like(winner_rows, big))
    first = mesh.all_reduce(cand.clone(), "min", "points")
    return g, (cand == first).to(g.dtype)


class _PointsMax(torch.autograd.Function):
    """The global max-pool over a points-split cloud. Forward: ``owners``'
    pool. Backward: the pooled cotangent is summed over the points group
    (every rank's loss reads the pooled feature), then goes to the local
    pool only on the owner, whose own backward routes it to its winner row
    (``_SumOwned``, differentiable: the exact paths differentiate this
    backward again)."""

    @staticmethod
    def forward(ctx, g_local, g, own, mesh):
        ctx.own, ctx.mesh = own, mesh
        return g.clone()

    @staticmethod
    def backward(ctx, dg):
        return _SumOwned.apply(dg, ctx.own, ctx.mesh), None, None, None


def points_max(g_local: torch.Tensor, argmax: torch.Tensor, n_int: Optional[int],
               placement, with_owner: bool = False):
    """The pooled feature (B, 1, F) of the whole cloud from this rank's max
    ``g_local`` over its [internal || boundary] rows and their first maximal
    local rows ``argmax`` (B, 1, F), of which the first ``n_int`` are
    internal (the placement's own count when None), at the rows'
    ``placement`` (``ops/dropout.Placement``) in the batch, over its mesh's
    'points' group. The identity when the rows are not split. With
    ``with_owner`` also the ``owners`` mask (B, 1, F) (all ones unsplit)."""
    if not placement.rows_split:
        return (g_local, torch.ones_like(g_local)) if with_owner else g_local
    g, own = owners(g_local, placement.global_rows(argmax.long(), n_int), placement.mesh)
    g = _PointsMax.apply(g_local, g, own, placement.mesh)
    return (g, own) if with_owner else g


class _GatherRows(torch.autograd.Function):
    """Every points rank's rows (B, n_k, C) concatenated along the rows in
    group order (each padded to the largest share for the collective).
    Backward: the reduce-scatter, ``_ScatterRows``; its backward is this
    gather again."""

    @staticmethod
    def forward(ctx, x, counts, mesh):
        ctx.counts, ctx.mesh = counts, mesh
        width = max(counts)
        pad = x.new_zeros((*x.shape[:-2], width - x.shape[-2], x.shape[-1]))
        parts = mesh.all_gather(torch.cat([x, pad], dim=-2), "points")
        return torch.cat([p[..., :n, :] for p, n in zip(parts, counts)], dim=-2)

    @staticmethod
    def backward(ctx, dy):
        return _ScatterRows.apply(dy, ctx.counts, ctx.mesh), None, None


class _ScatterRows(torch.autograd.Function):
    """The SUM over the points group of a whole-cloud tensor (B, sum n_k,
    C), this rank's rows kept: ``_GatherRows``' adjoint."""

    @staticmethod
    def forward(ctx, y, counts, mesh):
        ctx.counts, ctx.mesh = counts, mesh
        k = mesh.index("points")
        start = sum(counts[:k])
        total = mesh.all_reduce(y.contiguous().clone(), "sum", "points")
        return total[..., start:start + counts[k], :].clone()

    @staticmethod
    def backward(ctx, dx):
        return _GatherRows.apply(dx, ctx.counts, ctx.mesh), None, None


def points_gather(x: torch.Tensor, placement) -> torch.Tensor:
    """The whole cloud's rows (B, N, C) from this rank's share ``x`` (B, n,
    C) of one contiguous row range (the internal rows, say), gathered over
    the placement's 'points' group in order: differentiable to any order
    (backward a reduce-scatter, whose backward is this gather). The
    identity when the rows are not split."""
    if not placement.rows_split:
        return x
    n = torch.tensor([x.shape[-2]], device=x.device)
    counts = [int(c) for c in placement.mesh.all_gather(n, "points")]
    return _GatherRows.apply(x, counts, placement.mesh)
