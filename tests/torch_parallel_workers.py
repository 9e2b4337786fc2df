"""The port's training steps on a mesh of gloo processes, for the CPU tests
of ``porous_cfd_tpu_torch.parallel``: every family of the port at narrow
widths (two of them at D = 3), built from a seed (or from given flax weights) on
every rank, and a one-process run of the same spec; the points axis's
collectives and the exact path's derivatives on a share, beside the same
functions in one process. The ranks import the port alone (no JAX), and
reach each other through a ``file://`` store, no network."""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
from porous_cfd_tpu_torch.data.synthetic import (PATCHES_3D, VARIABLE_BOUNDARIES,
                                                 VARIABLE_BOUNDARIES_3D, make_foam_batch,
                                                 make_foam_batch_3d, make_scalers,
                                                 make_scalers_3d)
from porous_cfd_tpu_torch.models import pi_gano as gano
from porous_cfd_tpu_torch.models import pipn
from porous_cfd_tpu_torch.ops import dropout
from porous_cfd_tpu_torch.parallel.mesh import make_mesh, points_gather, points_max
from porous_cfd_tpu_torch.physics import analytic
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler, RelobraloScaler
from porous_cfd_tpu_torch.train.engine import (batch_share, make_optimizer, make_train_functions,
                                               model_derivatives, reduce_grads)

SEED = 8421
FOAM = dict(nu=1e-3, d=1.0, f=1.0, scalers=None)
PIPN = dict(fe_local_layers=[2, 8, 8], fe_global_layers=[13, 8, 16], seg_layers=[24, 16, 8, 3])
PP = dict(fe_local_layers=[2, 8, 8], fe_global_layers=[[8, 8, 8], [10, 8, 8], [10, 8, 16]],
          fe_radius=[0.5, 1.0], fe_fraction=[0.5, 0.25], seg_layers=[24, 8, 3],
          seg_dropout=[0.2, 0.0], max_neighbors=8)
MRG = dict(n_dims=2, mrg_in_features=6, fe_local_layers=[2, 8, 8], seg_layers=[1024 + 8, 8, 3],
           seg_dropout=[0.2, 0.0], max_neighbors=8)
GANO = dict(out_features=3, branch_layers=[8, 16], geometry_layers=[7, 8], local_layers=[2, 8],
            n_operators=2, operator_dropout=[0.0, 0.2], variable_boundaries=VARIABLE_BOUNDARIES)
GANO_PP = dict(GANO, geometry_layers=[[8, 8], [10, 8], [10, 8]], geometry_radius=[0.5, 1.0],
               geometry_fraction=[0.5, 0.25], max_neighbors=8)
UNET_ENC = dict(enc_layers=[[9, 8, 8], [10, 8, 8], [10, 16]], enc_radius=[0.5, 1.0],
                enc_fraction=[0.5, 0.25], dec_layers=[[24, 8], [16, 8], [15, 8, 3]],
                dec_k=[3, 3, 3], max_neighbors=8)
UNET = dict(UNET_ENC, nu=1e-3, d=1.0, f=1.0, dec_dropout=[0, 0, [0.2, 0]])
# dropout on a middle FP level: the exact path, that level's masks over the
# coarse points every points rank holds whole
UNET_MID = dict(UNET, dec_dropout=[0, 0.2, [0.2, 0]])
UNET_GANO = dict(UNET_ENC, nu=1e-3, out_features=3, branch_layers=[8, 16],
                 fp_dropout=[0, 0, [0.2, 0]], variable_boundaries=VARIABLE_BOUNDARIES)
# the JAX package's tiny manufactured PIPN (tests/test_engine.py)
MANUFACTURED = dict(nu=0.01, d=50.0, f=1.0, fe_local_layers=[2, 16, 16],
                    fe_global_layers=[16 + 3, 16, 32], seg_layers=[32 + 16, 32, 3])
# abc's pipn-pp at narrow widths (tests/test_torch_3d_zoo.py's ABC_PP): D = 3,
# 4 boundary ids, 16 neighbours
ABC_PP = dict(fe_local_layers=[3, 16, 16], seg_layers=[32 + 16, 24, 16, 4],
              fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
              fe_global_layers=[[3 + 4 + 3, 16, 24], [24 + 3, 24, 24], [24 + 3, 24, 32]],
              max_neighbors=16, seg_dropout=[0.2, 0.0, 0.0])
# windbreaks' pi-gano at narrow widths (tests/test_torch_3d_zoo.py's WB_GANO)
# on its CLI's analytic path: 5 boundary ids, the inlet's Ux in the branch
WB_GANO = dict(out_features=4, branch_layers=[10, 16, 40], local_layers=[3, 16, 16, 16],
               geometry_layers=[5 + 3 + 1, 16, 24, 24], n_operators=4,
               operator_dropout=[0.0, 0.2, 0.2, 0.0], variable_boundaries=VARIABLE_BOUNDARIES_3D)


def _foam(factory, **kwargs):
    def build(gen):
        return factory(**{**FOAM, "scalers": make_scalers()}, **kwargs, generator=gen,
                       device="cpu")
    return build


def _gano(factory, cfg, **kwargs):
    def build(gen):
        return factory(1e-3, **cfg, scalers=make_scalers(), **kwargs, generator=gen,
                       device="cpu")
    return build


# name -> (the model from a generator, the batch kind)
FAMILIES = {
    "pipn_decoupled": (_foam(pipn.pipn_foam, **PIPN, seg_dropout=[0.2, 0.2, 0.0]), "foam"),
    # without dropout, for the JAX package's sharded step (whose masks are
    # jax.random's)
    "pipn_decoupled_plain": (_foam(pipn.pipn_foam, **PIPN), "foam"),
    "pipn_coupled": (_foam(pipn.pipn_foam, **PIPN, seg_dropout=[0.2, 0.2, 0.0],
                           coupled_context=True), "foam"),
    "pipn_exact": (_foam(pipn.pipn_foam, **PIPN, seg_dropout=[0.2, 0.2, 0.0],
                         fast_derivatives=False), "foam"),
    "pipn_pp": (_foam(pipn.pipn_foam_pp, **PP), "foam"),
    "pipn_pp_exact": (_foam(pipn.pipn_foam_pp, **PP, fast_derivatives=False), "foam"),
    "pipn_pp_mrg": (_foam(pipn.pipn_foam_pp_mrg, **MRG), "foam"),
    "pipn_pp_full": (lambda gen: pipn.pipn_foam_pp_full(
        **UNET, scalers=make_scalers(), generator=gen, device="cpu"), "foam"),
    "pipn_pp_full_exact": (lambda gen: pipn.pipn_foam_pp_full(
        **UNET, scalers=make_scalers(), fast_derivatives=False, generator=gen,
        device="cpu"), "foam"),
    "pipn_pp_full_mid_dropout": (lambda gen: pipn.pipn_foam_pp_full(
        **UNET_MID, scalers=make_scalers(), generator=gen, device="cpu"), "foam"),
    "pi_gano": (_gano(gano.pi_gano, GANO), "foam"),
    # without dropout, for the JAX package's sharded step
    "pi_gano_plain": (_gano(gano.pi_gano, dict(GANO, operator_dropout=[0.0, 0.0])), "foam"),
    "pi_gano_fast": (_gano(gano.pi_gano, GANO, fast_derivatives=True), "foam"),
    "pi_gano_full": (_gano(gano.pi_gano, GANO, full=True, fast_derivatives=True), "foam"),
    "pi_gano_pp": (_gano(gano.pi_gano_pp, GANO_PP), "foam"),
    "pi_gano_pp_full": (lambda gen: gano.pi_gano_pp_full(
        **UNET_GANO, scalers=make_scalers(), generator=gen, device="cpu"), "foam"),
    "manufactured": (lambda gen: pipn.pipn_manufactured(**MANUFACTURED, generator=gen,
                                                        device="cpu"), "manufactured"),
    "manufactured_coupled": (lambda gen: pipn.pipn_manufactured(
        **MANUFACTURED, fast_derivatives=True, generator=gen, device="cpu"), "manufactured"),
    "manufactured_pp": (lambda gen: pipn.pipn_manufactured_pp(
        0.01, 50.0, 1.0, [2, 8, 8], [[6, 8], [10, 8], [10, 16]], [0.6, 1.2], [0.5, 0.25],
        [24, 8, 3], max_neighbors=8, generator=gen, device="cpu"), "manufactured"),
    "abc_pipn_pp": (lambda gen: pipn.pipn_foam_pp(
        **FOAM | {"scalers": make_scalers_3d()}, **ABC_PP, generator=gen, device="cpu"),
        "abc"),
    "windbreaks_pi_gano": (lambda gen: gano.pi_gano(
        1e-3, **WB_GANO, scalers=make_scalers_3d(), fast_derivatives=True, generator=gen,
        device="cpu"), "windbreaks"),
}


def make_batch(spec: dict):
    """The spec's batch: ``make_foam_batch`` (``make_foam_batch_3d`` at
    D = 3) or the JAX test's manufactured batch, from the spec's seed;
    ``tie`` repeats an extreme internal row of the first points share in the
    second (a channel maximal in both)."""
    kind = FAMILIES[spec["family"]][1]
    # windbreaks' boundary splits over its 5 patches
    cases, n_int, n_bnd, n_obs = spec.get("sizes", (8, 24, 20 if kind == "windbreaks" else 16,
                                                    6))
    rng = np.random.default_rng(spec.get("data_seed", 0))
    if kind == "manufactured":
        return make_manufactured_batch(rng, cases, n_int, n_bnd, 0.01, 50.0, 1.0)
    if kind in PATCHES_3D:
        return make_foam_batch_3d(cases, n_int, n_bnd, n_obs, PATCHES_3D[kind], rng=rng)
    batch = make_foam_batch(cases, n_int, n_bnd, n_obs, rng=rng)
    if spec.get("tie"):
        data = batch.data.clone()
        c = batch.column_indices("C")
        data[:, 0, c] = 4.0                        # the first share's first row
        data[:, n_int - 1] = data[:, 0]            # the last share's last row
        batch = type(batch)(data, batch.labels, batch.domain)
    return batch


def build(spec: dict):
    """(model, batch) of ``spec`` on the CPU: the family's weights from the
    spec's seed, or its ``params`` (a flax tree) when given."""
    factory, _ = FAMILIES[spec["family"]]
    model = factory(torch.Generator().manual_seed(spec.get("weights_seed", SEED)))
    if spec.get("params") is not None:
        params_from_flax(spec["params"], model.module)
    return model, model.attach_neighbors(make_batch(spec))


def _scaler(spec, model):
    if spec.get("scaler") == "relobralo":
        return RelobraloScaler(model.num_losses, update_period=1)
    return FixedLossScaler((1.0,) * (model.num_losses - 3) + (10.0,) * 3
                           if model.enable_data_loss else (1.0,) * model.num_losses)


def run_steps(spec: dict, mesh=None) -> dict:
    """``spec["steps"]`` training steps (1 by default); the last step's
    metrics, every parameter's gradient and value after it, the scaler
    state and Adam's (lr, eps), on the CPU. With ``masks``, also the mask of
    the decoder's layer 0 at this rank's share (width 16) and the share's
    bounds."""
    model, batch = build(spec)
    shard_points = bool(spec.get("shard_points")) and mesh is not None
    fns = make_train_functions(model, make_optimizer(model, 1), _scaler(spec, model),
                               mesh=mesh, shard_points=shard_points)
    state = fns.init_state(seed=SEED)
    for _ in range(spec.get("steps", 1)):
        state, metrics = fns.train_step(state, batch)
    out = {"metrics": metrics.detach().clone(),
           "grads": [p.grad.detach().clone() for p in model.module.parameters()],
           "params": [p.detach().clone() for p in model.module.parameters()],
           "scaler": None if state.scaler_state is None else
           [t.clone() for t in vars(state.scaler_state).values()],
           "adam": (model.learning_rate, model.adam_eps)}
    if spec.get("masks"):
        local, share = batch_share(batch, mesh, shard_points)
        pl = share.placement
        v = local.data.new_zeros((*local.data.shape[:2], 16))
        out["mask"] = analytic.merged_mask(dropout.fold_in(SEED, 7), 0, 0.3, v,
                                           local.domain["internal"].shape[-1], pl)
        out["placement"] = (pl.case0, pl.int_row0, pl.bnd_row0)
    if spec.get("eval"):
        out["eval"] = fns.eval_batch(batch).clone()
        pred, extras = fns.predict_batch(batch, verbose=True)
        out["predict"] = (pred.data.clone(), extras.data.clone())
    return out


def _worker(rank: int, world: int, init_method: str, jobs: list, out: str, extra) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        results = []
        for shape, specs in jobs:
            mesh = make_mesh(*shape, devices=["cpu"] * world, init_method=init_method)
            results.append([run_steps(spec, mesh) for spec in specs])
        for fn in extra:
            results.append(fn(mesh))
        torch.save(results, f"{out}.{rank}")
    finally:
        torch.distributed.destroy_process_group()


class Ranks:
    """A world of ranks started by ``start_ranks``; ``results()`` waits for
    them: per rank, one list of ``run_steps`` results a job, then each
    ``extra`` function's result."""

    def __init__(self, world: int, jobs: list, extra):
        self.world = world
        self.tmp = tempfile.TemporaryDirectory()
        self.out = str(Path(self.tmp.name) / "results")
        self.ctx = torch.multiprocessing.start_processes(
            _worker, args=(world, f"file://{self.tmp.name}/store", jobs, self.out, extra),
            nprocs=world, join=False, start_method="spawn")

    def results(self) -> list:
        while not self.ctx.join():
            pass
        try:
            return [torch.load(f"{self.out}.{r}", weights_only=False)
                    for r in range(self.world)]
        finally:
            self.tmp.cleanup()


def start_ranks(world: int, jobs: list, extra=()) -> Ranks:
    """Start ``world`` gloo processes that run each (shape, specs) job of
    ``jobs`` (its specs stepped on a (data x points) mesh of that shape),
    then ``fn(mesh)`` for ``extra`` (a module-level function), or for each
    function of a tuple of them, on the last mesh."""
    return Ranks(world, jobs, (extra,) if callable(extra) else tuple(extra))


def points_max_ties(mesh) -> dict:
    """``points_max`` on a (1 x 2) mesh with hand-made pools: ties
    across the ranks (the lower global row owns the channel; an internal row
    precedes every boundary row) and a channel one rank holds alone."""
    r = mesh.index("points")
    pl = dropout.Placement(0, int_row0=(0, 10)[r], bnd_row0=20 + (0, 3)[r], mesh=mesh)
    g = torch.tensor(([[[1., 2., 3., 5., 7.]]], [[[1., 3., 3., 4., 7.]]])[r],
                     requires_grad=True)
    rows = torch.tensor(([[[0, 1, 2, 0, 5]]], [[[3, 1, 0, 2, 1]]])[r], dtype=torch.int32)
    out = points_max(g, rows, 5, pl)
    out.backward(torch.full_like(out, r + 1.0))
    return {"g": out.detach(), "grad": g.grad}


def mesh_cases(mesh) -> dict:
    """On a world of 4 CPU ranks: ``make_mesh``'s shapes and refusal (the
    JAX package's ``tests/test_parallel.py`` cases at 4 devices),
    ``mesh_from_args`` under a launcher's environment, and the collectives
    over each axis."""
    from argparse import Namespace

    from porous_cfd_tpu_torch.parallel.mesh import shard_dataset_for_ranks
    from porous_cfd_tpu_torch.pipelines.training import mesh_from_args
    from porous_cfd_tpu_torch.train.engine import shard_batch
    cpu = ["cpu"] * 4
    res = {"coords": mesh.coords, "default": make_mesh(devices=cpu).shape,
           "points": make_mesh(points=2, devices=cpu).shape}
    try:
        make_mesh(data=16, points=2, devices=cpu)
    except ValueError as e:
        res["too_many"] = str(e)
    for data in (2, -1):
        m, sp = mesh_from_args(Namespace(mesh_data=data, mesh_points=2), "cpu")
        res[f"from_args_{data}"] = (m.shape, m.coords, sp)
    m = make_mesh(points=2, devices=cpu)
    batch = make_foam_batch(5, 24, 16, 6, seed=1)
    res["dataset_share"] = torch.equal(shard_dataset_for_ranks(batch, m).data,
                                       batch.data[(0, 3)[m.index("data")]:(3, 5)[m.index("data")]])
    local = shard_batch(batch, m, shard_points=True)
    res["points_share"] = (tuple(local.data.shape), local.domain["internal"].shape[-1])
    rank = torch.tensor([float(mesh.rank)])
    res["gather"] = [float(t) for t in m.all_gather(rank)]
    res["gather_points"] = [float(t) for t in m.all_gather(rank, "points")]
    res["max_data"] = float(m.all_reduce(rank.clone(), "max", "data"))
    res["sum"] = float(m.all_reduce(rank.clone(), "sum"))
    return res


def distance_cases(mesh) -> dict:
    """``ops/distance.py`` on a mesh whose 'points' axis splits the query
    rows: the JAX package's ``tests/test_distance_ops.py`` clouds (numpy
    and tensors in), and the SDF feature with and without the mesh."""
    from porous_cfd_tpu_torch.ops import distance
    rng = np.random.default_rng(2)
    q = rng.normal(size=(333, 2)).astype(np.float32)
    t = rng.normal(size=(40, 2)).astype(np.float32)
    rng = np.random.default_rng(3)
    pts_i, pts_b = rng.uniform(size=(80, 2)), rng.uniform(size=(30, 2))
    zone = (pts_i[:, 0] > 0.5).astype(float)
    return {"sharded": distance.min_distance_sharded(q, t, mesh, chunk=64),
            "sharded_tensor": distance.min_distance_sharded(torch.from_numpy(q),
                                                            torch.from_numpy(t), mesh, 64),
            "sdf_mesh": distance.sdf_feature(pts_i, pts_b, zone, mesh),
            "sdf": distance.sdf_feature(pts_i, pts_b, zone)}


# the collectives' derivative cases: each points rank's rows (uneven), and
# the exact path's winners: the manufactured PIPN on 2 cases of 24 / 16 rows
DERIV_ROWS = (7, 5)
EXACT_WINNERS = dict(family="manufactured", sizes=(2, 24, 16, 0))


def _deriv_x() -> torch.Tensor:
    return torch.rand((2, sum(DERIV_ROWS), 2), generator=torch.Generator().manual_seed(3),
                      dtype=torch.float64) * 2 - 1


def _collective_scalar(kind: str, x: torch.Tensor, placement) -> torch.Tensor:
    """A scalar of the rows ``x`` (B, n, 2), summed over them, that reads
    the whole cloud: through the pool ``points_max`` of tanh(x W) ("max"),
    or through every row's coordinates, ``points_gather`` ("gather")."""
    gen = torch.Generator().manual_seed(4)
    w, v = (torch.randn((2, 6), generator=gen, dtype=x.dtype) for _ in range(2))
    if kind == "max":
        g, rows = torch.max(torch.tanh(x @ w), dim=-2, keepdim=True)
        return (torch.tanh(x @ v) * points_max(g, rows, None, placement)).sum()
    whole = points_gather(x, placement)
    d2 = ((x[:, :, None] - whole[:, None]) ** 2).sum(-1)
    return (torch.exp(-d2) * (1.0 + whole[:, None, :, 0])).sum()


def collective_derivatives(x: torch.Tensor, placement) -> dict:
    """Per kind of ``_collective_scalar``: its first derivative in ``x``,
    and the second and third as products with fixed weights of the rows'
    global indices, (B, n, 2) each; on a points share every rank calls this
    at once, and each gets its rows' part of the whole cloud's."""
    rows = placement.global_rows(torch.arange(x.shape[-2]))
    c1 = torch.cos(rows + 1.0)[:, None] * torch.tensor([1.0, -0.5], dtype=x.dtype)
    c2 = torch.sin(rows + 2.0)[:, None] * torch.tensor([0.3, 1.0], dtype=x.dtype)
    out = {}
    for kind in ("max", "gather"):
        xr = x.detach().clone().requires_grad_()
        d1 = torch.autograd.grad(_collective_scalar(kind, xr, placement), xr,
                                 create_graph=True)[0]
        d2 = torch.autograd.grad((d1 * c1).sum(), xr, create_graph=True)[0]
        d3 = torch.autograd.grad((d2 * c2).sum(), xr)[0]
        out[kind] = [d1.detach(), d2.detach(), d3.detach()]
    return out


def collective_cases(mesh) -> dict:
    """``collective_derivatives`` on this rank's rows of ``_deriv_x`` over a
    (1 x 2) mesh's points group, every row internal."""
    k = mesh.index("points")
    i0, n = sum(DERIV_ROWS[:k]), DERIV_ROWS[k]
    x = _deriv_x()
    pl = dropout.Placement(0, i0, x.shape[-2], mesh, n)
    return collective_derivatives(x[:, i0:i0 + n], pl)


def exact_derivatives(mesh=None) -> dict:
    """The manufactured PIPN's exact path on ``EXACT_WINNERS`` (this rank's
    points share with a mesh): out, J and H of the share's rows, and every
    parameter's gradient of a loss of J and H alone (sum J^2 + H^2),
    summed over the ranks (0 where the loss reads none)."""
    model, batch = build(EXACT_WINNERS)
    part, sh = batch_share(batch, mesh, mesh is not None)
    out, jac, lap = model_derivatives(model, part, True, None, sh.placement)
    ((jac ** 2).sum() + (lap ** 2).sum()).backward()
    reduce_grads(model.module, mesh)
    return {"out": out.detach(), "jac": jac.detach(), "lap": lap.detach(),
            "grads": {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for n, p in model.module.named_parameters()}}
