"""Multi-process training of the port on the CPU (``parallel/mesh.py``, the
engine's ``mesh``/``shard_points``): gloo ranks spawned over a ``file://``
store step a batch and are held to one process of the port, and the JAX
package's sharded step on its 8-device CPU mesh (``tests/test_engine.py``'s
own tolerance), on the data axis for every family, with uneven shares of 13
cases, with dropout and ReLoBRaLo, and on the points axis for every family
and derivative path (uneven shares of the rows, ties across ranks, the
collectives' second and third derivatives, the exact path's winner rows);
the refusals, the mesh's cases (``tests/test_parallel.py``,
``tests/test_cli_multidevice.py``), the CLI's ``--mesh-data 2`` and the dry
run. The two worlds (2 and 4 ranks) run once a module, each over two meshes
(``torch_parallel_workers.py``)."""
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import torch_parallel_workers as w
from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.data.manufactured import make_manufactured_batch as jax_manufactured_batch
from porous_cfd_tpu.models.pi_gano import pi_gano as jax_pi_gano
from porous_cfd_tpu.models.pipn import pipn_foam as jax_pipn_foam
from porous_cfd_tpu.models.pipn import pipn_manufactured as jax_pipn_manufactured
from porous_cfd_tpu.physics import scaling as jax_scaling
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.ops.dropout import WHOLE
from porous_cfd_tpu_torch.parallel.mesh import (Mesh, choose_backend, initialize_distributed,
                                                make_mesh, mesh_shape, share)
from porous_cfd_tpu_torch.pipelines.training import mesh_dims
from porous_cfd_tpu_torch.train.engine import batch_share, make_optimizer, make_train_functions

FAMILIES = [f for f in w.FAMILIES if not f.endswith("_plain")]
UNEVEN = dict(family="pipn_decoupled", sizes=(13, 24, 16, 6), scaler="relobralo", steps=2,
              masks=True)
POINTS = dict(family="pipn_decoupled", scaler="relobralo", steps=2, masks=True,
              shard_points=True)
TIE = dict(family="pipn_decoupled", tie=True, shard_points=True)
EVAL = dict(family="pipn_decoupled", sizes=(5, 24, 16, 6), eval=True)
# every other family and path on the points axis, ReLoBRaLo, dropout where
# the family has it, the rows split unevenly (internal 13 / 12, and the
# manufactured boundary 9 / 8)
SIZES = {"foam": (8, 25, 16, 6), "manufactured": (8, 27, 17, 0), "abc": (4, 25, 24, 6),
         "windbreaks": (4, 25, 25, 6)}
POINT_SPECS = {f: dict(family=f, sizes=SIZES[w.FAMILIES[f][1]], scaler="relobralo",
                       shard_points=True)
               for f in FAMILIES if f != "pipn_decoupled"}
# a channel maximal on both ranks on the coupled and exact pools
TIES = {f: dict(family=f, tie=True, shard_points=True) for f in ("pipn_coupled", "pipn_exact")}
# the JAX package's weights for the JAX comparisons (filled by jax_refs)
JAX_SPECS = {"manufactured": dict(family="manufactured", sizes=(8, 48, 16, 0)),
             "decoupled": dict(family="pipn_decoupled_plain"),
             "pi_gano": dict(family="pi_gano_plain")}
# the JAX comparisons of the points axis: the decoupled PIPN and both exact
# paths (the manufactured PIPN, pi-gano's default)
JAX_POINTS = ("decoupled", "manufactured", "pi_gano")


def weights_of(model) -> tuple:
    return (1.0,) * (model.num_losses - 3) + (10.0,) * 3 if model.enable_data_loss \
        else (1.0,) * model.num_losses


def jax_models() -> dict:
    """The JAX package's tiny manufactured PIPN (``tests/test_engine.py``),
    decoupled ``pipn_foam`` and exact ``pi_gano`` with their batches; their
    initial weights go into the port's specs."""
    models = {"manufactured": (jax_pipn_manufactured(**w.MANUFACTURED),
                               jax_manufactured_batch(np.random.default_rng(0), 8, 48, 16,
                                                      0.01, 50.0, 1.0)),
              "decoupled": (jax_pipn_foam(**w.FOAM | {"scalers": jax_synthetic.make_scalers()},
                                          **w.PIPN),
                            jax_synthetic.make_foam_batch(8, 24, 16, 6,
                                                          rng=np.random.default_rng(0))),
              "pi_gano": (jax_pi_gano(1e-3, **w.GANO | {"operator_dropout": [0.0, 0.0]},
                                      scalers=jax_synthetic.make_scalers()),
                          jax_synthetic.make_foam_batch(8, 24, 16, 6,
                                                        rng=np.random.default_rng(0)))}
    for name, (model, batch) in models.items():
        state = jax_engine.init_train_state(model, jax_engine.make_optimizer(model, 1), batch)
        JAX_SPECS[name]["params"] = jax.tree_util.tree_map(np.asarray, state.params)
    return models


def jax_sharded_steps(models: dict) -> dict:
    """The JAX sharded steps' metrics on the 8-device CPU mesh: data (8 x 1)
    for the PIPNs and points (4 x 2) for ``JAX_POINTS``."""
    devs = np.array(jax.devices()[:8])
    out = {}
    for name, (model, batch) in models.items():
        tx = jax_engine.make_optimizer(model, 1)
        scaler = jax_scaling.FixedLossScaler(weights_of(model))
        for shape, sp in ([(8, 1), False], [(4, 2), True]):
            if name not in (JAX_POINTS if sp else ("manufactured", "decoupled")):
                continue
            mesh = JaxMesh(devs.reshape(shape), ("data", "points"))
            fns = jax_engine.make_train_functions(model, tx, scaler, mesh=mesh, shard_points=sp)
            _, metrics = fns.train_step(fns.init_state(batch), batch)
            out[(name, sp)] = np.asarray(metrics)
    return out


@pytest.fixture(scope="module")
def worlds():
    """Two worlds of ranks, started together, while the JAX package's
    sharded steps run here. World of 2: the data axis (2 x 1) for every
    family, the JAX specs, 13 cases (7 / 6) and the sharded eval; the
    points axis (1 x 2) with dropout and ReLoBRaLo for every family and
    path, the tie batches, the JAX specs, ``points_max``'s hand-made ties,
    the collectives' derivatives and the exact path's winners. World of 4:
    the data axis (4 x 1) for the JAX specs, 13 cases (4 / 3 / 3 / 3) and
    the eval; the points axis (2 x 2) for every family and path and the
    JAX specs; the mesh's cases."""
    models = jax_models()
    jax_points = [JAX_SPECS[n] | {"shard_points": True} for n in JAX_POINTS]
    every_path = list(POINT_SPECS.values())
    specs = {2: {"data": [dict(family=f) for f in FAMILIES]
                 + [JAX_SPECS["manufactured"], JAX_SPECS["decoupled"], UNEVEN, EVAL],
                 "points": [POINTS, TIE, *TIES.values(), *jax_points, *every_path]},
             4: {"data": [JAX_SPECS["manufactured"], JAX_SPECS["decoupled"], UNEVEN, EVAL],
                 "points": [POINTS, *jax_points, *every_path]}}
    started = {2: w.start_ranks(2, [((2, 1), specs[2]["data"]), ((1, 2), specs[2]["points"])],
                                extra=(w.points_max_ties, w.collective_cases,
                                       w.exact_derivatives)),
               4: w.start_ranks(4, [((4, 1), specs[4]["data"]), ((2, 2), specs[4]["points"])],
                                extra=(w.mesh_cases,))}
    refs = jax_sharded_steps(models)
    out = {"jax": refs}
    for n, ranks in started.items():
        res = ranks.results()
        out[n] = {"data": [r[0] for r in res], "points": [r[1] for r in res],
                  "extra": [r[2] for r in res], "cases": [r[3:] for r in res],
                  "specs": specs[n]}
    return out


@pytest.fixture(scope="module")
def jax_refs(worlds):
    return worlds["jax"]


@pytest.fixture(scope="module")
def two_ranks(worlds):
    return worlds[2]


@pytest.fixture(scope="module")
def four_ranks(worlds):
    return worlds[4]


_SINGLE = {}


def single(spec) -> dict:
    """One process of the port on ``spec`` (cached a spec)."""
    key = repr(sorted((k, v) for k, v in spec.items() if k not in ("params", "shard_points")))
    if key not in _SINGLE:
        s = {k: v for k, v in spec.items() if k != "shard_points"}
        _SINGLE[key] = w.run_steps(s)
    return _SINGLE[key]


def assert_close(got, ref, label="", per_entry=False):
    """1e-4 * max|ref| and rtol 1e-4, ROADMAP's tolerance of losses,
    gradients and parameters; ``per_entry`` holds each entry to 1e-4 of its
    own magnitude instead of the largest (a metric vector, whose weighted
    total dwarfs its errors)."""
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    assert got.shape == ref.shape, label
    scale = ref.abs() if per_entry else ref.abs().max()
    excess = (got - ref).abs() - 1e-4 * (ref.abs() + scale)
    assert bool((excess <= 0).all()), f"{label}: {got} != {ref}"


def assert_same_step(got: dict, ref: dict, label: str):
    """A sharded step's metrics, gradients and updated parameters against
    one process's (Adam's first step moves a weight by about lr sign(g):
    its gradient is held, and its value within the tolerance plus what
    the gradient's tolerance can move it)."""
    assert_close(got["metrics"], ref["metrics"], f"{label} metrics", per_entry=True)
    for i, (g, r) in enumerate(zip(got["grads"], ref["grads"])):
        assert_close(g, r, f"{label} grad {i}")
    for i, (p, r) in enumerate(zip(got["params"], ref["params"])):
        assert_close(p, r, f"{label} param {i}")


def assert_same_first_step(got: dict, ref: dict, label: str):
    """``assert_same_step``'s metrics and gradients, and the parameters
    after Adam's first step within the tolerance plus the most that step
    can move them while each gradient stays within its own tolerance:
    lr g / (|g| + eps) turns a gradient near eps (a bias that a few rows
    reach) into a step of any size up to lr (``chip_smoke.py`` holds phase
    41's parameters so)."""
    assert_close(got["metrics"], ref["metrics"], f"{label} metrics", per_entry=True)
    lr, eps = ref["adam"]
    for i, (g, r, p, rp) in enumerate(zip(got["grads"], ref["grads"], got["params"],
                                          ref["params"])):
        assert_close(g, r, f"{label} grad {i}")
        r = r.double()
        tau = 1e-4 * (r.abs() + r.abs().max())

        def step(x):
            return lr * x / (x.abs() + eps)

        spread = (step(r + tau) - step(r)).abs().maximum((step(r - tau) - step(r)).abs())
        rp = rp.double()
        excess = (p.double() - rp).abs() - 1e-4 * (rp.abs() + rp.abs().max()) - spread
        assert bool((excess <= 0).all()), f"{label} param {i}: {p} != {rp}"


def spec_result(world: dict, axis: str, spec: dict, rank: int = 0) -> dict:
    return world[axis][rank][world["specs"][axis].index(spec)]


def test_mesh_shapes_are_the_jax_packages():
    """``tests/test_parallel.py``'s cases on 8 devices."""
    assert mesh_shape(None, 1, 8) == (8, 1)
    assert mesh_shape(None, 2, 8) == (4, 2)
    with pytest.raises(ValueError, match=r"mesh \(16 x 2\) needs 32 devices, have 8"):
        mesh_shape(16, 2, 8)
    assert share(13, 2, 0) == (0, 7) and share(13, 2, 1) == (7, 13)
    assert [share(13, 4, i) for i in range(4)] == [(0, 4), (4, 7), (7, 10), (10, 13)]
    assert share(8, 2, 1, unit=2) == (4, 8)
    assert choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert choose_backend(["cuda:0", "cuda:0"]) == choose_backend(["cpu"] * 2) == "gloo"


def test_initialize_distributed_single_process_noop():
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(1, 1, devices=["cpu"])
    assert mesh.shape == {"data": 1, "points": 1} and mesh.backend is None
    t = torch.ones(3)
    assert mesh.all_reduce(t, "max") is t and mesh.all_gather(t) == [t]


def test_mesh_from_args_dims():
    """``tests/test_cli_multidevice.py``'s cases at 8 devices."""
    assert mesh_dims(Namespace(mesh_data=0, mesh_points=1), 8) is None
    assert mesh_dims(Namespace(mesh_data=4, mesh_points=2), 8) == (4, 2)
    assert mesh_dims(Namespace(mesh_data=-1, mesh_points=2), 8) == (4, 2)
    assert mesh_dims(Namespace(mesh_data=0, mesh_points=2), 8) == (1, 2)
    assert mesh_dims(Namespace(mesh_data=1, mesh_points=1), 8) == (1, 1)
    with pytest.raises(ValueError):
        mesh_dims(Namespace(mesh_data=8, mesh_points=2), 8)


def test_make_mesh_on_four_ranks(four_ranks):
    for rank, cases in enumerate(four_ranks["extra"]):
        assert cases["coords"] == (rank // 2, rank % 2)
        assert cases["default"] == {"data": 4, "points": 1}
        assert cases["points"] == {"data": 2, "points": 2}
        assert "mesh (16 x 2) needs 32 devices, have 4" in cases["too_many"]
        for data in (2, -1):
            assert cases[f"from_args_{data}"] == ({"data": 2, "points": 2},
                                                  (rank // 2, rank % 2), True)
        # 5 cases over 2 data ranks (3 / 2); 12 + 8 of 24 + 16 rows a points rank
        assert cases["dataset_share"]
        assert cases["points_share"] == ((3 - rank // 2, 20, 17), 12)
        assert cases["gather"] == [0.0, 1.0, 2.0, 3.0]
        assert cases["gather_points"] == [2.0 * (rank // 2), 2.0 * (rank // 2) + 1]
        assert cases["max_data"] == 2.0 + rank % 2 and cases["sum"] == 6.0


@pytest.mark.parametrize("family", FAMILIES)
def test_data_axis_every_family_equals_one_process(two_ranks, family):
    """Every family of the port, dropout on where it has any, 8 cases over
    2 ranks: the step's metrics, gradients and parameters on each rank."""
    spec = dict(family=family)
    for rank in range(2):
        assert_same_step(spec_result(two_ranks, "data", spec, rank), single(spec),
                         f"{family} rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["manufactured", "decoupled"])
def test_data_axis_matches_one_process_and_the_jax_sharded_step(jax_refs, two_ranks,
                                                                four_ranks, world, name):
    ranks = two_ranks if world == 2 else four_ranks
    got = spec_result(ranks, "data", JAX_SPECS[name])
    assert_same_step(got, single(JAX_SPECS[name]), f"{name} over {world}")
    np.testing.assert_allclose(got["metrics"].numpy(), jax_refs[(name, False)], rtol=5e-3,
                               atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_uneven_shares_dropout_and_relobralo(two_ranks, four_ranks, world):
    """13 cases over 2 (7 / 6) and 4 (4 / 3 / 3 / 3) ranks, dropout on,
    ReLoBRaLo, two steps: one process's step; every rank's scaler state the
    same bit for bit; each rank's dropout mask is one process's mask at
    the rank's cases."""
    ranks = two_ranks if world == 2 else four_ranks
    ref = single(UNEVEN)
    results = [spec_result(ranks, "data", UNEVEN, r) for r in range(world)]
    for rank, got in enumerate(results):
        assert_same_step(got, ref, f"13 cases rank {rank}")
        for a, b in zip(got["scaler"], results[0]["scaler"]):
            assert torch.equal(a, b)
        for a, b in zip(got["scaler"], ref["scaler"]):
            assert_close(a, b, "scaler")
        c0 = share(13, world, rank)[0]
        assert got["placement"] == (c0, 0, None)
        assert torch.equal(got["mask"], ref["mask"][c0:c0 + got["mask"].shape[0]])
    assert sum(r["mask"].shape[0] for r in results) == 13


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_eval_and_predict(two_ranks, four_ranks, world):
    """5 cases over the data axis: the errors' case-weighted mean and the
    gathered verbose prediction are one process's."""
    ranks = two_ranks if world == 2 else four_ranks
    ref = single(EVAL)
    for rank in range(world):
        got = spec_result(ranks, "data", EVAL, rank)
        assert_close(got["eval"], ref["eval"], "eval", per_entry=True)
        for a, b in zip(got["predict"], ref["predict"]):
            assert_close(a, b, "predict")


@pytest.mark.parametrize("world", [2, 4])
def test_points_axis_equals_one_process(two_ranks, four_ranks, world):
    """``pipn`` decoupled with its rows split over 2 points ranks ((1 x 2)
    and (2 x 2)), dropout and ReLoBRaLo, two steps; each rank's mask is one
    process's at its cases and global rows."""
    ranks = two_ranks if world == 2 else four_ranks
    ref = single(POINTS)
    n_int, n_bnd = 24, 16
    for rank in range(world):
        got = spec_result(ranks, "points", POINTS, rank)
        assert_same_step(got, ref, f"points rank {rank}")
        d, p = divmod(rank, 2) if world == 4 else (0, rank)
        c0, c1 = share(8, world // 2, d)
        i0, i1 = share(n_int, 2, p)
        b0, b1 = share(n_bnd, 2, p)
        assert got["placement"] == (c0, i0, n_int + b0)
        rows = torch.cat([torch.arange(i0, i1), torch.arange(n_int + b0, n_int + b1)])
        assert torch.equal(got["mask"], ref["mask"][c0:c1][:, rows])


@pytest.mark.parametrize("world", [2, 4])
def test_points_axis_matches_the_jax_sharded_step(jax_refs, two_ranks, four_ranks, world):
    ranks = two_ranks if world == 2 else four_ranks
    spec = JAX_SPECS["decoupled"] | {"shard_points": True}
    got = spec_result(ranks, "points", spec)
    assert_same_step(got, single(spec), f"points over {world}")
    np.testing.assert_allclose(got["metrics"].numpy(), jax_refs[("decoupled", True)],
                               rtol=5e-3, atol=1e-5)


def test_points_axis_ties_across_ranks(two_ranks):
    """A channel's equal maxima on both ranks go to the lower global row:
    the pooled cotangent, summed over the ranks, reaches the owner alone
    (an internal row before any boundary row); and a batch whose first and
    last internal rows are equal steps as one process steps it."""
    ties = two_ranks["extra"]
    for r in range(2):
        assert ties[r]["g"].flatten().tolist() == [1.0, 3.0, 3.0, 5.0, 7.0]
    assert ties[0]["grad"].flatten().tolist() == [3.0, 0.0, 3.0, 3.0, 0.0]
    assert ties[1]["grad"].flatten().tolist() == [0.0, 3.0, 0.0, 0.0, 3.0]
    for rank in range(2):
        assert_same_step(spec_result(two_ranks, "points", TIE, rank), single(TIE),
                         f"tie rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", list(POINT_SPECS))
def test_points_axis_every_path_equals_one_process(two_ranks, four_ranks, world, family):
    """Each family and derivative path with its rows split over 2 points
    ranks ((1 x 2) and (2 x 2)), the internal rows 13 / 12, dropout where
    the family has it, ReLoBRaLo: every rank's step is one process's."""
    ranks = two_ranks if world == 2 else four_ranks
    spec = POINT_SPECS[family]
    ref = single(spec)
    for rank in range(world):
        assert_same_first_step(spec_result(ranks, "points", spec, rank), ref,
                               f"{family} points rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["manufactured", "pi_gano"])
def test_points_axis_exact_paths_match_the_jax_sharded_step(jax_refs, two_ranks, four_ranks,
                                                           world, name):
    """The manufactured PIPN and ``pi-gano``, both on their exact paths
    (the JAX dry run's model and the variable CLI's default), points split:
    one process of the port, and the JAX package's step on its (4 x 2)
    mesh."""
    ranks = two_ranks if world == 2 else four_ranks
    spec = JAX_SPECS[name] | {"shard_points": True}
    for rank in range(world):
        got = spec_result(ranks, "points", spec, rank)
        assert_same_step(got, single(spec), f"{name} points over {world} rank {rank}")
        np.testing.assert_allclose(got["metrics"].numpy(), jax_refs[(name, True)], rtol=5e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("path", list(TIES))
def test_points_axis_ties_on_the_coupled_and_exact_pools(two_ranks, path):
    """The tie batch (a channel maximal in the first share's first row and
    the last share's last row) on the coupled and exact pools: the lower
    global row owns the channel, and each rank steps as one process."""
    for rank in range(2):
        assert_same_step(spec_result(two_ranks, "points", TIES[path], rank),
                         single(TIES[path]), f"{path} tie rank {rank}")


@pytest.mark.parametrize("kind", ["max", "gather"])
def test_points_collectives_second_and_third_derivatives(two_ranks, kind):
    """``points_max`` and ``points_gather`` on 7 / 5 rows of a (1 x 2)
    mesh: a scalar summed over the rows, its first derivative and its second
    and third (as products with fixed weights) at each rank's rows equal one
    process's at the same rows (float64)."""
    ref = w.collective_derivatives(w._deriv_x(), WHOLE)[kind]
    for rank in range(2):
        i0 = sum(w.DERIV_ROWS[:rank])
        rows = slice(i0, i0 + w.DERIV_ROWS[rank])
        got = two_ranks["cases"][rank][0][kind]
        for order, (a, r) in enumerate(zip(got, ref), 1):
            assert a.abs().max() > 0
            torch.testing.assert_close(a, r[:, rows], rtol=1e-10, atol=1e-12,
                                       msg=f"{kind} order {order} rank {rank}")


def test_exact_path_winner_rows_cross_ranks(two_ranks):
    """The manufactured PIPN's exact path on a (1 x 2) mesh: the pooled
    channels' winners lie on both ranks' internal rows, and every row
    (whichever rank reads the pool) has one process's J and H; the gradient
    of a loss of J and H alone in every parameter, the encoder's among them,
    is one process's after the all-reduce."""
    ref = w.exact_derivatives()
    model, batch = w.build(w.EXACT_WINNERS)
    fe = model.module.feature_extract
    with torch.no_grad():
        local = fe.local_feature(batch["C"])
        y = fe.global_feature(torch.cat([local, batch["boundaryId"], batch["sdf"]], dim=-1))
    winners = torch.max(y, dim=-2).indices
    n_int = 24
    assert bool((winners < n_int // 2).any()) and bool(((winners >= n_int // 2)
                                                        & (winners < n_int)).any())
    for rank in range(2):
        got = two_ranks["cases"][rank][1]
        rows = torch.cat([torch.arange(12 * rank, 12 * rank + 12),
                          torch.arange(24 + 8 * rank, 24 + 8 * rank + 8)])
        assert_close(got["out"], ref["out"][:, rows], f"out rank {rank}")
        for key in ("jac", "lap"):
            assert_close(got[key], ref[key][:, 12 * rank:12 * rank + 12], f"{key} rank {rank}")
        for name, g in got["grads"].items():
            assert_close(g, ref["grads"][name], f"{name} rank {rank}")
        assert ref["grads"]["feature_extract.global_feature.linear_0.weight"].abs().max() > 0


def test_points_sharding_of_other_paths_is_refused():
    """Every family and path splits its rows now (``POINT_SPECS``); what is
    refused: a mesh of another type (``TypeError``), ``shard_points``
    without a mesh, and a batch with fewer internal or boundary rows than
    points ranks (``ValueError``)."""
    model, batch = w.build(dict(family="manufactured", sizes=(2, 24, 1, 0)))
    with pytest.raises(TypeError):
        make_train_functions(model, make_optimizer(model, 1), mesh=object())
    with pytest.raises(ValueError):
        make_train_functions(model, make_optimizer(model, 1), shard_points=True)
    # a (1 x 2) mesh's view from rank 0 (no collective is reached)
    mesh = Mesh({"data": 1, "points": 2}, 0, (0, 0), torch.device("cpu"), None,
                {"world": None})
    with pytest.raises(ValueError, match="24 internal and 1 boundary rows do not split"):
        batch_share(batch, mesh, shard_points=True)


def test_mesh_of_one_process_steps_as_no_mesh():
    spec = dict(family="pipn_decoupled", sizes=(3, 24, 16, 6), shard_points=True)
    assert_same_step(w.run_steps(spec, make_mesh(1, 1, devices=["cpu"])), single(spec),
                     "mesh of one")


def test_cli_mesh_data_2_writes_one_checkpoint_equal_to_one_process(tmp_path):
    """``duct_fixed_boundary/train.py --mesh-data 2`` spawns two ranks on
    the CPU: rank 0 alone writes the run's files, and its checkpoint
    restores one process's training."""
    from porous_cfd_tpu_torch.datagen import synthetic_case
    from porous_cfd_tpu_torch.datagen.meta import generate_meta, generate_min_points
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as duct_train
    fields = ["C", "U", "p", "cellToRegion"]
    rng = np.random.default_rng(8421)
    for split, n in [("train", 8), ("val", 4)]:
        synthetic_case.write_foam_split(tmp_path / split, n, rng, n_internal=200,
                                        n_per_patch=30)
        synthetic_case.write_data_config(
            tmp_path / split, fields=fields, variable_boundaries={},
            normalize={"Scale": [], "Standardize": ["C", "U", "p"]}, dims=["x", "y"])
        generate_meta(tmp_path / split, *fields, max_dim=2)
    generate_min_points(tmp_path)

    def argv(name, *extra):
        return ["--model", "pipn", "--name", name, "--epochs", "1",
                "--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val"),
                "--n-internal", "80", "--n-boundary", "40", "--n-observations", "20",
                "--batch-size", "4", "--precision", "32", "--logs-dir", str(tmp_path / "logs"),
                *extra]

    assert duct_train.run(argv("dp2", "--mesh-data", "2"), device="cpu") is None
    assert not torch.distributed.is_initialized()
    run_dir = tmp_path / "logs" / "lightning_logs" / "dp2"
    written = sorted(p.name for p in run_dir.iterdir() if not p.name.startswith("events"))
    assert written == ["best.ckpt", "model.ckpt", "model_meta.json"]
    got = torch.load(run_dir / "model.ckpt", weights_only=True)
    assert got["step"] == 2 and got["epoch"] == 1
    # one process: the CLI's model, data, scaler, seed and epoch permutation
    args = duct_train.build_arg_parser().parse_args(argv("one"))
    train_data, _ = duct_train.make_datasets(args)
    model = duct_train.get_model(args, train_data.normalizers, "cpu")
    fns = make_train_functions(model, make_optimizer(model, 2), duct_train.get_loss_scaler(args))
    perm = np.random.default_rng(8421).permutation(8).reshape(2, 4)
    fns.train_epoch(fns.init_state(seed=8421), train_data.stacked().to("cpu"), perm)
    for k, v in model.module.state_dict().items():
        assert_close(got["module"][k], v, k)
    model.module.load_state_dict(got["module"])


def test_dryrun_multichip_four_ranks_equals_one_process():
    from porous_cfd_tpu_torch.dryrun import dryrun_multichip
    res = dryrun_multichip(4)
    assert res["mesh"] == (2, 2)
    assert bool(torch.isfinite(res["metrics"]).all())
    assert_close(res["metrics"], res["single"], per_entry=True)
