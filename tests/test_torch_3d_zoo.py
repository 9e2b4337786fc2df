"""The 3D experiments' model zoos, abc (the PIPN family: ``pipn`` on its
decoupled, coupled and exact paths, ``pipn-pp``, ``pipn-pp-mrg``,
``pipn-pp-full``) and windbreaks (``pi-gano``, ``pi-gano-pp``,
``pi-gano-pp-full`` with the ``Ux-inlet`` branch feature and 5 boundary ids),
against the JAX factories at narrow widths on synthetic 3D splits, dropout
off: values, J and H of the derivative path, the loss vector and its
gradients in every parameter, with the JAX parameters carried across by
``convert.params_from_flax``. Each model keeps its zoo's structure: D = 3,
the zoo's layer counts and neighbour counts, the examples' loss weights.
Both sides run f32 on the CPU (JAX at "highest" matmul precision,
tests/conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.abc import train as jax_abc
from examples.windbreaks import train as jax_windbreaks
from porous_cfd_tpu.data.dataset import FoamDataset as JaxFoamDataset
from porous_cfd_tpu.models import pi_gano as jax_pi_gano
from porous_cfd_tpu.models import pipn as jax_pipn
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.datagen import meta, synthetic_case
from porous_cfd_tpu_torch.examples.abc import train as abc
from porous_cfd_tpu_torch.examples.windbreaks import train as windbreaks
from porous_cfd_tpu_torch.models import pi_gano, pipn
from porous_cfd_tpu_torch.train import engine

FIELDS = ["C", "U", "p", "cellToRegion", "d", "f"]
WINDBREAK_PATCHES = ["inlet", "interface", "outlet", "solid", "walls"]
N_INT, N_BND, N_OBS = 48, 50, 12
V_TOL = dict(rtol=1e-5, atol=1e-5)

# narrow forms of the zoos (examples/abc/train.py:32-86,
# examples/windbreaks/train.py:33-76): n = 3 dimensions, b boundary ids
N, B_ABC, B_WB = 3, 4, 5
ABC_PIPN = dict(fe_local_layers=[N, 16, 16], fe_global_layers=[16 + B_ABC + 1, 16, 24, 32],
                seg_layers=[32 + 16, 24, 16, 16, N + 1])
ABC_PP = dict(fe_local_layers=[N, 16, 16], seg_layers=[32 + 16, 24, 16, N + 1],
              fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
              fe_global_layers=[[N + B_ABC + N, 16, 24], [24 + N, 24, 24], [24 + N, 24, 32]],
              max_neighbors=16)
ABC_MRG = dict(n_dims=N, mrg_in_features=B_ABC + N, fe_local_layers=[N, 16, 16],
               seg_layers=[1024 + 16, 24, 16, N + 1], max_neighbors=16)
ABC_FULL = dict(enc_layers=[[N + B_ABC + 1 + N, 16, 16, 24], [24 + N, 24, 24, 32],
                            [32 + N, 48]],
                enc_radius=[0.4, 0.8], enc_fraction=[0.5, 0.25],
                dec_layers=[[48 + 32, 32, 32], [24 + 32, 24, 24],
                            [24 + N + B_ABC + 1, 16, 16, 16, N + 1]],
                dec_k=[3, 3, 3], max_neighbors=16)
WB_GANO = dict(out_features=N + 1, branch_layers=[10, 16, 40], local_layers=[N, 16, 16, 16],
               geometry_layers=[B_WB + N + 1, 16, 24, 24], n_operators=4)
WB_PP = dict(out_features=N + 1, branch_layers=[10, 16, 40], local_layers=[N, 16, 16, 16],
             geometry_layers=[[N * 2 + B_WB, 16, 24], [24 + N, 24], [24 + N, 24, 24]],
             geometry_radius=[0.5, 1], geometry_fraction=[0.5, 0.25], n_operators=4)
WB_FULL = dict(out_features=N + 1, branch_layers=[10, 16, 24],
               enc_layers=[[N * 2 + 1 + B_WB, 16, 16, 24], [24 + N, 24, 24, 32],
                           [32 + N, 32, 48]],
               enc_radius=[0.5, 1], enc_fraction=[0.5, 0.25],
               dec_layers=[[48 + 32, 24, 24], [24 + 24, 24, 24],
                           [24 + N + 1 + B_WB, 16, 16, 16, N + 1]],
               dec_k=[3, 3, 3])

# name: (experiment, JAX factory, port factory, config, dropout keyword,
# dropout rates (all 0), extra keywords)
ZOO = {
    "abc-pipn": ("abc", jax_pipn.pipn_foam, pipn.pipn_foam, ABC_PIPN, "seg_dropout",
                 [0.0] * 4, {}),
    "abc-pipn-coupled": ("abc", jax_pipn.pipn_foam, pipn.pipn_foam, ABC_PIPN, "seg_dropout",
                         [0.0] * 4, {"coupled_context": True}),
    "abc-pipn-exact": ("abc", jax_pipn.pipn_foam, pipn.pipn_foam, ABC_PIPN, "seg_dropout",
                       [0.0] * 4, {"fast_derivatives": False}),
    "abc-pipn-pp": ("abc", jax_pipn.pipn_foam_pp, pipn.pipn_foam_pp, ABC_PP, "seg_dropout",
                    [0.0] * 3, {}),
    "abc-pipn-pp-mrg": ("abc", jax_pipn.pipn_foam_pp_mrg, pipn.pipn_foam_pp_mrg, ABC_MRG,
                        "seg_dropout", [0.0] * 3, {}),
    "abc-pipn-pp-full": ("abc", jax_pipn.pipn_foam_pp_full, pipn.pipn_foam_pp_full, ABC_FULL,
                         "dec_dropout", [0.0, 0.0, [0.0] * 4], {}),
    "windbreaks-pi-gano": ("windbreaks", jax_pi_gano.pi_gano, pi_gano.pi_gano, WB_GANO,
                           "operator_dropout", [0.0] * 4, {"fast_derivatives": True}),
    "windbreaks-pi-gano-pp": ("windbreaks", jax_pi_gano.pi_gano_pp, pi_gano.pi_gano_pp, WB_PP,
                              "operator_dropout", [0.0] * 4, {}),
    "windbreaks-pi-gano-pp-full": ("windbreaks", jax_pi_gano.pi_gano_pp_full,
                                   pi_gano.pi_gano_pp_full, WB_FULL, "fp_dropout",
                                   [0.0, 0.0, [0.0] * 4], {}),
}


def tol(ref):
    """J, H, losses and gradients (ROADMAP §3): second derivatives through
    every layer, summed in another order on each side."""
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_3d_split(root, patch_names, seed=8421):
    """A synthetic 3D split as the JAX package's own 3D test writes one
    (tests/test_examples_3d.py:15-31): 3 training and 2 held-out cases of
    160 internal points and 24 a patch, variable inlet Ux and d, f."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", 3), ("val", 2)):
        synthetic_case.write_foam_split(root / split, n, rng, n_internal=160, n_per_patch=24,
                                        dims=3, d=30000.0, f=79.731, variable=True,
                                        patch_names=patch_names)
        synthetic_case.write_data_config(root / split, fields=FIELDS,
                                         variable_boundaries={"Ux": "inlet"},
                                         normalize={"Scale": ["d", "f"],
                                                    "Standardize": ["C", "U", "p"]},
                                         dims=["x", "y", "z"])
        meta.generate_meta(root / split, *FIELDS, max_dim=3)
    meta.generate_min_points(root)
    return root


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    base = tmp_path_factory.mktemp("zoo3d")
    return {"abc": write_3d_split(base / "abc", None),
            "windbreaks": write_3d_split(base / "windbreaks", WINDBREAK_PATCHES)}


def datasets(root):
    """The training split through both packages' FoamDataset, one rng seed."""
    args = (str(root / "train"), N_INT, N_BND, N_OBS)
    return (JaxFoamDataset(*args, rng=np.random.default_rng(3)),
            FoamDataset(*args, rng=np.random.default_rng(3)))


def grads_to_flax(module) -> dict:
    tree: dict = {}
    for name, lin in module.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = tree
            for k in name.split("."):
                node = node.setdefault(k, {})
            node["kernel"] = lin.weight.grad.numpy().T
            node["bias"] = lin.bias.grad.numpy()
    return tree


def assert_trees_close(got: dict, ref: dict, path=""):
    assert got.keys() == ref.keys(), path
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(got[k], ref[k], f"{path}/{k}")
        else:
            r = np.asarray(ref[k])
            np.testing.assert_allclose(np.asarray(got[k]), r, err_msg=f"{path}/{k}", **tol(r))


def random_params(model, batch, seed=7):
    """Parameters of the flax module's shapes drawn from a seed (kernels
    scaled by 1/sqrt(fan-in)): no traced init to compile."""
    shapes = jax.eval_shape(lambda: model.module.init(
        {"params": jax.random.PRNGKey(0)}, batch["C"], batch, deterministic=True))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.normal(size=s.shape)
                               / np.sqrt(s.shape[0] if len(s.shape) == 2 else 10))
                              .astype(np.float32)), shapes)


@pytest.mark.parametrize("name", list(ZOO))
def test_3d_zoo_matches_jax(splits, name):
    experiment, jax_factory, port_factory, cfg, drop_key, rates, extra = ZOO[name]
    jax_ds, ds = datasets(splits[experiment])
    if experiment == "abc":
        physics = dict(nu=jax_abc.NU, d=jax_abc.D, f=jax_abc.F)
        weights = np.asarray([1, 1, 1, 1, 1, 1, 1, 1, 100, 100, 100, 100], np.float32)
    else:
        physics = dict(nu=jax_windbreaks.NU,
                       variable_boundaries=jax_windbreaks.VARIABLE_BOUNDARIES)
        weights = np.asarray([10, 10, 10, 10, 1, 1, 1, 1, 1, 1, 1, 1], np.float32)
    model = jax_factory(**cfg, **physics, **extra, **{drop_key: rates},
                        scalers=jax_ds.normalizers)
    port = port_factory(**cfg, **physics, **extra, **{drop_key: rates},
                        scalers=ds.normalizers, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    jb = model.attach_neighbors(jax_ds.stacked())
    pb = port.attach_neighbors(ds.stacked().to("cpu"))
    params = random_params(model, jb)
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), port.module)
    assert (port.derivative_apply is None) == (model.derivative_apply is None)
    w = jnp.asarray(weights)

    def reference(p):
        """The JAX side in one compiled call: (v, J, H) of the derivative
        path (None on the exact path) and the weighted loss's value, loss
        vector and gradients."""
        def total(q):
            losses, _ = jax_engine.compute_losses(model, q, jb, None, deterministic=True)
            return jnp.sum(w * losses), losses

        derivs = (model.derivative_apply(p, jb, None, True)
                  if model.derivative_apply is not None else None)
        return derivs, jax.value_and_grad(total, has_aux=True)(p)

    ref_derivs, ((_, ref_losses), ref_grads) = jax.jit(reference)(params)
    if ref_derivs is not None:
        with torch.no_grad():
            got = port.derivative_apply(pb, True)
        assert got[1].shape[-1] == 3
        for label, a, r in zip(("values", "J", "H"), got, ref_derivs):
            r = np.asarray(r)
            np.testing.assert_allclose(a.numpy(), r, err_msg=label,
                                       **(V_TOL if label == "values" else tol(r)))

    port.module.zero_grad(set_to_none=True)
    losses, _ = engine.compute_losses(port, pb, deterministic=True)
    assert losses.shape == (12,)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses),
                               **tol(ref_losses))
    torch.sum(torch.from_numpy(weights) * losses).backward()
    assert_trees_close(grads_to_flax(port.module), ref_grads)


@pytest.mark.parametrize("name", ["pipn", "pipn-pp", "pipn-pp-mrg", "pipn-pp-full"])
def test_abc_cli_zoo_matches_the_jax_zoo(splits, name):
    """The CLI's ``get_model`` at full width builds the JAX zoo's layers:
    every parameter of the flax tree fits the port's module."""
    jax_ds, ds = datasets(splits["abc"])
    args = abc.build_arg_parser().parse_args(["--model", name])
    model = jax_abc.get_model(args, jax_ds.normalizers)
    port = abc.get_model(args, ds.normalizers, "cpu")
    jb = model.attach_neighbors(jax_ds.stacked())
    params = jax.eval_shape(lambda: model.module.init(
        {"params": jax.random.PRNGKey(0)}, jb["C"], jb, deterministic=True))["params"]
    params_from_flax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), params),
                     port.module)
    assert (port.derivative_apply is None) == (model.derivative_apply is None)


@pytest.mark.parametrize("name", ["pi-gano", "pi-gano-pp", "pi-gano-pp-full"])
def test_windbreaks_cli_zoo_matches_the_jax_zoo(splits, name):
    jax_ds, ds = datasets(splits["windbreaks"])
    args = windbreaks.build_arg_parser().parse_args(["--model", name])
    model = jax_windbreaks.get_model(args, jax_ds.normalizers)
    port = windbreaks.get_model(args, ds.normalizers, "cpu")
    jb = model.attach_neighbors(jax_ds.stacked())
    params = jax.eval_shape(lambda: model.module.init(
        {"params": jax.random.PRNGKey(0)}, jb["C"], jb, deterministic=True))["params"]
    params_from_flax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), params),
                     port.module)
    assert (port.derivative_apply is None) == (model.derivative_apply is None)
