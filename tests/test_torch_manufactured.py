"""The manufactured-solutions workload: the port's ``make_manufactured_batch``
and ``manufactured_fields`` against the JAX package's (same numpy generator,
same batch), ``MomentumLossManufactured`` and the raw ``ContinuityLoss``
against JAX's on the same fields, and ``pipn_manufactured`` on its two paths
(the default exact operator and the max-pool-coupled analytic one) against
JAX's: losses and gradients, f32 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import manufactured as jax_manufactured
from porous_cfd_tpu.models.pipn import pipn_manufactured as jax_pipn_manufactured
from porous_cfd_tpu.physics import losses as jax_losses
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data import manufactured
from porous_cfd_tpu_torch.models.pipn import pipn_manufactured
from porous_cfd_tpu_torch.physics import losses
from porous_cfd_tpu_torch.train import engine

# nu, d, f, fe_local, fe_global ([local || boundaryId (2) || sdf]), seg
ARGS = (0.01, 50.0, 1.0, [2, 8, 8], [8 + 3, 8, 16], [16 + 8, 12, 3])
B, NI, NB = 2, 30, 12
V_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(ref):
    ref = np.asarray(ref)
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def batches(seed=5):
    return (jax_manufactured.make_manufactured_batch(np.random.default_rng(seed), B, NI, NB),
            manufactured.make_manufactured_batch(np.random.default_rng(seed), B, NI, NB))


def test_make_manufactured_batch_matches_jax():
    ref, got = batches()
    assert got.labels == tuple((k, None if v is None else tuple(v))
                               for k, v in jax_manufactured.MANUFACTURED_LABELS.items())
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert got.domain.keys() == ref.domain.keys()
    for k in ref.domain:
        np.testing.assert_array_equal(got.domain[k].numpy(), np.asarray(ref.domain[k]))
    # the walls are 3/4 of the boundary rows, the porous band has zone 1
    assert got.domain["walls"].shape == (B, 9) and got.domain["interface"].shape == (B, 3)
    zone = got["internal"]["cellToRegion"]
    assert 0 < float(zone.mean()) < 1 and float(got["boundary"]["cellToRegion"].abs().max()) == 0


def test_manufactured_fields_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 2 * np.pi, size=(50, 2))
    zones = (rng.uniform(size=(50, 1)) < 0.5).astype(np.float64)
    for a, b in zip(manufactured.manufactured_fields(pts, zones, 0.02, 30.0, 2.0),
                    jax_manufactured.manufactured_fields(pts, zones, 0.02, 30.0, 2.0)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_raw_losses_match_jax():
    """The residuals and losses on the batch's own fields and random
    derivatives."""
    ref_batch, batch = batches(7)
    rng = np.random.default_rng(3)
    u = rng.normal(size=(B, NI, 2)).astype(np.float32)
    u_jac = rng.normal(size=(B, NI, 2, 2)).astype(np.float32)
    u_lap = rng.normal(size=(B, NI, 2, 2)).astype(np.float32)
    p_grad = rng.normal(size=(B, NI, 2)).astype(np.float32)
    mom, ref_mom = losses.MomentumLossManufactured(0.01, 50.0, 1.0), \
        jax_losses.MomentumLossManufactured(0.01, 50.0, 1.0)
    args = (u, u_jac, u_lap, p_grad)
    t = [torch.from_numpy(a) for a in args]
    j = [jnp.asarray(a) for a in args]
    for port_fn, ref_fn in ((mom.residual, ref_mom.residual), (mom, ref_mom)):
        r = np.asarray(ref_fn(ref_batch["internal"], *j))
        np.testing.assert_allclose(port_fn(batch["internal"], *t).numpy(), r, **tol(r))
    cont, ref_cont = losses.ContinuityLoss(), jax_losses.ContinuityLoss()
    for port_fn, ref_fn in ((cont.residual, ref_cont.residual), (cont, ref_cont)):
        r = np.asarray(ref_fn(j[1]))
        np.testing.assert_allclose(port_fn(t[1]).numpy(), r, **tol(r))


@pytest.mark.parametrize("fast", [False, True])
def test_pipn_manufactured_losses_and_gradients_match_jax(fast):
    """Default (exact operator) and fast_derivatives=True (the coupled
    analytic path, the JAX package's dense route off the TPU)."""
    ref_batch, batch = batches(11)
    jmodel = jax_pipn_manufactured(*ARGS, fast_derivatives=fast)
    params = jmodel.module.init({"params": jax.random.PRNGKey(2)}, ref_batch["C"], ref_batch,
                                deterministic=True)["params"]

    def total(p):
        ls, _ = jax_engine.compute_losses(jmodel, p, ref_batch, None, deterministic=True)
        return jnp.sum(ls), ls

    (_, ref_losses), ref_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    model = pipn_manufactured(*ARGS, fast_derivatives=fast, device="cpu")
    assert (model.derivative_apply is None) == (not fast)
    assert (model.learning_rate, model.lr_gamma, model.adam_eps) == (1e-3, 0.9995, 1e-6)
    assert not model.enable_data_loss and model.num_losses == 6
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    ls, _ = engine.compute_losses(model, batch, deterministic=True)
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(ref_losses), **tol(ref_losses))
    ls.sum().backward()
    for name, lin in model.module.named_modules():
        if isinstance(lin, torch.nn.Linear):
            node = ref_grads
            for k in name.split("."):
                node = node[k]
            for got, r in ((lin.weight.grad.numpy().T, node["kernel"]),
                           (lin.bias.grad.numpy(), node["bias"])):
                np.testing.assert_allclose(got, np.asarray(r), err_msg=name, **tol(r))
