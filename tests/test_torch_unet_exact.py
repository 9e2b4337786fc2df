"""The U-Nets' exact paths (``fast_derivatives=False``: micro-batches of 2,
as the JAX factories set them) against the JAX package's at small widths
on the CPU, and a micro-batched step against one pass in the port. The
configurations and helpers are tests/test_torch_unet.py's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import (B, NB, NI, NO, V_TOL, WEIGHTS, assert_trees_close, both_sides,
                             grads_to_flax, port_model, tol)

from porous_cfd_tpu.data.foam_data import split_contiguous as jax_split
from porous_cfd_tpu.physics.operators import pinn_derivatives as jax_pinn_derivatives
from porous_cfd_tpu.train import engine as jax_engine
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch
from porous_cfd_tpu_torch.train import engine

# The exact paths' H: the JAX package's own U-Net tolerance
# (tests/test_fp_analytic.py:205-207), looser than ROADMAP §3's. A point
# 0.01 from a coarse point has an interpolation weight near 1e4, and H's
# w^3 terms then amplify f32 rounding to about 3e-3 of that point's H on
# either side (float64 lies between the two packages' values).
H_TOL = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family,act", [("pipn_pp_full", "silu"),
                                        ("pi_gano_pp_full", "tanh")])
def test_exact_path_matches_jax(family, act):
    """fast_derivatives=False: micro-batches of 2 as the JAX factory sets
    them (its remat has no counterpart in the port); the module forward
    under ``pinn_derivatives`` (values, J, H), then the loss vector and
    every parameter gradient."""
    model, params, jb, port, pb = both_sides(family, act, fast=False)
    assert model.remat and model.microbatch == 2 and model.derivative_apply is None
    assert port.microbatch == 2 and port.derivative_apply is None
    internal, boundary = jax_split(jb)

    def apply_fn(pts):
        return model.module.apply({"params": params},
                                  jnp.concatenate([pts, boundary["C"]], -2), jb, True)

    ref = jax.jit(lambda pts: jax_pinn_derivatives(jax.checkpoint(apply_fn), pts))(
        internal["C"])
    with torch.no_grad():
        got = engine.model_derivatives(port, pb, True)
    for label, a, r, t in zip(("values", "J", "H"), got, ref, (V_TOL, tol(ref[1]), H_TOL)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=label, **t)

    def total(p):
        losses, _ = jax_engine.compute_losses(model, p, jb, None, deterministic=True)
        return jnp.sum(jnp.asarray(WEIGHTS) * losses), losses

    (_, ref_losses), ref_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    port.module.zero_grad(set_to_none=True)
    losses, _ = engine.compute_losses(port, pb, deterministic=True)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref_losses),
                               **tol(ref_losses))
    torch.sum(torch.from_numpy(WEIGHTS) * losses).backward()
    assert_trees_close(grads_to_flax(port.module), ref_grads)


@pytest.mark.parametrize("family", ["pipn_pp_full", "pi_gano_pp_full"])
def test_microbatched_exact_step_equals_one_pass(family):
    """Dropout off, one training step of the exact path over 4 cases in
    micro-batches of 2 against one pass over all 4, from the same weights:
    the same metrics and parameter gradients (the loss is a mean over the
    cases, so the two groups' mean is the whole batch's)."""
    batch = make_foam_batch(4, NI, NB, NO, rng=np.random.default_rng(10))
    got = []
    for microbatch in (2, None):
        model = dataclasses.replace(port_model(family, "tanh", False), microbatch=microbatch)
        fns = engine.make_train_functions(model, engine.make_optimizer(model, 1))
        _, metrics = fns.train_step(fns.init_state(seed=5), model.attach_neighbors(batch))
        got.append([metrics] + [p.grad for p in model.module.parameters()])
    for a, r in zip(*got):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
