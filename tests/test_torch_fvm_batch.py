"""The port's batched 2D solver (``datagen/fvm_batch.solve_duct_batch``, on
the CPU) against the JAX package's: the f32 march gives the JAX
``solve_duct_batch``'s fields and steps on the JAX test's three cases
(``tests/test_fvm_tpu.py``: an anisotropic Darcy pair, a per-case f and an
angled inlet among them); in float64 it reproduces the numpy solver to
round-off; its results do not depend on how often the host checks the
batch; TF32 is off inside the solve and the caller's switch comes back."""
import dataclasses

import numpy as np
import pytest
import torch

from porous_cfd_tpu.datagen.fvm_tpu import solve_duct_batch as jax_solve_duct_batch
from porous_cfd_tpu_torch.datagen import fvm, fvm_batch

# the JAX test's grid, limits and cases (tests/test_fvm_tpu.py:11-22)
GRID = dict(nx=40, ny=24)
TOL, MAX_STEPS = 5e-4, 8000
CASES = [
    dict(shape="circle", cx=0.10, cy=0.00, size=0.12, theta=0.0),
    dict(shape="square", cx=0.08, cy=0.02, size=0.12, theta=np.radians(30), sx=0.875, sy=0.75),
    dict(shape="ellipse", cx=0.12, cy=-0.02, size=0.13, theta=np.radians(70),
         d=(12000.0, 20000.0), f=30.80, u_inlet=0.15 * np.cos(np.radians(20)),
         v_inlet=0.15 * np.sin(np.radians(20))),
]
# f32 march against f32 march: XLA and torch round a few products and sums
# differently (XLA's CPU code multiplies by 1/dx and fuses multiply-adds);
# measured on these cases: 8.6e-6 of p's norm at most
BATCH_RTOL = 1e-5
# one ulp of u near the inlet speed moves the residual by about 8.9e-6 at
# this grid (1.8% of TOL), so a case whose residual passes TOL within an ulp
# of it stops one step apart in the two marches (the ellipse: the JAX march
# reads 4.962e-4 at its step 643 where the port reads 5.007e-4)
STEP_SLACK = 1
# float64 against the numpy solver: the eigenbasis projection against the
# sparse LU, both in f64 (measured: 3e-16 of the fields' largest value)
F64_ATOL = 1e-12


def rel(a, b):
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.fixture(scope="module")
def batched():
    return fvm_batch.solve_duct_batch(CASES, tol=TOL, max_steps=MAX_STEPS, device="cpu", **GRID)


def test_batched_march_matches_jax_batched_march(batched):
    ref = jax_solve_duct_batch(CASES, tol=TOL, max_steps=MAX_STEPS, **GRID)
    steps = [(got.steps, want.steps) for got, want in zip(batched, ref)]
    assert steps[0][0] == steps[0][1] and steps[1][0] == steps[1][1], steps
    for (case, got, want) in zip(CASES, batched, ref):
        assert abs(got.steps - want.steps) <= STEP_SLACK, case["shape"]
        assert got.residual < TOL
        np.testing.assert_array_equal(got.zone, want.zone)
        uscale = np.linalg.norm(np.stack([want.u, want.v]))
        for name in ("u", "v"):
            assert np.linalg.norm(getattr(got, name) - getattr(want, name)) / uscale < \
                BATCH_RTOL, (case["shape"], name)
        assert rel(got.p, want.p) < BATCH_RTOL, case["shape"]
        assert rel(got.moment_err, want.moment_err) < 1e-3
        for name in ("x", "y"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_batched_march_matches_numpy_solver(batched):
    """The JAX test's agreement (tests/test_fvm_tpu.py:29-50)."""
    for case, sol in zip(CASES, batched):
        ref = fvm.solve_duct(**case, tol=TOL, max_steps=MAX_STEPS, **GRID)
        assert sol.residual < TOL and ref.residual < TOL
        uscale = np.linalg.norm(np.stack([ref.u, ref.v]))
        assert rel(sol.u, ref.u) < 2e-3
        assert np.linalg.norm(sol.v - ref.v) / uscale < 2e-3
        assert rel(sol.p, ref.p) < 2e-3
        np.testing.assert_array_equal(sol.zone, ref.zone)
        m_s = np.abs(sol.moment_err[1:-1, 1:-1]).mean()
        m_r = np.abs(ref.moment_err[1:-1, 1:-1]).mean()
        assert m_s < m_r * 1.5 + 1e-8


def test_float64_march_reproduces_the_numpy_solver():
    """In float64 the batched march is the numpy solver to round-off: the
    same steps and residuals, the fields within F64_ATOL."""
    sols = fvm_batch.solve_duct_batch(CASES, tol=TOL, max_steps=MAX_STEPS, device="cpu",
                                      dtype=torch.float64, **GRID)
    for case, sol in zip(CASES, sols):
        ref = fvm.solve_duct(**case, tol=TOL, max_steps=MAX_STEPS, **GRID)
        assert sol.steps == ref.steps, case["shape"]
        np.testing.assert_allclose(sol.residual, ref.residual, rtol=1e-9)
        for field in ("u", "v", "p", "div", "moment_err"):
            np.testing.assert_allclose(getattr(sol, field), getattr(ref, field), rtol=0,
                                       atol=F64_ATOL, err_msg=field)


def test_batched_march_does_not_depend_on_the_check_cadence():
    """A case that converges early, one later and one that runs out of
    steps: checks every 1 and every 37 steps give the same bits, steps and
    residuals (frozen cases stay frozen on the device)."""
    cases = CASES[:2] + [dict(shape="star", cx=0.05, cy=0.0, size=0.15, theta=0.3)]
    kw = dict(tol=3.2e-2, max_steps=205, device="cpu", nx=24, ny=16)
    runs = [fvm_batch.solve_duct_batch(cases, check_every=n, **kw) for n in (1, 37)]
    steps = [s.steps for s in runs[0]]
    assert steps[0] < steps[1] < steps[2] == 205, steps
    for a, b in zip(*runs):
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=field.name)
            else:
                assert x == y, field.name
    with pytest.raises(ValueError, match="check_every"):
        fvm_batch.solve_duct_batch(cases, check_every=0, **kw)


def test_tf32_is_off_inside_the_solve_and_restored(monkeypatch):
    """The projection's products run in full f32: the TF32 switch reads off
    inside the march and the caller's value (on or off) comes back after it,
    also when the march raises."""
    seen = []
    real_einsum = torch.einsum

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_einsum(*args)

    monkeypatch.setattr(torch, "einsum", spy)
    for before in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = before
        fvm_batch.solve_duct_batch(CASES[:1], tol=1.0, max_steps=2, device="cpu", nx=8, ny=6)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is before
        seen.clear()

    def boom(*args):
        raise FloatingPointError("inside the march")

    monkeypatch.setattr(torch, "einsum", boom)
    torch.backends.cuda.matmul.allow_tf32 = True
    with pytest.raises(FloatingPointError):
        fvm_batch.solve_duct_batch(CASES[:1], tol=1.0, max_steps=2, device="cpu", nx=8, ny=6)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    torch.backends.cuda.matmul.allow_tf32 = False


def test_no_card_raises_without_being_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fvm_batch.solve_duct_batch(CASES[:1], nx=8, ny=6)


def test_stats_report_the_march():
    stats = {}
    sols = fvm_batch.solve_duct_batch(CASES[:2], tol=2e-2, max_steps=300, device="cpu", nx=24,
                                      ny=16, check_every=50, stats=stats)
    assert stats["steps"] % 50 == 0 and stats["steps"] >= max(s.steps for s in sols)
    assert stats["seconds"] > 0

