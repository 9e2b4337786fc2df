"""The port's 3D FVM solvers against the JAX package's: ``fvm3d.solve_duct3``
gives bit-equal fields and ``solution_to_case3`` writes byte-equal case
files; the batched march (``fvm3d_batch.solve_duct3_batch``, on the CPU)
takes the JAX ``solve_duct3_batch``'s steps and fields, and holds the numpy
solver at the JAX test's agreement (``tests/test_fvm3d_tpu.py``); its
results do not depend on how often the host checks the batch."""
import dataclasses

import numpy as np
import pytest

from porous_cfd_tpu.datagen import fvm3d as jax_fvm3d
from porous_cfd_tpu.datagen.fvm3d_tpu import solve_duct3_batch as jax_solve_duct3_batch
from porous_cfd_tpu_torch.datagen import fvm3d, fvm3d_batch

# the JAX test's grid, cases and limits (tests/test_fvm3d_tpu.py:9-13)
GRID = dict(nx=20, ny=12, nz=12)
TOL, MAX_STEPS = 5e-4, 6000
CASES = [("band", (0.1, 0.0, 0.0), 0.10, 0.20),
         ("sphere", (0.12, 0.02, -0.02), 0.12, 0.16)]
# f32 march against f32 march: XLA and torch order a few sums differently
# (measured on this grid: 2.4e-6 of p's norm at most)
BATCH_RTOL = 1e-4


def rel(a, b):
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def assert_solutions_equal(got, ref):
    assert got.steps == ref.steps and got.residual == ref.residual
    for field in dataclasses.fields(ref):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)


@pytest.mark.parametrize("shape,center,size", [("sphere", (0.1, 0.0, 0.0), 0.14),
                                               ("cylinder", (0.1, 0.02, 0.0), 0.1)])
def test_solve_duct3_equals_jax(shape, center, size):
    kw = dict(nx=16, ny=10, nz=10, u_inlet=0.175, max_steps=150)
    got = fvm3d.solve_duct3(shape, center, size, **kw)
    ref = jax_fvm3d.solve_duct3(shape, center, size, **kw)
    assert got.zone.sum() > 0
    assert_solutions_equal(got, ref)
    np.testing.assert_array_equal(got.points, ref.points)


def test_solution_to_case3_writes_the_jax_packages_bytes(tmp_path):
    sol = fvm3d.solve_duct3("box", (0.12, -0.03, 0.02), 0.12, nx=16, ny=10, nz=10,
                            max_steps=60)
    kw = dict(n_internal=300, rng=None, d=30000.0, f=79.731, u_inlet=0.2, n_per_patch=40,
              elapsed_ns=12345)
    fvm3d.solution_to_case3(sol, tmp_path / "port", **kw)
    jax_fvm3d.solution_to_case3(sol, tmp_path / "jax", **kw)
    files = {side: sorted(p.relative_to(tmp_path / side)
                          for p in (tmp_path / side).rglob("*") if p.is_file())
             for side in ("jax", "port")}
    assert files["jax"] == files["port"] and len(files["jax"]) > 10
    for name in files["jax"]:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    c, u, p = fvm3d._interface_faces3(sol)
    jc, ju, jp = jax_fvm3d._interface_faces3(sol)
    for a, b in ((c, jc), (u, ju), (p, jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        fvm3d._momentum_residual3(sol.u, sol.v, sol.w, sol.p, sol.zone, (0.1, 0.1, 0.1),
                                  1e-3, 100.0, 1.0),
        jax_fvm3d._momentum_residual3(sol.u, sol.v, sol.w, sol.p, sol.zone, (0.1, 0.1, 0.1),
                                      1e-3, 100.0, 1.0))


@pytest.fixture(scope="module")
def batched():
    return fvm3d_batch.solve_duct3_batch(CASES, tol=TOL, max_steps=MAX_STEPS, device="cpu",
                                         **GRID)


def test_batched_march_matches_jax_batched_march(batched):
    ref = jax_solve_duct3_batch(CASES, tol=TOL, max_steps=MAX_STEPS, **GRID)
    for got, want in zip(batched, ref):
        assert got.steps == want.steps
        assert got.residual < TOL
        np.testing.assert_array_equal(got.zone, want.zone)
        uscale = np.linalg.norm(np.stack([want.u, want.v, want.w]))
        for name in ("u", "v", "w"):
            assert np.linalg.norm(getattr(got, name) - getattr(want, name)) / uscale < \
                BATCH_RTOL, name
        assert rel(got.p, want.p) < BATCH_RTOL
        assert rel(got.moment_err, want.moment_err) < 1e-3


def test_batched_march_matches_numpy_solver(batched):
    """The JAX test's agreement (tests/test_fvm3d_tpu.py:25-40)."""
    for (shape, center, size, u_in), sol in zip(CASES, batched):
        ref = fvm3d.solve_duct3(shape, center, size, u_inlet=u_in, tol=TOL,
                                max_steps=MAX_STEPS, **GRID)
        assert sol.residual < TOL and ref.residual < TOL
        uscale = np.linalg.norm(np.stack([ref.u, ref.v, ref.w]))
        assert rel(sol.u, ref.u) < 2e-3
        assert np.linalg.norm(sol.v - ref.v) / uscale < 2e-3
        assert np.linalg.norm(sol.w - ref.w) / uscale < 2e-3
        assert rel(sol.p, ref.p) < 2e-3
        np.testing.assert_array_equal(sol.zone, ref.zone)
        m_s = np.abs(sol.moment_err[1:-1, 1:-1, 1:-1]).mean()
        m_r = np.abs(ref.moment_err[1:-1, 1:-1, 1:-1]).mean()
        assert m_s < m_r * 1.5 + 1e-8


def test_batched_march_does_not_depend_on_the_check_cadence():
    """A case that converges early, one that converges later and one that
    runs out of steps: the host's check every 1 and every 37 steps give the
    same bits, steps and residuals (frozen cases stay frozen on the
    device)."""
    cases = CASES + [("box", (0.0, 0.0, 0.0), 0.14, 0.175)]
    kw = dict(tol=TOL, max_steps=120, device="cpu", nx=16, ny=10, nz=10)
    runs = [fvm3d_batch.solve_duct3_batch(cases, check_every=n, **kw) for n in (1, 37)]
    steps = [s.steps for s in runs[0]]
    assert steps[0] < steps[-1] == 120, steps
    for a, b in zip(*runs):
        assert_solutions_equal(a, b)


def test_batched_march_sets_full_f32_and_restores_the_callers_switch():
    import torch
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with fvm3d_batch._full_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
