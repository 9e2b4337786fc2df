"""The batched 3D Navier-Stokes + Darcy-Forchheimer solver on the card: the
port's counterpart of ``porous_cfd_tpu/datagen/fvm3d_tpu.py``.

The same discretization as ``datagen/fvm3d.py`` (staggered MAC grid, central
convection with a small upwind blend, implicit porous sink, explicit
pseudo-time projection), in plain torch, so that a whole zoo of cases
marches in lockstep in f32 on one device:

  * the Kronecker-sum pressure Poisson operator is solved in its eigenbasis:
    three small symmetric tridiagonal eigendecompositions (numpy, at set-up)
    turn every projection into six products over the (B, nx, ny, nz) field
    and an eigenvalue divide, in full f32 (TF32 is switched off inside the
    solve, whatever the caller set);
  * every step freezes, on the device, each case that has converged or
    reached ``max_steps``, so its fields, residual and step count stay as
    they were. The host asks whether any case is still marching only every
    ``check_every`` steps (one synchronization each), and the extra steps
    after the last case froze change nothing: the results do not depend on
    ``check_every``.

The fields come back as ``fvm3d.DuctSolution3``s, post-processed in float64
on the host as the numpy solver's are. The f32 march takes the numpy (f64)
solver's steps and agrees with its steady fields within the JAX package's
2e-3 relative (1.3e-6 on the JAX test's cases; ``tests/test_torch_fvm3d.py``).

    from porous_cfd_tpu_torch.datagen.fvm3d_batch import solve_duct3_batch
    sols = solve_duct3_batch([("sphere", (0.1, 0.0, 0.0), 0.14, 0.2)])

It runs on the CUDA card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from porous_cfd_tpu_torch.datagen import fvm3d
from porous_cfd_tpu_torch.datagen.fvm3d import DOMAIN3, NU, DuctSolution3
from porous_cfd_tpu_torch.device import resolve_device

# steps between two reads of the batch's state on the host
CHECK_EVERY = 200


def _poisson_eig(n: int, h: float, dirichlet_end: bool):
    """Dense symmetric 1D second-difference operator -> (Q, lam) with
    A = Q diag(lam) Q^T (the stencil of ``fvm3d._poisson_1d``)."""
    a = 1.0 / h ** 2
    A = np.zeros((n, n))
    A[np.arange(n), np.arange(n)] = -2.0 * a
    A[0, 0] = -a
    A[n - 1, n - 1] = -3.0 * a if dirichlet_end else -a
    idx = np.arange(n - 1)
    A[idx, idx + 1] = a
    A[idx + 1, idx] = a
    lam, Q = np.linalg.eigh(A)
    return Q, lam


@contextlib.contextmanager
def _full_f32():
    """Products in full f32 on the card for the block, as on the CPU."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _sl(ndim: int, axis: int, s: slice) -> tuple:
    return tuple(s if ax == axis else slice(None) for ax in range(ndim))


def _avg(a, axis):
    axis += 1
    n = a.shape[axis]
    return 0.5 * (a[_sl(a.ndim, axis, slice(0, n - 1))] + a[_sl(a.ndim, axis, slice(1, n))])


def _diff(a, axis, h):
    axis += 1
    n = a.shape[axis]
    return (a[_sl(a.ndim, axis, slice(1, n))] - a[_sl(a.ndim, axis, slice(0, n - 1))]) / h


def _even(a, axis):
    """Pad with edge values (zero-gradient / slip-tangential ghost)."""
    axis += 1
    n = a.shape[axis]
    return torch.cat([a[_sl(a.ndim, axis, slice(0, 1))], a,
                      a[_sl(a.ndim, axis, slice(n - 1, n))]], dim=axis)


def _masks(cases, nx, ny, nz):
    """The porous masks on the u, v and w faces and the cells (B, ...), and
    the inlet speeds (B,), in f32."""
    (x0, x1), (y0, y1), (z0, z1) = DOMAIN3
    dx, dy, dz = (x1 - x0) / nx, (y1 - y0) / ny, (z1 - z0) / nz
    xc = x0 + (np.arange(nx) + 0.5) * dx
    yc = y0 + (np.arange(ny) + 0.5) * dy
    zc = z0 + (np.arange(nz) + 0.5) * dz
    xu = x0 + np.arange(nx + 1) * dx
    yv = y0 + np.arange(ny + 1) * dy
    zw = z0 + np.arange(nz + 1) * dz
    b = len(cases)
    su = np.empty((b, nx + 1, ny, nz), np.float32)
    sv = np.empty((b, nx, ny + 1, nz), np.float32)
    sw = np.empty((b, nx, ny, nz + 1), np.float32)
    zone = np.empty((b, nx, ny, nz), np.float32)
    u_in = np.empty((b,), np.float32)
    for i, (shape, center, size, u_inlet) in enumerate(cases):
        inside = fvm3d.shape_indicator3(shape, center, size)

        def mask(xs, ys, zs):
            xx, yy, zz = np.meshgrid(xs, ys, zs, indexing="ij")
            return inside(xx, yy, zz).astype(np.float32)

        su[i], sv[i], sw[i] = mask(xu, yc, zc), mask(xc, yv, zc), mask(xc, yc, zw)
        zone[i] = mask(xc, yc, zc)
        u_in[i] = u_inlet
    return (xc, yc, zc), (dx, dy, dz), su, sv, sw, zone, u_in


def solve_duct3_batch(cases, nx: int = 48, ny: int = 28, nz: int = 28, nu: float = NU,
                      d: float = fvm3d.DARCY_D, f: float = fvm3d.FORCH_F, tol: float = 1e-4,
                      max_steps: int = 20000, upwind: float = 0.15, device=None,
                      check_every: int = CHECK_EVERY, stats: dict | None = None
                      ) -> list[DuctSolution3]:
    """March a batch of 3D duct cases to steady state on ``device`` (the
    CUDA card unless ``"cpu"`` is asked for).

    :param cases: a sequence of (shape, center, size, u_inlet) tuples.
    :param check_every: steps between two reads of the batch's state on the
        host; the results do not depend on it.
    :param stats: if given, receives the march's ``steps`` (the steps run,
        frozen ones included) and ``seconds`` (ending in a synchronization).
    :return: one ``fvm3d.DuctSolution3`` a case (cell-centred float64
        fields, the case's residual and steps), as ``fvm3d.solve_duct3``
        returns them.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be at least 1, got {check_every}")
    dev = resolve_device(device)
    (xc, yc, zc), (dx, dy, dz), su, sv, sw, zone, u_in = _masks(cases, nx, ny, nz)
    b = len(cases)
    dt = 0.35 * np.minimum(dx / np.maximum(u_in * 3.0, 1e-9),
                           dx * dx / (6.0 * nu)).astype(np.float32)

    Qx, lx = _poisson_eig(nx, dx, dirichlet_end=True)
    Qy, ly = _poisson_eig(ny, dy, dirichlet_end=False)
    Qz, lz = _poisson_eig(nz, dz, dirichlet_end=False)
    lam = (lx[:, None, None] + ly[None, :, None] + lz[None, None, :]).astype(np.float32)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    Qx, Qy, Qz, lam = put(Qx), put(Qy), put(Qz), put(lam)
    su_t, sv_t, sw_t = put(su), put(sv), put(sw)
    dt4 = put(dt)[:, None, None, None]
    uin = put(u_in)
    uin3 = uin[:, None, None]

    def cd_u(u, v, w):
        uc = _avg(u, 0)
        uu = uc * uc
        uw_ = torch.where(uc >= 0, u[:, :-1], u[:, 1:])
        duu = _diff((1 - upwind) * uu + upwind * uc * uw_, 0, dx)

        ug_y = _even(u, 1)[:, 1:-1]
        u_ey = _avg(ug_y, 1)
        v_ey = _avg(v, 0)
        duv = _diff(v_ey * u_ey, 1, dy)

        ug_z = _even(u, 2)[:, 1:-1]
        u_ez = _avg(ug_z, 2)
        w_ez = _avg(w, 0)
        duw = _diff(w_ez * u_ez, 2, dz)

        lap = (u[:, 2:] - 2 * u[:, 1:-1] + u[:, :-2]) / dx ** 2
        lap = lap + (ug_y[:, :, 2:] - 2 * ug_y[:, :, 1:-1] + ug_y[:, :, :-2]) / dy ** 2
        lap = lap + (ug_z[:, :, :, 2:] - 2 * ug_z[:, :, :, 1:-1] + ug_z[:, :, :, :-2]) / dz ** 2
        return -(duu + duv + duw) + nu * lap

    def cd_v(u, v, w):
        vc = _avg(v, 1)
        vv = vc * vc
        vw_ = torch.where(vc >= 0, v[:, :, :-1], v[:, :, 1:])
        dvv = _diff((1 - upwind) * vv + upwind * vc * vw_, 1, dy)

        vg_x = torch.cat([-v[:, :1], v, v[:, -1:]], dim=1)
        v_ex = _avg(vg_x, 0)[:, :, 1:-1]
        u_ex = _avg(u, 1)
        duv = _diff(u_ex * v_ex, 0, dx)

        vg_z = _even(v, 2)
        v_ez = _avg(vg_z, 2)[:, :, 1:-1]
        w_ez = _avg(w, 1)
        dwv = _diff(w_ez * v_ez, 2, dz)

        lap = (v[:, :, 2:] - 2 * v[:, :, 1:-1] + v[:, :, :-2]) / dy ** 2
        lap = lap + (vg_x[:, 2:, 1:-1] - 2 * vg_x[:, 1:-1, 1:-1] + vg_x[:, :-2, 1:-1]) / dx ** 2
        lap = lap + (vg_z[:, :, 1:-1, 2:] - 2 * vg_z[:, :, 1:-1, 1:-1]
                     + vg_z[:, :, 1:-1, :-2]) / dz ** 2
        return -(dvv + duv + dwv) + nu * lap

    def cd_w(u, v, w):
        wc = _avg(w, 2)
        ww = wc * wc
        ww_up = torch.where(wc >= 0, w[:, :, :, :-1], w[:, :, :, 1:])
        dww = _diff((1 - upwind) * ww + upwind * wc * ww_up, 2, dz)

        wg_x = torch.cat([-w[:, :1], w, w[:, -1:]], dim=1)
        w_ex = _avg(wg_x, 0)[:, :, :, 1:-1]
        u_ex = _avg(u, 2)
        duw = _diff(u_ex * w_ex, 0, dx)

        wg_y = _even(w, 1)
        w_ey = _avg(wg_y, 1)[:, :, :, 1:-1]
        v_ey = _avg(v, 2)
        dvw = _diff(v_ey * w_ey, 1, dy)

        lap = (w[:, :, :, 2:] - 2 * w[:, :, :, 1:-1] + w[:, :, :, :-2]) / dz ** 2
        lap = lap + (wg_x[:, 2:, :, 1:-1] - 2 * wg_x[:, 1:-1, :, 1:-1]
                     + wg_x[:, :-2, :, 1:-1]) / dx ** 2
        lap = lap + (wg_y[:, :, 2:, 1:-1] - 2 * wg_y[:, :, 1:-1, 1:-1]
                     + wg_y[:, :, :-2, 1:-1]) / dy ** 2
        return -(dww + duw + dvw) + nu * lap

    def poisson(rhs):
        # the Kronecker-sum operator's eigenbasis, batched over the cases
        t = torch.einsum("xi,bxyz->biyz", Qx, rhs)
        t = torch.einsum("yj,biyz->bijz", Qy, t)
        t = torch.einsum("zk,bijz->bijk", Qz, t)
        t = t / lam
        t = torch.einsum("zk,bijk->bijz", Qz, t)
        t = torch.einsum("yj,bijz->biyz", Qy, t)
        return torch.einsum("xi,biyz->bxyz", Qx, t)

    def step(u, v, w, p, res, steps, done):
        frz = done | (steps >= max_steps)        # converged, or out of steps
        s_u = (nu * d + 0.5 * f * torch.abs(u[:, 1:-1])) * su_t[:, 1:-1]
        s_v = (nu * d + 0.5 * f * torch.abs(v[:, :, 1:-1])) * sv_t[:, :, 1:-1]
        s_w = (nu * d + 0.5 * f * torch.abs(w[:, :, :, 1:-1])) * sw_t[:, :, :, 1:-1]

        rhs_u = cd_u(u, v, w) - _diff(p, 0, dx)
        rhs_v = cd_v(u, v, w) - _diff(p, 1, dy)
        rhs_w = cd_w(u, v, w) - _diff(p, 2, dz)

        u_star, v_star, w_star = u.clone(), v.clone(), w.clone()
        u_star[:, 1:-1] = (u[:, 1:-1] + dt4 * rhs_u) / (1.0 + dt4 * s_u)
        v_star[:, :, 1:-1] = (v[:, :, 1:-1] + dt4 * rhs_v) / (1.0 + dt4 * s_v)
        w_star[:, :, :, 1:-1] = (w[:, :, :, 1:-1] + dt4 * rhs_w) / (1.0 + dt4 * s_w)
        u_star[:, 0] = uin3
        u_star[:, -1] = u_star[:, -2]
        v_star[:, :, 0] = 0.0
        v_star[:, :, -1] = 0.0
        w_star[:, :, :, 0] = 0.0
        w_star[:, :, :, -1] = 0.0

        div = _diff(u_star, 0, dx) + _diff(v_star, 1, dy) + _diff(w_star, 2, dz)
        phi = poisson(div / dt4)

        u_new, v_new, w_new = u_star, v_star, w_star
        u_new[:, 1:-1] = u_star[:, 1:-1] - dt4 * _diff(phi, 0, dx)
        u_new[:, -1] = u_star[:, -1] - dt4[:, 0] * (0.0 - phi[:, -1]) * 2.0 / dx
        v_new[:, :, 1:-1] = v_star[:, :, 1:-1] - dt4 * _diff(phi, 1, dy)
        w_new[:, :, :, 1:-1] = w_star[:, :, :, 1:-1] - dt4 * _diff(phi, 2, dz)
        p_new = p + phi

        p_scale = torch.maximum(0.5 * uin ** 2, torch.amax(torch.abs(p_new), dim=(1, 2, 3)))
        dtb = dt4[:, 0, 0, 0]
        res_new = torch.maximum(
            torch.amax(torch.abs(u_new - u), dim=(1, 2, 3)) / (dtb * uin),
            torch.amax(torch.abs(phi), dim=(1, 2, 3)) / (dtb * p_scale))

        f4 = frz[:, None, None, None]
        return (torch.where(f4, u, u_new), torch.where(f4, v, v_new),
                torch.where(f4, w, w_new), torch.where(f4, p, p_new),
                torch.where(frz, res, res_new), steps + (~frz).to(steps.dtype),
                done | (~frz & (res_new < tol)))

    state = (uin[:, None, None, None].expand(b, nx + 1, ny, nz).contiguous(),
             torch.zeros((b, nx, ny + 1, nz), device=dev),
             torch.zeros((b, nx, ny, nz + 1), device=dev),
             torch.zeros((b, nx, ny, nz), device=dev),
             torch.full((b,), float("inf"), device=dev),
             torch.zeros((b,), dtype=torch.int32, device=dev),
             torch.zeros((b,), dtype=torch.bool, device=dev))
    marched = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad(), _full_f32():
        while True:
            _, _, _, _, _, steps, done = state
            # the one read of the device a chunk: is any case still marching?
            if not bool(((~done) & (steps < max_steps)).any()):
                break
            for _ in range(check_every):
                state = step(*state)
            marched += check_every
    seconds = time.perf_counter() - t0
    if stats is not None:
        stats.update(steps=marched, seconds=seconds)
    u, v, w, p, res, steps, _ = (t.cpu().numpy() for t in state)

    sols = []
    for i in range(b):
        uc = 0.5 * (u[i, :-1] + u[i, 1:])
        vc = 0.5 * (v[i][:, :-1] + v[i][:, 1:])
        wc = 0.5 * (w[i][..., :-1] + w[i][..., 1:])
        div_c = ((u[i, 1:] - u[i, :-1]) / dx + (v[i][:, 1:] - v[i][:, :-1]) / dy
                 + (w[i][..., 1:] - w[i][..., :-1]) / dz)
        uc64, vc64, wc64, p64 = (a.astype(np.float64) for a in (uc, vc, wc, p[i]))
        merr = fvm3d._momentum_residual3(uc64, vc64, wc64, p64, zone[i], (dx, dy, dz), nu, d, f)
        sols.append(DuctSolution3(xc, yc, zc, uc64, vc64, wc64, p64,
                                  zone[i].astype(np.float64), div_c.astype(np.float64), merr,
                                  float(res[i]), int(steps[i])))
    return sols
