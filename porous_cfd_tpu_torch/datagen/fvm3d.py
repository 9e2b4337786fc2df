"""Steady 3D Navier-Stokes + Darcy-Forchheimer reference solver: the port's
own copy of ``porous_cfd_tpu/datagen/fvm3d.py`` (numpy and ``scipy.sparse``,
on the host), so that a machine without JAX can make the 3D golden data. On
the same grid it gives the same fields bit for bit, and ``solution_to_case3``
writes the same case files byte for byte, through the port's
``synthetic_case.write_case``. ``datagen/fvm3d_batch.py`` marches a batch of
the same cases on the card.

It extends the 2D duct solver (``datagen/fvm.py``) to a coarse 3D duct, so
that the 3D experiments (abc, windbreaks) can be validated against solved 3D
physics instead of synthetic random fields.

Setup: box domain [-0.4, 0.6] x [-0.3, 0.3]^2; inlet fixedValue
U = (u_inlet, 0, 0); outlet p = 0 with zero-gradient U; slip side walls; a
porous obstacle region with Darcy-Forchheimer sink ``-(nu d + 1/2 f |U|) U``.

Discretization mirrors the 2D solver: staggered MAC grid, central convection
with a small upwind blend, implicit porous sink, explicit pseudo-time
stepping with a prefactorized pressure-Poisson projection per step. The
Poisson operator is assembled from 1D operators via Kronecker sums
(Neumann at inlet/walls, Dirichlet p' = 0 at the outlet face). It runs
offline (fixture generation), not in the training hot path.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from porous_cfd_tpu_torch.datagen.synthetic_case import write_case

DOMAIN3 = ((-0.4, 0.6), (-0.3, 0.3), (-0.3, 0.3))
U_INLET = 0.2
NU = 1489.4e-6
DARCY_D = 14000.0
FORCH_F = 17.11


# ---------------------------------------------------------------------------
# porous obstacle shapes

def shape_indicator3(shape: str, center, size: float) -> Callable:
    """Inside-test for a 3D porous primitive; ``size`` is the half-extent."""
    cx, cy, cz = center

    def sphere(x, y, z):
        return ((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
                <= size * size)

    def box(x, y, z):
        return ((np.abs(x - cx) <= size) & (np.abs(y - cy) <= 0.7 * size)
                & (np.abs(z - cz) <= 0.7 * size))

    def cylinder_z(x, y, z):
        # vertical cylinder spanning the duct height (a "tree"/house-like
        # bluff obstacle, cf. windbreaks)
        return (x - cx) ** 2 + (y - cy) ** 2 <= size * size

    def band(x, y, z):
        # full-cross-section porous band (quasi-1D analytic validation)
        return np.abs(x - cx) <= size

    return {"sphere": sphere, "box": box, "cylinder": cylinder_z,
            "band": band}[shape]


# ---------------------------------------------------------------------------
# solver

@dataclasses.dataclass
class DuctSolution3:
    x: np.ndarray           # (nx,)
    y: np.ndarray           # (ny,)
    z: np.ndarray           # (nz,)
    u: np.ndarray           # (nx, ny, nz) cell-centred
    v: np.ndarray
    w: np.ndarray
    p: np.ndarray
    zone: np.ndarray
    div: np.ndarray
    moment_err: np.ndarray  # (nx, ny, nz, 3)
    residual: float
    steps: int

    @property
    def points(self):
        xx, yy, zz = np.meshgrid(self.x, self.y, self.z, indexing="ij")
        return np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)


def _poisson_1d(n: int, h: float, dirichlet_end: bool) -> sp.csr_matrix:
    """1D second-difference operator, Neumann at the start (and end unless
    ``dirichlet_end``: ghost-cell Dirichlet at the end face)."""
    a = 1.0 / h ** 2
    main = np.full(n, -2.0 * a)
    main[0] = -a
    if not dirichlet_end:
        main[-1] = -a
    else:
        main[-1] = -3.0 * a   # interior neighbor + ghost p' = -p'_n
    off = np.full(n - 1, a)
    return sp.diags([off, main, off], [-1, 0, 1], format="csr")


def _even(a, axis):
    """Pad with edge values (zero-gradient / slip-tangential ghost)."""
    lo = [slice(None)] * a.ndim
    hi = [slice(None)] * a.ndim
    lo[axis] = slice(0, 1)
    hi[axis] = slice(a.shape[axis] - 1, a.shape[axis])
    return np.concatenate([a[tuple(lo)], a, a[tuple(hi)]], axis=axis)


def _avg(a, axis):
    lo = [slice(None)] * a.ndim
    hi = [slice(None)] * a.ndim
    lo[axis] = slice(0, a.shape[axis] - 1)
    hi[axis] = slice(1, a.shape[axis])
    return 0.5 * (a[tuple(lo)] + a[tuple(hi)])


def _diff(a, axis, h):
    lo = [slice(None)] * a.ndim
    hi = [slice(None)] * a.ndim
    lo[axis] = slice(0, a.shape[axis] - 1)
    hi[axis] = slice(1, a.shape[axis])
    return (a[tuple(hi)] - a[tuple(lo)]) / h


def solve_duct3(shape: str = "sphere", center=(0.1, 0.0, 0.0),
                size: float = 0.14, nx: int = 48, ny: int = 28, nz: int = 28,
                u_inlet: float = U_INLET, nu: float = NU,
                d: float = DARCY_D, f: float = FORCH_F,
                dt: float | None = None, max_steps: int = 20000,
                tol: float = 1e-4, upwind: float = 0.15) -> DuctSolution3:
    """March the 3D duct flow to steady state (cell-centred fields)."""
    (x0, x1), (y0, y1), (z0, z1) = DOMAIN3
    dx = (x1 - x0) / nx
    dy = (y1 - y0) / ny
    dz = (z1 - z0) / nz
    xc = x0 + (np.arange(nx) + 0.5) * dx
    yc = y0 + (np.arange(ny) + 0.5) * dy
    zc = z0 + (np.arange(nz) + 0.5) * dz
    inside = shape_indicator3(shape, center, size)

    def mask(xs, ys, zs):
        xx, yy, zz = np.meshgrid(xs, ys, zs, indexing="ij")
        return inside(xx, yy, zz).astype(float)

    xu = x0 + np.arange(nx + 1) * dx
    yv = y0 + np.arange(ny + 1) * dy
    zw = z0 + np.arange(nz + 1) * dz
    su = mask(xu, yc, zc)
    sv = mask(xc, yv, zc)
    sw = mask(xc, yc, zw)
    zone = mask(xc, yc, zc)

    u = np.full((nx + 1, ny, nz), u_inlet)
    v = np.zeros((nx, ny + 1, nz))
    w = np.zeros((nx, ny, nz + 1))
    p = np.zeros((nx, ny, nz))

    if dt is None:
        dt = 0.35 * min(dx / max(u_inlet * 3.0, 1e-9),
                        dx * dx / (6.0 * nu))

    ax = _poisson_1d(nx, dx, dirichlet_end=True)
    ay = _poisson_1d(ny, dy, dirichlet_end=False)
    az = _poisson_1d(nz, dz, dirichlet_end=False)
    iy, iz = sp.identity(ny), sp.identity(nz)
    ix = sp.identity(nx)
    A = (sp.kron(ax, sp.kron(iy, iz)) + sp.kron(ix, sp.kron(ay, iz))
         + sp.kron(ix, sp.kron(iy, az))).tocsc()
    lu = spla.splu(A)

    def cd_u(u, v, w):
        """-(div(U u)) + nu lap(u) on interior u-faces (1..nx-1, :, :)."""
        uc = _avg(u, 0)                               # (nx, ny, nz)
        uu = uc * uc
        uw_ = np.where(uc >= 0, u[:-1], u[1:])
        duu = _diff((1 - upwind) * uu + upwind * uc * uw_, 0, dx)

        # d(vu)/dy at interior-u-face y-edges
        ug_y = _even(u, 1)[1:-1]                      # (nx-1, ny+2, nz)
        u_ey = _avg(ug_y, 1)                          # (nx-1, ny+1, nz)
        v_ey = _avg(v, 0)                             # (nx-1, ny+1, nz)
        duv = _diff(v_ey * u_ey, 1, dy)

        # d(wu)/dz at interior-u-face z-edges
        ug_z = _even(u, 2)[1:-1]                      # (nx-1, ny, nz+2)
        u_ez = _avg(ug_z, 2)                          # (nx-1, ny, nz+1)
        w_ez = _avg(w, 0)                             # (nx-1, ny, nz+1)
        duw = _diff(w_ez * u_ez, 2, dz)

        lap = (u[2:] - 2 * u[1:-1] + u[:-2]) / dx ** 2
        lap = lap + (ug_y[:, 2:] - 2 * ug_y[:, 1:-1]
                     + ug_y[:, :-2]) / dy ** 2
        lap = lap + (ug_z[:, :, 2:] - 2 * ug_z[:, :, 1:-1]
                     + ug_z[:, :, :-2]) / dz ** 2
        return -(duu + duv + duw) + nu * lap

    def cd_v(u, v, w):
        """interior v-faces (:, 1..ny-1, :); inlet fixes v -> odd x-ghost."""
        vc = _avg(v, 1)                               # (nx, ny, nz)
        vv = vc * vc
        vw_ = np.where(vc >= 0, v[:, :-1], v[:, 1:])
        dvv = _diff((1 - upwind) * vv + upwind * vc * vw_, 1, dy)

        vg_x = np.concatenate([-v[:1], v, v[-1:]], axis=0)  # (nx+2, ny+1, nz)
        v_ex = _avg(vg_x, 0)[:, 1:-1]                 # (nx+1, ny-1, nz)
        u_ex = _avg(u, 1)                             # (nx+1, ny-1, nz)
        duv = _diff(u_ex * v_ex, 0, dx)

        vg_z = _even(v, 2)                            # (nx, ny+1, nz+2)
        v_ez = _avg(vg_z, 2)[:, 1:-1]                 # (nx, ny-1, nz+1)
        w_ez = _avg(w, 1)                             # (nx, ny-1, nz+1)
        dwv = _diff(w_ez * v_ez, 2, dz)

        lap = (v[:, 2:] - 2 * v[:, 1:-1] + v[:, :-2]) / dy ** 2
        lap = lap + (vg_x[2:, 1:-1] - 2 * vg_x[1:-1, 1:-1]
                     + vg_x[:-2, 1:-1]) / dx ** 2
        lap = lap + (vg_z[:, 1:-1, 2:] - 2 * vg_z[:, 1:-1, 1:-1]
                     + vg_z[:, 1:-1, :-2]) / dz ** 2
        return -(dvv + duv + dwv) + nu * lap

    def cd_w(u, v, w):
        """interior w-faces (:, :, 1..nz-1); inlet fixes w -> odd x-ghost."""
        wc = _avg(w, 2)                               # (nx, ny, nz)
        ww = wc * wc
        ww_up = np.where(wc >= 0, w[:, :, :-1], w[:, :, 1:])
        dww = _diff((1 - upwind) * ww + upwind * wc * ww_up, 2, dz)

        wg_x = np.concatenate([-w[:1], w, w[-1:]], axis=0)  # (nx+2, ny, nz+1)
        w_ex = _avg(wg_x, 0)[:, :, 1:-1]              # (nx+1, ny, nz-1)
        u_ex = _avg(u, 2)                             # (nx+1, ny, nz-1)
        duw = _diff(u_ex * w_ex, 0, dx)

        wg_y = _even(w, 1)                            # (nx, ny+2, nz+1)
        w_ey = _avg(wg_y, 1)[:, :, 1:-1]              # (nx, ny+1, nz-1)
        v_ey = _avg(v, 2)                             # (nx, ny+1, nz-1)
        dvw = _diff(v_ey * w_ey, 1, dy)

        lap = (w[:, :, 2:] - 2 * w[:, :, 1:-1] + w[:, :, :-2]) / dz ** 2
        lap = lap + (wg_x[2:, :, 1:-1] - 2 * wg_x[1:-1, :, 1:-1]
                     + wg_x[:-2, :, 1:-1]) / dx ** 2
        lap = lap + (wg_y[:, 2:, 1:-1] - 2 * wg_y[:, 1:-1, 1:-1]
                     + wg_y[:, :-2, 1:-1]) / dy ** 2
        return -(dww + duw + dvw) + nu * lap

    res = np.inf
    steps = 0
    for steps in range(1, max_steps + 1):
        s_u = (nu * d + 0.5 * f * np.abs(u[1:-1])) * su[1:-1]
        s_v = (nu * d + 0.5 * f * np.abs(v[:, 1:-1])) * sv[:, 1:-1]
        s_w = (nu * d + 0.5 * f * np.abs(w[:, :, 1:-1])) * sw[:, :, 1:-1]

        rhs_u = cd_u(u, v, w) - _diff(p, 0, dx)
        rhs_v = cd_v(u, v, w) - _diff(p, 1, dy)
        rhs_w = cd_w(u, v, w) - _diff(p, 2, dz)

        u_star, v_star, w_star = u.copy(), v.copy(), w.copy()
        u_star[1:-1] = (u[1:-1] + dt * rhs_u) / (1.0 + dt * s_u)
        v_star[:, 1:-1] = (v[:, 1:-1] + dt * rhs_v) / (1.0 + dt * s_v)
        w_star[:, :, 1:-1] = (w[:, :, 1:-1] + dt * rhs_w) / (1.0 + dt * s_w)
        u_star[0] = u_inlet
        u_star[-1] = u_star[-2]
        v_star[:, 0] = 0.0
        v_star[:, -1] = 0.0
        w_star[:, :, 0] = 0.0
        w_star[:, :, -1] = 0.0

        div = (_diff(u_star, 0, dx) + _diff(v_star, 1, dy)
               + _diff(w_star, 2, dz))
        phi = lu.solve((div / dt).ravel()).reshape(nx, ny, nz)

        u_new, v_new, w_new = u_star.copy(), v_star.copy(), w_star.copy()
        u_new[1:-1] = u_star[1:-1] - dt * _diff(phi, 0, dx)
        u_new[-1] = u_star[-1] - dt * (0.0 - phi[-1]) * 2.0 / dx
        v_new[:, 1:-1] = v_star[:, 1:-1] - dt * _diff(phi, 1, dy)
        w_new[:, :, 1:-1] = w_star[:, :, 1:-1] - dt * _diff(phi, 2, dz)
        p += phi

        p_scale = max(0.5 * u_inlet ** 2, float(np.max(np.abs(p))))
        res = max(float(np.max(np.abs(u_new - u)) / (dt * u_inlet)),
                  float(np.max(np.abs(phi)) / (dt * p_scale)))
        u, v, w = u_new, v_new, w_new
        if res < tol:
            break

    uc = _avg(u, 0)
    vc = _avg(v, 1)
    wc = _avg(w, 2)
    div_c = _diff(u, 0, dx) + _diff(v, 1, dy) + _diff(w, 2, dz)
    moment_err = _momentum_residual3(uc, vc, wc, p, zone,
                                     (dx, dy, dz), nu, d, f)
    return DuctSolution3(xc, yc, zc, uc, vc, wc, p, zone, div_c, moment_err,
                         res, steps)


def _momentum_residual3(u, v, w, p, zone, hs, nu, d, f):
    """Steady momentum residual from cell-centred fields (central diffs)."""
    def grad(q, axis):
        h = hs[axis]
        g = np.empty_like(q)
        n = q.shape[axis]

        def sl(a, b):
            return tuple(slice(a, b) if ax == axis else slice(None)
                         for ax in range(3))
        g[sl(1, n - 1)] = (q[sl(2, n)] - q[sl(0, n - 2)]) / (2 * h)
        g[sl(0, 1)] = (q[sl(1, 2)] - q[sl(0, 1)]) / h
        g[sl(n - 1, n)] = (q[sl(n - 1, n)] - q[sl(n - 2, n - 1)]) / h
        return g

    def lap(q):
        out = np.zeros_like(q)
        inner = (slice(1, -1),) * 3
        for axis in range(3):
            h = hs[axis]
            n = q.shape[axis]

            def sl(a, b):
                return tuple(
                    slice(a, b) if ax == axis else slice(1, -1)
                    for ax in range(3))
            out[inner] += (q[sl(2, n)] - 2 * q[sl(1, n - 1)]
                           + q[sl(0, n - 2)]) / h ** 2
        return out

    vmag = np.sqrt(u * u + v * v + w * w)
    sink = (nu * d + 0.5 * f * vmag) * zone
    comps = []
    for q in (u, v, w):
        conv = u * grad(q, 0) + v * grad(q, 1) + w * grad(q, 2)
        comps.append(conv - nu * lap(q) + sink * q)
    comps[0] += grad(p, 0)
    comps[1] += grad(p, 1)
    comps[2] += grad(p, 2)
    return np.stack(comps, axis=-1)


def _interface_faces3(sol: DuctSolution3):
    """Porous-fluid interface face centres + face-interpolated U, p from the
    zone-transition faces of the structured 3D grid."""
    zone = sol.zone
    hs = (sol.x[1] - sol.x[0], sol.y[1] - sol.y[0], sol.z[1] - sol.z[0])
    coords = (sol.x, sol.y, sol.z)
    fields = (sol.u, sol.v, sol.w, sol.p)

    centres, vals = [], [[] for _ in fields]
    for axis in range(3):
        n = zone.shape[axis]
        lo = tuple(slice(0, n - 1) if a == axis else slice(None)
                   for a in range(3))
        hi = tuple(slice(1, n) if a == axis else slice(None)
                   for a in range(3))
        idx = np.nonzero(zone[hi] != zone[lo])
        if not len(idx[0]):
            continue
        c = [coords[a][idx[a]].astype(float) for a in range(3)]
        c[axis] = c[axis] + 0.5 * hs[axis]
        centres.append(np.stack(c, -1))
        idx_hi = tuple(idx[a] + (1 if a == axis else 0) for a in range(3))
        for k, q in enumerate(fields):
            vals[k].append(0.5 * (q[idx] + q[idx_hi]))
    if not centres:
        raise ValueError("no porous-fluid interface faces in the solution")
    c = np.concatenate(centres)
    u, v, w, p = (np.concatenate(v_) for v_ in vals)
    return c, np.stack([u, v, w], -1), p


# ---------------------------------------------------------------------------
# case emission

def solution_to_case3(sol: DuctSolution3, case_dir: str | Path,
                      n_internal: int | None = None,
                      rng: np.random.Generator | None = None,
                      d: float = DARCY_D, f: float = FORCH_F,
                      nu: float = NU, u_inlet: float = U_INLET,
                      n_per_patch: int | None = None,
                      elapsed_ns: int = 10 ** 9) -> None:
    """Write a solved 3D case in the standard on-disk layout (inlet/outlet/
    walls patches; subsampled face centres when ``n_per_patch`` is set)."""
    nx, ny, nz = sol.u.shape
    (x0, x1), (y0, y1), (z0, z1) = DOMAIN3

    pts = sol.points
    U = np.stack([sol.u.ravel(), sol.v.ravel(), sol.w.ravel()], axis=-1)
    P = sol.p.ravel()
    zone = sol.zone.ravel()
    merr = sol.moment_err.reshape(-1, 3)
    divp = sol.div.ravel()

    rng = rng or np.random.default_rng(8421)
    if n_internal is not None and n_internal < len(pts):
        sel = rng.choice(len(pts), n_internal, replace=False)
        pts, U, P, zone, merr, divp = (pts[sel], U[sel], P[sel], zone[sel],
                                       merr[sel], divp[sel])

    yy, zz = np.meshgrid(sol.y, sol.z, indexing="ij")
    inlet_c = np.stack([np.full(yy.size, x0), yy.ravel(), zz.ravel()], -1)
    outlet_c = np.stack([np.full(yy.size, x1), yy.ravel(), zz.ravel()], -1)

    xxy, yyx = np.meshgrid(sol.x, sol.y, indexing="ij")   # z walls
    xxz, zzx = np.meshgrid(sol.x, sol.z, indexing="ij")   # y walls
    walls_c = np.concatenate([
        np.stack([xxz.ravel(), np.full(xxz.size, y0), zzx.ravel()], -1),
        np.stack([xxz.ravel(), np.full(xxz.size, y1), zzx.ravel()], -1),
        np.stack([xxy.ravel(), yyx.ravel(), np.full(xxy.size, z0)], -1),
        np.stack([xxy.ravel(), yyx.ravel(), np.full(xxy.size, z1)], -1)])

    inlet_U = np.tile([[u_inlet, 0.0, 0.0]], (inlet_c.shape[0], 1))
    outlet_U = np.stack([sol.u[-1].ravel(), sol.v[-1].ravel(),
                         sol.w[-1].ravel()], -1)
    inlet_p = sol.p[0].ravel()
    outlet_p = np.zeros(yy.size)
    walls_U = np.concatenate([
        np.stack([sol.u[:, 0, :].ravel(), np.zeros(xxz.size),
                  sol.w[:, 0, :].ravel()], -1),
        np.stack([sol.u[:, -1, :].ravel(), np.zeros(xxz.size),
                  sol.w[:, -1, :].ravel()], -1),
        np.stack([sol.u[:, :, 0].ravel(), sol.v[:, :, 0].ravel(),
                  np.zeros(xxy.size)], -1),
        np.stack([sol.u[:, :, -1].ravel(), sol.v[:, :, -1].ravel(),
                  np.zeros(xxy.size)], -1)])
    walls_p = np.concatenate([sol.p[:, 0, :].ravel(), sol.p[:, -1, :].ravel(),
                              sol.p[:, :, 0].ravel(), sol.p[:, :, -1].ravel()])

    # porous-fluid interface faces (4th patch, cf. the 2D writer and the
    # reference's 'interface' faceZone surface dump)
    iface_c, iface_U, iface_p = _interface_faces3(sol)
    patches = {"inlet": inlet_c, "interface": iface_c, "outlet": outlet_c,
               "walls": walls_c}
    patch_U = {"inlet": inlet_U, "interface": iface_U, "outlet": outlet_U,
               "walls": walls_U}
    patch_p = {"inlet": inlet_p, "interface": iface_p, "outlet": outlet_p,
               "walls": walls_p}

    if n_per_patch is not None:
        for name in patches:
            n = len(patches[name])
            if n_per_patch < n:
                sel = rng.choice(n, n_per_patch, replace=False)
                patches[name] = patches[name][sel]
                patch_U[name] = patch_U[name][sel]
                patch_p[name] = patch_p[name][sel]

    patch_fields = {
        name: {"U": patch_U[name], "p": patch_p[name],
               "momentError": np.zeros((len(patches[name]), 3)),
               "div(phi)": np.zeros(len(patches[name]))}
        for name in patches}
    write_case(case_dir, pts, zone, patches,
               fields={"U": U, "p": P, "momentError": merr, "div(phi)": divp},
               patch_fields=patch_fields, d=d, f=f, nu=nu,
               elapsed_ns=elapsed_ns)
