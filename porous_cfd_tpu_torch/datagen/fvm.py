"""Steady incompressible Navier-Stokes + Darcy-Forchheimer reference solver:
the port's own copy of ``porous_cfd_tpu/datagen/fvm.py`` (numpy and
``scipy.sparse``, on the host), so that a machine without JAX can make the
golden-duct data. On the same grid it gives the same fields bit for bit, and
``write_golden_split(time_solve=False)`` writes the same case files byte for
byte, through the port's ``synthetic_case.write_case``.

It produces CFD ground truth for the 2D duct experiments without an external
OpenFOAM install, in the on-disk layout the parsers consume, so the
datagen -> dataset -> training -> evaluation chain runs on genuinely solved
physics (the accuracy bar is "U, p rel-L2 vs CFD").

Setup mirrors the reference duct template: domain [-0.4, 0.6] x [-0.3, 0.3];
inlet fixedValue U = (0.2, 0); outlet p = 0 with zero-gradient U; slip walls;
a porous obstacle cellZone with ``explicitPorositySource`` Darcy-Forchheimer
coefficients ``-(nu*d + 0.5*f*|U|) U`` (d = 14000, f = 17.11); nu = 1489.4e-6.

Discretization: staggered MAC grid; central-difference convection with a
small upwind blend for boundedness; the stiff porous sink (nu*d ~ 21 1/s) is
treated implicitly; explicit pseudo-time stepping with a prefactorized sparse
pressure-Poisson solve per step (incremental projection) continues until the
velocity time-derivative drops below tolerance. It runs offline (fixture
generation), not in the training hot path.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from porous_cfd_tpu_torch.datagen.synthetic_case import write_case

# Reference duct envelope (template dicts + fvOptions)
DOMAIN = ((-0.4, 0.6), (-0.3, 0.3))
U_INLET = 0.2
NU = 1489.4e-6
DARCY_D = 14000.0
FORCH_F = 17.11


# ---------------------------------------------------------------------------
# porous obstacle shapes (the primitive zoo of the 2D generators)

def _rot(x, y, cx, cy, theta):
    c, s = np.cos(theta), np.sin(theta)
    dx, dy = x - cx, y - cy
    return c * dx + s * dy, -s * dx + c * dy


def _regular_polygon(n: int, phase: float = 0.0) -> np.ndarray:
    a = phase + 2 * np.pi * np.arange(n) / n
    return np.stack([np.cos(a), np.sin(a)], axis=-1)


def _star_polygon(n: int = 5, inner: float = 0.45) -> np.ndarray:
    a = np.pi / 2 + np.pi * np.arange(2 * n) / n
    r = np.where(np.arange(2 * n) % 2 == 0, 1.0, inner)
    return np.stack([r * np.cos(a), r * np.sin(a)], axis=-1)


def _point_in_polygon(px: np.ndarray, py: np.ndarray,
                      verts: np.ndarray) -> np.ndarray:
    """Vectorized even-odd rule; works for the non-convex star too."""
    x0, y0 = verts[:, 0], verts[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    p, q = px[..., None], py[..., None]
    crosses = ((y0 > q) != (y1 > q)) & (
        p < (x1 - x0) * (q - y0) / np.where(y1 != y0, y1 - y0, 1e-300) + x0)
    return np.sum(crosses, axis=-1) % 2 == 1


# Unit-frame polygon vertices for the reference's primitive mesh zoo
# (examples/duct_fixed_boundary/assets/meshes/standard/*.obj): regular
# polygons at circumradius 1, a symmetric trapezoid, a 5-point star.
_POLYGONS = {
    "equilateral_triangle": _regular_polygon(3),
    "equilateral_hexagon": _regular_polygon(6),
    "equilateral_octagon": _regular_polygon(8, np.pi / 8),
    "square": np.array([[1., 1.], [-1., 1.], [-1., -1.], [1., -1.]]),
    "trapezoid": np.array([[1., -0.7], [0.5, 0.7], [-0.5, 0.7], [-1., -0.7]]),
    "star": _star_polygon(),
}


# Inside-tests in the unit frame (|coords| pre-divided by the half-extent).
def _unit_tests() -> dict[str, Callable]:
    def circle(x, y):
        return x * x + y * y <= 1.0

    def semi_circle(x, y):
        return (x * x + y * y <= 1.0) & (y >= 0.0)

    def circle_sector(x, y):
        # 120-degree sector about +x
        return ((x * x + y * y <= 1.0)
                & (np.abs(np.arctan2(y, x)) <= np.pi / 3))

    def ellipse(x, y):
        return x ** 2 + (y / 0.6) ** 2 <= 1.0

    def rectangle(x, y):
        return (np.abs(x) <= 1.0) & (np.abs(y) <= 0.7)

    def triangle(x, y):
        # equilateral triangle of circumradius 1 pointing +x
        return ((x >= -0.5)
                & (y <= (1.0 - x) / np.sqrt(3.0))
                & (-y <= (1.0 - x) / np.sqrt(3.0)))

    def rhombus(x, y):
        return np.abs(x) + np.abs(y) / 0.7 <= 1.0

    table = {"circle": circle, "semi_circle": semi_circle,
             "circle_sector": circle_sector, "ellipse": ellipse,
             "rectangle": rectangle, "triangle": triangle, "rhombus": rhombus}
    for name, verts in _POLYGONS.items():
        table[name] = (lambda v: lambda x, y: _point_in_polygon(x, y, v))(verts)
    return table


UNIT_SHAPES = _unit_tests()
SHAPES = tuple(UNIT_SHAPES) + ("band",)


def shape_indicator(shape: str, cx: float, cy: float, size: float,
                    theta: float = 0.0, sx: float = 1.0,
                    sy: float = 1.0) -> Callable:
    """Inside-test for a porous primitive. ``size`` is the half-extent;
    ``sx``/``sy`` are anisotropic scale multipliers applied in the shape
    frame (the reference's transforms.json x/y scale grid)."""
    if shape == "band":
        # full-height porous band (1D analytic validation case)
        return lambda x, y: np.abs(x - cx) <= size * sx
    unit = UNIT_SHAPES[shape]

    def inside(x, y):
        rx, ry = _rot(x, y, cx, cy, theta)
        return unit(rx / (size * sx), ry / (size * sy))
    return inside


# ---------------------------------------------------------------------------
# solver

@dataclasses.dataclass
class DuctSolution:
    """Converged steady fields on the structured grid."""
    x: np.ndarray          # (nx,) cell-centre x
    y: np.ndarray          # (ny,) cell-centre y
    u: np.ndarray          # (nx, ny) cell-centred velocity x
    v: np.ndarray          # (nx, ny) cell-centred velocity y
    p: np.ndarray          # (nx, ny) kinematic pressure
    zone: np.ndarray       # (nx, ny) porous mask (0/1)
    div: np.ndarray        # (nx, ny) continuity residual of the face fluxes
    moment_err: np.ndarray  # (nx, ny, 2) steady momentum residual
    residual: float        # final |du/dt|_inf / U_inlet
    steps: int

    @property
    def points(self):
        xx, yy = np.meshgrid(self.x, self.y, indexing="ij")
        return np.stack([xx.ravel(), yy.ravel()], axis=-1)


def _poisson_matrix(nx, ny, dx, dy):
    """5-point pressure-Poisson operator: Neumann at inlet/walls (projection
    leaves those normal velocities fixed), Dirichlet p' = 0 at the outlet."""
    ax, ay = 1.0 / dx ** 2, 1.0 / dy ** 2
    n = nx * ny
    diag = np.zeros(n)
    rows, cols, vals = [], [], []

    def idx(i, j):
        return i * ny + j

    for i in range(nx):
        for j in range(ny):
            k = idx(i, j)
            d = 0.0
            if i > 0:
                rows.append(k); cols.append(idx(i - 1, j)); vals.append(ax)
                d -= ax
            if i < nx - 1:
                rows.append(k); cols.append(idx(i + 1, j)); vals.append(ax)
                d -= ax
            else:
                d -= 2.0 * ax  # ghost outlet cell with p' = -p'_i (Dirichlet at face)
            if j > 0:
                rows.append(k); cols.append(idx(i, j - 1)); vals.append(ay)
                d -= ay
            if j < ny - 1:
                rows.append(k); cols.append(idx(i, j + 1)); vals.append(ay)
                d -= ay
            diag[k] = d
    rows.extend(range(n)); cols.extend(range(n)); vals.extend(diag)
    return sp.csc_matrix((vals, (rows, cols)), shape=(n, n))


def solve_duct(shape: str = "circle", cx: float = 0.1, cy: float = 0.0,
               size: float = 0.12, theta: float = 0.0,
               nx: int = 120, ny: int = 72,
               u_inlet: float = U_INLET, nu: float = NU,
               d=DARCY_D, f: float = FORCH_F,
               dt: float | None = None, max_steps: int = 20000,
               tol: float = 1e-4, upwind: float = 0.1,
               sx: float = 1.0, sy: float = 1.0,
               v_inlet: float = 0.0) -> DuctSolution:
    """March the duct flow to steady state. Returns cell-centred fields.

    ``tol`` is on |du/dt|_inf normalized by the inlet speed — at 1e-4 the
    velocity field changes by less than 0.01% of U_inlet per second of
    pseudo-time.

    ``sx``/``sy`` anisotropically scale the obstacle (transforms.json grid);
    ``v_inlet`` gives the inlet velocity a y-component (the variable-boundary
    experiments' inlet angle); ``d`` may be a scalar or an (dx, dy) pair (the
    reference's anisotropic Darcy vector, e.g. config.json d=[12000,20000,0]).
    """
    (x0, x1), (y0, y1) = DOMAIN
    dx, dy = (x1 - x0) / nx, (y1 - y0) / ny
    xc = x0 + (np.arange(nx) + 0.5) * dx
    yc = y0 + (np.arange(ny) + 0.5) * dy
    inside = shape_indicator(shape, cx, cy, size, theta, sx, sy)
    d_x, d_y = (float(d[0]), float(d[1])) if np.ndim(d) else (float(d),) * 2
    speed = float(np.hypot(u_inlet, v_inlet))

    # staggered arrays: u on x-faces (nx+1, ny), v on y-faces (nx, ny+1)
    u = np.full((nx + 1, ny), u_inlet)
    v = np.zeros((nx, ny + 1))
    p = np.zeros((nx, ny))

    xu = x0 + np.arange(nx + 1) * dx          # u-face x
    xv = xc                                    # v-face x
    yv = y0 + np.arange(ny + 1) * dy           # v-face y
    def mask(xs, ys):
        xx, yy = np.meshgrid(xs, ys, indexing="ij")
        return inside(xx, yy).astype(float)

    su = mask(xu, yc)     # porous mask, u faces (nx+1, ny)
    sv = mask(xv, yv)     # porous mask, v faces (nx, ny+1)
    zone = mask(xc, yc)

    if dt is None:
        dt = 0.4 * min(dx / max(speed * 3.0, 1e-9), dx * dx / (4.0 * nu))

    A = _poisson_matrix(nx, ny, dx, dy)
    lu = spla.splu(A)

    def ghost_u(u):
        """u with wall ghost rows (slip: du/dy = 0)."""
        return np.concatenate([u[:, :1], u, u[:, -1:]], axis=1)

    def convect_diffuse_u(u, v):
        """-(d(uu)/dx + d(uv)/dy) + nu lap(u) on interior u-faces (1..nx-1)."""
        ug = ghost_u(u)                       # (nx+1, ny+2)
        # d(uu)/dx at u-face i: (uu)_E - (uu)_W over cell centres
        uc = 0.5 * (u[1:, :] + u[:-1, :])     # u at cell centres (nx, ny)
        uu = uc * uc
        duu = (uu[1:, :] - uu[:-1, :]) / dx   # (nx-1, ny) at interior faces
        # upwind blend for boundedness
        uw = np.where(uc >= 0, u[:-1, :], u[1:, :])
        uuw = uc * uw
        duu_up = (uuw[1:, :] - uuw[:-1, :]) / dx
        duu = (1 - upwind) * duu + upwind * duu_up
        # d(uv)/dy at u-face: v at u-face corners (nx-1, ny+1)
        vf = 0.5 * (v[1:, :] + v[:-1, :])     # v at interior u-face y-edges
        uf = 0.5 * (ug[1:-1, 1:] + ug[1:-1, :-1])  # u at y-edges (nx-1, ny+1)
        uv = vf * uf
        duv = (uv[:, 1:] - uv[:, :-1]) / dy
        lap = ((u[2:, :] - 2 * u[1:-1, :] + u[:-2, :]) / dx ** 2
               + (ug[1:-1, 2:] - 2 * ug[1:-1, 1:-1] + ug[1:-1, :-2]) / dy ** 2)
        return -(duu + duv) + nu * lap

    def convect_diffuse_v(u, v):
        """Same for interior v-faces (:, 1..ny-1)."""
        # inlet fixes the full velocity vector -> v = v_inlet at the inlet
        # face (Dirichlet ghost); outlet is zero-gradient
        vg = np.concatenate([2.0 * v_inlet - v[:1, :], v, v[-1:, :]],
                            axis=0)  # (nx+2, ny+1)
        vc = 0.5 * (v[:, 1:] + v[:, :-1])     # v at cell centres (nx, ny)
        vv = vc * vc
        dvv = (vv[:, 1:] - vv[:, :-1]) / dy   # (nx, ny-1)
        vwid = np.where(vc >= 0, v[:, :-1], v[:, 1:])
        dvv_up = (vc * vwid)[:, 1:] / dy - (vc * vwid)[:, :-1] / dy
        dvv = (1 - upwind) * dvv + upwind * dvv_up
        uf = 0.5 * (u[:, 1:] + u[:, :-1])     # u at v-face x-edges (nx+1, ny-1)
        vf = 0.5 * (vg[1:, 1:-1] + vg[:-1, 1:-1])  # v at x-edges (nx+1, ny-1)
        uv = uf * vf
        duv = (uv[1:, :] - uv[:-1, :]) / dx
        lap = ((vg[2:, 1:-1] - 2 * vg[1:-1, 1:-1] + vg[:-2, 1:-1]) / dx ** 2
               + (v[:, 2:] - 2 * v[:, 1:-1] + v[:, :-2]) / dy ** 2)
        return -(duv + dvv) + nu * lap

    res = np.inf
    steps = 0
    for steps in range(1, max_steps + 1):
        # velocity magnitude on faces for the Forchheimer term
        vmag_u = np.abs(u[1:-1, :])
        vmag_v = np.abs(v[:, 1:-1])
        s_u = (nu * d_x + 0.5 * f * vmag_u) * su[1:-1, :]
        s_v = (nu * d_y + 0.5 * f * vmag_v) * sv[:, 1:-1]

        rhs_u = convect_diffuse_u(u, v) - (p[1:, :] - p[:-1, :]) / dx
        rhs_v = convect_diffuse_v(u, v) - (p[:, 1:] - p[:, :-1]) / dy

        u_star = u.copy()
        v_star = v.copy()
        u_star[1:-1, :] = (u[1:-1, :] + dt * rhs_u) / (1.0 + dt * s_u)
        v_star[:, 1:-1] = (v[:, 1:-1] + dt * rhs_v) / (1.0 + dt * s_v)
        # BCs on the provisional field: inlet fixed, outlet zero-gradient,
        # wall-normal velocity zero (slip)
        u_star[0, :] = u_inlet
        u_star[-1, :] = u_star[-2, :]
        v_star[:, 0] = 0.0
        v_star[:, -1] = 0.0

        div = ((u_star[1:, :] - u_star[:-1, :]) / dx
               + (v_star[:, 1:] - v_star[:, :-1]) / dy)
        phi = lu.solve((div / dt).ravel()).reshape(nx, ny)

        u_new = u_star.copy()
        v_new = v_star.copy()
        u_new[1:-1, :] = u_star[1:-1, :] - dt * (phi[1:, :] - phi[:-1, :]) / dx
        # outlet face: Dirichlet phi = 0 at the face -> correction with ghost
        u_new[-1, :] = u_star[-1, :] - dt * (0.0 - phi[-1, :]) * 2.0 / dx
        v_new[:, 1:-1] = v_star[:, 1:-1] - dt * (phi[:, 1:] - phi[:, :-1]) / dy
        p += phi

        # both fields must be stationary: u directly, p through its increment
        # (in quasi-1D cases the projection restores u instantly while p is
        # still accumulating toward the porous pressure drop)
        p_scale = max(0.5 * speed ** 2, float(np.max(np.abs(p))))
        res = max(float(np.max(np.abs(u_new - u)) / (dt * speed)),
                  float(np.max(np.abs(phi)) / (dt * p_scale)))
        u, v = u_new, v_new
        if res < tol:
            break

    # cell-centred fields
    uc = 0.5 * (u[1:, :] + u[:-1, :])
    vc = 0.5 * (v[:, 1:] + v[:, :-1])
    div_c = (u[1:, :] - u[:-1, :]) / dx + (v[:, 1:] - v[:, :-1]) / dy

    moment_err = _momentum_residual(uc, vc, p, zone, dx, dy, nu, (d_x, d_y), f)
    return DuctSolution(xc, yc, uc, vc, p, zone, div_c, moment_err,
                        res, steps)


def _momentum_residual(u, v, p, zone, dx, dy, nu, d, f):
    """Steady momentum residual from the cell-centred fields via central
    differences (the role of the reference's ``momentumError`` function
    object): conv + grad(p) - nu lap(U) + porous sink."""
    def grad_x(q):
        g = np.empty_like(q)
        g[1:-1] = (q[2:] - q[:-2]) / (2 * dx)
        g[0] = (q[1] - q[0]) / dx
        g[-1] = (q[-1] - q[-2]) / dx
        return g

    def grad_y(q):
        g = np.empty_like(q)
        g[:, 1:-1] = (q[:, 2:] - q[:, :-2]) / (2 * dy)
        g[:, 0] = (q[:, 1] - q[:, 0]) / dy
        g[:, -1] = (q[:, -1] - q[:, -2]) / dy
        return g

    def lap(q):
        l = np.zeros_like(q)
        l[1:-1, 1:-1] = ((q[2:, 1:-1] - 2 * q[1:-1, 1:-1] + q[:-2, 1:-1]) / dx ** 2
                         + (q[1:-1, 2:] - 2 * q[1:-1, 1:-1] + q[1:-1, :-2]) / dy ** 2)
        return l

    d_x, d_y = (float(d[0]), float(d[1])) if np.ndim(d) else (float(d),) * 2
    vmag = np.sqrt(u * u + v * v)
    sink_x = (nu * d_x + 0.5 * f * vmag) * zone
    sink_y = (nu * d_y + 0.5 * f * vmag) * zone
    rx = u * grad_x(u) + v * grad_y(u) + grad_x(p) - nu * lap(u) + sink_x * u
    ry = u * grad_x(v) + v * grad_y(v) + grad_y(p) - nu * lap(v) + sink_y * v
    return np.stack([rx, ry], axis=-1)


# ---------------------------------------------------------------------------
# case emission

def solution_to_case(sol: DuctSolution, case_dir: str | Path,
                     n_internal: int | None = None,
                     rng: np.random.Generator | None = None,
                     d=DARCY_D, f: float = FORCH_F,
                     nu: float = NU, u_inlet: float = U_INLET,
                     v_inlet: float = 0.0,
                     elapsed_ns: int = 10 ** 9,
                     solver_meta: dict | None = None) -> None:
    """Write a solved case in the on-disk layout the data pipeline consumes.

    Internal rows are the cell centres (optionally subsampled to
    ``n_internal``); patch rows are the true boundary face centres with their
    boundary-condition values (inlet fixedValue / outlet p=0, zero-gradient
    U / slip walls), exactly how OpenFOAM's postProcessing surface dumps
    present them.
    """
    nx, ny = sol.u.shape
    (x0, x1), (y0, y1) = DOMAIN
    dx, dy = (x1 - x0) / nx, (y1 - y0) / ny

    pts = sol.points
    U = np.stack([sol.u.ravel(), sol.v.ravel()], axis=-1)
    P = sol.p.ravel()
    zone = sol.zone.ravel()
    merr = sol.moment_err.reshape(-1, 2)
    divp = sol.div.ravel()

    if n_internal is not None and n_internal < len(pts):
        rng = rng or np.random.default_rng(8421)
        sel = rng.choice(len(pts), n_internal, replace=False)
        pts, U, P, zone, merr, divp = (pts[sel], U[sel], P[sel], zone[sel],
                                       merr[sel], divp[sel])

    # patch face centres + BC values
    yc, xc = sol.y, sol.x
    inlet_c = np.stack([np.full(ny, x0), yc], -1)
    outlet_c = np.stack([np.full(ny, x1), yc], -1)
    walls_c = np.concatenate([np.stack([xc, np.full(nx, y0)], -1),
                              np.stack([xc, np.full(nx, y1)], -1)])
    # porous-fluid interface faces (the reference dumps the snappyHexMesh
    # cellZone cut surface as an 'interface' patch — controlDict:149; it is
    # the 4th boundaryId and carries the obstacle outline into the geometry
    # features and the SDF)
    iface_c, iface_u, iface_p = _interface_faces(sol)
    patches = {"inlet": inlet_c, "interface": iface_c, "outlet": outlet_c,
               "walls": walls_c}
    patch_fields = {
        "interface": {"U": iface_u, "p": iface_p,
                      "momentError": np.zeros((len(iface_c), 2)),
                      "div(phi)": np.zeros(len(iface_c))},
        "inlet": {"U": np.tile([[u_inlet, v_inlet]], (ny, 1)),
                  "p": sol.p[0, :],                      # zeroGradient
                  "momentError": np.zeros((ny, 2)),
                  "div(phi)": np.zeros(ny)},
        "outlet": {"U": np.stack([sol.u[-1, :], sol.v[-1, :]], -1),
                   "p": np.zeros(ny),                    # fixedValue 0
                   "momentError": np.zeros((ny, 2)),
                   "div(phi)": np.zeros(ny)},
        "walls": {"U": np.concatenate(                   # slip: tangential only
                      [np.stack([sol.u[:, 0], np.zeros(nx)], -1),
                       np.stack([sol.u[:, -1], np.zeros(nx)], -1)]),
                  "p": np.concatenate([sol.p[:, 0], sol.p[:, -1]]),
                  "momentError": np.zeros((2 * nx, 2)),
                  "div(phi)": np.zeros(2 * nx)},
    }
    write_case(case_dir, pts, zone, patches,
               fields={"U": U, "p": P, "momentError": merr, "div(phi)": divp},
               patch_fields=patch_fields, d=d, f=f, nu=nu,
               elapsed_ns=elapsed_ns, solver_meta=solver_meta)


def _interface_faces(sol: DuctSolution):
    """Porous-fluid interface face centres + face-interpolated U, p from the
    zone-transition faces of the structured grid. Mirrors the reference's
    'interface' faceZone surface dump (cellZone cut surface)."""
    zone = sol.zone
    dx = sol.x[1] - sol.x[0]
    dy = sol.y[1] - sol.y[0]

    centres, us, vs, ps = [], [], [], []
    # vertical faces between cells (i, j) and (i+1, j)
    i_idx, j_idx = np.nonzero(zone[1:, :] != zone[:-1, :])
    if len(i_idx):
        centres.append(np.stack([sol.x[i_idx] + 0.5 * dx, sol.y[j_idx]], -1))
        us.append(0.5 * (sol.u[i_idx, j_idx] + sol.u[i_idx + 1, j_idx]))
        vs.append(0.5 * (sol.v[i_idx, j_idx] + sol.v[i_idx + 1, j_idx]))
        ps.append(0.5 * (sol.p[i_idx, j_idx] + sol.p[i_idx + 1, j_idx]))
    # horizontal faces between cells (i, j) and (i, j+1)
    i_idx, j_idx = np.nonzero(zone[:, 1:] != zone[:, :-1])
    if len(i_idx):
        centres.append(np.stack([sol.x[i_idx], sol.y[j_idx] + 0.5 * dy], -1))
        us.append(0.5 * (sol.u[i_idx, j_idx] + sol.u[i_idx, j_idx + 1]))
        vs.append(0.5 * (sol.v[i_idx, j_idx] + sol.v[i_idx, j_idx + 1]))
        ps.append(0.5 * (sol.p[i_idx, j_idx] + sol.p[i_idx, j_idx + 1]))
    if not centres:
        raise ValueError("no porous-fluid interface faces in the solution")
    c = np.concatenate(centres)
    u = np.stack([np.concatenate(us), np.concatenate(vs)], -1)
    p = np.concatenate(ps)
    return c, u, p


# the primitive/placement zoo used for golden splits (deterministic)
GOLDEN_CASES = [
    ("circle", 0.10, 0.00, 0.12, 0.0),
    ("ellipse", 0.05, 0.02, 0.14, 0.4),
    ("rectangle", 0.12, -0.03, 0.11, 0.2),
    ("triangle", 0.08, 0.00, 0.13, 0.0),
    ("rhombus", 0.10, 0.04, 0.12, 0.6),
    ("circle", 0.20, -0.05, 0.10, 0.0),
    ("rectangle", 0.00, 0.00, 0.12, 0.8),
    ("ellipse", 0.15, -0.02, 0.12, 1.2),
    ("triangle", 0.05, 0.05, 0.11, 0.5),
    ("rhombus", 0.18, -0.04, 0.13, 0.3),
    ("circle", 0.10, 0.06, 0.13, 0.0),
    ("rectangle", 0.07, 0.02, 0.10, 1.1),
]


def write_golden_split(split_dir: str | Path, cases=None,
                       nx: int = 120, ny: int = 72,
                       n_internal: int | None = None,
                       tol: float = 1e-4, max_steps: int = 20000,
                       time_solve: bool = True) -> list[DuctSolution]:
    """Solve and write a split of duct cases (deterministic geometry zoo)."""
    import time as _time
    sols = []
    for i, (shape, cx, cy, size, theta) in enumerate(cases or GOLDEN_CASES):
        t0 = _time.perf_counter_ns()
        sol = solve_duct(shape, cx, cy, size, theta, nx=nx, ny=ny,
                         tol=tol, max_steps=max_steps)
        elapsed = _time.perf_counter_ns() - t0 if time_solve else 10 ** 9
        solution_to_case(sol, Path(split_dir) / f"case_{i}",
                         n_internal=n_internal,
                         rng=np.random.default_rng(8421 + i),
                         elapsed_ns=elapsed)
        sols.append(sol)
    return sols
