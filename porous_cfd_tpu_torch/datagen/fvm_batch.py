"""The batched 2D Navier-Stokes + Darcy-Forchheimer solver on the card: the
port's counterpart of ``porous_cfd_tpu/datagen/fvm_tpu.py``.

The same discretization as ``datagen/fvm.py`` (staggered MAC grid, central
convection with a small upwind blend, implicit porous sink, explicit
pseudo-time incremental projection), in plain torch, so that a whole
transform grid of cases marches in lockstep on one device:

  * the 5-point pressure Poisson operator of ``fvm._poisson_matrix`` is the
    Kronecker sum of two 1D operators (Neumann walls and inlet, Dirichlet
    outlet face), so each projection is four products over the (B, nx, ny)
    divergence in the operators' eigenbasis and an eigenvalue divide, in
    full f32 (TF32 is switched off inside the solve and the caller's switch
    restored after it);
  * the cases march with their own dt, inlet vector, Darcy pair (dx, dy)
    and Forchheimer f (the variable-boundary protocol's batch axes). Every
    step freezes, on the device, each case that has converged or reached
    ``max_steps``, so its fields, residual and step count stay as they
    were. The host asks whether any case is still marching only every
    ``check_every`` steps (one synchronization each), and the steps after
    the last case froze change nothing: the results do not depend on
    ``check_every``;
  * on the card one step (about 90 small kernels) is captured once as a
    CUDA graph and replayed, so the host's launch time no longer paces the
    march (``graph=False`` launches each kernel eagerly instead).

The fields come back as ``fvm.DuctSolution``s, post-processed in float64 on
the host as the numpy solver's are. With ``dtype=torch.float64`` on the CPU
the march reproduces ``fvm.solve_duct`` to round-off; the f32 march differs
from it by accumulation noise, so keep ``tol`` at 2e-4 or above in f32 (the
update norm's noise floor).

    from porous_cfd_tpu_torch.datagen.fvm_batch import solve_duct_batch
    sols = solve_duct_batch([dict(shape="circle", cx=0.1, cy=0.0, size=0.12,
                                  theta=0.0)])

It runs on the CUDA card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from porous_cfd_tpu_torch.datagen import fvm
from porous_cfd_tpu_torch.datagen.fvm import DOMAIN, NU, DuctSolution
from porous_cfd_tpu_torch.datagen.fvm3d_batch import _full_f32, _poisson_eig
from porous_cfd_tpu_torch.device import resolve_device

# steps between two reads of the batch's state on the host
CHECK_EVERY = 200


def _case_arrays(cases, nx, ny):
    """The porous masks on the u and v faces and the cells (B, ...), and the
    per-case inlet vector, Darcy pair and Forchheimer coefficient (B,), in
    float64."""
    (x0, x1), (y0, y1) = DOMAIN
    dx, dy = (x1 - x0) / nx, (y1 - y0) / ny
    xc = x0 + (np.arange(nx) + 0.5) * dx
    yc = y0 + (np.arange(ny) + 0.5) * dy
    xu = x0 + np.arange(nx + 1) * dx
    yv = y0 + np.arange(ny + 1) * dy
    b = len(cases)
    su = np.empty((b, nx + 1, ny))
    sv = np.empty((b, nx, ny + 1))
    zone = np.empty((b, nx, ny))
    coef = {k: np.empty((b,)) for k in ("u_in", "v_in", "d_x", "d_y", "f")}
    for i, case in enumerate(cases):
        inside = fvm.shape_indicator(case["shape"], case.get("cx", 0.1), case.get("cy", 0.0),
                                     case.get("size", 0.12), case.get("theta", 0.0),
                                     case.get("sx", 1.0), case.get("sy", 1.0))

        def mask(xs, ys):
            xx, yy = np.meshgrid(xs, ys, indexing="ij")
            return inside(xx, yy).astype(np.float64)

        su[i], sv[i], zone[i] = mask(xu, yc), mask(xc, yv), mask(xc, yc)
        coef["u_in"][i] = case.get("u_inlet", fvm.U_INLET)
        coef["v_in"][i] = case.get("v_inlet", 0.0)
        d = case.get("d", fvm.DARCY_D)
        coef["d_x"][i], coef["d_y"][i] = ((float(d[0]), float(d[1])) if np.ndim(d)
                                          else (float(d),) * 2)
        coef["f"][i] = case.get("f", fvm.FORCH_F)
    return (xc, yc), (dx, dy), su, sv, zone, coef


def _captured(step, state):
    """One ``step`` captured as a CUDA graph that advances ``state``'s
    tensors in place: each replay is one step. ``step`` is pure, so the
    warm-up runs (cuBLAS's handles and workspaces) change nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(*state)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for buf, new in zip(state, step(*state)):
            buf.copy_(new)
    return g


def solve_duct_batch(cases, nx: int = 120, ny: int = 72, nu: float = NU, tol: float = 2e-4,
                     max_steps: int = 30000, upwind: float = 0.1, dtype=torch.float32,
                     device=None, check_every: int = CHECK_EVERY, stats: dict | None = None,
                     graph: bool = True) -> list[DuctSolution]:
    """March a batch of 2D duct cases to steady state on ``device`` (the
    CUDA card unless ``"cpu"`` is asked for).

    :param cases: a sequence of dicts of ``fvm.solve_duct``'s geometry and
        boundary parameters: ``shape``, ``cx``, ``cy``, ``size``, ``theta``
        (radians), and optional ``sx``, ``sy``, ``u_inlet``, ``v_inlet``,
        ``d`` (a scalar or a (dx, dy) pair) and ``f``.
    :param dtype: the march's precision (``torch.float64`` reproduces the
        numpy solver to round-off).
    :param check_every: steps between two reads of the batch's state on the
        host; the results do not depend on it.
    :param stats: if given, receives the march's ``steps`` (the steps run,
        frozen ones included) and ``seconds`` (ending in a synchronization,
        the graph's capture included).
    :param graph: on a CUDA device, replay one captured step (a CUDA graph)
        instead of launching its kernels one by one.
    :return: one ``fvm.DuctSolution`` a case (cell-centred float64 fields,
        the case's residual and steps), as ``fvm.solve_duct`` returns them.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be at least 1, got {check_every}")
    dev = resolve_device(device)
    (xc, yc), (dx, dy), su, sv, zone, coef = _case_arrays(cases, nx, ny)
    b = len(cases)
    speed = np.hypot(coef["u_in"], coef["v_in"])
    dt = 0.4 * np.minimum(dx / np.maximum(speed * 3.0, 1e-9), dx * dx / (4.0 * nu))

    # the Kronecker sum's eigenbasis: x carries the outlet's Dirichlet ghost
    # (its last diagonal -3/dx^2), y is Neumann at both walls
    Qx, lx = _poisson_eig(nx, dx, dirichlet_end=True)
    Qy, ly = _poisson_eig(ny, dy, dirichlet_end=False)

    def put(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    lam = put(lx[:, None] + ly[None, :])
    Qx, Qy = put(Qx), put(Qy)
    su_t, sv_t = put(su), put(sv)
    uin = put(coef["u_in"])[:, None]               # (B, 1): the inlet column u[:, 0]
    vin = put(coef["v_in"])[:, None, None]         # (B, 1, 1): the inlet ghost row of v
    spd = put(speed)
    dtb = put(dt)                                  # (B,)
    dt3 = dtb[:, None, None]
    dx_coef = put(nu * coef["d_x"])[:, None, None]
    dy_coef = put(nu * coef["d_y"])[:, None, None]
    f3 = put(coef["f"])[:, None, None]

    def cd_u(u, v):
        """-(d(uu)/dx + d(uv)/dy) + nu lap(u) on the interior u faces (the
        walls' ghost rows slip: du/dy = 0)."""
        ug = torch.cat([u[:, :, :1], u, u[:, :, -1:]], dim=2)
        uc = 0.5 * (u[:, 1:] + u[:, :-1])
        uu = uc * uc
        duu = (uu[:, 1:] - uu[:, :-1]) / dx
        uuw = uc * torch.where(uc >= 0, u[:, :-1], u[:, 1:])
        duu_up = (uuw[:, 1:] - uuw[:, :-1]) / dx
        duu = (1 - upwind) * duu + upwind * duu_up
        vf = 0.5 * (v[:, 1:] + v[:, :-1])
        uf = 0.5 * (ug[:, 1:-1, 1:] + ug[:, 1:-1, :-1])
        uv = vf * uf
        duv = (uv[:, :, 1:] - uv[:, :, :-1]) / dy
        lap = ((u[:, 2:] - 2 * u[:, 1:-1] + u[:, :-2]) / dx ** 2
               + (ug[:, 1:-1, 2:] - 2 * ug[:, 1:-1, 1:-1] + ug[:, 1:-1, :-2]) / dy ** 2)
        return -(duu + duv) + nu * lap

    def cd_v(u, v):
        """The same on the interior v faces (the inlet's Dirichlet ghost
        carries each case's v_inlet; the outlet is zero-gradient)."""
        vg = torch.cat([2.0 * vin - v[:, :1], v, v[:, -1:]], dim=1)
        vc = 0.5 * (v[:, :, 1:] + v[:, :, :-1])
        vv = vc * vc
        dvv = (vv[:, :, 1:] - vv[:, :, :-1]) / dy
        vcw = vc * torch.where(vc >= 0, v[:, :, :-1], v[:, :, 1:])
        dvv_up = (vcw[:, :, 1:] - vcw[:, :, :-1]) / dy
        dvv = (1 - upwind) * dvv + upwind * dvv_up
        uf = 0.5 * (u[:, :, 1:] + u[:, :, :-1])
        vf = 0.5 * (vg[:, 1:, 1:-1] + vg[:, :-1, 1:-1])
        uv = uf * vf
        duv = (uv[:, 1:] - uv[:, :-1]) / dx
        lap = ((vg[:, 2:, 1:-1] - 2 * vg[:, 1:-1, 1:-1] + vg[:, :-2, 1:-1]) / dx ** 2
               + (v[:, :, 2:] - 2 * v[:, :, 1:-1] + v[:, :, :-2]) / dy ** 2)
        return -(duv + dvv) + nu * lap

    def poisson(rhs):
        # the Kronecker-sum operator's eigenbasis, batched over the cases
        t = torch.einsum("xi,bxy->biy", Qx, rhs)
        t = torch.einsum("yj,biy->bij", Qy, t)
        t = t / lam
        t = torch.einsum("yj,bij->biy", Qy, t)
        return torch.einsum("xi,biy->bxy", Qx, t)

    def step(u, v, p, res, steps, done):
        frz = done | (steps >= max_steps)        # converged, or out of steps
        s_u = (dx_coef + 0.5 * f3 * torch.abs(u[:, 1:-1])) * su_t[:, 1:-1]
        s_v = (dy_coef + 0.5 * f3 * torch.abs(v[:, :, 1:-1])) * sv_t[:, :, 1:-1]
        rhs_u = cd_u(u, v) - (p[:, 1:] - p[:, :-1]) / dx
        rhs_v = cd_v(u, v) - (p[:, :, 1:] - p[:, :, :-1]) / dy

        u_star, v_star = u.clone(), v.clone()
        u_star[:, 1:-1] = (u[:, 1:-1] + dt3 * rhs_u) / (1.0 + dt3 * s_u)
        v_star[:, :, 1:-1] = (v[:, :, 1:-1] + dt3 * rhs_v) / (1.0 + dt3 * s_v)
        u_star[:, 0] = uin
        u_star[:, -1] = u_star[:, -2]
        v_star[:, :, 0] = 0.0
        v_star[:, :, -1] = 0.0

        div = ((u_star[:, 1:] - u_star[:, :-1]) / dx
               + (v_star[:, :, 1:] - v_star[:, :, :-1]) / dy)
        phi = poisson(div / dt3)

        u_new, v_new = u_star, v_star
        u_new[:, 1:-1] = u_star[:, 1:-1] + (-dt3 * (phi[:, 1:] - phi[:, :-1]) / dx)
        # the outlet face: phi = 0 there (Dirichlet), reached through a ghost
        u_new[:, -1] = u_star[:, -1] + (-dtb[:, None] * (0.0 - phi[:, -1]) * 2.0 / dx)
        v_new[:, :, 1:-1] = v_star[:, :, 1:-1] + (-dt3 * (phi[:, :, 1:] - phi[:, :, :-1]) / dy)
        p_new = p + phi

        p_scale = torch.maximum(0.5 * spd ** 2, torch.amax(torch.abs(p_new), dim=(1, 2)))
        res_new = torch.maximum(torch.amax(torch.abs(u_new - u), dim=(1, 2)) / (dtb * spd),
                                torch.amax(torch.abs(phi), dim=(1, 2)) / (dtb * p_scale))
        f_ = frz[:, None, None]
        return (torch.where(f_, u, u_new), torch.where(f_, v, v_new),
                torch.where(f_, p, p_new), torch.where(frz, res, res_new),
                steps + (~frz).to(steps.dtype), done | (~frz & (res_new < tol)))

    state = (uin[:, :, None].expand(b, nx + 1, ny).contiguous(),
             torch.zeros((b, nx, ny + 1), dtype=dtype, device=dev),
             torch.zeros((b, nx, ny), dtype=dtype, device=dev),
             torch.full((b,), float("inf"), dtype=dtype, device=dev),
             torch.zeros((b,), dtype=torch.int32, device=dev),
             torch.zeros((b,), dtype=torch.bool, device=dev))
    marched = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad(), _full_f32():
        advance = _captured(step, state) if graph and dev.type == "cuda" else None
        while True:
            _, _, _, _, steps, done = state
            # the one read of the device a chunk: is any case still marching?
            if not bool(((~done) & (steps < max_steps)).any()):
                break
            for _ in range(check_every):
                if advance is not None:
                    advance.replay()              # the state's buffers, in place
                else:
                    state = step(*state)
            marched += check_every
    seconds = time.perf_counter() - t0
    if stats is not None:
        stats.update(steps=marched, seconds=seconds)
    u, v, p, res, steps, _ = (t.cpu().numpy() for t in state)

    sols = []
    for i in range(b):
        uc = (0.5 * (u[i, 1:] + u[i, :-1])).astype(np.float64)
        vc = (0.5 * (v[i][:, 1:] + v[i][:, :-1])).astype(np.float64)
        p64 = p[i].astype(np.float64)
        div_c = ((u[i, 1:] - u[i, :-1]) / dx + (v[i][:, 1:] - v[i][:, :-1]) / dy
                 ).astype(np.float64)
        merr = fvm._momentum_residual(uc, vc, p64, zone[i], dx, dy, nu,
                                      (coef["d_x"][i], coef["d_y"][i]), coef["f"][i])
        sols.append(DuctSolution(xc, yc, uc, vc, p64, zone[i], div_c, merr,
                                 float(res[i]), int(steps[i])))
    return sols
