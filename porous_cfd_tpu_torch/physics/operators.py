"""Differential operators for PINN residuals (counterpart of
``porous_cfd_tpu/physics/operators.py``): the exact autodiff operator
``pinn_derivatives`` and ``split_derivatives``.

``pinn_derivatives`` has the reference's grad-of-sum semantics: each output
channel is summed over the differentiated rows (the cotangent is ones over
the first N rows), so cross-point couplings through a global max-pool are
included. It uses PyTorch's reverse mode twice, as the reference does: one
``autograd.grad`` per output channel gives the Jacobian, and one more per
(channel, input dim) pair gives the Laplacian's diagonal. That second pass
differentiates the Jacobian's column ``j`` summed over the points, which by
the symmetry of second derivatives equals the JAX package's directional
derivative with the tangent e_j at every point.
"""
from __future__ import annotations

from typing import Callable

import torch


def pinn_derivatives(apply_fn: Callable[[torch.Tensor], torch.Tensor], points: torch.Tensor,
                     compute_laplacian: bool = True):
    """Outputs with their Jacobian and Laplacian diagonal.

    :param apply_fn: maps ``points (..., N, Din)`` to outputs ``(..., M, O)``
        with ``M >= N``; only the first N output rows are differentiated (the
        forward also produces the boundary rows).
    :param points: coordinates ``(..., N, Din)`` to differentiate w.r.t.
    :param compute_laplacian: skip the second-order pass when False.
    :return: ``(out, jac, lap)``: ``out (..., M, O)``, ``jac (..., N, O, Din)``
        with ``jac[..., n, o, j] = d(sum_{rows < N} out[..., o]) / d
        points[..., n, j]``, and ``lap`` of the same shape holding
        ``d^2 / d points_j^2`` of the same sums (None when disabled).

    Under ``torch.no_grad()`` (verbose prediction) the results are detached;
    otherwise the graph is kept, so a loss on them back-propagates to the
    parameters.
    """
    keep_graph = torch.is_grad_enabled()
    n, din = points.shape[-2], points.shape[-1]
    with torch.enable_grad():
        pts = points if points.requires_grad else points.detach().requires_grad_()
        out = apply_fn(pts)
        rows = out[..., :n, :]
        jac = torch.stack([
            torch.autograd.grad(rows[..., o].sum(), pts, retain_graph=True,
                                create_graph=keep_graph or compute_laplacian)[0]
            for o in range(out.shape[-1])], dim=-2)            # (..., N, O, Din)
        lap = None
        if compute_laplacian:
            lap = torch.stack([
                torch.stack([
                    torch.autograd.grad(jac[..., o, j].sum(), pts, retain_graph=True,
                                        create_graph=keep_graph)[0][..., j]
                    for j in range(din)], dim=-1)
                for o in range(out.shape[-1])], dim=-2)
    if not keep_graph:
        out, jac = out.detach(), jac.detach()
        lap = None if lap is None else lap.detach()
    return out, jac, lap


def split_derivatives(jac: torch.Tensor, lap: torch.Tensor | None, dims: int):
    """Split full-output derivatives into the quantities the losses consume.
    Output channels are [Ux, Uy, (Uz), p].

    :return: ``(u_jac (..., N, D, Din), u_lap or None, p_grad (..., N, Din))``.
    """
    u_jac = jac[..., :dims, :]
    p_grad = jac[..., dims, :]
    u_lap = None if lap is None else lap[..., :dims, :]
    return u_jac, u_lap, p_grad
