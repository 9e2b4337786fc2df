"""Differential-operator helpers (counterpart of
``porous_cfd_tpu/physics/operators.py``). Only ``split_derivatives`` is
ported; the exact autodiff operator ``pinn_derivatives`` waits for its
slice."""
from __future__ import annotations

import torch


def split_derivatives(jac: torch.Tensor, lap: torch.Tensor | None, dims: int):
    """Split full-output derivatives into the quantities the losses consume.
    Output channels are [Ux, Uy, (Uz), p].

    :return: ``(u_jac (..., N, D, Din), u_lap or None, p_grad (..., N, Din))``.
    """
    u_jac = jac[..., :dims, :]
    p_grad = jac[..., dims, :]
    u_lap = None if lap is None else lap[..., :dims, :]
    return u_jac, u_lap, p_grad
