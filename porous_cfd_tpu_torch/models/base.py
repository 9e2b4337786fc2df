"""PinnModel: a module with its physics losses and training recipe
(counterpart of ``porous_cfd_tpu/models/base.py``).

Every model module follows one forward contract::

    y = module(points, batch, deterministic=...)

where ``points (..., N, Din)`` is the differentiable coordinate tensor
(internal followed by boundary points) and ``batch`` the full ``FoamData``;
``y`` has output channels [Ux, Uy, (Uz), p]. The parameters live in the
module, on the device the model was built for.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.data.scalers import StandardScaler


def predicted_labels(dims: int) -> dict:
    """Output schema [Ux, Uy, (Uz), p] + composite U."""
    u_labels = ["Ux", "Uy", "Uz"][:dims]
    labels: dict = dict.fromkeys(u_labels, None)
    labels["p"] = None
    labels["U"] = u_labels
    return labels


def extra_labels(dims: int) -> dict:
    """Residual output schema [Momentum.., div] + composite Momentum."""
    m_labels = ["Momentumx", "Momentumy", "Momentumz"][:dims]
    labels: dict = dict.fromkeys(m_labels, None)
    labels["div"] = None
    labels["Momentum"] = m_labels
    return labels


def loss_labels(dims: int, enable_data_loss: bool) -> list[str]:
    """Ordered labels of the loss vector [continuity, momentum..,
    boundary_u.., boundary_p, obs_u.., obs_p]."""
    axes = ["x", "y", "z"][:dims]
    labels = ["Continuity loss"] + [f"Momentum {a} loss" for a in axes]
    labels += [f"Boundary loss u{a}" for a in axes] + ["Boundary loss p"]
    if enable_data_loss:
        labels += [f"Observations loss u{a}" for a in axes] + ["Observations loss p"]
    return labels


def error_labels(dims: int) -> list[str]:
    return ["error p"] + [f"error u{a}" for a in ["x", "y", "z"][:dims]]


@dataclasses.dataclass(frozen=True)
class PinnModel:
    """A model family member: module + physics losses + optimizer recipe.

    :param learning_rate/lr_gamma/adam_eps: Adam with a per-epoch
        exponential learning-rate decay (every reference model's recipe).
    :param derivative_apply: analytic fast path
        ``(batch, deterministic, seed, placement) -> (out_full, jac, lap)``
        with jac/lap shaped (..., Ni, O, D); ``placement``
        (``ops/dropout.Placement``) is where ``batch`` sits in the whole
        batch, for the dropout masks. A model without one predicts verbosely
        and trains through the exact autodiff operator
        (``physics/operators.pinn_derivatives``) on its module, whose
        forward then also takes ``seed=`` and ``placement=`` for its
        dropout.
    :param neighbor_precompute: ``FoamData -> dict`` of per-case aux built
        once per dataset (``attach_neighbors``), or None.
    :param microbatch: the U-Net variants' memory knob on their exact path:
        a training step accumulates gradients over groups of at most
        ``microbatch`` cases.
    :param eval_dtype: the compute type of the forward-only surfaces
        (validation, non-verbose prediction), set by ``with_precision``;
        None is f32. Training and every derivative graph stay f32.
    """
    module: nn.Module
    dims: int
    momentum_loss: Any
    continuity_loss: Any
    enable_data_loss: bool = True
    u_scaler: Optional[StandardScaler] = None
    p_scaler: Optional[StandardScaler] = None
    learning_rate: float = 1e-3
    lr_gamma: float = 0.999
    adam_eps: float = 1e-8
    derivative_apply: Optional[Any] = None
    neighbor_precompute: Optional[Any] = None
    microbatch: Optional[int] = None
    eval_dtype: Optional[torch.dtype] = None

    def with_precision(self, precision: str) -> "PinnModel":
        """The ``--precision`` flag on the forward-only surfaces: ``bf16*``
        runs their matmuls in bfloat16 (``torch.autocast``) with f32
        parameters; anything else is f32 throughout."""
        dtype = torch.bfloat16 if str(precision).startswith("bf16") else None
        return dataclasses.replace(self, eval_dtype=dtype)

    def attach_neighbors(self, dataset: FoamData) -> FoamData:
        """Merge the model's precomputed per-case aux (keys starting with
        ``_``) into the dataset's domain, once per dataset; the dataset as
        it is when the model has none."""
        if self.neighbor_precompute is None:
            return dataset
        aux = self.neighbor_precompute(dataset)
        return FoamData(dataset.data, dataset.labels, {**dataset.domain, **aux})

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def num_losses(self) -> int:
        return 1 + self.dims + (self.dims + 1) * (2 if self.enable_data_loss else 1)

    @property
    def predicted_labels(self) -> dict:
        return predicted_labels(self.dims)

    @property
    def extra_labels(self) -> dict:
        return extra_labels(self.dims)

    def postprocess_out(self, u, p):
        """Denormalize outputs before error metrics."""
        if self.u_scaler is not None:
            u = self.u_scaler.inverse_transform(u)
        if self.p_scaler is not None:
            p = self.p_scaler.inverse_transform(p)
        return u, p
