"""Physics residuals and losses (counterpart of
``porous_cfd_tpu/physics/losses.py``): continuity div(u) and the
Navier-Stokes-Darcy-Forchheimer momentum residual

    (u . grad) u  -  nu lap(u)  +  grad p  +  u (d nu + 1/2 |u| f) * zone

on raw coordinates with an analytic forcing (``ContinuityLoss``,
``MomentumLossManufactured``), or with the chain-rule factors that undo
z-score standardization, for fixed scalar d/f (``MomentumLossFixed``) or
per-point d/f fields (``MomentumLossVariable``). Each loss has
``residual(...)`` and is a callable giving the per-component MSE against 0.
Scalers must lie on the device of the tensors they meet (``.to(device)``).
"""
from __future__ import annotations

import dataclasses

import torch

from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.data.scalers import Normalizer, StandardScaler


def mse(x, y):
    return torch.mean((x - y) ** 2)


def mae(x, y):
    return torch.mean(torch.abs(x - y))


def vector_loss(x: torch.Tensor, y: torch.Tensor, loss_fn: str = "mse"):
    """Per-component loss over the last axis: ``(D,)`` means."""
    err = (x - y) ** 2 if loss_fn == "mse" else torch.abs(x - y)
    return torch.mean(err.reshape(-1, err.shape[-1]), dim=0)


def _u_source(u_raw, d, f, nu):
    """Darcy-Forchheimer penalization source: u (d nu + 1/2 |u| f)."""
    u_mag = torch.linalg.vector_norm(u_raw, dim=-1, keepdim=True)
    return u_raw * (d * nu + 0.5 * u_mag * f)


@dataclasses.dataclass(frozen=True)
class ContinuityLoss:
    """div(u) residual on raw (unscaled) outputs."""

    def residual(self, u_jac: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.diagonal(u_jac, dim1=-2, dim2=-1), dim=-1)

    def __call__(self, u_jac: torch.Tensor) -> torch.Tensor:
        r = self.residual(u_jac)
        return mse(r, torch.zeros_like(r))


@dataclasses.dataclass(frozen=True)
class ContinuityLossStandardized:
    """div(u) residual with the standardization chain rule."""
    u_scaler: StandardScaler
    points_scaler: StandardScaler

    def residual(self, u_jac: torch.Tensor) -> torch.Tensor:
        diag = torch.diagonal(u_jac, dim1=-2, dim2=-1)
        diag = diag * self.u_scaler.std / self.points_scaler.std
        return torch.sum(diag, dim=-1)

    def __call__(self, u_jac: torch.Tensor) -> torch.Tensor:
        r = self.residual(u_jac)
        return mse(r, torch.zeros_like(r))


@dataclasses.dataclass(frozen=True)
class MomentumLossManufactured:
    """Raw-coordinate residual with the analytic forcing ``internal["f"]``:
    (u . grad) u - nu sum_j d2u/dxj2 + grad p + source * cellToRegion - f."""
    nu: float
    d: float
    f: float

    def residual(self, internal: FoamData, u, u_jac, u_lap, p_grad):
        source = _u_source(u, self.d, self.f, self.nu)
        convection = torch.einsum("...ij,...j->...i", u_jac, u)
        viscosity = self.nu * torch.sum(u_lap, dim=-1)
        return (convection - viscosity + p_grad + source * internal["cellToRegion"]
                - internal["f"])

    def __call__(self, internal, u, u_jac, u_lap, p_grad):
        r = self.residual(internal, u, u_jac, u_lap, p_grad)
        return vector_loss(r, torch.zeros_like(r))


@dataclasses.dataclass(frozen=True)
class MomentumLossFixed:
    """Standardized-coordinate residual with fixed scalar d/f. Convection
    scales by u_std/points_std, viscosity by u_std/points_std^2, pressure by
    p_std/points_std."""
    nu: float
    d: float
    f: float
    u_scaler: StandardScaler
    points_scaler: StandardScaler
    p_scaler: StandardScaler

    def residual(self, internal: FoamData, u, u_jac, u_lap, p_grad):
        u_raw = self.u_scaler.inverse_transform(u)
        source = _u_source(u_raw, self.d, self.f, self.nu)
        return _standardized_residual(self, internal, u_raw, source, u_jac, u_lap, p_grad)

    def __call__(self, internal, u, u_jac, u_lap, p_grad):
        r = self.residual(internal, u, u_jac, u_lap, p_grad)
        return vector_loss(r, torch.zeros_like(r))


@dataclasses.dataclass(frozen=True)
class MomentumLossVariable:
    """The same residual with per-point d/f coefficient fields, each put back
    into raw units through its ``Normalizer``."""
    nu: float
    u_scaler: StandardScaler
    points_scaler: StandardScaler
    p_scaler: StandardScaler
    d_scaler: Normalizer
    f_scaler: Normalizer

    def residual(self, internal: FoamData, u, u_jac, u_lap, p_grad):
        u_raw = self.u_scaler.inverse_transform(u)
        d_raw = self.d_scaler.inverse_transform(internal["d"])
        f_raw = self.f_scaler.inverse_transform(internal["f"])
        source = _u_source(u_raw, d_raw, f_raw, self.nu)
        return _standardized_residual(self, internal, u_raw, source, u_jac, u_lap, p_grad)

    def __call__(self, internal, u, u_jac, u_lap, p_grad):
        r = self.residual(internal, u, u_jac, u_lap, p_grad)
        return vector_loss(r, torch.zeros_like(r))


def _standardized_residual(loss, internal: FoamData, u_raw, source, u_jac, u_lap, p_grad):
    """Convection, viscosity and pressure in standardized coordinates plus
    the penalization source in the porous zone."""
    convection = torch.einsum(
        "...ij,...j->...i", u_jac,
        u_raw / loss.points_scaler.std) * loss.u_scaler.std
    viscosity = loss.nu * torch.einsum(
        "...ij,...j->...i", u_lap,
        1.0 / loss.points_scaler.std ** 2) * loss.u_scaler.std
    pressure = (loss.p_scaler.std / loss.points_scaler.std) * p_grad
    return convection - viscosity + pressure + source * internal["cellToRegion"]
