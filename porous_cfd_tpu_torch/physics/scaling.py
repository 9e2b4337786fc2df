"""Loss balancing, fixed weights and ReLoBRaLo, with explicit carried state
(counterpart of ``porous_cfd_tpu/physics/scaling.py``).

``scaler.init_state()`` makes the carried state and ``scaler(state, losses,
step, seed)`` returns ``(weights, new_state)``. The weights are constants
with respect to the parameters: callers form ``sum(weights * losses)`` with
the weights computed from detached losses. ``seed`` fixes ReLoBRaLo's
Bernoulli lookback draw; the training step derives it from the run's seed
and the step, so a resumed run draws what an uninterrupted one draws.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch


class LossScaler:
    """Identity scaler: every weight is 1."""

    def init_state(self, device=None):
        return None

    def __call__(self, state, losses, step: int, seed: int):
        return torch.ones_like(losses), state


@dataclasses.dataclass(frozen=True)
class FixedLossScaler(LossScaler):
    """Fixed per-loss coefficients, in loss-vector order."""
    weights: tuple[float, ...]

    @classmethod
    def from_dict(cls, loss_weights: dict) -> "FixedLossScaler":
        """Keys in order: continuity, momentum, boundary, observations."""
        w = list(loss_weights["continuity"])
        w.extend(loss_weights["momentum"])
        w.extend(loss_weights["boundary"])
        if "observations" in loss_weights:
            w.extend(loss_weights["observations"])
        return cls(tuple(float(x) for x in w))

    def __call__(self, state, losses, step: int, seed: int):
        return _constant(self.weights, losses.dtype, losses.device), state


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype, device) -> torch.Tensor:
    """A tensor made once per device: a copy from the host in every step
    would wait for the device to drain the work queued before it."""
    return torch.tensor(values, dtype=dtype, device=device)


@dataclasses.dataclass
class RelobraloState:
    init_losses: torch.Tensor
    prev_losses: torch.Tensor
    lambda_ema: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RelobraloScaler(LossScaler):
    """ReLoBRaLo random-lookback loss balancing. ``alpha`` is (1 - alpha)
    with respect to the original paper, and losses are accumulated over
    ``update_period`` steps and averaged to compute weights.

    :param update_period: steps between weight updates (steps per epoch for
        per-epoch averaging).
    """
    num_losses: int
    alpha: float = 0.95
    beta: float = 0.99
    tau: float = 1.0
    eps: float = 1e-8
    update_period: int = 1

    def init_state(self, device=None) -> RelobraloState:
        return RelobraloState(torch.zeros(self.num_losses, device=device),
                              torch.zeros(self.num_losses, device=device),
                              torch.ones(self.num_losses, device=device))

    def lookback(self, seed: int) -> float:
        """The Bernoulli(beta) draw of one step, a pure function of seed."""
        u = torch.rand((), generator=torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1)))
        return float(u.item() < self.beta)

    def __call__(self, state: RelobraloState, losses, step: int, seed: int):
        losses = losses.detach().float()
        period = self.update_period
        if step == 0:
            return torch.ones_like(losses), RelobraloState(losses, losses, state.lambda_ema)
        if step % period != 0:
            return state.lambda_ema, RelobraloState(
                state.init_losses, state.prev_losses + losses, state.lambda_ema)
        prev = state.prev_losses / period
        norm_prev = torch.max(losses / (self.tau * prev))
        norm_init = torch.max(losses / (self.tau * state.init_losses))
        rho = self.lookback(seed)
        lam_prev = torch.exp(losses / (self.tau * prev + self.eps) - norm_prev)
        lam_init = torch.exp(losses / (self.tau * state.init_losses + self.eps) - norm_init)
        lam_prev = lam_prev * self.num_losses / (torch.sum(lam_prev) + self.eps)
        lam_init = lam_init * self.num_losses / (torch.sum(lam_init) + self.eps)
        lam = self.alpha * (rho * state.lambda_ema + (1.0 - rho) * lam_init)
        lam = lam + (1.0 - self.alpha) * lam_prev
        return lam, RelobraloState(state.init_losses, losses, lam)


def make_loss_scaler(name: Optional[str], num_losses: int, weights: Optional[dict] = None,
                     alpha: float = 0.005, update_period: int = 1) -> LossScaler:
    """Scaler by CLI name: ``none``/None, ``fixed`` (with ``weights``) or
    ``relobralo``."""
    if name in (None, "none"):
        return LossScaler()
    if name == "fixed":
        if weights is None:
            return LossScaler()
        return FixedLossScaler.from_dict(weights)
    if name == "relobralo":
        return RelobraloScaler(num_losses, alpha=alpha, update_period=update_period)
    raise ValueError(f"Unknown loss scaler {name}")
