"""Feature scalers on tensors (counterpart of ``porous_cfd_tpu/data/scalers.py``).

``StandardScaler`` (z-score) and ``Normalizer`` (min-max to [0, 1]); the
statistics are tensors that broadcast against the data's last axis. Move a
scaler to the data's device with ``.to(device)`` once, not per call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)) if not torch.is_tensor(x) else x


@dataclasses.dataclass(frozen=True)
class StandardScaler:
    std: torch.Tensor
    mean: torch.Tensor

    def __post_init__(self):
        object.__setattr__(self, "std", _tensor(self.std))
        object.__setattr__(self, "mean", _tensor(self.mean))

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return self.std * data + self.mean

    def __getitem__(self, item):
        return StandardScaler(self.std[item], self.mean[item])

    def to(self, device=None, dtype=None) -> "StandardScaler":
        return StandardScaler(self.std.to(device=device, dtype=dtype),
                              self.mean.to(device=device, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class Normalizer:
    min: torch.Tensor
    max: torch.Tensor

    def __post_init__(self):
        object.__setattr__(self, "min", _tensor(self.min))
        object.__setattr__(self, "max", _tensor(self.max))

    @property
    def range(self):
        return self.max - self.min

    def transform(self, data):
        return (data - self.min) / self.range

    def inverse_transform(self, data):
        return self.min + self.range * data

    def __getitem__(self, item):
        return Normalizer(self.min[item], self.max[item])

    def to(self, device=None, dtype=None) -> "Normalizer":
        return Normalizer(self.min.to(device=device, dtype=dtype),
                          self.max.to(device=device, dtype=dtype))


def scalers_from_meta(meta: dict, normalize_fields: dict) -> dict:
    """Build scalers from ``meta.json`` statistics (reference
    dataset/foam_dataset.py:140-151)."""
    stats = meta["Stats"]
    out = {}
    for field in normalize_fields.get("Standardize", []):
        s = stats[field]
        out[field] = StandardScaler(s["Std"], s["Mean"])
    for field in normalize_fields.get("Scale", []):
        s = stats[field]
        out[field] = Normalizer(s["Min"], s["Max"])
    return out
