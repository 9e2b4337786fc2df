"""FoamData: a point-cloud tensor with label- and subdomain-based indexing
(counterpart of ``porous_cfd_tpu/data/foam_data.py``).

Schema rules (the same as the JAX package and the reference container):
  * single labels (value ``None``) occupy one column each, in insertion order;
  * composite labels (value = tuple of single-label names) concatenate their
    sub-label columns on lookup;
  * subdomain lookup gathers rows and returns a new ``FoamData`` whose only
    subdomain is the looked-up one re-indexed from zero.

Rows are internal-first, then boundary (``split_contiguous`` relies on it).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

Labels = tuple[tuple[str, tuple[str, ...] | None], ...]


def freeze_labels(labels: Mapping[str, Sequence[str] | None]) -> Labels:
    """Canonicalize a labels mapping into a hashable tuple-of-pairs."""
    if isinstance(labels, tuple):
        return labels
    return tuple((k, tuple(v) if v is not None else None) for k, v in labels.items())


def _as_array(x):
    """Tensors and numpy arrays are kept as they are; anything else becomes a
    tensor."""
    return x if isinstance(x, (torch.Tensor, np.ndarray)) else torch.as_tensor(x)


def _as_index(x):
    x = _as_array(x)
    return x.long() if torch.is_tensor(x) else x.astype(np.int64)


def _arange_like(n: int, like):
    if torch.is_tensor(like):
        return torch.arange(n, device=like.device)
    return np.arange(n)


@dataclasses.dataclass(frozen=True)
class FoamData:
    """Tensor of shape ``(N, C)`` or ``(B, N, C)`` indexed by field name and
    subdomain. ``domain`` maps a subdomain name to an integer index tensor
    ``(K,)`` or ``(B, K)``; an entry whose name starts with ``_`` is a
    model's per-case aux (``PinnModel.attach_neighbors``), kept as given,
    float or not. ``numpy()`` gives the same container over numpy arrays on
    the host, which indexes the same way."""

    data: torch.Tensor
    labels: Labels
    domain: dict[str, torch.Tensor]

    def __init__(self, data, labels, domain):
        object.__setattr__(self, "data", _as_array(data))
        object.__setattr__(self, "labels", freeze_labels(labels))
        object.__setattr__(self, "domain",
                           {k: _as_array(v) if k.startswith("_") else _as_index(v)
                            for k, v in domain.items()})

    @property
    def label_dict(self) -> dict[str, tuple[str, ...] | None]:
        return dict(self.labels)

    def column_index(self, name: str) -> int:
        for i, (k, _) in enumerate(self.labels):
            if k == name:
                return i
        raise KeyError(name)

    def column_indices(self, name: str) -> list[int]:
        lab = self.label_dict
        if name not in lab:
            raise KeyError(name)
        sub = lab[name]
        if sub is None:
            return [self.column_index(name)]
        out: list[int] = []
        for s in sub:
            out.extend(self.column_indices(s))
        return out

    def __getitem__(self, item: str) -> "FoamData | torch.Tensor":
        lab = self.label_dict
        if item in lab:
            cols = self.column_indices(item)
            if cols == list(range(cols[0], cols[0] + len(cols))):
                return self.data[..., cols[0]:cols[0] + len(cols)]
            return self.data[..., cols]
        if item in self.domain:
            ids = self.domain[item]
            if self.data.ndim <= 2:
                sub = self.data[ids]
            elif torch.is_tensor(self.data):
                gather = ids[..., None].expand(*ids.shape, self.data.shape[-1])
                sub = torch.gather(self.data, -2, gather)
            else:
                sub = np.take_along_axis(self.data, ids[..., None], axis=-2)
            new_ids = _arange_like(ids.shape[-1], ids)
            if ids.ndim > 1:
                new_ids = new_ids.expand(ids.shape) if torch.is_tensor(ids) \
                    else np.broadcast_to(new_ids, ids.shape)
            return FoamData(sub, self.labels, {item: new_ids})
        raise KeyError(
            f"{item} not found in labels or subdomains. "
            f"Available labels: {list(lab.keys())}. "
            f"Available subdomains: {list(self.domain.keys())}.")

    def __contains__(self, item: str) -> bool:
        return item in self.label_dict or item in self.domain

    def squeeze(self) -> "FoamData":
        data = self.data.squeeze(0) if self.data.ndim > 2 else self.data
        dom = {k: (v.squeeze(0) if v.ndim > 1 else v)
               for k, v in self.domain.items()}
        return FoamData(data, self.labels, dom)

    def to(self, device) -> "FoamData":
        return FoamData(torch.as_tensor(self.data).to(device), self.labels,
                        {k: torch.as_tensor(v).to(device)
                         for k, v in self.domain.items()})

    def numpy(self) -> "FoamData":
        """The same container over numpy arrays (copied to the host)."""
        def host(x):
            return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return FoamData(host(self.data), self.labels,
                        {k: host(v) for k, v in self.domain.items()})

    def __len__(self) -> int:
        return self.data.shape[0]


def split_contiguous(batch: FoamData) -> tuple[FoamData, FoamData]:
    """(internal, boundary) row views by slicing: rows [0, Ni) are internal
    and [Ni, N) boundary (the dataset layout guarantees it)."""
    n_int = batch.domain["internal"].shape[-1]
    dev = batch.data.device
    internal = FoamData(batch.data[..., :n_int, :], batch.labels,
                        {"internal": torch.arange(n_int, device=dev)})
    boundary = FoamData(batch.data[..., n_int:, :], batch.labels,
                        {"boundary": torch.arange(batch.data.shape[-2] - n_int,
                                                  device=dev)})
    return internal, boundary


def collate(samples: Sequence[FoamData]) -> FoamData:
    """Stack per-case FoamData into a batch (all cases share schema and
    shapes)."""
    data = torch.stack([s.data for s in samples])
    keys = samples[0].domain.keys()
    dom = {k: torch.stack([s.domain[k] for s in samples]) for k in keys}
    return FoamData(data, samples[0].labels, dom)
