"""Manufactured-solution data: the analytic verification workload
(counterpart of ``porous_cfd_tpu/data/manufactured.py``; the same numpy
generator gives the same batch in both packages).

The Taylor-Green-like solution

    u = ( sin(y) cos(x), -sin(x) cos(y) ),   p = -1/4 (cos 2x + cos 2y)

with the exact Navier-Stokes-Darcy forcing (the Darcy-Forchheimer
penalization inside the porous zone included) synthesized analytically, so
the PDE-residual machinery can be checked end to end without a CFD solver.
``ManufacturedDataset`` reads the cases ``datagen/synthetic_case.py:
write_manufactured_split`` writes (geometry only) and synthesizes the
fields at load time; ``make_manufactured_batch`` fabricates a batch in
memory.
"""
from __future__ import annotations

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.data.foam_data import FoamData


def manufactured_fields(points: np.ndarray, zones: np.ndarray,
                        nu: float = 0.01, d: float = 50.0, f: float = 1.0):
    """Analytic u, p and forcing at ``points (..., 2)`` with porous-zone ids
    ``zones (..., 1)``. Returns (u (..., 2), p (..., 1), forcing (..., 2))."""
    x, y = points[..., 0], points[..., 1]
    u_x = np.sin(y) * np.cos(x)
    u_y = -np.sin(x) * np.cos(y)
    p = -0.25 * (np.cos(2 * x) + np.cos(2 * y))

    f_x = 2 * nu * np.cos(x) * np.sin(y)
    f_y = -2 * nu * np.sin(x) * np.cos(y)
    u_mag = np.sqrt(u_x ** 2 + u_y ** 2)
    z = zones[..., 0]
    f_x = f_x + (nu * d + 0.5 * f * u_mag) * u_x * z
    f_y = f_y + (nu * d + 0.5 * f * u_mag) * u_y * z

    u = np.stack([u_x, u_y], axis=-1)
    forcing = np.stack([f_x, f_y], axis=-1)
    return u, p[..., None], forcing


MANUFACTURED_LABELS = {
    "Cx": None, "Cy": None,
    "cellToRegion": None,
    "fx": None, "fy": None,
    "Ux": None, "Uy": None,
    "p": None,
    "sdf": None,
    "boundaryIdwalls": None, "boundaryIdinterface": None,
    "C": ["Cx", "Cy"],
    "f": ["fx", "fy"],
    "U": ["Ux", "Uy"],
    "boundaryId": ["boundaryIdwalls", "boundaryIdinterface"],
}


class ManufacturedDataset(FoamDataset):
    """File-based manufactured-solutions dataset: a ``FoamDataset`` of
    geometry-only cases whose ``add_features`` synthesizes ``U``, ``p`` and
    the exact forcing ``f`` (``manufactured_fields``) on the internal table
    and on each patch. It samples no observation points."""

    def __init__(self, data_dir, n_internal: int, n_boundary: int, d: float, f: float,
                 rng: np.random.Generator, meta_dir=None, extra_fields=(),
                 nu: float = 0.01):
        self.nu, self.d, self.f = nu, d, f
        super().__init__(data_dir, n_internal, n_boundary, 0, rng, meta_dir=meta_dir,
                         extra_fields=list(extra_fields))

    def add_features(self, internal, patches):
        super().add_features(internal, patches)
        for table in (internal, *patches.values()):
            u, p, forcing = manufactured_fields(table["C"], table["cellToRegion"],
                                                self.nu, self.d, self.f)
            table["f"] = forcing
            table["U"] = u
            table["p"] = p


def make_manufactured_batch(rng: np.random.Generator, batch_size: int, n_internal: int,
                            n_boundary: int, nu: float = 0.01, d: float = 50.0,
                            f: float = 1.0, extent: float = 2 * np.pi,
                            porous_band: tuple[float, float] = (0.25, 0.5)) -> FoamData:
    """A batched FoamData (CPU tensors) with the manufactured schema.

    Internal points are uniform in the square [0, extent]^2; boundary points
    sit on the square's border (3/4 of them, the walls) and on the two
    vertical 'interface' lines that bound the porous band x in porous_band *
    extent."""
    lo, hi = porous_band[0] * extent, porous_band[1] * extent

    def one_case():
        pts_i = rng.uniform(0, extent, size=(n_internal, 2))
        zone_i = ((pts_i[:, 0] >= lo) & (pts_i[:, 0] <= hi)).astype(np.float64)[:, None]

        n_wall = (3 * n_boundary) // 4
        n_iface = n_boundary - n_wall
        t = rng.uniform(0, 4.0, size=n_wall)
        side = np.floor(t).astype(int)
        frac = (t - side) * extent
        wall = np.zeros((n_wall, 2))
        wall[side == 0] = np.stack([frac[side == 0], np.zeros(np.sum(side == 0))], -1)
        wall[side == 1] = np.stack([np.full(np.sum(side == 1), extent), frac[side == 1]], -1)
        wall[side == 2] = np.stack([frac[side == 2], np.full(np.sum(side == 2), extent)], -1)
        wall[side == 3] = np.stack([np.zeros(np.sum(side == 3)), frac[side == 3]], -1)

        iface_x = np.where(rng.uniform(size=n_iface) < 0.5, lo, hi)
        iface = np.stack([iface_x, rng.uniform(0, extent, size=n_iface)], -1)
        pts_b = np.concatenate([wall, iface])
        zone_b = np.zeros((n_boundary, 1))

        pts = np.concatenate([pts_i, pts_b])
        zones = np.concatenate([zone_i, zone_b])
        u, p, forcing = manufactured_fields(pts, zones, nu, d, f)

        # SDF feature: distance to the nearest boundary point, max-normalized,
        # negative on the porous side
        dist = np.linalg.norm(pts[:, None, :] - pts_b[None, :, :], axis=-1)
        sdf = np.min(dist, axis=-1)
        sdf = sdf / np.max(sdf)
        sign = np.ones_like(sdf)
        sign[:n_internal] = (0.5 - zone_i[:, 0]) * 2
        sdf = (sdf * sign)[:, None]

        bid = np.zeros((len(pts), 2))
        bid[n_internal:n_internal + n_wall, 0] = 1.0
        bid[n_internal + n_wall:, 1] = 1.0

        data = np.concatenate([pts, zones, forcing, u, p, sdf, bid], axis=-1).astype(np.float32)
        domain = {
            "internal": np.arange(n_internal),
            "boundary": np.arange(n_boundary) + n_internal,
            "walls": np.arange(n_wall) + n_internal,
            "interface": np.arange(n_iface) + n_internal + n_wall,
        }
        return data, domain

    cases = [one_case() for _ in range(batch_size)]
    data = np.stack([c[0] for c in cases])
    domain = {k: torch.from_numpy(np.stack([c[1][k] for c in cases])) for k in cases[0][1]}
    return FoamData(torch.from_numpy(data), MANUFACTURED_LABELS, domain)
