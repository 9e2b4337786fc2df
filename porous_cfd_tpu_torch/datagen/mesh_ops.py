"""Mesh utilities: OBJ IO and linear transforms, Blender-free where possible
(the port's own copy of ``porous_cfd_tpu/datagen/mesh_ops.py``).

The reference does all mesh work through Blender's ``bpy`` (imported
unconditionally, datagen/data_generator.py:12-14). Here the operations that are
pure linear algebra — OBJ parsing, rotation/scale augmentation, center-of-mass
inside points (datagen/data_generator.py:259-273) — are implemented in numpy so
the standard 2D augmentation pipeline runs without Blender; boolean union /
remesh operations (the 'hard' and windbreaks generators) still require bpy and
are gated behind :func:`require_bpy`.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np


def require_bpy():
    """Import bpy or fail with an actionable message (boolean/remesh ops)."""
    try:
        import bpy  # noqa: F401
        return bpy
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "This mesh operation (boolean union / remesh / inside-point ray "
            "casting) requires Blender-as-module (bpy), which is not installed "
            "in this environment. Linear augmentations run without it.") from e


def read_obj(path: str | Path):
    """Parse vertices (V, 3) and faces (list of index tuples, 0-based)."""
    verts, faces = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            faces.append(tuple(int(p.split("/")[0]) - 1 for p in parts[1:]))
    return np.asarray(verts, np.float64), faces


def write_obj(path: str | Path, verts: np.ndarray, faces) -> None:
    lines = ["# porous_cfd_tpu mesh"]
    lines += [f"v {v[0]} {v[1]} {v[2]}" for v in verts]
    lines += ["f " + " ".join(str(i + 1) for i in f) for f in faces]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def transform_verts(verts: np.ndarray, scale=(1.0, 1.0, 1.0),
                    rotation_z_deg: float = 0.0,
                    offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Scale, rotate about Z (degrees, negative like the reference's
    ``radians(-r)``), then translate."""
    v = verts * np.asarray(scale)
    a = math.radians(-rotation_z_deg)
    rot = np.array([[math.cos(a), -math.sin(a), 0.0],
                    [math.sin(a), math.cos(a), 0.0],
                    [0.0, 0.0, 1.0]])
    return v @ rot.T + np.asarray(offset)


def center_of_mass(path_or_verts) -> np.ndarray:
    """Vertex centroid — the reference's convex inside-point
    (data_generator.py:259-273)."""
    verts = (read_obj(path_or_verts)[0]
             if isinstance(path_or_verts, (str, Path)) else path_or_verts)
    return np.sum(verts, axis=0) / len(verts)


def grid_inside_point(path: str | Path, resolution: int = 20) -> np.ndarray:
    """Deepest interior point of a (possibly concave) closed triangle mesh
    (generator_3d.py:22-55 semantics, Blender-free): probe a uniform grid,
    classify inside via the nearest-surface-normal dot test, return the
    point with maximum surface distance."""
    verts, faces = read_obj(path)
    tris = np.asarray([[verts[i] for i in f[:3]] for f in faces])
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    axes = [np.linspace(lo[i], hi[i], resolution) for i in range(3)]
    g = np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, 3)

    closest, normals = _closest_points_on_tris(g, tris)
    direction = closest - g
    dist = np.linalg.norm(direction, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        unit = direction / dist[:, None]
    dot = np.sum(normals * unit, axis=-1)
    inside = dot > 0.5
    if not np.any(inside):
        return center_of_mass(verts)
    sel = np.argmax(np.where(inside, dist, -np.inf))
    return g[sel]


def _closest_points_on_tris(points: np.ndarray, tris: np.ndarray):
    """Closest point on any triangle for each query point, with the owning
    triangle's (outward) normal. Vectorized over points x triangles."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    n = np.cross(b - a, c - a)
    n_unit = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)

    best_d = np.full(len(points), np.inf)
    best_p = np.zeros_like(points)
    best_n = np.zeros_like(points)
    for t in range(len(tris)):
        p = _closest_on_triangle(points, a[t], b[t], c[t])
        d = np.linalg.norm(p - points, axis=-1)
        upd = d < best_d
        best_d[upd] = d[upd]
        best_p[upd] = p[upd]
        best_n[upd] = n_unit[t]
    return best_p, best_n


def _closest_on_triangle(p: np.ndarray, a, b, c) -> np.ndarray:
    """Closest point on triangle abc for each p (Ericson's method,
    vectorized)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = ap @ ab, ap @ ac
    bp, cp = p - b, p - c
    d3, d4 = bp @ ab, bp @ ac
    d5, d6 = cp @ ab, cp @ ac

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-30)
    v = np.clip(vb / denom, 0, 1)
    w = np.clip(vc / denom, 0, 1)
    out = a + v[:, None] * ab + w[:, None] * ac

    # vertex/edge regions
    out = np.where((d1 <= 0)[:, None] & (d2 <= 0)[:, None], a, out)
    out = np.where((d3 >= 0)[:, None] & (d4 <= d3)[:, None], b, out)
    out = np.where((d6 >= 0)[:, None] & (d5 <= d6)[:, None], c, out)
    t_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.where(
        d1 - d3 == 0, 1, d1 - d3), 0), 0, 1)
    on_ab = (d1 >= 0) & (d3 <= 0) & (vc <= 0)
    out = np.where(on_ab[:, None], a + t_ab[:, None] * ab, out)
    t_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.where(
        d2 - d6 == 0, 1, d2 - d6), 0), 0, 1)
    on_ac = (d2 >= 0) & (d6 <= 0) & (vb <= 0)
    out = np.where(on_ac[:, None], a + t_ac[:, None] * ac, out)
    t_bc = np.clip(np.where((d4 - d3) + (d5 - d6) != 0,
                            (d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-30),
                            0), 0, 1)
    on_bc = (d4 - d3 >= 0) & (d5 - d6 >= 0) & (va <= 0)
    out = np.where(on_bc[:, None], b + t_bc[:, None] * (c - b), out)
    return out
