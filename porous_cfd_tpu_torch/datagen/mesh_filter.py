"""Pure-numpy mesh-filtering geometry used by the ABC preprocess (the port's
own copy of ``porous_cfd_tpu/datagen/mesh_filter.py``; reference
examples/abc/data_preprocess.py:125-186): connected-component
("loose part") detection, signed tetrahedral volume, and the
aspect/volume-ratio acceptance test. The Blender-dependent workflow lives in
examples/abc/data_preprocess.py and calls into these on extracted vertex/face
arrays, so the geometric semantics are testable without bpy."""
from __future__ import annotations

import numpy as np


def connected_components(n_verts: int, edges: np.ndarray) -> np.ndarray:
    """Vertex component labels from an (E, 2) edge list (union-find with path
    halving). Reference parity: has_multiple_islands walks edge connectivity
    (data_preprocess.py:125-149); here every component is labeled so callers
    can also split parts."""
    parent = np.arange(n_verts, dtype=np.int64)

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.fromiter((find(i) for i in range(n_verts)), dtype=np.int64,
                        count=n_verts)
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def has_multiple_islands(n_verts: int, edges: np.ndarray) -> bool:
    """True when the vertex graph has more than one connected component
    (loose parts). Isolated vertices count as their own component, matching
    the reference's unseen-set walk."""
    if n_verts <= 1:
        return False
    return int(connected_components(n_verts, edges).max()) > 0


def mesh_volume(verts: np.ndarray, faces: np.ndarray) -> float:
    """Signed volume as the sum of origin-anchored tetrahedra over triangles
    (reference get_volume, data_preprocess.py:152-173; overlapping faces are
    not compensated there either). ``faces`` is (F, 3) indices; triangulate
    first for polygonal input."""
    v = np.asarray(verts, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64)
    if f.size == 0:
        return 0.0
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


def triangulate_fan(faces: list[np.ndarray] | list[list[int]]) -> np.ndarray:
    """Fan-triangulate polygon faces -> (F, 3) index array (Blender's
    bmesh.ops.triangulate equivalent for convex faces)."""
    tris = []
    for poly in faces:
        poly = np.asarray(poly, dtype=np.int64)
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
    return (np.asarray(tris, dtype=np.int64) if tris
            else np.zeros((0, 3), np.int64))


def bbox_dimensions(verts: np.ndarray) -> np.ndarray:
    v = np.asarray(verts, dtype=np.float64)
    if v.size == 0:
        return np.zeros(3)
    return v.max(axis=0) - v.min(axis=0)


def is_mesh_good(verts: np.ndarray, faces: np.ndarray,
                 min_aspect: float, min_volume_ratio: float) -> bool:
    """Acceptance test for snappyHexMesh suitability (reference
    is_object_good, data_preprocess.py:176-186): bounding box must have
    positive volume, the min/max bbox-dimension aspect must exceed
    ``min_aspect`` (rejects degenerate plates/needles), and the enclosed
    volume must fill more than ``min_volume_ratio`` of the bbox (rejects
    wire-frame-like shells)."""
    dims = bbox_dimensions(verts)
    bbox_volume = float(dims[0] * dims[1] * dims[2])
    if bbox_volume <= 0:
        return False
    aspect = float(dims.min() / dims.max())
    volume_ratio = mesh_volume(verts, faces) / bbox_volume
    return aspect > min_aspect and volume_ratio > min_volume_ratio
