"""Write the eleven primitive 2D porous-shape meshes (counterpart of
``tools/make_mesh_assets.py``).

    python -m porous_cfd_tpu_torch.tools.make_mesh_assets DEST

Flat polygons in the z = 0 plane at unit-ish scale, each a triangle fan, as
OBJ files through ``datagen/mesh_ops.write_obj``: the same bytes as the
checked-in ``examples/duct_fixed_boundary/assets/meshes/standard/*.obj``.
DEST is required: the tool writes nowhere it is not told to. Needs no card.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.datagen import mesh_ops

NAMES = ("circle", "ellipse", "square", "rectangle", "equilateral_triangle",
         "equilateral_hexagon", "equilateral_octagon", "semi_circle", "circle_sector",
         "right_triangle", "rhombus")


def polygon(n, radius=0.05, start=0.0):
    a = start + np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([radius * np.cos(a), radius * np.sin(a), np.zeros_like(a)], -1)


def fan_faces(n):
    return [(0, i, i + 1) for i in range(1, n - 1)]


def primitives() -> dict:
    """Each primitive's vertices, by name."""
    return {
        "circle": polygon(64),
        "ellipse": polygon(64) * np.array([1.0, 0.6, 1.0]),
        "square": polygon(4, start=np.pi / 4),
        "rectangle": polygon(4, start=np.pi / 4) * np.array([1.4, 0.7, 1.0]),
        "equilateral_triangle": polygon(3, start=np.pi / 2),
        "equilateral_hexagon": polygon(6),
        "equilateral_octagon": polygon(8),
        "semi_circle": np.concatenate([polygon(33)[:17], [[0.0, 0.0, 0.0]]]),
        "circle_sector": np.concatenate([[[0.0, 0.0, 0.0]], polygon(65)[:17]]),
        "right_triangle": np.array([[0, 0, 0], [0.08, 0, 0], [0, 0.06, 0]], float),
        "rhombus": np.array([[0.05, 0, 0], [0, 0.03, 0], [-0.05, 0, 0], [0, -0.03, 0]], float),
    }


def main(argv=None) -> list:
    """Write the primitives into DEST; returns their paths."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dest")
    dest = Path(p.parse_args(argv).dest)
    dest.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, verts in primitives().items():
        path = dest / f"{name}.obj"
        mesh_ops.write_obj(path, verts, fan_faces(len(verts)))
        paths.append(path)
    print(f"wrote {len(paths)} primitives to {dest}", flush=True)
    return paths


if __name__ == "__main__":
    main()
