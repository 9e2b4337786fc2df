"""A headless render smoke job over the port's 3D plots and the Blender mesh
workflow (counterpart of ``tools/render_smoke.py``).

    python -m porous_cfd_tpu_torch.tools.render_smoke --out DIR

Where PyVista is installed it renders off-screen, with screenshots under
DIR: ``viz/viz3d.plot_orthogonal_slices`` and ``plot_3d_streamlines`` on a
synthetic duct field on a regular grid (no OpenFOAM mesh needed), and
``plot_houses`` with the checked-in windbreaks house mesh. Where
Blender-as-module is installed (``datagen/mesh_ops.require_bpy``) it runs a
boolean union and a voxel remesh, the mesh operations of the generators.
A package that is not installed prints its ``SKIP`` line; one that is
installed and fails sets the exit code to 1. Where neither is installed
(the card's machine has neither) it prints two ``SKIP`` lines and renders
nothing.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
HOUSE = ROOT / "examples/windbreaks/assets/meshes/standard/houses/house_0.obj"


def smoke_pyvista(out: Path) -> str:
    try:
        import pyvista as pv
    except ImportError:
        return "SKIP (pyvista not installed)"

    from porous_cfd_tpu_torch.viz import viz3d

    # a synthetic duct field on a regular grid, named as _interpolated_mesh names it
    grid = pv.ImageData(dimensions=(40, 24, 24), spacing=(0.025, 0.025, 0.025),
                        origin=(-0.4, -0.3, -0.3))
    pts = np.asarray(grid.points)
    r2 = pts[:, 1] ** 2 + pts[:, 2] ** 2
    u = np.stack([0.2 * (1 - r2 / 0.18) * (1 - 0.5 * np.exp(-((pts[:, 0] - 0.1) ** 2) / 0.01)),
                  0.02 * pts[:, 1], 0.02 * pts[:, 2]], axis=-1)
    grid["Uinterp"] = u
    grid["pinterp"] = 0.9 - pts[:, 0]

    plotter = pv.Plotter(shape=(2, 3), off_screen=True, window_size=[1200, 800])
    inlet_pts = pts[np.abs(pts[:, 0] + 0.4) < 1e-6]
    plotter.subplot(0, 0)
    viz3d.plot_3d_streamlines(grid, inlet_pts, plotter)
    viz3d.plot_orthogonal_slices(grid, "Uinterp", "U", (0.1, 0.0, 0.0), plotter, (1, 0))
    plotter.show(screenshot=str(out / "slices_streamlines.png"))

    viz3d.plot_houses("house_errors", pts[::37, :], u[::37] * 0.01,
                      (0.9 - pts[::37, 0]) * 0.01, HOUSE, save_path=str(out))
    return "OK (slices, streamlines, houses rendered)"


def smoke_bpy(out: Path) -> str:
    try:
        import bpy  # noqa: F401
    except ImportError:
        return "SKIP (bpy not installed)"

    from porous_cfd_tpu_torch.datagen.mesh_ops import require_bpy
    b = require_bpy()
    import bmesh

    b.ops.wm.read_factory_settings(use_empty=True)
    b.ops.mesh.primitive_cube_add(size=1.0, location=(0, 0, 0))
    cube = b.context.active_object
    b.ops.mesh.primitive_uv_sphere_add(radius=0.6, location=(0.4, 0, 0))
    sphere = b.context.active_object
    mod = cube.modifiers.new("union", "BOOLEAN")
    mod.operation = "UNION"
    mod.object = sphere
    b.context.view_layer.objects.active = cube
    b.ops.object.modifier_apply(modifier="union")
    remesh = cube.modifiers.new("remesh", "REMESH")
    remesh.mode = "VOXEL"
    remesh.voxel_size = 0.1
    b.ops.object.modifier_apply(modifier="remesh")
    bm = bmesh.new()
    bm.from_mesh(cube.data)
    n_verts = len(bm.verts)
    bm.free()
    return f"OK (boolean + voxel remesh -> {n_verts} verts)"


def main(argv=None) -> int:
    """Run both smokes; returns the exit code (1 if an installed package
    failed)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="directory for the screenshots")
    out = Path(p.parse_args(argv).out)
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    for name, fn in (("pyvista", smoke_pyvista), ("bpy", smoke_bpy)):
        try:
            print(f"{name}: {fn(out)}", flush=True)
        except Exception:  # an installed package that fails: report it and go on
            failed = True
            print(f"{name}: FAILED", flush=True)
            traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
