"""3D field visualization (the port's counterpart of
``porous_cfd_tpu/viz/viz3d.py``). The reference renders with PyVista;
PyVista is optional here as in the JAX module: when installed the same plot
set is produced (scatter fields, orthogonal slice panels, inlet-seeded
streamlines, house-surface renders); otherwise matplotlib-3D scatters cover
the scatter and field plots, and the mesh renders raise.

Geometry decisions that affect the physics reading of the plots (which inlet
points seed the streamlines, where the slice planes sit) are pure numpy
helpers, tested without PyVista. matplotlib is imported inside the
functions that draw.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.viz.common import M2_S2, M_S, plot_or_save

try:  # optional dependency
    import pyvista  # noqa: F401
    HAS_PYVISTA = True
except ImportError:  # pragma: no cover
    HAS_PYVISTA = False

N_STREAM_SEEDS = 250


# -- pure-numpy helpers (tested without pyvista) ------------------------------

def inlet_seed_points(inlet_points: np.ndarray, k: int = N_STREAM_SEEDS,
                      rng: np.random.Generator | None = None) -> np.ndarray:
    """Streamline seeds: the inlet-patch points on its upstream (min-x) face,
    resampled to k points with replacement (visualization_3d.py:100-103 uses
    ``random.choices`` over the same subset)."""
    pts = np.asarray(inlet_points, dtype=np.float64)
    upstream = pts[pts[:, 0] == pts[:, 0].min()]
    if rng is None:
        rng = np.random.default_rng(8421)
    return upstream[rng.integers(0, len(upstream), size=k)]


def slice_origin(additional_meshes: list, default_z: float = 1.0) -> tuple:
    """Slice-plane origin: x=y=0, z at the first solid object's center so the
    planes cut through the obstacle (visualization_3d.py:170)."""
    if additional_meshes:
        return (0.0, 0.0, float(additional_meshes[0][0].center[2]))
    return (0.0, 0.0, default_z)


def camera_position(points: np.ndarray,
                    direction=(-0.8, -1.0, 0.5)) -> np.ndarray:
    """Isometric-ish camera placement scaled to the cloud extent
    (visualization_3d.py:32)."""
    r = float(np.max(np.linalg.norm(np.asarray(points), axis=-1)))
    return np.asarray(direction) * r * 2.5


# -- matplotlib paths ----------------------------------------------------------

def _scatter3d(ax, points, values, title, cmap="coolwarm"):
    sc = ax.scatter(points[:, 0], points[:, 1], points[:, 2],
                    c=np.asarray(values).flatten(), cmap=cmap, s=4)
    ax.set_title(title)
    return sc


def plot_scatter_field(title, points, values, save_path=None):
    """Single 3D scatter field (visualization_3d.py:16-34)."""
    if HAS_PYVISTA:
        return _pv_scatter(title, points, values, save_path)
    from matplotlib import pyplot as plt
    fig = plt.figure(figsize=(10, 8))
    fig.suptitle(title)
    ax = fig.add_subplot(projection="3d")
    sc = _scatter3d(ax, np.asarray(points), values, title)
    fig.colorbar(sc, shrink=0.6)
    plot_or_save(fig, save_path)


def plot_fields_3d(title, points, u, p, save_path=None):
    """4-panel 3D scatter (visualization_3d.py:212-237)."""
    from matplotlib import pyplot as plt
    points, u, p = np.asarray(points), np.asarray(u), np.asarray(p)
    fig = plt.figure(figsize=(16, 12))
    fig.suptitle(title, fontsize=20)
    panels = [(f"$u_x {M_S}$", u[:, 0]), (f"$u_y {M_S}$", u[:, 1]),
              (f"$p {M2_S2}$", p), (f"$U {M_S}$", np.linalg.norm(u, axis=1))]
    for i, (name, vals) in enumerate(panels):
        ax = fig.add_subplot(2, 2, i + 1, projection="3d")
        sc = _scatter3d(ax, points, vals, name)
        fig.colorbar(sc, shrink=0.5)
    plot_or_save(fig, save_path)


def plot_slices(title, points, values, axis=2, n_slices=3, save_path=None):
    """Scatter slice panels: the matplotlib stand-in for the orthogonal-slice
    renderer when PyVista is unavailable."""
    from matplotlib import pyplot as plt
    points, values = np.asarray(points), np.asarray(values).flatten()
    coords = points[:, axis]
    edges = np.quantile(coords, np.linspace(0, 1, n_slices + 1))
    other = [i for i in range(3) if i != axis]
    fig, axs = plt.subplots(1, n_slices, figsize=(5 * n_slices, 5))
    fig.suptitle(title)
    for i, ax in enumerate(np.atleast_1d(axs)):
        sel = (coords >= edges[i]) & (coords <= edges[i + 1])
        sc = ax.scatter(points[sel, other[0]], points[sel, other[1]],
                        c=values[sel], cmap="coolwarm", s=6)
        ax.set_title(f"slice {i}")
        ax.set_aspect("equal")
        fig.colorbar(sc, ax=ax)
    plot_or_save(fig, save_path)


def plot_surface_errors(title, surface_points, errors, save_path=None):
    """Per-surface-point error scatter (the matplotlib path of the house
    plots; plot_houses is the PyVista mesh render)."""
    plot_scatter_field(title, surface_points, errors, save_path)


# -- pyvista-backed implementations -------------------------------------------

def _pv_scatter(title, points, values, save_path,
                plotter=None):  # pragma: no cover - needs pyvista
    import pyvista as pv
    cloud = pv.PolyData(np.asarray(points, np.float64))
    cloud[title] = np.asarray(values).flatten()
    own_plotter = plotter is None
    if own_plotter:
        plotter = pv.Plotter(off_screen=save_path is not None)
    plotter.add_mesh(cloud, scalars=title, cmap="coolwarm", point_size=5.0,
                     scalar_bar_args={"title": title, "vertical": True,
                                      "position_y": 0.25, "height": 0.5})
    plotter.show_grid(all_edges=True)
    plotter.camera.position = camera_position(points)
    plotter.camera.zoom(0.75)
    plotter.disable_shadows()
    if own_plotter:
        _show(plotter, title, save_path)


def _show(plotter, title, save_path):  # pragma: no cover - needs pyvista
    if save_path is not None:
        plotter.show(screenshot=f"{save_path}/{title}.png")
    else:
        plotter.show()


def read_case_mesh(case_path):  # pragma: no cover - needs pyvista
    """Open an OpenFOAM case at its final time with point data
    (visualization_3d.py:148-155): PyVista's reader needs an empty ``.foam``
    stub file inside the case directory."""
    import pyvista as pv
    stub = Path(case_path) / "empty.foam"
    stub.touch()
    try:
        reader = pv.OpenFOAMReader(str(stub))
        reader.set_active_time_value(reader.time_values[-1])
        reader.cell_to_point_creation = True
        return reader.read()
    finally:
        stub.unlink(missing_ok=True)


def _interpolated_mesh(mesh, points, u, p,
                       interp_radius):  # pragma: no cover - needs pyvista
    import pyvista as pv
    cloud = pv.PolyData(np.asarray(points, np.float64))
    cloud["Uinterp"] = np.asarray(u)
    if p is not None:
        cloud["pinterp"] = np.asarray(p).reshape(len(cloud.points), -1)
    return mesh["internalMesh"].interpolate(cloud, radius=interp_radius)


def plot_orthogonal_slices(mesh, field, label, origin, plotter, grid_pos,
                           solids=()):  # pragma: no cover - needs pyvista
    """Three axis-aligned slices of ``field`` through ``origin``, one subplot
    per plane, with solid-object outlines overlaid (visualization_3d.py:37-84).

    ``solids`` is a sequence of (dataset, color) pairs; each is sliced by the
    same planes and drawn as thick black contours.
    """
    slices = mesh.slice_orthogonal(x=origin[0], y=origin[1], z=origin[2])
    solid_slices = [s.slice_orthogonal(x=origin[0], y=origin[1], z=origin[2])
                    for s, _ in solids]
    row, col = grid_pos
    for i, plane in enumerate(("yz", "xz", "xy")):
        plotter.subplot(row, col + i)
        title = f"${label}_{{{plane}}} \\quad {M_S}$"
        plotter.add_mesh(slices[i], cmap="coolwarm", scalars=field,
                         lighting=False,
                         scalar_bar_args={"title": title, "position_x": 0.25,
                                          "height": 0.05, "width": 0.5})
        for ss in solid_slices:
            if len(ss[i].points) > 0:
                plotter.add_mesh(ss[i], color="black", line_width=5)
        plotter.enable_parallel_projection()
        getattr(plotter, f"view_{plane}")()
        plotter.show_bounds(location="outer", xtitle="X", ytitle="Y",
                            ztitle="z")
        plotter.disable_shadows()


def plot_3d_streamlines(interp_mesh, inlet_points, plotter,
                        solids=()):  # pragma: no cover - needs pyvista
    """Velocity streamlines seeded at the inlet's upstream face
    (visualization_3d.py:87-119)."""
    import pyvista as pv
    seeds = pv.PointSet(inlet_seed_points(inlet_points))
    stream = interp_mesh.streamlines_from_source(seeds, vectors="Uinterp")
    plotter.add_mesh(stream, scalars="Uinterp", cmap="coolwarm", line_width=1,
                     lighting=False, render_lines_as_tubes=False,
                     scalar_bar_args={"title": f"$U \\quad {M_S}$",
                                      "position_x": 0.25, "height": 0.05,
                                      "width": 0.5})
    for solid, color in solids:
        plotter.add_mesh(solid, color=color)
    plotter.camera.position = camera_position(interp_mesh.points)
    plotter.camera.zoom(0.5)
    plotter.show_bounds(location="outer", xtitle="X", ytitle="Y", ztitle="z")


def plot_streamlines(title, case_path, points, u, p=None,
                     additional_meshes=None, save_path=None,
                     interp_radius=0.1):  # pragma: no cover - needs pyvista
    """Full streamline figure (visualization_3d.py:122-175): interpolate the
    sampled prediction onto the OpenFOAM mesh, then render inlet-seeded
    streamlines plus orthogonal U (and p, if given) slice panels in one
    2x4 grid. ``additional_meshes`` maps obj names under
    ``constant/triSurface/`` to PyVista colors."""
    if not HAS_PYVISTA:
        raise RuntimeError(
            "plot_streamlines requires pyvista; install it or use "
            "plot_fields_3d for the scatter fallback")
    import pyvista as pv
    mesh = read_case_mesh(case_path)
    solids = [(pv.get_reader(
        f"{case_path}/constant/triSurface/{name}.obj").read(), color)
        for name, color in (additional_meshes or {}).items()]
    interp = _interpolated_mesh(mesh, points, u, p, interp_radius)

    plotter = pv.Plotter(shape=(2, 4), off_screen=save_path is not None,
                         window_size=[4096, 3000])
    plotter.subplot(0, 0)
    plot_3d_streamlines(interp, np.asarray(mesh["boundary"]["inlet"].points),
                        plotter, solids)
    origin = slice_origin(solids)
    plot_orthogonal_slices(interp, "Uinterp", "U", origin, plotter, (0, 1),
                           solids)
    if p is not None:
        plot_orthogonal_slices(interp, "pinterp", "p", origin, plotter,
                               (1, 0), solids)
    _show(plotter, title, save_path)


def plot_houses(title, points, u, p, house_mesh_path,
                save_path=None):  # pragma: no cover - needs pyvista
    """House-surface error figure (visualization_3d.py:178-209): the house
    mesh rendered in 'oldlace' with |U| and p error scatters on top, side by
    side."""
    if not HAS_PYVISTA:
        raise RuntimeError("plot_houses requires pyvista; use "
                           "plot_surface_errors for the scatter fallback")
    import pyvista as pv
    house = pv.get_reader(str(house_mesh_path)).read()
    plotter = pv.Plotter(shape=(1, 2), off_screen=save_path is not None,
                         window_size=[3840, 1440])
    panels = [(f"U error ${M_S}$", np.linalg.norm(np.asarray(u), axis=1)),
              (f"p error ${M2_S2}$", np.asarray(p))]
    for i, (label, vals) in enumerate(panels):
        plotter.subplot(0, i)
        plotter.add_mesh(house, color="oldlace")
        plotter.camera.zoom(5)
        _pv_scatter(label, points, vals, save_path, plotter=plotter)
    _show(plotter, title, save_path)
