"""2D field visualization (the port's counterpart of
``porous_cfd_tpu/viz/viz2d.py``): triangulated contour plots and
streamplots. matplotlib is imported inside the functions that draw."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data import parser
from porous_cfd_tpu_torch.viz.common import M2_S2, M_S, plot_or_save


def add_colorbar(fig, ax, plot):
    from mpl_toolkits.axes_grid1 import make_axes_locatable
    divider = make_axes_locatable(ax)
    cax = divider.append_axes("right", size="3%", pad=0.05)
    fig.colorbar(plot, cax=cax)


def mask_triangulation(triangulation, mask, points):
    """Mask triangles whose centers fall inside rectangular bounding boxes
    [(bottom, left), (top, right)] (visualization_2d.py:26-41)."""
    full = np.full(len(triangulation.triangles), False)
    centers = points[triangulation.triangles].mean(axis=1)
    for m in mask:
        inside = np.logical_and(centers > np.asarray(m[0]),
                                centers < np.asarray(m[1])).all(-1)
        full |= inside
    triangulation.set_mask(full)


def plot_scalar_field(title, points, value, porous_id, fig, ax, mask=None):
    """Refined tricontour of a scalar field with porous points highlighted
    (visualization_2d.py:44-83)."""
    from matplotlib import tri
    ax.set_title(title, pad=20)
    porous = np.nonzero(np.asarray(porous_id).flatten() > 0)[0]
    ax.scatter(points[porous, 0], points[porous, 1], marker="o", s=25, zorder=1,
               c="#00000000", label="Porous", edgecolors="black")
    ax.scatter(points[:, 0], points[:, 1], s=5, zorder=1, c="black",
               label="Collocation")
    triangulation = tri.Triangulation(points[:, 0], points[:, 1])
    if mask:
        mask_triangulation(triangulation, mask, points)
    refiner = tri.UniformTriRefiner(triangulation)
    tri_pts, tri_field = refiner.refine_field(np.asarray(value).flatten(),
                                              subdiv=3)
    plot = ax.tricontourf(tri_pts, tri_field, levels=100, zorder=-1,
                          cmap="coolwarm")
    ax.set_ymargin(0.025)
    ax.set_xmargin(0.02)
    add_colorbar(fig, ax, plot)
    ax.legend(loc="upper right")
    ax.set_aspect("equal")


def plot_uneven_stream(title, points, field, fig, ax, mask=None):
    """Streamplot from scattered data via nearest-grid interpolation
    (visualization_2d.py:86-136)."""
    from matplotlib import tri
    from scipy.interpolate import griddata
    ax.set_title(title, pad=20)
    triangulation = tri.Triangulation(points[:, 0], points[:, 1])
    if mask:
        mask_triangulation(triangulation, mask, points)
    refiner = tri.UniformTriRefiner(triangulation)
    tri_pts, tri_field = refiner.refine_field(
        np.linalg.norm(field, axis=1).flatten())
    plot = ax.tricontourf(tri_pts, tri_field, levels=100, zorder=-1,
                          cmap="coolwarm")
    xx = np.linspace(points[:, 0].min(), points[:, 0].max(), 50)
    yy = np.linspace(points[:, 1].min(), points[:, 1].max(), 50)
    xi, yi = np.meshgrid(xx, yy)
    g_x = griddata(points, field[:, 0].flatten(), (xi, yi), method="nearest")
    g_y = griddata(points, field[:, 1].flatten(), (xi, yi), method="nearest")
    if mask:
        grid = np.stack([xi.flatten(), yi.flatten()], axis=-1)
        full = np.full(len(grid), False)
        for m in mask:
            full |= np.logical_and(grid > np.asarray(m[0]),
                                   grid < np.asarray(m[1])).all(-1)
        full = full.reshape(xi.shape)
        g_x[full] = np.nan
        g_y[full] = np.nan
    ax.streamplot(xx, yy, g_x, g_y, color="black", density=2, zorder=1)
    ax.set_ymargin(0)
    add_colorbar(fig, ax, plot)
    ax.set_aspect("equal")


def plot_fields(title, points, u, p, porous_id, plot_streams=True,
                save_path=None, mask=None):
    """4-panel Ux/Uy/p/U figure (visualization_2d.py:139-183); the last panel
    is streamlines or |U| contours (useful for error fields)."""
    from matplotlib import pyplot as plt
    points, u, p = (np.asarray(points), np.asarray(u), np.asarray(p))
    size = [np.ptp(points[:, 0]), np.ptp(points[:, 1])]
    m = max(size)
    fig = plt.figure(figsize=(16 * size[0] / m * 1.1, 16 * size[1] / m),
                     layout="constrained")
    fig.suptitle(title, fontsize=20)
    ax_ux, ax_uy, ax_p, ax_u = fig.subplots(2, 2).flatten()
    plot_scalar_field(f"$p {M2_S2}$", points, p, porous_id, fig, ax_p, mask)
    plot_scalar_field(f"$u_x {M_S}$", points, u[:, 0], porous_id, fig, ax_ux,
                      mask)
    plot_scalar_field(f"$u_y {M_S}$", points, u[:, 1], porous_id, fig, ax_uy,
                      mask)
    if plot_streams:
        plot_uneven_stream(f"$U {M_S}$", points, u, fig, ax_u, mask)
    else:
        plot_scalar_field(f"$U {M_S}$", points, np.linalg.norm(u, axis=1),
                          porous_id, fig, ax_u, mask)
    plot_or_save(fig, save_path)


def plot_case(path, save_path=None):
    """Plot an OpenFOAM case directly (visualization_2d.py:186-200)."""
    internal, patches = parser.parse_case_fields(path, "C", "U", "p",
                                                 "cellToRegion", max_dim=2)
    pts = np.concatenate([internal["C"]] + [t["C"] for t in patches.values()])
    u = np.concatenate([internal["U"]] + [t["U"] for t in patches.values()])
    p = np.concatenate([internal["p"]] + [t["p"] for t in patches.values()])
    zone = np.concatenate([internal["cellToRegion"]]
                          + [t["cellToRegion"] for t in patches.values()])
    plot_fields(Path(path).stem, pts[:, :2], u[:, :2], p, zone,
                save_path=save_path)
