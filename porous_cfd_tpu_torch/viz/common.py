"""Shared plotting utilities (the port's counterpart of
``porous_cfd_tpu/viz/common.py``): distributions, error bars, timing
comparisons, heatmaps, the same plot inventory on the port's own numpy
parsers.

matplotlib is imported inside the functions that draw, never when a module
of the port is imported: the card's machine has no matplotlib, and only
``--save-plots`` draws. ``require_matplotlib`` is the check the CLIs make
before they predict anything.
"""
from __future__ import annotations

import glob
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data import parser

M_S = r"\left[ \frac{m}{s} \right]"
M2_S2 = r"\left[ \frac{m^2}{s^2} \right]"

LIGHT_COLORS = ["lightblue", "lightcoral", "bisque", "lightgreen", "lightgrey",
                "lightsalmon", "moccasin", "powderblue", "lavender", "thistle",
                "lightpink"]


def require_matplotlib():
    """matplotlib, imported; an ``ImportError`` that names it when the
    machine has none (``--save-plots`` draws with it and never carries on
    without the plots)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--save-plots needs matplotlib, which this machine does not "
                          "have: run without --save-plots") from e
    return matplotlib


def plot_or_save(fig, save_path):
    """Save the figure as <title>.png under save_path, or show when None
    (visualization/common.py:28-43)."""
    from matplotlib import pyplot as plt
    if fig._suptitle is not None:
        name = fig._suptitle.get_text()
    else:
        name = fig.axes[0].get_title()
    if save_path is not None:
        fig.savefig(f"{save_path}/{name}.png", transparent=True, dpi=150)
        plt.close(fig)
    else:
        plt.show()


def get_fields_names(f: np.ndarray) -> list[str]:
    """Field names for (.., D) data, velocities-then-pressure convention."""
    return ["$U_x$", "$U_y$", "$U_z$"][:np.shape(f)[-1] - 1] + ["$p$"]


def plot_histogram(ax, data, color, title, bins="doane"):
    ax.set_title(title, pad=10)
    ax.hist(np.asarray(data).flatten(), bins=bins, color=color,
            edgecolor="black")


def plot_data_dist(title, u, p, zones_ids=None, save_path=None):
    """Velocity/pressure/zone distributions (common.py:79-105)."""
    from matplotlib import pyplot as plt
    fig = plt.figure(layout="constrained")
    fig.suptitle(title, fontsize=20)
    ax_ux, ax_uy, ax_uz, ax_p, ax_zones, _ = fig.subplots(2, 3).flatten()
    u, p = np.asarray(u), np.asarray(p)
    plot_histogram(ax_ux, u[..., 0], "lightsteelblue", "$U_x$")
    plot_histogram(ax_uy, u[..., 1], "lemonchiffon", "$U_y$")
    if u.shape[-1] > 2:
        plot_histogram(ax_uz, u[..., 2], "thistle", "$U_z$")
    plot_histogram(ax_p, p, "lightsalmon", "$p$")
    if zones_ids is not None:
        plot_histogram(ax_zones, zones_ids, "palegreen", "Material zones", 2)
    else:
        plot_histogram(ax_zones, np.linalg.norm(u, axis=-1), "palegreen", "$U$")
    plot_or_save(fig, save_path)


def plot_dataset_dist(path, save_path=None):
    """Whole-split field distributions + box plot (common.py:59-76)."""
    us, ps, zs = [], [], []
    for case in sorted(glob.glob(f"{path}/*/")):
        internal, patches = parser.parse_case_fields(case, "U", "p",
                                                     "cellToRegion")
        us.append(np.concatenate([internal["U"]]
                                 + [t["U"] for t in patches.values()]))
        ps.append(np.concatenate([internal["p"]]
                                 + [t["p"] for t in patches.values()]))
        zs.append(np.concatenate([internal["cellToRegion"]]
                                 + [t["cellToRegion"] for t in patches.values()]))
    u, p, z = np.concatenate(us), np.concatenate(ps), np.concatenate(zs)
    plot_data_dist(f"{Path(path).name} distribution", u, p, z, save_path)
    box_plot("Fields boxplot", [*np.hsplit(u, u.shape[-1]), p],
             get_fields_names(np.zeros(u.shape[-1] + 1)), save_path)


BAR_W = 0.01  # thin bars; value readability comes from the printed labels


def plot_barh(ax, title, values, labels, colors, spacing=BAR_W, offset=0.0):
    """A row of labeled horizontal bars (scientific-notation annotations,
    hidden y axis, two-column legend). Output contract of common.py:108-126."""
    rows = offset + spacing * np.arange(len(values))
    bars = ax.barh(rows, values, BAR_W, label=labels, color=colors)
    ax.bar_label(bars, fmt="%.2e", padding=10)
    # leave ~30% headroom so the annotations fit inside the axes
    ax.set_xlim(right=1.3 * max(values))
    ax.set_yticks([])
    ax.set_title(title, pad=10)
    ax.legend(ncols=2)


def plot_timing(total, average, save_path=None):
    """PINN vs OpenFOAM total/average solve time bars (common.py:129-147);
    PINN first in each list."""
    from matplotlib import pyplot as plt
    fig = plt.figure()
    ax_total, ax_avg = fig.subplots(2)
    colors, labels = ["salmon", "lightblue"], ["PINN", "OpenFoam"]
    plot_barh(ax_total, "Total simulation time [s]", total, labels, colors)
    plot_barh(ax_avg, "Average simulation time [s per case]", average, labels,
              colors)
    fig.tight_layout()
    plot_or_save(fig, save_path)


def plot_errors(title, values, save_path=None):
    """Per-field horizontal error bars (common.py:150-166)."""
    from matplotlib import pyplot as plt
    fig, ax = plt.subplots()
    values = list(np.asarray(values).flatten())
    colors = ["salmon", "lightblue", "palegreen"]
    labels = [f"$U_x {M_S}$", f"$U_y {M_S}$", f"$p {M2_S2}$"]
    if len(values) > 3:
        colors.append("moccasin")
        labels.insert(-1, f"$U_z {M_S}$")
    plot_barh(ax, title, values, labels, colors)
    fig.tight_layout()
    plot_or_save(fig, save_path)


def plot_multi_bar(title, values: dict, values_labels, save_path=None):
    """Grouped comparison bars (common.py:169-192)."""
    from matplotlib import pyplot as plt
    fig, ax = plt.subplots(figsize=(max(4, len(values_labels) * len(values)), 5))
    ax.set_title(title, pad=10)
    w = 0.01
    n_groups = len(values)
    x = np.array([i * w * (n_groups + 1) for i in range(len(values_labels))])
    for i, (k, v) in enumerate(values.items()):
        rects = ax.bar(x + w * i, v, w, label=k, color=LIGHT_COLORS[i])
        ax.bar_label(rects, fmt="%.2e", padding=10)
    ax.legend()
    ax.set_ylim(0, max(max(d) for d in values.values()) * 1.1 + 1e-12)
    ax.set_xticks(x + w / 2 * (n_groups - 1), values_labels)
    fig.tight_layout()
    plot_or_save(fig, save_path)


def annotate_stats(ax, samples):
    """Small mean/std box in the upper-right corner of ``ax``."""
    text = (f"Mean: {np.mean(samples):.2f}\n"
            f"Std: {np.std(samples, ddof=1):.2f}")
    ax.annotate(text, xy=(0.985, 0.94), xycoords="axes fraction",
                ha="right", va="top", fontsize=8,
                bbox={"boxstyle": "round", "facecolor": "white",
                      "alpha": 0.5})


def plot_u_direction_change(data_dir, save_path=None):
    """Dataset-difficulty figure: per-case bar chart + histogram (with a
    mean/std box) of the case-average mag(grad(Unorm)) field
    (common.py:195-224)."""
    from matplotlib import pyplot as plt
    cases = sorted(glob.glob(f"{data_dir}/*/"))
    means = [float(np.mean(
        parser.parse_internal_fields(c, "mag(grad(Unorm))")["mag(grad(Unorm))"]
    )) for c in cases]

    fig = plt.figure(layout="constrained")
    per_case, hist = fig.subplots(2, 1)
    per_case.bar(range(len(means)), means, color="lightblue")
    per_case.set(xticks=[], ylabel="U direction change")
    per_case.set_title("Average U direction change per case", pad=10)
    plot_histogram(hist, means, "salmon",
                   "Average U direction change distribution", 20)
    annotate_stats(hist, means)
    hist.set(xlabel="U direction change", ylabel="Frequency")
    plot_or_save(fig, save_path)


def box_plot(title, values, labels, save_path=None):
    """One box per value set (``tick_labels=`` needs matplotlib >= 3.9)."""
    from matplotlib import pyplot as plt
    fig, axs = plt.subplots(1, len(values))
    fig.suptitle(title)
    for a, v, l in zip(np.atleast_1d(axs), values, labels):
        a.boxplot(np.asarray(v).flatten(), tick_labels=[l])
    plot_or_save(fig, save_path)


def plot_errors_vs_var(title, errors, var, labels, save_path=None):
    """Error-vs-variable scatter + smoothing-spline trend, the trend only past
    5 points and 3 distinct values (common.py:248-283)."""
    import matplotlib
    from matplotlib import pyplot as plt
    from scipy.interpolate import make_smoothing_spline
    errors, var = np.asarray(errors), np.asarray(var).flatten()
    fig, axs = plt.subplots(errors.shape[-1], 1, figsize=(8, 10))
    fig.suptitle(title)
    cmap = matplotlib.colormaps["Set2"]
    names = get_fields_names(errors)
    order = np.argsort(var)
    for i, ax in enumerate(np.atleast_1d(axs)):
        ax.scatter(var, errors[:, i], label="Raw", color=cmap(2), s=15)
        ax.set_xlabel(labels[0])
        ax.set_ylabel(labels[1])
        if len(var) > 5 and len(np.unique(var)) > 3:
            interp = make_smoothing_spline(var[order], errors[order, i])
            x = np.linspace(var.min(), var.max(), 100)
            ax.plot(x, interp(x), color=cmap(1), label="Interpolated")
        ax.legend()
        ax.set_title(names[i])
    fig.tight_layout()
    plot_or_save(fig, save_path)


def get_heatmap(mae, x, y):
    """2D value matrix over the unique (x, y) grid (common.py:286-303)."""
    x_unique = np.unique(x)
    y_unique = np.unique(y)[::-1]
    hm = np.full((len(y_unique), len(x_unique)), np.nan)
    for v, xi, yi in zip(np.asarray(mae).flatten(), x, y):
        hm[(y_unique == yi).nonzero()[0], (x_unique == xi).nonzero()[0]] = v
    return hm, x_unique, y_unique


def _axis_value_fmt(ticks: np.ndarray):
    """Tick formatter for numeric axis values: ints plain, tiny floats in
    scientific notation, the rest with 3 decimals."""
    ticks = np.asarray(ticks)
    integral = np.issubdtype(ticks.dtype, np.integer)

    def fmt(pos, _=None):
        i = int(pos)
        if not 0 <= i < len(ticks):
            return ""
        if integral:
            return str(int(ticks[i]))
        return f"{ticks[i]:.2e}" if ticks[i] < 1e-3 else f"{ticks[i]:.3f}"

    return fmt


def plot_heatmap(ax, matrix, x, y, labels):
    """Annotated value heatmap over a (y, x) grid; NaN holes (negative
    sentinels) are left unannotated. Output contract of common.py:336-367."""
    ax.imshow(matrix, cmap="Wistia")
    for (i, j), value in np.ndenumerate(matrix):
        if value >= 0:
            ax.annotate(f"{value:.2e}", xy=(j, i), ha="center", va="center",
                        color="black")
    ax.set_xticks(range(len(x)), labels=x, rotation=45, ha="right",
                  rotation_mode="anchor")
    ax.set_yticks(range(len(y)), labels=y)
    ax.xaxis.set_major_formatter(_axis_value_fmt(x))
    ax.yaxis.set_major_formatter(_axis_value_fmt(y))
    ax.set_xlabel(labels[0])
    ax.set_ylabel(labels[1])


def plot_errors_vs_multi_vars(title, errors, x, y, labels, save_path=None):
    """Per-field error heatmaps over two variables (common.py:306-333)."""
    from matplotlib import pyplot as plt
    errors = np.asarray(errors)
    fig = plt.figure(figsize=(16, 9))
    axs = fig.subplots(1, errors.shape[-1])
    fig.suptitle(title)
    names = get_fields_names(errors)
    for ax, e, name in zip(np.atleast_1d(axs),
                           np.hsplit(errors, errors.shape[-1]), names):
        matrix, lx, ly = get_heatmap(e, x, y)
        plot_heatmap(ax, matrix, lx, ly, labels)
        ax.set_title(name)
    fig.tight_layout()
    plot_or_save(fig, save_path)


def plot_per_case(title, values, save_path=None):
    """One bar-per-case subplot per field column of a (C, D) value table
    (output contract of common.py:370-388)."""
    from matplotlib import pyplot as plt
    values = np.atleast_2d(np.asarray(values))
    fig = plt.figure(layout="constrained")
    fig.suptitle(title)
    axs = np.ravel(fig.subplots(values.shape[-1], 1))
    palette = plt.get_cmap("Set2")
    for i, (ax, column) in enumerate(zip(axs, values.T)):
        ax.bar(range(len(column)), column, color=palette(i))
        if column.min() < 0:  # mark the sign flip for signed metrics
            ax.axhline(0, 0, 1, linestyle="--", color="black")
        ax.set_xticks([])
        ax.set_ylabel(f"{get_fields_names(values)[i]} MAE")
    plot_or_save(fig, save_path)
