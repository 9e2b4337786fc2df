"""The port's viz modules (``porous_cfd_tpu_torch/viz``) against the JAX
package's (``porous_cfd_tpu/viz``): every plotting function renders the same
PNG file names on the same seeded inputs (Agg backend), and the numpy
helpers (``get_heatmap``, ``_axis_value_fmt``, the ``mask_triangulation``
mask, ``inlet_seed_points``, ``slice_origin``, ``camera_position``,
``get_fields_names``) agree exactly. The PyVista paths raise the JAX
module's errors without PyVista; neither machine has it, so no test renders
them."""
import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
from matplotlib import tri

from porous_cfd_tpu.viz import common as jax_common
from porous_cfd_tpu.viz import viz2d as jax_viz2d
from porous_cfd_tpu.viz import viz3d as jax_viz3d
from porous_cfd_tpu_torch.viz import common, viz2d, viz3d

N = 60


def inputs(seed=0):
    """One seeded set of arrays for every plot."""
    rng = np.random.default_rng(seed)
    pts2 = rng.uniform(0, 1, size=(N, 2))
    return {"pts2": pts2, "pts3": rng.uniform(size=(N, 3)), "u2": rng.normal(size=(N, 2)),
            "u3": rng.normal(size=(N, 3)), "p": rng.normal(size=(N, 1)),
            "zone": (pts2[:, 0] > 0.5).astype(float), "errors3": np.abs(rng.normal(size=(20, 3))),
            "errors4": np.abs(rng.normal(size=(8, 4))), "per_case": rng.normal(size=(7, 3))}


# name -> (function name in both packages, arguments from ``inputs``)
CALLS = {
    "plot_data_dist": (("common", "plot_data_dist"),
                       lambda a: ("dist", a["u2"], a["p"], a["zone"])),
    "plot_data_dist_3d": (("common", "plot_data_dist"), lambda a: ("dist 3d", a["u3"], a["p"])),
    "plot_timing": (("common", "plot_timing"), lambda a: ([1.0, 100.0], [0.1, 10.0])),
    "plot_errors": (("common", "plot_errors"), lambda a: ("errs2d", [0.1, 0.2, 0.3])),
    "plot_errors_uz": (("common", "plot_errors"), lambda a: ("errs3d", [0.1, 0.2, 0.3, 0.4])),
    "plot_multi_bar": (("common", "plot_multi_bar"),
                       lambda a: ("cmp", {"A": [1, 2], "B": [2, 1]}, ["$U$", "$p$"])),
    "box_plot": (("common", "box_plot"),
                 lambda a: ("box", [a["u2"][:, 0], a["p"]], ["$U_x$", "$p$"])),
    "plot_errors_vs_var": (("common", "plot_errors_vs_var"),
                           lambda a: ("vs var", a["errors3"], np.linspace(0, 1, 20),
                                      ["Angle", "MAE"])),
    "plot_errors_vs_var_few": (("common", "plot_errors_vs_var"),
                               lambda a: ("vs var few", a["errors3"][:4], [0.1, 0.2, 0.2, 0.1],
                                          ["U inlet", "MAE"])),
    "plot_errors_vs_multi_vars": (("common", "plot_errors_vs_multi_vars"),
                                  lambda a: ("heat", a["errors4"],
                                             np.repeat([5000, 7000], 4),
                                             np.tile([0.1, 0.125, 0.15, 0.175], 2), ["D", "U"])),
    "plot_per_case": (("common", "plot_per_case"), lambda a: ("per case", a["per_case"])),
    "plot_fields_errors": (("viz2d", "plot_fields"),
                           lambda a: ("errors", a["pts2"], np.abs(a["u2"]), np.abs(a["p"]),
                                      a["zone"], False)),
    "plot_fields_3d": (("viz3d", "plot_fields_3d"),
                       lambda a: ("f3d", a["pts3"], a["u3"], a["p"])),
    "plot_scatter_field": (("viz3d", "plot_scatter_field"),
                           lambda a: ("scatter", a["pts3"], a["p"])),
    "plot_slices": (("viz3d", "plot_slices"), lambda a: ("slices", a["pts3"], a["p"])),
    "plot_surface_errors": (("viz3d", "plot_surface_errors"),
                            lambda a: ("surf", a["pts3"][:30], np.abs(a["p"][:30]))),
}
MODULES = {"common": (jax_common, common), "viz2d": (jax_viz2d, viz2d),
           "viz3d": (jax_viz3d, viz3d)}


def pngs(path):
    return sorted(p.name for p in path.iterdir())


@pytest.mark.parametrize("name", list(CALLS))
def test_each_plot_writes_the_jax_file_names(name, tmp_path):
    (module, fn), args = CALLS[name]
    jax_mod, port_mod = MODULES[module]
    for side, mod in (("jax", jax_mod), ("port", port_mod)):
        (tmp_path / side).mkdir()
        getattr(mod, fn)(*args(inputs()), save_path=tmp_path / side)
    assert pngs(tmp_path / "port") == pngs(tmp_path / "jax") != []


def test_masked_fields_and_mask(tmp_path):
    """A masked field plot with streamlines writes the JAX names, and the
    triangulation's mask is the JAX module's, triangle for triangle."""
    a = inputs(1)
    mask = [[(0.4, 0.4), (0.6, 0.6)], [(0.0, 0.8), (0.3, 1.0)]]
    for side, mod in (("jax", jax_viz2d), ("port", viz2d)):
        (tmp_path / side).mkdir()
        mod.plot_fields("masked", a["pts2"], a["u2"], a["p"], a["zone"],
                        save_path=tmp_path / side, mask=mask)
    assert pngs(tmp_path / "port") == pngs(tmp_path / "jax") == ["masked.png"]
    got, ref = (tri.Triangulation(a["pts2"][:, 0], a["pts2"][:, 1]) for _ in range(2))
    viz2d.mask_triangulation(got, mask, a["pts2"])
    jax_viz2d.mask_triangulation(ref, mask, a["pts2"])
    assert got.mask.any() and not got.mask.all()
    np.testing.assert_array_equal(got.mask, ref.mask)


def write_case(path, dims=2, seed=5):
    from porous_cfd_tpu_torch.datagen import synthetic_case
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(80, dims))
    synthetic_case.write_case(
        path, pts, (pts[:, 0] > 0.5).astype(float),
        {"walls": rng.uniform(size=(20, dims))},
        fields={"U": rng.normal(size=(80, dims)), "p": rng.normal(size=80),
                "mag(grad(Unorm))": rng.uniform(size=80)},
        patch_fields={"walls": {"U": rng.normal(size=(20, dims)), "p": rng.normal(size=20),
                                "mag(grad(Unorm))": rng.uniform(size=20)}})


def test_case_and_dataset_plots_read_the_ports_parser(tmp_path):
    """``plot_case``, ``plot_dataset_dist`` and ``plot_u_direction_change``
    read a written split through the port's parser and write the JAX names."""
    split = tmp_path / "split"
    for i in range(3):
        write_case(split / f"case_{i}", seed=i)
    for side, (c, v2) in (("jax", (jax_common, jax_viz2d)), ("port", (common, viz2d))):
        out = tmp_path / side
        out.mkdir()
        v2.plot_case(str(split / "case_0"), out)
        c.plot_dataset_dist(str(split), out)
        c.plot_u_direction_change(str(split), out)
    assert pngs(tmp_path / "port") == pngs(tmp_path / "jax")
    assert {"case_0.png", "split distribution.png", "Fields boxplot.png"} <= \
        set(pngs(tmp_path / "port"))


def test_get_heatmap_and_axis_formatter_agree_exactly():
    rng = np.random.default_rng(3)
    d = np.repeat([5000, 7000, 9000, 12000], 5)
    u = np.tile([0.1, 0.125, 0.15, 0.175, 0.2], 4)
    keep = rng.permutation(20)[:17]          # holes stay NaN
    mae = rng.uniform(size=20)
    got = common.get_heatmap(mae[keep], d[keep], u[keep])
    ref = jax_common.get_heatmap(mae[keep], d[keep], u[keep])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert np.isnan(got[0]).sum() == 3
    for ticks in (np.array([5000, 7000]), np.array([1e-4, 0.5, 0.125]), np.array([2.5])):
        f, fr = common._axis_value_fmt(ticks), jax_common._axis_value_fmt(ticks)
        assert [f(i) for i in range(-1, len(ticks) + 1)] == \
            [fr(i) for i in range(-1, len(ticks) + 1)]


def test_3d_geometry_helpers_and_field_names_agree_exactly():
    rng = np.random.default_rng(0)
    inlet = rng.uniform(size=(200, 3))
    inlet[::4, 0] = 0.0
    for k, seed in ((50, 1), (250, None)):
        got = viz3d.inlet_seed_points(inlet, k=k, rng=None if seed is None
                                      else np.random.default_rng(seed))
        ref = jax_viz3d.inlet_seed_points(inlet, k=k, rng=None if seed is None
                                          else np.random.default_rng(seed))
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (k, 3) and np.all(got[:, 0] == 0.0)

    class FakeSolid:
        center = (0.0, 0.0, 2.5)

    for meshes in ([(FakeSolid(), "oldlace")], []):
        assert viz3d.slice_origin(meshes) == jax_viz3d.slice_origin(meshes)
    pts = rng.normal(size=(30, 3))
    np.testing.assert_array_equal(viz3d.camera_position(pts), jax_viz3d.camera_position(pts))
    np.testing.assert_array_equal(viz3d.camera_position(pts, (1.0, 0.0, 0.0)),
                                  jax_viz3d.camera_position(pts, (1.0, 0.0, 0.0)))
    for width in (3, 4):
        assert common.get_fields_names(np.zeros((5, width))) == \
            jax_common.get_fields_names(np.zeros((5, width)))
    assert (common.M_S, common.M2_S2) == (jax_common.M_S, jax_common.M2_S2)


def test_pyvista_paths_raise_the_jax_errors_without_pyvista():
    assert viz3d.HAS_PYVISTA == jax_viz3d.HAS_PYVISTA
    if viz3d.HAS_PYVISTA:
        pytest.skip("pyvista installed; its gate is not reachable")
    for mod in (viz3d, jax_viz3d):
        with pytest.raises(RuntimeError, match="requires pyvista"):
            mod.plot_streamlines("t", ".", np.zeros((4, 3)), np.zeros((4, 3)))
        with pytest.raises(RuntimeError, match="requires pyvista"):
            mod.plot_houses("t", np.zeros((4, 3)), np.zeros((4, 3)), np.zeros((4, 1)),
                            "house.obj")
