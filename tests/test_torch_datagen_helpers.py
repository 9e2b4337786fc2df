"""The port's numpy datagen helpers against the JAX package's modules on
the same inputs, with the JAX tests' cases (``tests/test_datagen.py``,
``tests/test_mesh_filter.py``): ``momentum_error`` over the port's OpenFOAM
IO, ``mesh_filter`` and ``mesh_ops`` (OBJ IO, transforms, the inside point;
the Blender operations stay behind ``require_bpy``)."""
import numpy as np
import pytest

from porous_cfd_tpu.data import foam_io as jax_foam_io
from porous_cfd_tpu.datagen import mesh_filter as jax_mesh_filter
from porous_cfd_tpu.datagen import mesh_ops as jax_mesh_ops
from porous_cfd_tpu.datagen.momentum_error import write_momentum_error as jax_write
from porous_cfd_tpu_torch.data import foam_io
from porous_cfd_tpu_torch.datagen import mesh_filter, mesh_ops, momentum_error
from test_datagen import D, F, NU, analytic, write_gradient_case
from test_mesh_filter import CUBE_TRIS, CUBE_VERTS, cube_edges

PATCH_FILE = "postProcessing/walls/surface/1000/patch_walls/vectorField/momentError"


@pytest.mark.parametrize("seed", [0, 1])
def test_momentum_error_writes_the_jax_packages_files(tmp_path, seed):
    """The same case written twice: the port's and the JAX package's
    ``write_momentum_error`` write the same bytes, and the field is the
    manufactured forcing (Taylor-Green: 2 nu u + the porous source)."""
    cases = {}
    for name in ("port", "jax"):
        case = tmp_path / name
        pts_i, zone, pts_b = write_gradient_case(case, np.random.default_rng(seed))
        cases[name] = case
    momentum_error.write_momentum_error(str(cases["port"]))
    jax_write(str(cases["jax"]))
    for rel in ("1000/momentError", PATCH_FILE):
        assert (cases["port"] / rel).read_bytes() == (cases["jax"] / rel).read_bytes(), rel
    err = foam_io.read_field_file(cases["port"] / "1000" / "momentError")["internal"]
    u, _, _ = analytic(pts_i)
    u_mag = np.linalg.norm(u, axis=-1, keepdims=True)
    np.testing.assert_allclose(err, 2 * NU * u + u * (D * NU + 0.5 * u_mag * F) * zone[:, None],
                               atol=1e-6)
    np.testing.assert_allclose(foam_io.read_postprocess_field(cases["port"] / PATCH_FILE),
                               jax_foam_io.read_postprocess_field(cases["jax"] / PATCH_FILE))
    assert momentum_error.JAC_LABELS[0] == "grad(U)xx"


def test_momentum_error_residual_equals_jax():
    from porous_cfd_tpu.datagen.momentum_error import momentum_error as jax_momentum_error
    rng = np.random.default_rng(5)
    u, jac, lap, gp = (rng.normal(size=s) for s in ((20, 3), (20, 3, 3), (20, 3, 3), (20, 3)))
    zone = (rng.uniform(size=(20, 1)) > 0.5).astype(float)
    np.testing.assert_array_equal(
        momentum_error.momentum_error(NU, D, F, u, jac, lap, gp, zone),
        jax_momentum_error(NU, D, F, u, jac, lap, gp, zone))


EDGE_CASES = {"cube": (8, None), "two_triangles": (6, [[0, 1], [1, 2], [2, 0], [3, 4],
                                                       [4, 5], [5, 3]]),
              "isolated_vertex": (4, [[0, 1], [1, 2]]), "one_vertex": (1, np.zeros((0, 2), int))}


@pytest.mark.parametrize("case", EDGE_CASES)
def test_mesh_filter_islands_equal_jax(case):
    n, edges = EDGE_CASES[case]
    edges = cube_edges() if edges is None else np.asarray(edges)
    np.testing.assert_array_equal(mesh_filter.connected_components(n, edges),
                                  jax_mesh_filter.connected_components(n, edges))
    assert mesh_filter.has_multiple_islands(n, edges) == \
        jax_mesh_filter.has_multiple_islands(n, edges)


def test_mesh_filter_geometry_equals_jax():
    sheet_v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 0.9]])
    sheet_t = np.array([[0, 1, 2], [0, 2, 3]])
    meshes = [(CUBE_VERTS, CUBE_TRIS), (CUBE_VERTS + [5.0, -3.0, 2.0], CUBE_TRIS),
              (CUBE_VERTS, CUBE_TRIS[:, ::-1]), (2 * CUBE_VERTS, CUBE_TRIS),
              (CUBE_VERTS, np.zeros((0, 3), int)), (CUBE_VERTS * [10.0, 0.5, 0.5], CUBE_TRIS),
              (sheet_v, sheet_t), (CUBE_VERTS * [1.0, 1.0, 0.0], CUBE_TRIS)]
    for verts, tris in meshes:
        assert mesh_filter.mesh_volume(verts, tris) == jax_mesh_filter.mesh_volume(verts, tris)
        np.testing.assert_array_equal(mesh_filter.bbox_dimensions(verts),
                                      jax_mesh_filter.bbox_dimensions(verts))
        assert mesh_filter.is_mesh_good(verts, tris, 0.2, 0.2) == \
            jax_mesh_filter.is_mesh_good(verts, tris, 0.2, 0.2)
    assert mesh_filter.mesh_volume(CUBE_VERTS, CUBE_TRIS) == pytest.approx(1.0)
    for faces in ([[0, 1, 2, 3]], [], [[0, 1, 2], [2, 3, 4, 5, 6]]):
        np.testing.assert_array_equal(mesh_filter.triangulate_fan(faces),
                                      jax_mesh_filter.triangulate_fan(faces))


def test_mesh_ops_obj_io_and_transforms_equal_jax(tmp_path):
    verts = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0], [1.5, 0.25, 3.0]], float)
    faces = [(0, 1, 2), (0, 1, 2, 3)]
    mesh_ops.write_obj(tmp_path / "port.obj", verts, faces)
    jax_mesh_ops.write_obj(tmp_path / "jax.obj", verts, faces)
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    v, f = mesh_ops.read_obj(tmp_path / "jax.obj")
    jv, jf = jax_mesh_ops.read_obj(tmp_path / "jax.obj")
    np.testing.assert_array_equal(v, jv)
    assert f == jf == faces
    for kwargs in ({}, dict(scale=(1, 2, 2), rotation_z_deg=90.0),
                   dict(scale=(0.5, 1.5, 1.0), rotation_z_deg=-33.0, offset=(1.0, -2.0, 0.5))):
        np.testing.assert_array_equal(mesh_ops.transform_verts(verts, **kwargs),
                                      jax_mesh_ops.transform_verts(verts, **kwargs))
    np.testing.assert_array_equal(mesh_ops.center_of_mass(tmp_path / "port.obj"),
                                  jax_mesh_ops.center_of_mass(tmp_path / "jax.obj"))


def test_mesh_ops_grid_inside_point_equals_jax(tmp_path):
    """``tests/test_datagen.py``'s closed cube: the deepest interior point
    is the JAX package's, near the center."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], float)
    tris = []
    for f in [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
              (1, 5, 7, 3)]:
        tris += [(f[0], f[1], f[2]), (f[0], f[2], f[3])]
    mesh_ops.write_obj(tmp_path / "cube.obj", v, tris)
    for res in (8, 5):
        got = mesh_ops.grid_inside_point(tmp_path / "cube.obj", resolution=res)
        np.testing.assert_array_equal(
            got, jax_mesh_ops.grid_inside_point(tmp_path / "cube.obj", resolution=res))
    assert np.all(got > 0.2) and np.all(got < 0.8)


def test_mesh_ops_blender_operations_stay_gated():
    try:
        import bpy  # noqa: F401
        pytest.skip("Blender is installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="bpy"):
        mesh_ops.require_bpy()
