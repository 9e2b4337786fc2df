"""The port's FVM golden-data solver against the JAX package's: on a small
grid ``solve_duct`` gives bit-equal arrays for two obstacle shapes;
``write_golden_split`` of two cases with ``time_solve=False`` writes
byte-equal case files; ``generate_meta`` over those splits writes the same
``meta.json`` and ``min_points.json``."""
import dataclasses

import numpy as np
import pytest

from porous_cfd_tpu.datagen import fvm as jax_fvm, meta as jax_meta
from porous_cfd_tpu.datagen import synthetic_case as jax_case
from porous_cfd_tpu_torch.datagen import fvm, meta, synthetic_case

NX, NY = 24, 16
SHAPES = [("circle", 0.10, 0.00, 0.12, 0.0), ("rhombus", 0.10, 0.04, 0.12, 0.6)]


@pytest.mark.parametrize("case", SHAPES, ids=[s[0] for s in SHAPES])
def test_solve_duct_equals_jax(case):
    got = fvm.solve_duct(*case, nx=NX, ny=NY)
    ref = jax_fvm.solve_duct(*case, nx=NX, ny=NY)
    assert got.steps == ref.steps and got.residual == ref.residual
    assert got.zone.sum() > 0
    for field in dataclasses.fields(ref):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
    np.testing.assert_array_equal(got.points, ref.points)


def write_golden(fvm_mod, case_mod, meta_mod, root):
    for split, cases in (("train", SHAPES), ("val", SHAPES[::-1])):
        fvm_mod.write_golden_split(root / split, cases, nx=NX, ny=NY, time_solve=False)
        case_mod.write_data_config(root / split, ["C", "U", "p", "cellToRegion"], {},
                                   {"Scale": [], "Standardize": ["C", "U", "p"]}, ["x", "y"])
        meta_mod.generate_meta(root / split, "C", "U", "p", "cellToRegion", max_dim=2)
    meta_mod.generate_min_points(root)


def test_golden_split_and_meta_write_the_jax_packages_bytes(tmp_path):
    write_golden(jax_fvm, jax_case, jax_meta, tmp_path / "jax")
    write_golden(fvm, synthetic_case, meta, tmp_path / "port")
    files = {side: sorted(p.relative_to(tmp_path / side)
                          for p in (tmp_path / side).rglob("*") if p.is_file())
             for side in ("jax", "port")}
    assert files["jax"] == files["port"]
    names = {p.name for p in files["jax"]}
    assert {"meta.json", "min_points.json", "data_config.json"} <= names
    assert len(files["jax"]) > 40
    for rel in files["jax"]:
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes(), \
            rel
