"""The port's data layer against the JAX package's: the synthetic case
writer and the metadata generator write the same bytes for the same rng;
``FoamDataset`` gives the same stacked data, labels, domain and normalizers
on the same split and rng, after ``resample`` too; the large-cloud SDF
route gives the small clouds' feature; and the native parser's library is
built once under its lock when six threads ask for it together, and parses
as the pure-Python path does."""
import threading
from pathlib import Path

import numpy as np
import pytest

from porous_cfd_tpu.data.dataset import FoamDataset as JaxFoamDataset
from porous_cfd_tpu.datagen import meta as jax_meta, synthetic_case as jax_case
from porous_cfd_tpu.ops import distance as jax_distance
from porous_cfd_tpu_torch.data import dataset, foam_io, native
from porous_cfd_tpu_torch.datagen import meta, synthetic_case

FIELDS = ["C", "U", "p", "cellToRegion", "d", "f"]
SPLITS = [("train", 3), ("val", 2)]


def write_splits(case_mod, meta_mod, root: Path, seed=8421, n_internal=160, n_per_patch=24):
    """The duct_variable_boundary layout: variable inlet U, d/f per case."""
    rng = np.random.default_rng(seed)
    for split, n in SPLITS:
        case_mod.write_foam_split(root / split, n, rng, n_internal=n_internal,
                                  n_per_patch=n_per_patch, variable=True)
        case_mod.write_data_config(root / split, fields=FIELDS,
                                   variable_boundaries={"U": "inlet"},
                                   normalize={"Scale": ["d", "f"],
                                              "Standardize": ["C", "U", "p"]},
                                   dims=["x", "y"])
        meta_mod.generate_meta(root / split, *FIELDS, max_dim=2)
    meta_mod.generate_min_points(root)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("splits")
    write_splits(jax_case, jax_meta, root / "jax")
    write_splits(synthetic_case, meta, root / "port")
    return root


def test_writer_and_meta_write_the_jax_packages_bytes(splits):
    jax_files = sorted(p.relative_to(splits / "jax") for p in (splits / "jax").rglob("*")
                       if p.is_file())
    port_files = sorted(p.relative_to(splits / "port") for p in (splits / "port").rglob("*")
                        if p.is_file())
    assert jax_files == port_files and len(jax_files) > 100
    for rel in jax_files:
        assert (splits / "jax" / rel).read_bytes() == (splits / "port" / rel).read_bytes(), rel


def assert_same_dataset(port_ds, jax_ds):
    got, ref = port_ds.stacked(), jax_ds.stacked()
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(ref.data))
    assert got.labels == ref.labels
    assert got.domain.keys() == ref.domain.keys()
    for key in ref.domain:
        np.testing.assert_array_equal(np.asarray(got.domain[key]), np.asarray(ref.domain[key]),
                                      err_msg=key)
    assert port_ds.normalizers.keys() == jax_ds.normalizers.keys()
    for key, norm in jax_ds.normalizers.items():
        for a, b in zip(port_ds.normalizers[key].__dict__.values(), norm.__dict__.values()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)


@pytest.mark.parametrize("split", ["train", "val"])
def test_foam_dataset_matches_jax_and_after_resample(splits, split):
    root = splits / "port"
    args = (str(root / split), 80, 40, 20)
    kw = {"meta_dir": str(root / "train")} if split == "val" else {}
    port_ds = dataset.FoamDataset(*args, rng=np.random.default_rng(3), **kw)
    jax_ds = JaxFoamDataset(*args, rng=np.random.default_rng(3), **kw)
    assert_same_dataset(port_ds, jax_ds)
    stacked = port_ds.stacked()
    assert isinstance(stacked.data, np.ndarray) and stacked.data.dtype == np.float32
    n_cols = sum(1 for _, sub in stacked.labels if sub is None)
    assert stacked.data.shape == (dict(SPLITS)[split], 120, n_cols)
    port_ds.resample(np.random.default_rng((8421, 1)))
    jax_ds.resample(np.random.default_rng((8421, 1)))
    assert_same_dataset(port_ds, jax_ds)
    assert not np.array_equal(port_ds.stacked().data, stacked.data)


def test_large_cloud_sdf_is_the_small_clouds_feature():
    """Clouds above 2M point pairs take the chunked reduction: the feature
    of the small clouds' float64 route within 1e-12, and the JAX package's
    float32 route within the digits its |q|^2 - 2 q t + |t|^2 form loses to
    cancellation next to the boundary (a deliberate difference)."""
    rng = np.random.default_rng(5)
    internal = rng.uniform(-1, 1, size=(3000, 2))
    boundary = rng.uniform(-1, 1, size=(900, 2))
    zone = (internal[:, 0] > 0.3).astype(np.float64)
    got = dataset.sdf_feature(internal, boundary, zone)
    d = np.min(np.linalg.norm(np.concatenate([internal, boundary])[:, None]
                              - boundary[None], axis=-1), axis=-1)
    sign = np.concatenate([(0.5 - zone) * 2, np.ones(len(boundary))])
    np.testing.assert_allclose(got, d / d.max() * sign, rtol=1e-12, atol=1e-12)
    ref = np.asarray(jax_distance.sdf_feature(internal, boundary, zone))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
    assert np.array_equal(np.sign(got), np.sign(ref))


def test_native_library_builds_once_under_its_lock(tmp_path, monkeypatch):
    """Six threads that want the library at once get one build and one file;
    the native parse equals the pure-Python one."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    results = [None] * 6

    def want(i):
        results[i] = native.build()

    threads = [threading.Thread(target=want, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results[0] is not None and len(set(results)) == 1
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == ["foamio.lock", results[0].name]
    body = "( (1 2.5 -3e-2) (4 5 6) // a comment\n (7e3 .5 -1.25E+2) )"
    pure = np.fromstring(body.replace("(", " ").replace(")", " ").replace(
        "// a comment", ""), sep=" ")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    np.testing.assert_array_equal(native.parse_floats(body), pure)
    np.testing.assert_array_equal(foam_io._parse_numeric_block(body), pure.reshape(3, 3))
