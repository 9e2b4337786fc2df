"""The port's ``ops/distance.py`` against the JAX package's
(``tests/test_distance_ops.py``'s clouds) and numpy: the chunked minimum
distance in float64 on the host or a tensor's device, its split over a
mesh's 'points' axis on 4 gloo ranks, and the SDF feature, which the
dataset takes from here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as w
from porous_cfd_tpu.ops import distance as jax_distance
from porous_cfd_tpu.parallel.mesh import make_mesh as jax_make_mesh
from porous_cfd_tpu_torch.data import dataset
from porous_cfd_tpu_torch.ops import distance


def brute(query, target):
    q, t = np.asarray(query, np.float64), np.asarray(target, np.float64)
    return np.linalg.norm(q[:, None] - t[None], axis=-1).min(-1)


@pytest.fixture(scope="module")
def ranks():
    """The distance cases on a (1 x 4) mesh of gloo ranks."""
    return [r[1] for r in w.start_ranks(4, [((1, 4), [])], extra=w.distance_cases).results()]


@pytest.mark.parametrize("n,m,d,chunk,seed", [(500, 120, 3, 128, 0), (77, 13, 2, 32, 1)],
                         ids=["chunks", "odd_sizes"])
def test_min_distance_matches_numpy_and_jax(n, m, d, chunk, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, d)).astype(np.float32)
    t = rng.normal(size=(m, d)).astype(np.float32)
    got = distance.min_distance(q, t, chunk)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, brute(q, t), rtol=1e-12, atol=1e-12)
    ref = np.asarray(jax_distance.min_distance(jnp.asarray(q), jnp.asarray(t), chunk))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_min_distance_on_tensors_stays_on_their_device():
    rng = np.random.default_rng(4)
    q, t = torch.from_numpy(rng.normal(size=(50, 2))), torch.from_numpy(rng.normal(size=(9, 2)))
    got = distance.min_distance(q.float(), t.float(), 16)
    assert torch.is_tensor(got) and got.dtype == torch.float64 and got.device == q.device
    np.testing.assert_allclose(got.numpy(), brute(q.float(), t.float()), rtol=1e-12)


def test_min_distance_sharded_matches_numpy_and_jax(ranks):
    """333 query rows over 4 points ranks (padded to 336), as the JAX
    version splits them over its 8: every rank gets all minima."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(333, 2)).astype(np.float32)
    t = rng.normal(size=(40, 2)).astype(np.float32)
    ref = np.asarray(jax_distance.min_distance_sharded(
        jnp.asarray(q), jnp.asarray(t), jax_make_mesh(data=1, points=8), chunk=64))
    for res in ranks:
        np.testing.assert_allclose(res["sharded"], brute(q, t), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(res["sharded"], ref, atol=1e-4)
        assert torch.is_tensor(res["sharded_tensor"])
        np.testing.assert_allclose(res["sharded_tensor"].numpy(), res["sharded"], rtol=0)


def test_sdf_feature_matches_jax_and_the_host_math(ranks):
    rng = np.random.default_rng(3)
    pts_i, pts_b = rng.uniform(size=(80, 2)), rng.uniform(size=(30, 2))
    zone = (pts_i[:, 0] > 0.5).astype(float)
    got = distance.sdf_feature(pts_i, pts_b, zone)
    np.testing.assert_allclose(got, np.asarray(jax_distance.sdf_feature(pts_i, pts_b, zone)),
                               atol=1e-5)
    allp = np.concatenate([pts_i, pts_b])
    d = brute(allp, pts_b)
    sign = np.ones(len(allp))
    sign[:80] = (0.5 - zone) * 2
    np.testing.assert_allclose(got, d / d.max() * sign, rtol=1e-12, atol=1e-15)
    assert np.all(got[80:] >= 0)
    for res in ranks:
        np.testing.assert_array_equal(res["sdf"], got)
        np.testing.assert_allclose(res["sdf_mesh"], got, rtol=1e-12, atol=1e-15)
    assert dataset.sdf_feature is distance.sdf_feature
