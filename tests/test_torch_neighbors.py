"""The port's neighbour ops (``models/neighbors.py`` and the FPS kernel's
plain version) against the JAX package's: FPS, the radius search and the
whole SetAbstraction chain precompute are held EXACTLY to JAX's
(``models/neighbors.py``) and FPS also to its Pallas kernel in interpret
mode; the float entries of the precompute within 1e-6, and through
``attach_neighbors`` / ``gather_cases`` bit for bit. Seeded clouds, the same
numpy inputs on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porous_cfd_tpu.models import neighbors as jax_neighbors
from porous_cfd_tpu.ops.fps_pallas import farthest_point_sampling_pallas
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models import neighbors
from porous_cfd_tpu_torch.models.pipn import pipn_foam_pp
from porous_cfd_tpu_torch.ops import fps_cuda
from porous_cfd_tpu_torch.train.engine import gather_cases

# the float entries: (pos_j - pos_c) / r and gathered copies, f32 both sides
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def cloud(b, n, d, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=(b, n, d)).astype(np.float32)


@pytest.mark.parametrize("b,n,d,n_samples", [(3, 40, 2, 20), (2, 57, 3, 19),
                                             (2, 1000, 2, 500), (2, 500, 2, 125)])
def test_fps_equals_jax_and_the_pallas_kernel(b, n, d, n_samples):
    """The last two are PIPN++'s two levels at full size."""
    pos = cloud(b, n, d, seed=n)
    got = neighbors.farthest_point_sampling(torch.from_numpy(pos), n_samples)
    assert got.dtype == torch.int64 and got.shape == (b, n_samples)
    ref = np.asarray(jax_neighbors.batched_fps(jnp.asarray(pos), n_samples, 0))
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_pl = np.asarray(farthest_point_sampling_pallas(jnp.asarray(pos), n_samples,
                                                       interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref_pl)
    assert neighbors.farthest_point_sampling is fps_cuda.farthest_point_sampling


def test_fps_single_cloud():
    """An unbatched (N, D) cloud gives (n_samples,) indices."""
    pos = cloud(1, 30, 2, seed=4)[0]
    got = neighbors.farthest_point_sampling(torch.from_numpy(pos), 10)
    assert got.shape == (10,)
    ref = jax_neighbors.farthest_point_sampling(jnp.asarray(pos), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fps_ties_take_the_first_index():
    """Four corners of a square twice over: every distance ties."""
    square = np.array([[0, 0], [1, 0], [0, 1], [1, 1]] * 2, np.float32)
    got = fps_cuda.farthest_point_sampling_plain(torch.from_numpy(square)[None], 4)
    ref = jax_neighbors.batched_fps(jnp.asarray(square)[None], 4, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.tolist() == [[0, 3, 1, 2]]


@pytest.mark.parametrize("n,c,r,k", [(40, 13, 0.6, 8), (1000, 500, 0.5, 64),
                                     (500, 125, 1.0, 64), (12, 5, 0.7, 16)])
def test_radius_neighbors_equal_jax(n, c, r, k):
    """(12, 5, 0.7, 16): fewer source points than the cap, padded."""
    src = cloud(2, n, 2, seed=c)
    query = src[:, :c]
    idx, mask = neighbors.radius_neighbors(torch.from_numpy(src), torch.from_numpy(query), r, k)
    ref_idx, ref_mask = jax_neighbors.batched_radius(jnp.asarray(src), jnp.asarray(query), r, k)
    assert idx.dtype == torch.int64 and mask.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


def test_pairwise_sqdist_matches_jax():
    q, s = cloud(2, 17, 2, seed=1), cloud(2, 23, 2, seed=2)
    got = neighbors.pairwise_sqdist(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    ref = np.asarray(jax_neighbors.pairwise_sqdist(jnp.asarray(q), jnp.asarray(s)))
    np.testing.assert_allclose(got, ref, **FLOAT_TOL)
    assert got.min() >= 0


@pytest.mark.parametrize("n,k,with_feats", [(60, 8, True), (1000, 64, True), (45, 8, False)])
def test_sa_chain_precompute_equals_jax(n, k, with_feats):
    """cent, idx and mask exactly; rel, posc and xg within 1e-6. (1000, 64)
    is PIPN++'s boundary cloud at full size."""
    pos = cloud(3, n, 2, seed=k + n)
    feats = np.random.default_rng(9).normal(size=(3, n, 6)).astype(np.float32)
    fractions, radii = [0.5, 0.25], [0.5, 1.0]
    got = neighbors.sa_chain_precompute(torch.from_numpy(pos), fractions, radii, k,
                                        torch.from_numpy(feats) if with_feats else None)
    ref = jax_neighbors.sa_chain_precompute(jnp.asarray(pos), fractions, radii, k,
                                            jnp.asarray(feats) if with_feats else None)
    assert set(got) == {f"_{key}" for key in ref}
    for key, r in ref.items():
        g, r = got[f"_{key}"].numpy(), np.asarray(r)
        assert g.shape == r.shape, key
        if key.split("_")[1] in ("cent", "idx", "mask"):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, r, err_msg=key, **FLOAT_TOL)


def test_extract_sa_neighbors_reads_the_port_keys():
    chain = neighbors.sa_chain_precompute(torch.from_numpy(cloud(2, 40, 2, 3)), [0.5, 0.25],
                                          [0.5, 1.0], 8, torch.zeros(2, 40, 6))
    nbrs = neighbors.extract_sa_neighbors(chain, 2)
    assert [len(e) for e in nbrs] == [6, 5]
    assert nbrs[0][3] is chain["_sa_rel_0"] and nbrs[0][5] is chain["_sa_xg_0"]
    assert neighbors.extract_sa_neighbors({"internal": None}, 2) is None


def test_float_aux_survives_attach_and_gather():
    """The precompute's float entries arrive through attach_neighbors and
    gather_cases bit for bit (FoamData keeps ``_`` entries as given), and
    level 0's xg is gathered in the model's [C || boundaryId] order."""
    model = pipn_foam_pp(1e-3, 100.0, 1.0, [2, 8, 8], [[8, 8, 8], [10, 8, 8], [10, 8, 16]],
                         [0.5, 1.0], [0.5, 0.25], [24, 8, 3], make_scalers(), max_neighbors=8,
                         device="cpu")
    data = make_foam_batch(4, 24, 16, 8, seed=3)
    attached = model.attach_neighbors(data)
    idx = torch.tensor([2, 0])
    batch = gather_cases(attached, idx)
    direct = model.neighbor_precompute(gather_cases(data, idx))
    for key, val in direct.items():
        assert batch.domain[key].dtype == val.dtype, key
        torch.testing.assert_close(batch.domain[key], val, rtol=0, atol=0, msg=key)
    rel = batch.domain["_sa_rel_0"]
    assert rel.dtype == torch.float32 and not torch.equal(rel, rel.round())
    boundary = batch.data[:, 24:]
    c_cols, id_cols = data.column_indices("C"), data.column_indices("boundaryId")
    rows = neighbors.gather_points(boundary, batch.domain["_sa_idx_0"]).reshape(2, -1, 17)
    torch.testing.assert_close(batch.domain["_sa_xg_0"], rows[..., c_cols + id_cols],
                               rtol=0, atol=0)


def test_masked_max_matches_jax_and_routes_ties_to_the_first():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    vals[0, 0, 2] = vals[0, 0, 4] = 9.0              # a tie at k = 2 and k = 4
    mask = rng.uniform(size=(2, 5, 6)) > 0.3
    mask[1, 3] = False                                # an empty neighbourhood
    mask[0, 0, 2] = mask[0, 0, 4] = True
    ref = np.asarray(jax_neighbors.masked_max(jnp.asarray(vals), jnp.asarray(mask)[..., None]))
    v = torch.from_numpy(vals).requires_grad_()
    got = neighbors.masked_max(v, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    assert torch.all(got[1, 3] == 0)
    got.sum().backward()
    assert torch.all(v.grad[0, 0, 2] == 1) and torch.all(v.grad[0, 0, 4] == 0)
    assert torch.all(v.grad[1, 3] == 0)
    assert torch.all(v.grad[torch.from_numpy(~mask)] == 0)
