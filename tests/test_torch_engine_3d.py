"""The (v, J, H) engine's block at D = 3, reckoned on the host as
``csrc/mlp_prop.cuh`` sizes it (``fwd_smem``, ``bwd_smem``; 28 rows a block
at D = 3, 40 at D = 2): the shared bytes of the 3D experiments' launches
before (8 points, 56 rows) and after (4 points), the refusal of a launch
past the card's limit before anything runs, and the wrappers' plain
versions at D = 3 on CPU tensors."""
import pytest
import torch

from porous_cfd_tpu_torch.models.mlp import MLP, NeuralOperatorSequential, dense
from porous_cfd_tpu_torch.ops import decoder_cuda, mlp_prop_cuda, neural_op_cuda
from porous_cfd_tpu_torch.ops.mlp_prop_cuda import (H100_SHARED_BYTES, Meta,
                                                    backward_shared_bytes, check_fits,
                                                    forward_shared_bytes, tile_rows)

# (widths, n_local, reduction): the launches of the 3D experiments and the
# 2D paths' widths
ABC_PIPN = ((64, 512, 256, 128, 4), 64, True)
ABC_PP = ((64, 384, 128, 4), 64, True)
WINDBREAKS_TRUNK = ((256, 512, 512, 512, 512, 4), 256, True)
DUCT_TRUNK = ((176, 352, 352, 352, 352, 3), 176, True)
DUCT_PIPN = ((64, 512, 256, 128, 3), 64, True)


def both(widths, n_local, reduction, d_dims):
    return (forward_shared_bytes(widths, n_local, d_dims),
            backward_shared_bytes(widths, reduction, d_dims))


def at_rows(nbytes, d_dims, rows):
    """``nbytes`` of a block of tile_rows(d_dims) rows, at ``rows`` rows."""
    per_row = (nbytes // 4 - mlp_prop_cuda.RING_FLOATS) // tile_rows(d_dims)
    return 4 * (rows * per_row + mlp_prop_cuda.RING_FLOATS)


def test_tile_rows():
    assert [tile_rows(d) for d in (1, 2, 3)] == [24, 40, 28]


@pytest.mark.parametrize("launch,d_dims,want", [
    (DUCT_PIPN, 2, (222_488, 222_488)),
    (DUCT_TRUNK, 2, (212_248, 212_248)),
    (ABC_PIPN, 3, (185_240, 185_240)),
    (ABC_PP, 3, (156_568, 156_568)),
    (WINDBREAKS_TRUNK, 3, (213_912, 213_912)),
    (DUCT_TRUNK, 3, (178_072, 178_072)),
    (DUCT_PIPN, 3, (185_240, 185_240)),
], ids=["duct-pipn-2d", "duct-trunk-2d", "abc-pipn", "abc-pp", "windbreaks-trunk",
        "duct-trunk-3d", "duct-pipn-3d"])
def test_shared_bytes_fit_the_card(launch, d_dims, want):
    got = both(*launch, d_dims)
    assert got == want
    assert max(got) <= H100_SHARED_BYTES


@pytest.mark.parametrize("launch,want", [
    (ABC_PIPN, 272_152), (ABC_PP, 214_808), (WINDBREAKS_TRUNK, 329_496),
    (DUCT_TRUNK, 257_816)], ids=["abc-pipn", "abc-pp", "windbreaks-trunk", "duct-trunk-3d"])
def test_eight_points_at_d3_did_not_fit(launch, want):
    """The tile before: 8 points of 7 rows, 56 rows. All but abc's pipn-pp
    decoder passed the card's 232,448 bytes."""
    fwd, bwd = (at_rows(b, 3, 56) for b in both(*launch, 3))
    assert fwd == want
    assert (max(fwd, bwd) > H100_SHARED_BYTES) == (launch is not ABC_PP)


def meta_of(widths, n_local, reduction, d_dims):
    return Meta(n_local, "silu", (0.0,) * (len(widths) - 1), None, d_dims, 2, 9, 3, widths,
                reduction=reduction)


def test_check_fits_refuses_past_the_limit_with_the_bytes():
    check_fits("neural_ops_prop", meta_of(*WINDBREAKS_TRUNK, 3), H100_SHARED_BYTES)
    check_fits("decoder_prop", meta_of(*ABC_PIPN, 3), H100_SHARED_BYTES)
    wide = meta_of((512, 1024, 1024, 4), 512, True, 3)
    with pytest.raises(ValueError, match=r"widths \[512, 1024, 1024, 4\] at D = 3 need "
                                         r"328600 shared bytes a block \(28 rows\)"):
        check_fits("neural_ops_prop", wide, H100_SHARED_BYTES)
    # the context columns of the ctx_width mode are staged 128 at a time
    ctx = Meta(64, "silu", (0.0,) * 4, None, 3, 2, 9, 3, (64, 512, 256, 128, 4),
               ctx_width=1024)
    assert forward_shared_bytes(ctx.int_widths, 64, 3) == 4 * (
        28 * (max(260, 68 + 132) + 516) + mlp_prop_cuda.RING_FLOATS)
    check_fits("decoder_prop", ctx, H100_SHARED_BYTES)


def test_wrappers_take_the_plain_versions_at_d3_on_the_cpu():
    """CPU tensors at D = 3 and a width no block holds: the plain versions,
    no check, no launch."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    dec = MLP([8 + 6, 1100, 4], activation="silu", last_activation=False, generator=gen)
    v, jt, ht = rnd(2, 5, 8), rnd(2, 3, 5, 8), rnd(2, 3, 5, 8)
    out = decoder_cuda.decoder_prop(dec.linears, 8, v, jt, ht, rnd(2, 4, 8), rnd(2, 1, 6),
                                    "silu")
    assert out[1].shape == (2, 5, 4, 3)
    ops = NeuralOperatorSequential(2, 1100, (0.0, 0.0), "silu", generator=gen)
    trunk = neural_op_cuda.neural_ops_prop(ops.linears, dense(1100, 4, gen), 8, v, jt, ht,
                                           None, rnd(2, 1, 1092), rnd(2, 1, 1100).abs(),
                                           "silu")
    assert trunk[2].shape == (2, 5, 4, 3)
    assert decoder_cuda.decoder_prop.launches == 0
    assert neural_op_cuda.neural_ops_prop.launches == 0
