"""The hand-written CUDA kernels against their plain PyTorch versions on the
card. Skipped without a CUDA device. On the GPU machine (no JAX there):

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models.mlp import MLP, NeuralOperatorSequential, dense
from porous_cfd_tpu_torch.models.pi_gano import pi_gano
from porous_cfd_tpu_torch.models.pipn import pipn_foam
from porous_cfd_tpu_torch.ops import decoder_cuda, neural_op_cuda, pointnet_cuda
from porous_cfd_tpu_torch.physics import analytic

pytestmark = pytest.mark.gpu

# |kernel - plain| <= RTOL * max|plain|: f32 on both sides, sums in another
# order (the kernels' FMA chains and the engine's 3xTF32 products, each
# within about 2^-21 of the f32 product, against cuBLAS; the backward's
# weight gradients add row chunks in another order).
RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def assert_close(got, ref, rtol=RTOL):
    assert got.shape == ref.shape
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= rtol * scale


@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("b,n,layers", [(2, 64, [16, 24, 32]), (3, 301, [21, 16, 32, 200]),
                                        (1, 7, [5, 130])])
def test_pointnet_kernel_matches_plain(cuda, act, b, n, layers):
    gen = torch.Generator().manual_seed(n)
    mlp = MLP(layers, activation=act, generator=gen).to(cuda)
    x = torch.randn((b, n, layers[0]), generator=gen).to(cuda)
    with torch.no_grad():
        m, a = pointnet_cuda.pointnet_global(mlp.linears, x, act)
        torch.cuda.synchronize()
        rm, ra = pointnet_cuda.pointnet_global_plain(mlp.linears, x, act)
        g = analytic.mlp_value(mlp.linears, x, act)
    assert_close(m, rm)
    assert a.dtype == torch.int32
    top2 = torch.topk(g, 2, dim=-2).values
    decided = (top2[:, 0] - top2[:, 1]) > RTOL * rm.abs().max()
    assert torch.equal(a[:, 0][decided], ra[:, 0][decided])


def test_pointnet_kernel_ties_take_the_first_row(cuda):
    """Rows repeat across tiles (64 rows each): the first copy must win."""
    gen = torch.Generator().manual_seed(0)
    mlp = MLP([3, 8, 16], activation="silu", generator=gen).to(cuda)
    base = torch.randn((1, 10, 3), generator=gen)
    x = base.repeat(1, 30, 1).to(cuda)                     # 300 rows, period 10
    with torch.no_grad():
        _, a = pointnet_cuda.pointnet_global(mlp.linears, x, "silu")
        _, ra = pointnet_cuda.pointnet_global_plain(mlp.linears, x[:, :10], "silu")
    assert torch.equal(a, ra)


@pytest.mark.parametrize("act,dims,boundary", [("silu", 2, True), ("tanh", 2, False),
                                               ("silu", 3, True), ("tanh", 1, True)])
def test_decoder_kernel_matches_plain(cuda, act, dims, boundary):
    gen = torch.Generator().manual_seed(dims)
    n_local, layers = 24, [24 + 40, 136, 72, 20, 3]
    dec = MLP(layers, activation=act, last_activation=False, generator=gen).to(cuda)
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda)  # noqa: E731
    v, jt, ht = rnd(2, 37, n_local), rnd(2, dims, 37, n_local), rnd(2, dims, 37, n_local)
    v_b = rnd(2, 45, n_local) if boundary else None
    g = rnd(2, 1, layers[0] - n_local)
    with torch.no_grad():
        got = decoder_cuda.decoder_prop(dec.linears, n_local, v, jt, ht, v_b, g, act)
        torch.cuda.synchronize()
        ref = decoder_cuda.decoder_prop_plain(dec.linears, n_local, v, jt, ht, v_b, g, act)
    for a, r in zip(got, ref):
        assert_close(a, r)


def test_slice_on_card_matches_cpu(cuda):
    cfg = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 32, 32],
               fe_global_layers=[37, 48, 64, 256], seg_layers=[288, 128, 64, 32, 3],
               scalers=make_scalers())
    gpu = pipn_foam(**cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    cpu = pipn_foam(**cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = make_foam_batch(3, 200, 96, 20, seed=2)
    launches = (pointnet_cuda.pointnet_global.launches, decoder_cuda.decoder_prop.launches)
    with torch.no_grad():
        out_g = gpu.derivative_apply(batch.to(cuda))
        out_c = cpu.derivative_apply(batch)
    assert (pointnet_cuda.pointnet_global.launches - launches[0],
            decoder_cuda.decoder_prop.launches - launches[1]) == (1, 2)
    for a, r in zip(out_g, out_c):
        assert_close(a.cpu(), r)


def _params(module):
    return [p for p in module.parameters()]


@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("b,n,layers", [(2, 64, [16, 24, 32]), (3, 301, [21, 16, 32, 200]),
                                        (1, 7, [5, 130])])
def test_pointnet_backward_matches_plain(cuda, act, b, n, layers):
    """Gradients of sum(cot * max) through the kernels against autograd
    through the plain MLP gathered at the kernel's winners (the tie rule is
    the forward's; near-ties may legitimately pick another row)."""
    gen = torch.Generator().manual_seed(n + 1)
    mlp = MLP(layers, activation=act, generator=gen).to(cuda)
    x = torch.randn((b, n, layers[0]), generator=gen).to(cuda).requires_grad_()
    cot = torch.randn((b, 1, layers[-1]), generator=gen).to(cuda)
    before = pointnet_cuda.pointnet_global_backward.launches
    m, arg = pointnet_cuda.pointnet_global(mlp.linears, x, act)
    got = torch.autograd.grad((m * cot).sum(), [x, *_params(mlp)])
    torch.cuda.synchronize()
    assert pointnet_cuda.pointnet_global_backward.launches == before + 1
    ref_m = pointnet_cuda.pointnet_global_at(mlp.linears, x, act, arg)
    ref = torch.autograd.grad((ref_m * cot).sum(), [x, *_params(mlp)])
    for a, r in zip(got, ref):
        assert_close(a, r)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("act,dims,boundary", [("silu", 2, True), ("tanh", 2, False),
                                               ("silu", 3, True), ("tanh", 1, True)])
def test_decoder_backward_matches_plain(cuda, act, dims, boundary, rate):
    gen = torch.Generator().manual_seed(10 + dims)
    n_local, layers = 24, [24 + 40, 136, 72, 20, 3]
    dec = MLP(layers, activation=act, last_activation=False, generator=gen).to(cuda)
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_()  # noqa: E731
    v, jt, ht = rnd(2, 37, n_local), rnd(2, dims, 37, n_local), rnd(2, dims, 37, n_local)
    v_b = rnd(2, 45, n_local) if boundary else None
    g = rnd(2, 1, layers[0] - n_local)
    drop = [rate, rate, 0.0, 0.0]
    inputs = [t for t in (v, jt, ht, v_b, g) if t is not None] + _params(dec)
    args = (dec.linears, n_local, v, jt, ht, v_b, g, act, drop, False, 1234)
    before = (decoder_cuda.decoder_prop.launches, decoder_cuda.decoder_prop_backward.launches)
    out = decoder_cuda.decoder_prop(*args)
    cots = [torch.randn(o.shape, generator=gen).to(cuda) for o in out]
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), inputs)
    torch.cuda.synchronize()
    n = 2 if boundary else 1
    assert (decoder_cuda.decoder_prop.launches - before[0],
            decoder_cuda.decoder_prop_backward.launches - before[1]) == (n, n)
    ref_out = decoder_cuda.decoder_prop_plain(*args)
    for a, r in zip(out, ref_out):
        assert_close(a.detach(), r.detach())
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), inputs)
    for a, r in zip(got, ref):
        assert_close(a, r)


def test_decoder_dropout_masks_match_plain(cuda):
    """Forward with dropout: mask for mask, the kernel zeroes exactly the
    columns the plain version zeroes."""
    gen = torch.Generator().manual_seed(7)
    n_local, layers = 16, [16 + 16, 64, 32, 3]
    dec = MLP(layers, activation="silu", last_activation=False, generator=gen).to(cuda)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)  # noqa: E731
    v, jt, ht, v_b, g = (rnd(3, 50, n_local), rnd(3, 2, 50, n_local), rnd(3, 2, 50, n_local),
                         rnd(3, 30, n_local), rnd(3, 1, 16))
    # an identity-like last layer exposes the second hidden layer's mask
    for seed in (0, 99, 2 ** 40 + 5):
        args = (dec.linears, n_local, v, jt, ht, v_b, g, "silu", [0.5, 0.5, 0.0], False, seed)
        with torch.no_grad():
            got = decoder_cuda.decoder_prop(*args)
            ref = decoder_cuda.decoder_prop_plain(*args)
        for a, r in zip(got, ref):
            assert_close(a, r)


def test_philox_known_answers(cuda):
    """Random123's known-answer values of Philox4x32-10."""
    rows = torch.tensor([[0, 0, 0, 0, 0, 0],
                         [0xFFFFFFFF] * 6,
                         [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344,
                          0xA4093822, 0x299F31D0]], dtype=torch.int64, device=cuda)
    want = [[0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
            [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD],
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]]
    assert decoder_cuda.philox(rows).cpu().tolist() == want


def test_slice_gradients_on_card_match_cpu(cuda):
    """The repair of the kernel path's gradients: a loss on derivative_apply
    with dropout on gives the same parameter gradients on the card as on the
    CPU."""
    cfg = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 32, 32],
               fe_global_layers=[37, 48, 64, 256], seg_layers=[288, 128, 64, 32, 3],
               seg_dropout=[0.1, 0.1, 0, 0], scalers=make_scalers())
    gpu = pipn_foam(**cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    cpu = pipn_foam(**cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = make_foam_batch(3, 200, 96, 20, seed=2)
    grads = []
    for model, b in ((gpu, batch.to(cuda)), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=False, seed=77)
        loss = sum((o ** 2).mean() for o in out)
        grads.append(torch.autograd.grad(loss, list(model.module.parameters())))
    for a, r in zip(*grads):
        assert_close(a.cpu(), r)


# ---------------------------------------------------------------------------
# PI-GANO: the trunk kernel, and pointnet_global at the model's widths


@pytest.mark.parametrize("layers", [[7, 64, 176, 176, 176], [8, 128, 352, 352, 352]])
def test_pointnet_at_pi_gano_widths(cuda, layers):
    """Last layers 176 and 352 wide (not multiples of 128), winner-row dot
    products as long, a point count that is not a multiple of 64, and an
    input without a gradient: forward, argmax and backward."""
    gen = torch.Generator().manual_seed(layers[-1])
    mlp = MLP(layers, activation="silu", generator=gen).to(cuda)
    x = torch.randn((3, 175, layers[0]), generator=gen).to(cuda)
    cot = torch.randn((3, 1, layers[-1]), generator=gen).to(cuda)
    m, arg = pointnet_cuda.pointnet_global(mlp.linears, x, "silu")
    got = torch.autograd.grad((m * cot).sum(), _params(mlp))
    torch.cuda.synchronize()
    with torch.no_grad():
        rm, ra = pointnet_cuda.pointnet_global_plain(mlp.linears, x, "silu")
        g = analytic.mlp_value(mlp.linears, x, "silu")
    assert_close(m.detach(), rm)
    top2 = torch.topk(g, 2, dim=-2).values
    decided = (top2[:, 0] - top2[:, 1]) > RTOL * rm.abs().max()
    assert torch.equal(arg[:, 0][decided], ra[:, 0][decided])
    ref_m = pointnet_cuda.pointnet_global_at(mlp.linears, x, "silu", arg)
    ref = torch.autograd.grad((ref_m * cot).sum(), _params(mlp))
    for a, r in zip(got, ref):
        assert_close(a, r)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("act,dims,boundary,f", [("silu", 2, True, 136), ("tanh", 2, False, 40),
                                                 ("silu", 3, True, 40), ("tanh", 1, True, 136)])
def test_neural_ops_kernel_matches_plain(cuda, act, dims, boundary, f, rate):
    """Forward and backward against the plain version, dropout on and off;
    widths 40 and 136 leave a tail past the 128-column chunk and 32-deep
    weight tiles. dpar collects all three streams."""
    gen = torch.Generator().manual_seed(20 + dims)
    n_local = f // 2
    ops = NeuralOperatorSequential(3, f, (0.0,) * 3, act, generator=gen).to(cuda)
    red = dense(f, 3, gen).to(cuda)
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_()  # noqa: E731
    v, jt, ht = rnd(2, 37, n_local), rnd(2, dims, 37, n_local), rnd(2, dims, 37, n_local)
    v_b = rnd(2, 45, n_local) if boundary else None
    geom = rnd(2, 1, f - n_local)
    par = (torch.rand((2, 1, f), generator=gen) + 0.5).to(cuda).requires_grad_()
    inputs = [t for t in (v, jt, ht, v_b, geom, par) if t is not None] + \
        _params(ops) + _params(red)
    args = (ops.linears, red, n_local, v, jt, ht, v_b, geom, par, act, [0.0, rate, rate],
            False, 1234)
    before = (neural_op_cuda.neural_ops_prop.launches,
              neural_op_cuda.neural_ops_prop_backward.launches)
    out = neural_op_cuda.neural_ops_prop(*args)
    cots = [torch.randn(o.shape, generator=gen).to(cuda) for o in out]
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), inputs)
    torch.cuda.synchronize()
    n = 2 if boundary else 1
    assert (neural_op_cuda.neural_ops_prop.launches - before[0],
            neural_op_cuda.neural_ops_prop_backward.launches - before[1]) == (n, n)
    ref_out = neural_op_cuda.neural_ops_prop_plain(*args)
    for a, r in zip(out, ref_out):
        assert_close(a.detach(), r.detach())
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), inputs)
    for a, r in zip(got, ref):
        assert_close(a, r)


def test_pi_gano_slice_on_card_matches_cpu(cuda):
    """derivative_apply with dropout on: outputs and parameter gradients on
    the card equal the CPU's; launches 2 pointnet_global and 2
    neural_ops_prop per batch."""
    cfg = dict(nu=1e-3, out_features=3, branch_layers=[8, 32, 80, 80],
               geometry_layers=[7, 16, 40, 40], local_layers=[2, 16, 40, 40], n_operators=3,
               operator_dropout=[0, 0.1, 0.1], variable_boundaries=VARIABLE_BOUNDARIES,
               scalers=make_scalers(), fast_derivatives=True)
    gpu = pi_gano(**cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    cpu = pi_gano(**cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = make_foam_batch(3, 200, 96, 20, seed=2)
    before = (pointnet_cuda.pointnet_global.launches, neural_op_cuda.neural_ops_prop.launches)
    results = []
    for model, b in ((gpu, gpu.attach_neighbors(batch.to(cuda))), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=False, seed=77)
        loss = sum((o ** 2).mean() for o in out)
        results.append((out, torch.autograd.grad(loss, list(model.module.parameters()))))
    assert (pointnet_cuda.pointnet_global.launches - before[0],
            neural_op_cuda.neural_ops_prop.launches - before[1]) == (2, 2)
    for a, r in zip(results[0][0], results[1][0]):
        assert_close(a.detach().cpu(), r.detach())
    for a, r in zip(results[0][1], results[1][1]):
        assert_close(a.cpu(), r)


# ---------------------------------------------------------------------------
# PIPN++: the SetAbstraction neighbourhood kernel and FPS


def _sa_input_tensors(gen, b, n, c, k, f_in, d, empty_every):
    """Random level inputs on the CPU: idx into n source rows (padding at
    index 0 with mask False), some neighbourhoods emptied."""
    x = torch.randn((b, n, f_in), generator=gen)
    idx = torch.randint(0, n, (b, c, k), generator=gen)
    mask = torch.rand((b, c, k), generator=gen) > 0.2
    if empty_every:
        mask[:, ::empty_every] = False
    idx = torch.where(mask, idx, torch.zeros_like(idx))
    rel = torch.rand((b, c, k, d), generator=gen) * 2 - 1
    xg = torch.gather(x, 1, idx.reshape(b, -1)[..., None].expand(-1, -1, f_in))
    return x, idx, mask, rel, xg


def _sa_inputs(gen, cuda, b, n, c, k, f_in, d, empty_every):
    """_sa_input_tensors on the card."""
    return [t.to(cuda) for t in _sa_input_tensors(gen, b, n, c, k, f_in, d, empty_every)]


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("act,b,n,c,k,layers,empty", [
    ("silu", 2, 40, 13, 8, [8, 16, 24], 3),         # 8 centroids a tile, odd count
    ("tanh", 2, 40, 13, 8, [8, 24], 0),             # one layer
    ("silu", 3, 300, 37, 64, [8, 64, 64], 5),       # PIPN++ level 0's stack
    ("tanh", 2, 200, 11, 48, [7, 136, 200], 0),     # K not dividing 64; widths past 128
    ("silu", 2, 130, 21, 64, [66, 128, 128], 4),    # PIPN++ level 1's stack
])
def test_sa_kernel_matches_plain(cuda, static, act, b, n, c, k, layers, empty):
    """Forward and backward against the plain version: values, every
    parameter gradient and, in the dynamic variant, dx through dP."""
    from porous_cfd_tpu_torch.ops import sa_cuda
    gen = torch.Generator().manual_seed(c + k)
    d = 2
    mlp = MLP(layers, activation=act, generator=gen).to(cuda)
    x, idx, mask, rel, xg = _sa_inputs(gen, cuda, b, n, c, k, layers[0] - d, d, empty)
    x.requires_grad_(not static)
    xg_arg = xg if static else None
    cot = torch.randn((b, c, layers[-1]), generator=gen).to(cuda)
    wrt = ([] if static else [x]) + _params(mlp)
    before = (sa_cuda.sa_neighborhood.launches, sa_cuda.sa_neighborhood_backward.launches)
    out = sa_cuda.sa_neighborhood(mlp.linears, x, idx, mask, rel, act, xg_arg)
    got = torch.autograd.grad((out * cot).sum(), wrt)
    torch.cuda.synchronize()
    assert (sa_cuda.sa_neighborhood.launches - before[0],
            sa_cuda.sa_neighborhood_backward.launches - before[1]) == (1, 1)
    ref_out = sa_cuda.sa_neighborhood_plain(mlp.linears, x, idx, mask, rel, act, xg_arg)
    assert_close(out.detach(), ref_out.detach())
    if empty:
        assert torch.all(out.detach()[~mask.any(-1)] == 0)
    ref = torch.autograd.grad((ref_out * cot).sum(), wrt)
    for a, r in zip(got, ref):
        assert_close(a, r)


def test_sa_backward_alternating_shapes(cuda):
    """The backward keeps one block count per shape and sets its shared
    memory on every launch: level 1's widths, then level 0's (less shared
    memory), then level 1's again on the same inputs, each against the plain
    version, and the repeat's parameter gradients bit for bit the first's."""
    from porous_cfd_tpu_torch.ops import sa_cuda
    runs = []
    for layers, c in (([66, 128, 128], 21), ([8, 64, 64], 37), ([66, 128, 128], 21)):
        gen = torch.Generator().manual_seed(c)
        mlp = MLP(layers, activation="silu", generator=gen).to(cuda)
        x, idx, mask, rel, xg = _sa_inputs(gen, cuda, 2, 130, c, 64, layers[0] - 2, 2, 0)
        cot = torch.randn((2, c, layers[-1]), generator=gen).to(cuda)
        out = sa_cuda.sa_neighborhood(mlp.linears, x, idx, mask, rel, "silu", xg)
        got = torch.autograd.grad((out * cot).sum(), _params(mlp))
        ref_out = sa_cuda.sa_neighborhood_plain(mlp.linears, x, idx, mask, rel, "silu", xg)
        for a, r in zip(got, torch.autograd.grad((ref_out * cot).sum(), _params(mlp))):
            assert_close(a, r)
        runs.append(got)
    for a, r in zip(runs[2], runs[0]):
        assert torch.equal(a, r)


def test_sa_kernel_ties_take_the_first_row(cuda):
    """Source rows 1 and 4 are equal and reached with equal rel: the two
    neighbours tie on every channel, and dx goes all to row 1."""
    from porous_cfd_tpu_torch.ops import sa_cuda
    gen = torch.Generator().manual_seed(3)
    mlp = MLP([7, 16, 16], activation="silu", generator=gen).to(cuda)
    x = torch.randn((1, 6, 5), generator=gen)
    x[0, 4] = x[0, 1]
    x = x.to(cuda).requires_grad_()
    idx = torch.tensor([[[2, 1, 4, 5]]], device=cuda)
    mask = torch.tensor([[[False, True, True, False]]], device=cuda)
    rel = torch.zeros((1, 1, 4, 2), device=cuda)
    out = sa_cuda.sa_neighborhood(mlp.linears, x, idx, mask, rel, "silu")
    (dx,) = torch.autograd.grad(out.sum(), [x])
    assert torch.count_nonzero(dx[0, 1]) == 5
    assert torch.all(dx[0, [0, 2, 3, 4, 5]] == 0)


# The SA kernels' winner-row design on cases that reach its edges: K of 64
# and 32, and K of 20 and 48 that do not divide a 64-row tile; centroid
# counts that leave a ragged last tile (and an idle warpgroup); widths 64,
# 128, 176 and 256 (a 64-, 128- or 176-column chunk, resident split weights
# or a ring); masks that are not a prefix and emptied neighbourhoods; exact
# ties across rows (repeated idx at equal rel); three layers (the backward's
# recompute and reverse sweep through block_mma16). Each: values within
# RTOL of the plain version, the argmax equal to its first maximal valid
# neighbour where the top two differ by more than RTOL, every gradient (dx
# too) within RTOL of the plain level at the kernel's argmax, the
# compaction equal to sa_winner_rows, two backwards bit for bit, no
# synchronizing call, one launch each way.
SA_CASES = {
    # (B, source rows, C, K, layers, empty every)
    "k64_w64": (2, 300, 37, 64, [8, 64, 64], 5),
    "k32_w176_ragged": (3, 200, 13, 32, [66, 176, 176], 4),
    "k20_w128": (2, 150, 11, 20, [66, 128, 128], 3),
    "k48_w256": (2, 120, 5, 48, [66, 256, 256], 0),
    "k16_nonprefix": (2, 60, 9, 16, [8, 24, 16], 4),
    "ties": (2, 40, 7, 8, [7, 16, 16], 0),
    "three_layers": (2, 90, 9, 24, [8, 32, 48, 40], 3),
}


def _sa_case(case, act, static, cuda):
    from porous_cfd_tpu_torch.ops import sa_cuda
    b, n, c, k, layers, empty = SA_CASES[case]
    gen = torch.Generator().manual_seed(len(case) + k)
    mlp = MLP(layers, activation=act, generator=gen).to(cuda)
    x, idx, mask, rel, xg = _sa_input_tensors(gen, b, n, c, k, layers[0] - 2, 2, empty)
    if case == "ties":  # neighbours 1, 4 and 5 read one row at equal rel
        idx[:, :, 4] = idx[:, :, 5] = idx[:, :, 1]
        rel[:, :, 4] = rel[:, :, 5] = rel[:, :, 1]
        mask[:, :, [1, 4, 5]] = True
        xg = torch.gather(x, 1, idx.reshape(b, -1)[..., None].expand(-1, -1, x.shape[-1]))
    cot = torch.randn((b, c, layers[-1]), generator=gen)
    x, idx, mask, rel, xg, cot = [t.to(cuda) for t in (x, idx, mask, rel, xg, cot)]
    xg = xg if static else None
    call = sa_cuda.level_call(mlp.linears, x, idx, mask, rel, act, xg)
    return mlp, x, idx, mask, rel, xg, cot, call


def _check_winner_backward(mlp, x, idx, mask, rel, xg, cot, call, act, static):
    """The public wrapper's forward and backward on one level against the
    plain version, its compaction, two bitwise backwards and no
    synchronizing call (see SA_CASES). Returns (argmax, plain argmax)."""
    from porous_cfd_tpu_torch.ops import sa_cuda
    lin = mlp.linears
    xr = x.clone().requires_grad_(not static)
    wrt = ([] if static else [xr]) + _params(mlp)
    before = (sa_cuda.sa_neighborhood.launches, sa_cuda.sa_neighborhood_backward.launches)
    out = sa_cuda.sa_neighborhood(lin, xr, idx, mask, rel, act, xg)
    got = torch.autograd.grad((out * cot).sum(), wrt)
    torch.cuda.synchronize()
    assert (sa_cuda.sa_neighborhood.launches - before[0],
            sa_cuda.sa_neighborhood_backward.launches - before[1]) == (1, 1)
    _, arg = sa_cuda._forward(call)  # the argmax the backward was given: same kernel, inputs
    with torch.no_grad():
        ref_out, ref_arg = sa_cuda.sa_neighborhood_plain(lin, x, idx, mask, rel, act, xg,
                                                         with_argmax=True)
        h = sa_cuda._plain_rows(lin, x, idx, mask, rel, act, xg)
    assert_close(out.detach(), ref_out)
    empty = ~mask.any(-1)
    assert torch.all(out.detach()[empty] == 0) and torch.all(arg[empty] == -1)
    top2 = torch.topk(h.masked_fill(~mask[..., None], -1e30), 2, dim=2).values
    decided = ((top2[:, :, 0] - top2[:, :, 1]) > RTOL * ref_out.abs().max()) | \
        (mask.sum(-1, keepdim=True) < 2)
    assert torch.equal(arg[decided], ref_arg[decided])
    del h, top2
    ref_at = sa_cuda.sa_neighborhood_at(lin, xr, idx, mask, rel, act, arg, xg)
    ref = torch.autograd.grad((ref_at * cot).sum(), wrt)
    for a, r in zip(got, ref):
        assert_close(a, r)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [sa_cuda.sa_neighborhood_backward(call, arg, cot, winners=True)
                for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows, slot, count = sa_cuda.sa_winner_rows(arg, mask)
    k_rows, k_slot, k_count = runs[0][3]
    assert torch.equal(k_count.long(), count) and torch.equal(k_slot.long(), slot)
    assert torch.equal(k_rows.long(), rows)
    flat = [[t for t in (*r[0], *r[1], r[2]) if t is not None] for r in runs]
    assert all(torch.equal(u, v) for u, v in zip(*flat))
    # autograd's gradients are the kernel's (the dynamic W0's rel columns:
    # its W0r block; b0's comes through P)
    dws, dbs = runs[0][0], runs[0][1]
    params = got[0 if static else 1:]
    for i in range(len(lin)):
        dw = params[2 * i] if static or i else params[0][:, -rel.shape[-1]:]
        assert torch.equal(dws[i].t(), dw)
        if dbs[i] is not None:
            assert torch.equal(dbs[i], params[2 * i + 1])
    return arg, ref_arg


@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("case", list(SA_CASES))
def test_sa_winner_backward_cases(cuda, case, static, act):
    mlp, x, idx, mask, rel, xg, cot, call = _sa_case(case, act, static, cuda)
    arg, ref_arg = _check_winner_backward(mlp, x, idx, mask, rel, xg, cot, call, act, static)
    if case == "ties":
        assert torch.equal(arg, ref_arg)
        assert torch.all(arg[torch.isin(arg, torch.tensor([1, 4, 5], device=cuda,
                                                          dtype=arg.dtype))] == 1)


# Shapes past the paths' 500 source rows and 500 centroids a case, which the
# backward's compaction takes in passes: more than 65,535 source rows and
# compact rows a case (the dP sort in 39-41 passes of source rows), and
# centroids whose winner masks do not fit its shared memory (dynamic, two
# passes; static). Checked as SA_CASES are.
SA_LARGE = {
    # (static, B, source rows, C, K, layers)
    "n_src_70000": (False, 2, 70000, 1100, 64, [66, 64, 64]),
    "cent_9000": (False, 1, 2000, 9000, 8, [10, 32, 16]),
    "cent_20000_static": (True, 1, 500, 20000, 4, [8, 32, 16]),
}


@pytest.mark.parametrize("case", list(SA_LARGE))
def test_sa_winner_backward_large_shapes(cuda, case):
    from porous_cfd_tpu_torch.ops import sa_cuda
    static, b, n, c, k, layers = SA_LARGE[case]
    gen = torch.Generator().manual_seed(c + k)
    mlp = MLP(layers, activation="silu", generator=gen).to(cuda)
    x, idx, mask, rel, xg = _sa_inputs(gen, cuda, b, n, c, k, layers[0] - 2, 2, 7)
    cot = torch.randn((b, c, layers[-1]), generator=gen).to(cuda)
    xg = xg if static else None
    call = sa_cuda.level_call(mlp.linears, x, idx, mask, rel, "silu", xg)
    _check_winner_backward(mlp, x, idx, mask, rel, xg, cot, call, "silu", static)


# Widths past what the kernels' blocks take raise, before any launch, rather
# than give a wrong result: the backward's last layer on more than 256
# inputs or with more than 1024 channels; a hidden layer too wide for the
# forward's two 64-row tiles of input rows in shared memory.
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("layers", [[8, 320, 64], [8, 64, 1040], [8, 1024, 64]],
                         ids=["last_inputs_320", "channels_1040", "hidden_1024"])
def test_sa_shapes_past_the_kernel_limits_raise(cuda, static, layers):
    from porous_cfd_tpu_torch.ops import sa_cuda
    gen = torch.Generator().manual_seed(len(layers))
    mlp = MLP(layers, activation="silu", generator=gen).to(cuda)
    x, idx, mask, rel, xg = _sa_inputs(gen, cuda, 2, 40, 9, 16, layers[0] - 2, 2, 0)
    x.requires_grad_(not static)
    wrt = ([] if static else [x]) + _params(mlp)
    with pytest.raises(ValueError, match="no kernel block fits"):
        out = sa_cuda.sa_neighborhood(mlp.linears, x, idx, mask, rel, "silu",
                                      xg if static else None)
        torch.autograd.grad(out.sum(), wrt)


@pytest.mark.parametrize("b,n,d,n_samples", [
    (52, 1000, 2, 500), (52, 500, 2, 125), (1, 1000, 2, 500), (2, 57, 3, 19), (3, 300, 1, 50),
    (4, 33, 2, 20), (2, 1001, 2, 300), (2, 1000, 1, 250), (2, 1000, 3, 250),
    (1, 40000, 2, 1000), (2, 20000, 3, 300), (1, 5000, 1, 500), (2, 200, 2, 200),
    (2, 100, 3, 150)])
def test_fps_kernel_equals_plain(cuda, b, n, d, n_samples):
    """Indices equal, not close, and one launch a call: PIPN++'s levels at
    52 cases and at one; sizes that are no multiple of a block's threads;
    1D and 3D; clouds past the old one-block cap of shared memory, which
    run as thread-block clusters (design B); as many samples as points and
    more (the picks then repeat point 0)."""
    from porous_cfd_tpu_torch.ops import fps_cuda
    pos = (torch.rand((b, n, d), generator=torch.Generator().manual_seed(n)) * 2 - 1).to(cuda)
    before = fps_cuda.farthest_point_sampling.launches
    got = fps_cuda.farthest_point_sampling(pos, n_samples)
    torch.cuda.synchronize()
    assert fps_cuda.farthest_point_sampling.launches == before + 1
    assert got.shape == (b, n_samples) and got.dtype == torch.int64
    assert torch.equal(got, fps_cuda.farthest_point_sampling_plain(pos, n_samples))


def test_fps_kernel_ties_take_the_first_index(cuda):
    from porous_cfd_tpu_torch.ops import fps_cuda
    square = torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]] * 2, dtype=torch.float32,
                          device=cuda)[None]
    assert fps_cuda.farthest_point_sampling(square, 4).tolist() == [[0, 3, 1, 2]]


@pytest.mark.parametrize("first,second", [(3000, 35000), (35000, 3000)])
def test_fps_cluster_ties_take_the_first_index(cuda, first, second):
    """A farthest point held twice, in two CTAs' slices of one cluster
    (design B): the lowest index wins, whichever CTA reports first."""
    from porous_cfd_tpu_torch.ops import fps_cuda
    n = 40000
    assert fps_cuda.fps_design(1, n, 2).kind == "B"
    pos = torch.rand((1, n, 2), generator=torch.Generator().manual_seed(5))
    pos[0, 0] = 0.0
    pos[0, first] = pos[0, second] = 9.0
    got = fps_cuda.farthest_point_sampling(pos.to(cuda), 50)
    assert got[0, 1].item() == min(first, second)
    assert torch.equal(got.cpu(), fps_cuda.farthest_point_sampling_plain(pos, 50))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_fps_past_the_cluster_limit_raises(cuda, d):
    """A cloud past design B's limit raises ValueError before any launch."""
    from porous_cfd_tpu_torch.ops import fps_cuda
    pos = torch.zeros((1, fps_cuda.MAX_POINTS + 1, d), device=cuda)
    before = fps_cuda.farthest_point_sampling.launches
    with pytest.raises(ValueError, match="exceed the kernel's limit"):
        fps_cuda.farthest_point_sampling(pos, 10)
    assert fps_cuda.farthest_point_sampling.launches == before


def test_pipn_pp_slice_on_card_matches_cpu(cuda):
    """derivative_apply with dropout on, on one neighbour chain (built on the
    CPU, copied to the card): outputs and parameter gradients on the card
    equal the CPU's; launches 2 sa_neighborhood, 1 pointnet_global and 2
    decoder_prop per batch, their backwards once each, no FPS."""
    from porous_cfd_tpu_torch.models.pipn import pipn_foam_pp
    from porous_cfd_tpu_torch.ops import fps_cuda, sa_cuda
    cfg = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 32, 32],
               fe_global_layers=[[8, 32, 32], [34, 64, 64], [66, 64, 256]],
               fe_radius=[0.5, 1.0], fe_fraction=[0.5, 0.25],
               seg_layers=[288, 96, 32, 3], seg_dropout=[0.1, 0.0, 0.0], scalers=make_scalers())
    gpu = pipn_foam_pp(**cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    cpu = pipn_foam_pp(**cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = cpu.attach_neighbors(make_foam_batch(3, 200, 96, 20, seed=2))
    counters = (sa_cuda.sa_neighborhood, sa_cuda.sa_neighborhood_backward,
                pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_backward,
                fps_cuda.farthest_point_sampling)
    before = [c.launches for c in counters]
    results = []
    for model, b in ((gpu, batch.to(cuda)), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=False, seed=77)
        loss = sum((o ** 2).mean() for o in out)
        results.append((out, torch.autograd.grad(loss, list(model.module.parameters()))))
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 1, 1, 2, 2, 0]
    for a, r in zip(results[0][0], results[1][0]):
        assert_close(a.detach().cpu(), r.detach())
    for a, r in zip(results[0][1], results[1][1]):
        assert_close(a.cpu(), r)


# ---------------------------------------------------------------------------
# the decoder's max-pool-coupled modes, and PIPN's coupled and exact paths


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("mode,act,dims,boundary", [
    ("j0_add", "silu", 2, True), ("j0_add", "tanh", 3, False), ("j0_add", "tanh", 1, True),
    ("ctx_width", "silu", 2, True), ("ctx_width", "tanh", 1, False),
    ("ctx_width", "silu", 3, True)])
def test_decoder_coupled_modes_match_plain(cuda, mode, act, dims, boundary, rate):
    """Forward and backward of both coupled modes against the plain
    version: every output and every gradient, dja/dha (the kernel's GZ_0
    rows) and the context derivatives and the context block of W0 (kernel
    dW0 plus autograd through ctx) included. A 300-wide context spans three
    staging chunks, the last one partial."""
    gen = torch.Generator().manual_seed(30 + dims)
    n_local, g_width = 24, (40 if mode == "j0_add" else 300)
    layers = [n_local + g_width, 136, 72, 20, 3]
    dec = MLP(layers, activation=act, last_activation=False, generator=gen).to(cuda)
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_()  # noqa: E731
    v, jt, ht = rnd(2, 37, n_local), rnd(2, dims, 37, n_local), rnd(2, dims, 37, n_local)
    v_b = rnd(2, 45, n_local) if boundary else None
    g = rnd(2, 1, g_width)
    if mode == "j0_add":
        xj, xh = rnd(2, dims, 37, layers[1]), rnd(2, dims, 37, layers[1])
        kw = dict(j0_add=xj, h0_add=xh)
    else:   # sparse, as at the pooling winners' rows
        keep = (torch.rand((2, 1, 37, 1), generator=gen) < 0.2).float().to(cuda)
        xj = (torch.randn((2, dims, 37, g_width), generator=gen).to(cuda) * keep).requires_grad_()
        xh = (torch.randn((2, dims, 37, g_width), generator=gen).to(cuda) * keep).requires_grad_()
        kw = dict(jctx_t=xj, hctx_t=xh)
    inputs = [t for t in (v, jt, ht, v_b, g, xj, xh) if t is not None] + _params(dec)
    args = (dec.linears, n_local, v, jt, ht, v_b, g, act, [rate, rate, 0.0, 0.0], False, 99)
    fwd_c, bwd_c = decoder_cuda.MODE_COUNTS[mode]
    before = (decoder_cuda.decoder_prop.launches, decoder_cuda.decoder_prop_backward.launches,
              fwd_c.launches, bwd_c.launches)
    out = decoder_cuda.decoder_prop(*args, **kw)
    cots = [torch.randn(o.shape, generator=gen).to(cuda) for o in out]
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), inputs)
    torch.cuda.synchronize()
    n = 2 if boundary else 1
    assert (decoder_cuda.decoder_prop.launches - before[0],
            decoder_cuda.decoder_prop_backward.launches - before[1],
            fwd_c.launches - before[2], bwd_c.launches - before[3]) == (n, n, 1, 1)
    ref_out = decoder_cuda.decoder_prop_plain(*args, **kw)
    for a, r in zip(out, ref_out):
        assert_close(a.detach(), r.detach())
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), inputs)
    for a, r in zip(got, ref):
        assert_close(a, r)


COUPLED_CFG = dict(nu=1e-3, d=100.0, f=1.0, fe_local_layers=[2, 32, 32],
                   fe_global_layers=[37, 48, 64, 256], seg_layers=[288, 128, 64, 32, 3],
                   seg_dropout=[0.1, 0.1, 0, 0], scalers=make_scalers())


def test_coupled_slice_on_card_matches_cpu(cuda):
    """pipn_foam(coupled_context=True): one pointnet_global and two
    decoder_prop launches (the internal one in the j0_add mode) a forward,
    as many backward; values, J, H and the parameter gradients of a loss on
    them, dropout on, as on the CPU."""
    gpu = pipn_foam(**COUPLED_CFG, coupled_context=True,
                    generator=torch.Generator().manual_seed(1), device=cuda)
    cpu = pipn_foam(**COUPLED_CFG, coupled_context=True,
                    generator=torch.Generator().manual_seed(1), device="cpu")
    batch = make_foam_batch(3, 200, 96, 20, seed=2)
    counters = (pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_backward,
                *decoder_cuda.MODE_COUNTS["j0_add"])
    before = [c.launches for c in counters]
    res = []
    for model, b in ((gpu, batch.to(cuda)), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=False, seed=77)
        loss = sum((o ** 2).mean() for o in out)
        res.append(([o.detach().cpu() for o in out],
                    torch.autograd.grad(loss, list(model.module.parameters()))))
        if model is gpu:
            torch.cuda.synchronize()
            assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 2, 2, 1, 1]
    for a, r in zip(res[0][0], res[1][0]):
        assert_close(a, r)
    for a, r in zip(res[0][1], res[1][1]):
        assert_close(a.cpu(), r)


def test_exact_path_on_card_launches_no_kernel(cuda):
    """pipn_foam(fast_derivatives=False) runs the plain module under
    autograd: no kernel launches, the losses and gradients as on the CPU."""
    from porous_cfd_tpu_torch.ops import fps_cuda, sa_cuda
    from porous_cfd_tpu_torch.train.engine import compute_losses
    counters = (pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_backward,
                neural_op_cuda.neural_ops_prop, neural_op_cuda.neural_ops_prop_backward,
                sa_cuda.sa_neighborhood, sa_cuda.sa_neighborhood_backward,
                fps_cuda.farthest_point_sampling)
    before = [c.launches for c in counters]
    batch = make_foam_batch(2, 120, 48, 20, seed=3)
    res = []
    for dev in (cuda, torch.device("cpu")):
        model = pipn_foam(**COUPLED_CFG, fast_derivatives=False,
                          generator=torch.Generator().manual_seed(5), device=dev)
        losses, _ = compute_losses(model, batch.to(dev), seed=11)
        res.append((losses.detach().cpu(),
                    torch.autograd.grad(losses.sum(), list(model.module.parameters()))))
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert_close(res[0][0], res[1][0])
    for a, r in zip(res[0][1], res[1][1]):
        assert_close(a.cpu(), r)


# ---------------------------------------------------------------------------
# the trunk's linear-last-operator and no-reduction modes, PiGanoFull and
# PI-GANO++


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("last_activation,reduction", [(False, True), (True, False),
                                                       (False, False)],
                         ids=["linear_last", "no_reduction", "both"])
@pytest.mark.parametrize("act,dims,boundary,f", [("silu", 2, True, 136), ("tanh", 2, False, 40),
                                                 ("silu", 3, True, 40)])
def test_neural_ops_modes_match_plain(cuda, act, dims, boundary, f, last_activation,
                                      reduction, rate):
    """The two other modes, alone and together, forward and backward against
    the plain version, dropout on and off; the outputs are F wide without a
    reduction, and dpar collects the linear operator's streams too."""
    gen = torch.Generator().manual_seed(40 + dims)
    n_local = f // 2
    ops = NeuralOperatorSequential(3, f, (0.0,) * 3, act, last_activation=last_activation,
                                   generator=gen).to(cuda)
    red = dense(f, 3, gen).to(cuda) if reduction else None
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_()  # noqa: E731
    v, jt, ht = rnd(2, 37, n_local), rnd(2, dims, 37, n_local), rnd(2, dims, 37, n_local)
    v_b = rnd(2, 45, n_local) if boundary else None
    geom = rnd(2, 1, f - n_local)
    par = (torch.rand((2, 1, f), generator=gen) + 0.5).to(cuda).requires_grad_()
    inputs = [t for t in (v, jt, ht, v_b, geom, par) if t is not None] + _params(ops) + (
        _params(red) if reduction else [])
    args = (ops.linears, red, n_local, v, jt, ht, v_b, geom, par, act, [0.0, rate, rate],
            False, 1234)
    mode = "_".join(m for m, on in (("linear_last", not last_activation),
                                    ("no_reduction", not reduction)) if on)
    counts = neural_op_cuda.MODE_COUNTS[mode]
    before = [c.launches for c in counts]
    out = neural_op_cuda.neural_ops_prop(*args, last_activation=last_activation)
    assert out[0].shape[-1] == (3 if reduction else f)
    cots = [torch.randn(o.shape, generator=gen).to(cuda) for o in out]
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), inputs)
    torch.cuda.synchronize()
    n = 2 if boundary else 1
    assert [c.launches - b for c, b in zip(counts, before)] == [n, n]
    ref_out = neural_op_cuda.neural_ops_prop_plain(*args, last_activation=last_activation)
    for a, r in zip(out, ref_out):
        assert_close(a.detach(), r.detach())
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), inputs)
    for a, r in zip(got, ref):
        assert_close(a, r)


PG_CFG = dict(nu=1e-3, out_features=3, branch_layers=[8, 32, 80, 80],
              local_layers=[2, 16, 40, 40], n_operators=3, operator_dropout=[0, 0.1, 0.1],
              variable_boundaries=VARIABLE_BOUNDARIES, scalers=make_scalers())


@pytest.mark.parametrize("variant", ["full", "pp"])
def test_pi_gano_variants_on_card_match_cpu(cuda, variant):
    """derivative_apply with dropout on: outputs and parameter gradients on
    the card equal the CPU's. PiGanoFull launches neural_ops_prop 6 times a
    batch (3 trunks x internal and boundary rows) and its backward 6 times;
    PI-GANO++ (32 neighbours) launches sa_neighborhood twice, pointnet_global
    twice (the global level and the branch) and neural_ops_prop twice."""
    from porous_cfd_tpu_torch.models.pi_gano import pi_gano_pp
    from porous_cfd_tpu_torch.ops import sa_cuda
    if variant == "full":
        def make(device):
            return pi_gano(**PG_CFG, geometry_layers=[7, 16, 40, 40], full=True,
                           fast_derivatives=True, generator=torch.Generator().manual_seed(1), device=device)
        want = [0, 0, 2, 2, 6, 6]
    else:
        def make(device):
            return pi_gano_pp(**PG_CFG, geometry_layers=[[8, 16, 16], [18, 40, 40],
                                                         [42, 40, 40]],
                              geometry_radius=[0.5, 1.0], geometry_fraction=[0.5, 0.25],
                              max_neighbors=32, generator=torch.Generator().manual_seed(1),
                              device=device)
        want = [2, 2, 2, 2, 2, 2]
    gpu, cpu = make(cuda), make("cpu")
    batch = cpu.attach_neighbors(make_foam_batch(3, 200, 96, 20, seed=2))
    counters = (sa_cuda.sa_neighborhood, sa_cuda.sa_neighborhood_backward,
                pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                neural_op_cuda.neural_ops_prop, neural_op_cuda.neural_ops_prop_backward)
    before = [c.launches for c in counters]
    results = []
    for model, b in ((gpu, batch.to(cuda)), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=False, seed=77)
        loss = sum((o ** 2).mean() for o in out)
        results.append((out, torch.autograd.grad(loss, list(model.module.parameters()))))
    assert [c.launches - n for c, n in zip(counters, before)] == want
    for a, r in zip(results[0][0], results[1][0]):
        assert_close(a.detach().cpu(), r.detach())
    for a, r in zip(results[0][1], results[1][1]):
        assert_close(a.cpu(), r)


def test_sync_sites_see_a_real_sync_and_none_in_a_training_step(cuda):
    """profile_predict.sync_sites counts a read of a value from the card
    (the mode's own prototype notice not counted), and a pipn training step
    makes no synchronizing call: it only queues work."""
    from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
    from porous_cfd_tpu_torch.profile_predict import sync_sites
    from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions
    x = torch.ones(4, device=cuda)
    assert len(sync_sites(lambda: x.sum().item())) == 1
    assert sync_sites(lambda: x * 2) == []
    model = pipn_foam(1e-3, 1.0, 1.0, [2, 16, 16], [21, 16, 64], [80, 32, 3], make_scalers(),
                      seg_dropout=[0.1, 0.0], generator=torch.Generator().manual_seed(3),
                      device=cuda)
    fns = make_train_functions(model, make_optimizer(model, 1),
                               FixedLossScaler((1, 1, 1, 1, 1, 1, 100, 100, 100)))
    state = fns.init_state(seed=5)
    batch = make_foam_batch(2, 64, 32, 16, seed=1).to(cuda)
    fns.train_step(state, batch)
    assert sync_sites(lambda: fns.train_step(state, batch)) == []


# ---------------------------------------------------------------------------
# the tensor-core engine (3xTF32 mma tiles): widths and point counts ragged
# against its 8-deep steps, n8 column tiles, 16-row m-tiles and 128-column
# chunks; the weight-gradient contraction alone; bit-identical backwards


def _grads_through(fn, args, inputs, gen, cuda, **kw):
    out = fn(*args, **kw)
    cots = [torch.randn(o.shape, generator=gen).to(cuda) for o in out]
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), inputs)
    torch.cuda.synchronize()
    return out, cots, got


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("n_local,layers,b,n_int,n_bnd", [
    (2, [2 + 6, 176, 3], 1, 13, 21),
    (7, [7 + 9, 69, 178, 3], 2, 29, 9),
    (69, [69 + 11, 130, 7], 1, 41, 17),
    (130, [130 + 2, 64, 176], 1, 5, 3),
    (178, [178 + 10, 378, 8, 378], 2, 23, 0),
], ids=["in2-out3", "in7-out3", "in69-out7", "in130-out176", "in178-out378"])
def test_decoder_ragged_widths_match_plain(cuda, n_local, layers, b, n_int, n_bnd, act, rate):
    gen = torch.Generator().manual_seed(n_local + n_int)
    dec = MLP(layers, activation=act, last_activation=False, generator=gen).to(cuda)
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_()  # noqa: E731
    v, jt, ht = rnd(b, n_int, n_local), rnd(b, 2, n_int, n_local), rnd(b, 2, n_int, n_local)
    v_b = rnd(b, n_bnd, n_local) if n_bnd else None
    g = rnd(b, 1, layers[0] - n_local)
    drop = [rate] * (len(layers) - 2) + [0.0]
    inputs = [t for t in (v, jt, ht, v_b, g) if t is not None] + _params(dec)
    args = (dec.linears, n_local, v, jt, ht, v_b, g, act, drop, False, 77)
    out, cots, got = _grads_through(decoder_cuda.decoder_prop, args, inputs, gen, cuda)
    ref_out = decoder_cuda.decoder_prop_plain(*args)
    for a, r in zip(out, ref_out):
        assert_close(a.detach(), r.detach())
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), inputs)
    for a, r in zip(got, ref):
        assert_close(a, r)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("n_local,f,reduction,b,n_int,n_bnd", [
    (2, 69, True, 1, 13, 21),
    (7, 178, False, 2, 29, 9),
    (69, 130, True, 1, 41, 0),
], ids=["in2-f69", "in7-f178-no-reduction", "in69-f130"])
def test_neural_ops_ragged_widths_match_plain(cuda, n_local, f, reduction, b, n_int, n_bnd,
                                              act, rate):
    gen = torch.Generator().manual_seed(n_local + f)
    ops = NeuralOperatorSequential(3, f, (0.0,) * 3, act, generator=gen).to(cuda)
    red = dense(f, 3, gen).to(cuda) if reduction else None
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_()  # noqa: E731
    v, jt, ht = rnd(b, n_int, n_local), rnd(b, 2, n_int, n_local), rnd(b, 2, n_int, n_local)
    v_b = rnd(b, n_bnd, n_local) if n_bnd else None
    geom = rnd(b, 1, f - n_local)
    par = (torch.rand((b, 1, f), generator=gen) + 0.5).to(cuda).requires_grad_()
    inputs = [t for t in (v, jt, ht, v_b, geom, par) if t is not None] + _params(ops) + (
        _params(red) if reduction else [])
    args = (ops.linears, red, n_local, v, jt, ht, v_b, geom, par, act, [0.0, rate, rate],
            False, 4321)
    out, cots, got = _grads_through(neural_op_cuda.neural_ops_prop, args, inputs, gen, cuda)
    assert out[0].shape[-1] == (3 if reduction else f)
    ref_out = neural_op_cuda.neural_ops_prop_plain(*args)
    for a, r in zip(out, ref_out):
        assert_close(a.detach(), r.detach())
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), inputs)
    for a, r in zip(got, ref):
        assert_close(a, r)


@pytest.mark.parametrize("k,n", [(64, 512), (512, 256), (128, 3), (69, 178)])
def test_weight_grad_at_pipn_rows_matches_float64(cuda, k, n):
    """dW = A^T G over the 97,500 stash rows of pipn's internal decoder
    launch, against float64."""
    from porous_cfd_tpu_torch.ops import mlp_prop_cuda
    gen = torch.Generator().manual_seed(k * n)
    a = torch.randn((97_500, k), generator=gen).to(cuda)
    g = torch.randn((97_500, n), generator=gen).to(cuda)
    before = mlp_prop_cuda.WEIGHT_GRAD.launches
    got = mlp_prop_cuda.weight_grad(a, g)
    torch.cuda.synchronize()
    assert mlp_prop_cuda.WEIGHT_GRAD.launches == before + 1
    assert_close(got.double(), a.double().t() @ g.double())


@pytest.mark.parametrize("kernel", ["decoder", "trunk"])
def test_backward_is_bit_identical_run_to_run(cuda, kernel):
    """No atomics in dW, db, dctx or dpar: two backwards on the same inputs
    (several row chunks per weight gradient) give the same bits."""
    gen = torch.Generator().manual_seed(5)
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_()  # noqa: E731
    n_local, b, n_int, n_bnd = 40, 2, 700, 300
    v, jt, ht = rnd(b, n_int, n_local), rnd(b, 2, n_int, n_local), rnd(b, 2, n_int, n_local)
    v_b = rnd(b, n_bnd, n_local)
    if kernel == "decoder":
        mod = MLP([n_local + 24, 136, 72, 3], activation="silu", last_activation=False,
                  generator=gen).to(cuda)
        g = rnd(b, 1, 24)
        inputs = [v, jt, ht, v_b, g] + _params(mod)
        fn, args = decoder_cuda.decoder_prop, (mod.linears, n_local, v, jt, ht, v_b, g, "silu",
                                               [0.1, 0.1, 0.0], False, 9)
    else:
        mod = NeuralOperatorSequential(3, 136, (0.0,) * 3, "silu", generator=gen).to(cuda)
        red = dense(136, 3, gen).to(cuda)
        geom = rnd(b, 1, 96)
        par = (torch.rand((b, 1, 136), generator=gen) + 0.5).to(cuda).requires_grad_()
        inputs = [v, jt, ht, v_b, geom, par] + _params(mod) + _params(red)
        fn, args = neural_op_cuda.neural_ops_prop, (mod.linears, red, n_local, v, jt, ht, v_b,
                                                    geom, par, "silu", [0.0, 0.1, 0.1], False, 9)
    runs = []
    for _ in range(2):
        out = fn(*args)
        cots = [torch.ones_like(o) for o in out]
        runs.append(torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), inputs))
    torch.cuda.synchronize()
    for a, r in zip(*runs):
        assert torch.equal(a, r)


def test_neural_ops_dropout_masks_match_plain(cuda):
    """Forward with heavy dropout at ragged widths: mask for mask, the trunk
    kernel zeroes exactly the columns the plain version zeroes."""
    gen = torch.Generator().manual_seed(8)
    n_local, f = 7, 69
    ops = NeuralOperatorSequential(3, f, (0.0,) * 3, "silu", generator=gen).to(cuda)
    red = dense(f, 3, gen).to(cuda)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)  # noqa: E731
    v, jt, ht, v_b, geom = (rnd(3, 45, n_local), rnd(3, 2, 45, n_local), rnd(3, 2, 45, n_local),
                            rnd(3, 27, n_local), rnd(3, 1, f - n_local))
    par = (torch.rand((3, 1, f), generator=gen) + 0.5).to(cuda)
    for seed in (0, 99, 2 ** 40 + 5):
        args = (ops.linears, red, n_local, v, jt, ht, v_b, geom, par, "silu", [0.5, 0.5, 0.5],
                False, seed)
        with torch.no_grad():
            got = neural_op_cuda.neural_ops_prop(*args, last_activation=False)
            ref = neural_op_cuda.neural_ops_prop_plain(*args, last_activation=False)
        for a, r in zip(got, ref):
            assert_close(a, r)


# ---------------------------------------------------------------------------
# pointnet_global's winner-row backward: the shapes and winner sets it must
# take (N < F, ragged blocks, one layer, one winner row, F distinct winner
# rows, ties across blocks, more channels than the compaction's one-key-a-
# thread sort takes), its compaction against pointnet_winner_rows, two runs
# bit for bit, and no synchronizing call


def _pointnet_case(case, act, cuda):
    gen = torch.Generator().manual_seed(len(case))
    shapes = {"n_lt_f": (2, 50, [20, 32, 300]), "ragged_128": (3, 197, [69, 96, 128, 256]),
              "one_layer": (2, 75, [9, 140]), "r_is_1": (2, 130, [6, 40, 200]),
              "r_is_f": (2, 150, [64, 64]), "ties_across_blocks": (2, 300, [3, 8, 16]),
              "f_gt_1024": (2, 40, [6, 16, 1100])}
    b, n, layers = shapes[case]
    mlp = MLP(layers, activation=act, generator=gen).to(cuda)
    x = torch.randn((b, n, layers[0]), generator=gen)
    if case == "r_is_1":                 # identical rows: row 0 wins every channel
        x = x[:, :1].repeat(1, n, 1)
    elif case == "ties_across_blocks":   # period 10: the first copy must win
        x = x[:, :10].repeat(1, n // 10, 1)
    elif case == "r_is_f":               # channel c peaks at row c alone
        f = layers[-1]
        with torch.no_grad():
            mlp.linears[0].weight.copy_(torch.eye(f) * 4.0)
            mlp.linears[0].bias.zero_()
        x = torch.zeros((b, n, f))
        x[:, torch.arange(f), torch.arange(f)] = 1.0
        x[:, f:] = -1.0
    return mlp, x.to(cuda), torch.randn((b, 1, layers[-1]), generator=gen).to(cuda)


def _check_pointnet_winners(mlp, x, cot, act, exact=False):
    """The public wrapper's forward and backward against the plain version:
    values, the argmax (equal everywhere when ``exact``, else where the top
    two rows differ by more than RTOL), every gradient at the kernel's
    argmax; the backward's compaction against pointnet_winner_rows, two runs
    bit for bit and equal to autograd's, no synchronizing call. Returns the
    winner count per case."""
    xg = x.clone().requires_grad_()
    m, arg = pointnet_cuda.pointnet_global(mlp.linears, xg, act)
    got = torch.autograd.grad((m * cot).sum(), [xg, *_params(mlp)])
    torch.cuda.synchronize()
    with torch.no_grad():
        rm, ra = pointnet_cuda.pointnet_global_plain(mlp.linears, x, act)
        g = analytic.mlp_value(mlp.linears, x, act)
    assert_close(m.detach(), rm)
    if exact:
        assert torch.equal(arg, ra)      # exact ties and clear winners
    else:
        top2 = torch.topk(g, 2, dim=-2).values
        decided = (top2[:, 0] - top2[:, 1]) > RTOL * rm.abs().max()
        assert torch.equal(arg[:, 0][decided], ra[:, 0][decided])
    del g
    ref_m = pointnet_cuda.pointnet_global_at(mlp.linears, xg, act, arg)
    ref = torch.autograd.grad((ref_m * cot).sum(), [xg, *_params(mlp)])
    for a, r in zip(got, ref):
        assert_close(a, r)

    weights = [lin.weight.detach() for lin in mlp.linears]
    biases = [lin.bias.detach() for lin in mlp.linears]
    arg = arg.contiguous()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [pointnet_cuda.pointnet_global_backward(weights, biases, x, act, arg, cot,
                                                       winners=True) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows, slot, count = pointnet_cuda.pointnet_winner_rows(arg)
    k_rows, k_slot, k_count = runs[0][3]
    assert torch.equal(k_count.long(), count) and torch.equal(k_slot.long(), slot)
    assert torch.equal(k_rows.long(), rows[:, :k_rows.shape[1]])
    flat = [[r[0], *r[1], *r[2]] for r in runs]
    assert all(torch.equal(u, v) for u, v in zip(*flat))
    for a, r in zip(flat[0], [got[0], *got[1::2], *got[2::2]]):
        assert torch.equal(a, r)
    return count


@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("case", ["n_lt_f", "ragged_128", "one_layer", "r_is_1", "r_is_f",
                                  "ties_across_blocks", "f_gt_1024"])
def test_pointnet_winner_backward_cases(cuda, case, act):
    mlp, x, cot = _pointnet_case(case, act, cuda)
    count = _check_pointnet_winners(mlp, x, cot, act,
                                    exact=case in ("r_is_1", "r_is_f", "ties_across_blocks"))
    if case == "r_is_1":
        assert count.tolist() == [1] * x.shape[0]
    if case == "r_is_f":
        assert count.tolist() == [x.shape[-1]] * x.shape[0]


# ---------------------------------------------------------------------------
# PIPN++ MRG: its five kernel shapes on a real chain, and its slice

MRG_LEVELS = ["branch1_sa0", "branch2_sa", "branch1_sa1", "branch3_gsa", "branch4_gsa"]
MRG_CFG = dict(n_dims=2, mrg_in_features=6, nu=1e-3, d=100.0, f=1.0,
               fe_local_layers=[2, 32, 32], seg_layers=[1024 + 32, 96, 32, 3])


def mrg_level_inputs(model, batch):
    """The inputs each of MRG's five levels gets on ``batch`` (its chain
    attached), as ``sa_cuda.sa_mrg_fused`` gives them, the levels below
    run plainly: {level: (mlp, x, idx, mask, rel, xg)} for the radius
    levels (xg None at the dynamic one) and {level: (mlp, x)} for the
    global ones."""
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
    from porous_cfd_tpu_torch.models.pipn import _geometry_features
    from porous_cfd_tpu_torch.ops import sa_cuda
    mrg = model.module.global_fe
    bnd = batch["boundary"]
    geom = _geometry_features(bnd, "id_first").contiguous()
    (_, idx0, mask0, rel0, posc0, xg), (_, idx1, mask1, rel1, posc1) = \
        extract_sa_neighbors(batch.domain, 2)
    with torch.no_grad():
        x1 = sa_cuda.sa_neighborhood_plain(mrg.branch1_sa0.conv_mlp.linears, geom, idx0, mask0,
                                           rel0, "silu", xg)
        x1b = sa_cuda.sa_neighborhood_plain(mrg.branch1_sa1.conv_mlp.linears, x1, idx1, mask1,
                                            rel1, "silu")
        x2 = sa_cuda.sa_neighborhood_plain(mrg.branch2_sa.conv_mlp.linears, geom, idx0, mask0,
                                           rel0, "silu", xg)
    x12 = torch.cat([torch.cat([x1b, x2], dim=-2), torch.cat([posc1, posc0], dim=-2)], dim=-1)
    return {"branch1_sa0": (mrg.branch1_sa0.conv_mlp, geom, idx0, mask0, rel0, xg),
            "branch2_sa": (mrg.branch2_sa.conv_mlp, geom, idx0, mask0, rel0, xg),
            "branch1_sa1": (mrg.branch1_sa1.conv_mlp, x1.contiguous(), idx1, mask1, rel1, None),
            "branch3_gsa": (mrg.branch3_gsa.mlp, torch.cat([geom, bnd["C"]], dim=-1)),
            "branch4_gsa": (mrg.branch4_gsa.mlp, x12.contiguous())}


@pytest.mark.parametrize("b", [13, 2])
@pytest.mark.parametrize("level", MRG_LEVELS)
def test_mrg_levels_match_plain(cuda, level, b):
    """Each of PIPN++ MRG's five kernel shapes at the reference envelope's
    1000 boundary points and 64 neighbours ([8, 64, 128] and [8, 64, 128,
    256] static, [130, 256] dynamic: a one-layer level; [8, 128, 256, 512]
    and [258, 512] pointnet: a one-layer stack on 63 + 500 rows), at full
    and at small batch, forward and backward against the plain versions as
    SA_CASES and the pointnet cases are checked."""
    from porous_cfd_tpu_torch.models.pipn import pipn_foam_pp_mrg
    from porous_cfd_tpu_torch.ops import sa_cuda
    model = pipn_foam_pp_mrg(**MRG_CFG, scalers=make_scalers(),
                             generator=torch.Generator().manual_seed(b), device=cuda)
    batch = model.attach_neighbors(make_foam_batch(b, 64, 1000, 16, seed=b).to(cuda))
    inputs = mrg_level_inputs(model, batch)[level]
    gen = torch.Generator().manual_seed(len(level))
    mlp, x = inputs[:2]
    width = mlp.linears[-1].weight.shape[0]
    if level.endswith("gsa"):
        assert x.shape == ((b, 1000, 8) if level == "branch3_gsa" else (b, 63 + 500, 258))
        cot = torch.randn((b, 1, width), generator=gen).to(cuda)
        _check_pointnet_winners(mlp, x, cot, "silu")
        return
    _, _, idx, mask, rel, xg = inputs
    assert idx.shape == ((b, 500, 64) if level != "branch1_sa1" else (b, 63, 64))
    cot = torch.randn((b, idx.shape[1], width), generator=gen).to(cuda)
    call = sa_cuda.level_call(mlp.linears, x, idx, mask, rel, "silu", xg)
    _check_winner_backward(mlp, x, idx, mask, rel, xg, cot, call, "silu", xg is not None)


def test_pipn_pp_mrg_slice_on_card_matches_cpu(cuda):
    """derivative_apply with dropout on, on one neighbour chain (built on the
    CPU, copied to the card): outputs and parameter gradients on the card
    equal the CPU's; launches 3 sa_neighborhood, 2 pointnet_global and 2
    decoder_prop per batch, their backwards 3, 2 and 2, no FPS."""
    from porous_cfd_tpu_torch.models.pipn import pipn_foam_pp_mrg
    from porous_cfd_tpu_torch.ops import fps_cuda, sa_cuda
    cfg = dict(MRG_CFG, seg_dropout=[0.1, 0.0, 0.0], scalers=make_scalers())
    gpu = pipn_foam_pp_mrg(**cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    cpu = pipn_foam_pp_mrg(**cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = cpu.attach_neighbors(make_foam_batch(3, 200, 160, 20, seed=2))
    counters = (sa_cuda.sa_neighborhood, sa_cuda.sa_neighborhood_backward,
                pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_backward,
                fps_cuda.farthest_point_sampling)
    before = [c.launches for c in counters]
    results = []
    for model, b in ((gpu, batch.to(cuda)), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=False, seed=77)
        loss = sum((o ** 2).mean() for o in out)
        results.append((out, torch.autograd.grad(loss, list(model.module.parameters()))))
    assert [c.launches - n for c, n in zip(counters, before)] == [3, 3, 2, 2, 2, 2, 0]
    for a, r in zip(results[0][0], results[1][0]):
        assert_close(a.detach().cpu(), r.detach())
    for a, r in zip(results[0][1], results[1][1]):
        assert_close(a.cpu(), r)


# ---------------------------------------------------------------------------
# The manufactured PIPN++: its kernel shapes at tanh on a real chain, and its
# slice

MS_LEVELS = ["sa_0", "sa_1", "global_sa", "decoder"]
# the manufactured_solutions zoo's pipn-pp at full width
MS_PP_CFG = dict(nu=0.01, d=50.0, f=1.0, fe_local_layers=[2, 64, 64],
                 fe_global_layers=[[2 * 2 + 2, 64], [64 + 2, 128], [128 + 2, 1024]],
                 fe_global_radius=[0.6, 1.2], fe_global_fraction=[0.5, 0.25],
                 seg_layers=[1024 + 64, 512, 256, 128, 3])


def ms_level_inputs(model, batch):
    """What each kernel of the manufactured PIPN++ gets on ``batch`` (its
    chain attached), the levels below run plainly: {"sa_0": (mlp, x, idx,
    mask, rel, xg), "sa_1": (...), "global_sa": (mlp, x)}, and for the
    decoder its (v, jt, ht, v_b, g)."""
    from porous_cfd_tpu_torch.data.foam_data import split_contiguous
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
    from porous_cfd_tpu_torch.models.pipn import _geometry_features
    from porous_cfd_tpu_torch.ops import sa_cuda
    seq = model.module.feature_extract.global_feature
    (_, idx0, mask0, rel0, posc0, xg), (_, idx1, mask1, rel1, posc1) = \
        extract_sa_neighbors(batch.domain, 2)
    internal, boundary = split_contiguous(batch)
    geom = _geometry_features(boundary, "id_first").contiguous()
    with torch.no_grad():
        x1 = sa_cuda.sa_neighborhood_plain(seq.sa_0.conv_mlp.linears, geom, idx0, mask0, rel0,
                                           "tanh", xg)
        x2 = sa_cuda.sa_neighborhood_plain(seq.sa_1.conv_mlp.linears, x1, idx1, mask1, rel1,
                                           "tanh")
        g = pointnet_cuda.pointnet_global_plain(seq.global_sa.mlp.linears,
                                                torch.cat([x2, posc1], dim=-1), "tanh")[0]
        local = model.module.feature_extract.local_feature.linears
        j0, h0 = analytic.identity_jacobian_t(internal["C"])
        v, jt, ht = analytic.mlp_prop_t(local, internal["C"], j0, h0, "tanh")
        v_b = analytic.mlp_value(local, boundary["C"], "tanh")
    return {"sa_0": (seq.sa_0.conv_mlp, geom, idx0, mask0, rel0, xg),
            "sa_1": (seq.sa_1.conv_mlp, x1.contiguous(), idx1, mask1, rel1, None),
            "global_sa": (seq.global_sa.mlp, torch.cat([x2, posc1], dim=-1).contiguous()),
            "decoder": (v.contiguous(), jt.contiguous(), ht.contiguous(), v_b.contiguous(),
                        g.contiguous())}


@pytest.mark.parametrize("b", [13, 2])
@pytest.mark.parametrize("level", MS_LEVELS)
def test_manufactured_pp_levels_match_plain(cuda, level, b):
    """Each kernel shape of the manufactured PIPN++ at the verification
    envelope's 1000 internal and 200 boundary points, all at tanh: SA level
    0 static and one layer ([6, 64], 100 centroids), SA level 1 dynamic and
    one layer ([66, 128], 25 centroids), pointnet_global one layer [130,
    1024] over the 25 centroids, and the decoupled decoder [1088, 512, 256,
    128, 3]; at full and small batch, forward and backward against the
    plain versions."""
    from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
    from porous_cfd_tpu_torch.models.pipn import pipn_manufactured_pp
    from porous_cfd_tpu_torch.ops import sa_cuda
    model = pipn_manufactured_pp(**MS_PP_CFG, generator=torch.Generator().manual_seed(b),
                                 device=cuda)
    batch = model.attach_neighbors(make_manufactured_batch(np.random.default_rng(b), b, 1000,
                                                           200).to(cuda))
    inputs = ms_level_inputs(model, batch)[level]
    gen = torch.Generator().manual_seed(len(level))
    if level == "decoder":
        v, jt, ht, v_b, g = inputs
        assert v.shape == (b, 1000, 64) and v_b.shape == (b, 200, 64) and g.shape == (b, 1, 1024)
        leaves = [t.clone().requires_grad_() for t in inputs]
        dec = model.module.decoder
        wrt = leaves + _params(dec)
        args = (dec.linears, 64, *leaves, "tanh", None, True, None)
        out = decoder_cuda.decoder_prop(*args)
        cots = [torch.randn(o.shape, generator=gen).to(cuda) for o in out]
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), wrt)
        ref_out = decoder_cuda.decoder_prop_plain(*args)
        for a, r in zip(out, ref_out):
            assert_close(a.detach(), r.detach())
        ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), wrt)
        for a, r in zip(got, ref):
            assert_close(a, r)
        return
    mlp, x = inputs[:2]
    width = mlp.linears[-1].weight.shape[0]
    assert len(mlp.linears) == 1
    if level == "global_sa":
        assert x.shape == (b, 25, 130) and width == 1024
        cot = torch.randn((b, 1, width), generator=gen).to(cuda)
        _check_pointnet_winners(mlp, x, cot, "tanh")
        return
    _, _, idx, mask, rel, xg = inputs
    assert idx.shape == ((b, 100, 64) if level == "sa_0" else (b, 25, 64))
    cot = torch.randn((b, idx.shape[1], width), generator=gen).to(cuda)
    call = sa_cuda.level_call(mlp.linears, x, idx, mask, rel, "tanh", xg)
    _check_winner_backward(mlp, x, idx, mask, rel, xg, cot, call, "tanh", xg is not None)


def test_manufactured_pp_slice_on_card_matches_cpu(cuda):
    """derivative_apply on one neighbour chain (built on the CPU, copied to
    the card): outputs and parameter gradients on the card equal the
    CPU's; launches 2 sa_neighborhood, 1 pointnet_global and 2 decoder_prop
    per batch, their backwards 2, 1 and 2, no FPS."""
    from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
    from porous_cfd_tpu_torch.models.pipn import pipn_manufactured_pp
    from porous_cfd_tpu_torch.ops import fps_cuda, sa_cuda
    cfg = dict(MS_PP_CFG, fe_local_layers=[2, 32, 32], seg_layers=[1024 + 32, 96, 32, 3])
    gpu = pipn_manufactured_pp(**cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    cpu = pipn_manufactured_pp(**cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = cpu.attach_neighbors(make_manufactured_batch(np.random.default_rng(2), 3, 300, 120))
    counters = (sa_cuda.sa_neighborhood, sa_cuda.sa_neighborhood_backward,
                pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_backward,
                fps_cuda.farthest_point_sampling)
    before = [c.launches for c in counters]
    results = []
    for model, b in ((gpu, batch.to(cuda)), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=True)
        loss = sum((o ** 2).mean() for o in out)
        results.append((out, torch.autograd.grad(loss, list(model.module.parameters()))))
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 1, 1, 2, 2, 0]
    for a, r in zip(results[0][0], results[1][0]):
        assert_close(a.detach().cpu(), r.detach())
    for a, r in zip(results[0][1], results[1][1]):
        assert_close(a.cpu(), r)


# ---------------------------------------------------------------------------
# The U-Nets: FPS over all the points of a cloud (design B), the all-points
# SA levels (dynamic from level 0 on), the one-layer global levels and
# PI-GANO++ full's branch, at the examples' widths, on a real chain; and
# their slices

UNET_LEVELS = ["sa_0", "sa_1", "global_sa"]
# the duct examples' U-Net encoders: (layers of sa_0, sa_1, global_sa),
# radii, and PI-GANO++ full's branch
UNET_ENCODERS = {
    "pipn-pp-full": ([[9, 64, 64, 128], [130, 128, 128, 256], [258, 1024]], [0.4, 0.8]),
    "pi-gano-pp-full": ([[9, 64, 64, 128], [130, 128, 128, 256], [258, 512]], [0.5, 1.0]),
}
UNET_GANO_BRANCH = [8, 128, 256, 256, 256]
# The U-Nets' H on the card against the CPU: the JAX package's own U-Net
# tolerance (tests/test_fp_analytic.py:205-207), of the largest entry here. A
# point near a coarse point has an interpolation weight w = 1 / d^2 of 1e4
# and more, and H's w^3 terms amplify rounding (the SA kernels' 3xTF32
# against the CPU's f32) by as much.
UNET_H_RTOL = 5e-3


def unet_level_inputs(seq, batch, chain):
    """What each kernel of a U-Net encoder ``seq`` gets on ``batch`` with
    ``chain`` (the U-Net precompute), the levels below run plainly:
    {"sa_0": (mlp, x, idx, mask, rel, None), "sa_1": (...), "global_sa":
    (mlp, x)}; level 0's x is ``[sdf || boundaryId || C]`` over all points."""
    from porous_cfd_tpu_torch.data.foam_data import split_contiguous
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
    from porous_cfd_tpu_torch.ops import sa_cuda
    internal, boundary = split_contiguous(batch)
    pts = torch.cat([internal["C"], boundary["C"]], dim=-2)
    x0 = torch.cat([batch["sdf"], batch["boundaryId"], pts], dim=-1).contiguous()
    (_, idx0, mask0, rel0, _), (_, idx1, mask1, rel1, posc1) = extract_sa_neighbors(chain, 2)
    with torch.no_grad():
        x1 = sa_cuda.sa_neighborhood_plain(seq.sa_0.conv_mlp.linears, x0, idx0, mask0, rel0,
                                           "silu")
        x2 = sa_cuda.sa_neighborhood_plain(seq.sa_1.conv_mlp.linears, x1, idx1, mask1, rel1,
                                           "silu")
    return {"sa_0": (seq.sa_0.conv_mlp, x0, idx0, mask0, rel0, None),
            "sa_1": (seq.sa_1.conv_mlp, x1.contiguous(), idx1, mask1, rel1, None),
            "global_sa": (seq.global_sa.mlp, torch.cat([x2, posc1], dim=-1).contiguous())}


@pytest.mark.parametrize("b", [13, 2])
@pytest.mark.parametrize("family,level", [(f, lv) for f in UNET_ENCODERS for lv in UNET_LEVELS]
                         + [("pi-gano-pp-full", "branch")])
def test_unet_levels_match_plain(cuda, family, level, b):
    """Each kernel shape of the U-Nets at the reference envelope's 1500 +
    1000 points and 64 neighbours: SA [9, 64, 64, 128] dynamic over all
    points (1250 centroids), [130, 128, 128, 256] dynamic (313 centroids),
    pointnet one layer [258, 1024] / [258, 512] over the 313 centroids and,
    for PI-GANO++ full, its branch [8, 128, 256, 256, 256]; at full and
    small batch, forward and backward against the plain versions as SA_CASES
    and the pointnet cases are checked."""
    from porous_cfd_tpu_torch.models.neighbors import unet_chain_precompute
    from porous_cfd_tpu_torch.models.pi_gano import gather_parameters
    from porous_cfd_tpu_torch.models.set_abstraction import SetAbstractionSeq
    from porous_cfd_tpu_torch.ops import sa_cuda
    layers, radii = UNET_ENCODERS[family]
    gen = torch.Generator().manual_seed(b + len(level))
    batch = make_foam_batch(b, 1500, 1000, 16, seed=b).to(cuda)
    cot_gen = torch.Generator().manual_seed(len(level))
    if level == "branch":
        mlp = MLP(UNET_GANO_BRANCH, activation="silu", generator=gen).to(cuda)
        x = gather_parameters(batch, VARIABLE_BOUNDARIES).contiguous()
        assert x.shape == (b, 250 + 1500, 8)
        _check_pointnet_winners(mlp, x, torch.randn((b, 1, 256), generator=cot_gen).to(cuda),
                                "silu")
        return
    seq = SetAbstractionSeq([0.5, 0.25], radii, layers, "silu", 64, gen).to(cuda)
    pts = torch.cat([batch["internal"]["C"], batch["boundary"]["C"]], dim=-2)
    chain = unet_chain_precompute(pts, [0.5, 0.25], radii, 64, [3, 3, 3], True)
    inputs = unet_level_inputs(seq, batch, chain)[level]
    mlp, x = inputs[:2]
    width = mlp.linears[-1].weight.shape[0]
    if level == "global_sa":
        assert x.shape == (b, 313, 258) and len(mlp.linears) == 1
        cot = torch.randn((b, 1, width), generator=cot_gen).to(cuda)
        _check_pointnet_winners(mlp, x, cot, "silu")
        return
    _, _, idx, mask, rel, _ = inputs
    assert idx.shape == ((b, 1250, 64) if level == "sa_0" else (b, 313, 64))
    cot = torch.randn((b, idx.shape[1], width), generator=cot_gen).to(cuda)
    call = sa_cuda.level_call(mlp.linears, x, idx, mask, rel, "silu")
    _check_winner_backward(mlp, x, idx, mask, rel, None, cot, call, "silu", False)


def test_unet_fps_over_all_points_is_design_b_and_equals_plain(cuda):
    """The U-Nets' precompute samples all 2,500 points of each cloud: past
    design A's 2,048, so the clusters run; then 1250 -> 313 in design A.
    Indices equal the plain version's, one launch a call; the chain and
    the FP levels' kNN indices equal the CPU's."""
    from porous_cfd_tpu_torch.models.neighbors import gather_points, unet_chain_precompute
    from porous_cfd_tpu_torch.ops import fps_cuda
    batch = make_foam_batch(13, 1500, 1000, 16, seed=5)
    pts = torch.cat([batch["internal"]["C"], batch["boundary"]["C"]], dim=-2)
    assert fps_cuda.fps_design(13, 2500, 2).kind == "B"
    assert fps_cuda.fps_design(13, 1250, 2).kind == "A"
    pos = pts.to(cuda)
    for n_samples in (1250, 313):
        before = fps_cuda.farthest_point_sampling.launches
        got = fps_cuda.farthest_point_sampling(pos, n_samples)
        assert fps_cuda.farthest_point_sampling.launches == before + 1
        assert torch.equal(got, fps_cuda.farthest_point_sampling_plain(pos, n_samples))
        pos = gather_points(pos, got)
    card = unet_chain_precompute(pts.to(cuda), [0.5, 0.25], [0.4, 0.8], 64, [3, 3, 3], True)
    cpu = unet_chain_precompute(pts, [0.5, 0.25], [0.4, 0.8], 64, [3, 3, 3], True)
    for key in ("_sa_cent_0", "_sa_cent_1", "_fp_idx_0", "_fp_idx_1", "_fp_idx_2"):
        assert torch.equal(card[key].cpu(), cpu[key]), key


@pytest.mark.parametrize("family", list(UNET_ENCODERS))
def test_unet_slice_on_card_matches_cpu(cuda, family):
    """derivative_apply with dropout on, on one U-Net precompute (built on
    the CPU, copied to the card): outputs and parameter gradients on the
    card equal the CPU's; launches 2 sa_neighborhood and 1 pointnet_global
    (2 with PI-GANO++ full's branch) each way, no FPS."""
    from porous_cfd_tpu_torch.models.pi_gano import pi_gano_pp_full
    from porous_cfd_tpu_torch.models.pipn import pipn_foam_pp_full
    from porous_cfd_tpu_torch.ops import fps_cuda, sa_cuda
    layers, radii = UNET_ENCODERS[family]
    enc = [[9, 32, 32, 48], [50, 48, 48, 64], [66, 96]]
    dec = [[96 + 64, 64, 64], [48 + 64, 32, 32], [32 + 7, 32, 32, 3]]
    kw = dict(enc_layers=enc, enc_radius=radii, enc_fraction=[0.5, 0.25], dec_layers=dec,
              dec_k=[3, 3, 3], scalers=make_scalers())
    if family == "pipn-pp-full":
        def build(dev):
            return pipn_foam_pp_full(1e-3, 100.0, 1.0, **kw, dec_dropout=[0, 0, [0.2, 0, 0]],
                                     generator=torch.Generator().manual_seed(1), device=dev)
        n_pointnet = 1
    else:
        def build(dev):
            return pi_gano_pp_full(1e-3, 3, [8, 32, 48], **kw, fp_dropout=[0, 0, [0.2, 0, 0]],
                                   variable_boundaries=VARIABLE_BOUNDARIES,
                                   generator=torch.Generator().manual_seed(1), device=dev)
        n_pointnet = 2
    gpu, cpu = build(cuda), build("cpu")
    batch = cpu.attach_neighbors(make_foam_batch(3, 300, 160, 20, seed=2))
    counters = (sa_cuda.sa_neighborhood, sa_cuda.sa_neighborhood_backward,
                pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                fps_cuda.farthest_point_sampling)
    before = [c.launches for c in counters]
    results = []
    for model, b in ((gpu, batch.to(cuda)), (cpu, batch)):
        out = model.derivative_apply(b, deterministic=False, seed=77)
        loss = sum((o ** 2).mean() for o in out)
        results.append((out, torch.autograd.grad(loss, list(model.module.parameters()))))
    assert [c.launches - n for c, n in zip(counters, before)] == \
        [2, 2, n_pointnet, n_pointnet, 0]
    for a, r, rtol in zip(results[0][0], results[1][0], (RTOL, RTOL, UNET_H_RTOL)):
        assert_close(a.detach().cpu(), r.detach(), rtol)
    for a, r in zip(results[0][1], results[1][1]):
        assert_close(a.cpu(), r)


# The (v, J, H) engine at D = 3, at the 3D experiments' widths: abc's
# decoders (pipn, pipn-pp), windbreaks' trunk (4 operators at 512, local
# 256, reduction to 4) and the 2D paths' widths (the 512 decoder, the 352
# trunk) at D = 3. (kind, n_local, widths, dropout rates)
ENGINE_3D = {
    "abc_pipn_decoder": ("decoder", 64, [64 + 1024, 512, 256, 128, 4], [0.03, 0.02, 0.0, 0.0]),
    "abc_pp_decoder": ("decoder", 64, [64 + 1024, 384, 128, 4], [0.03, 0.0, 0.0]),
    "windbreaks_trunk": ("trunk", 256, [512] * 4 + [4], [0.0, 0.15, 0.15, 0.0]),
    "duct_decoder_at_3d": ("decoder", 64, [64 + 1024, 512, 256, 128, 3], [0.05, 0.05, 0.0, 0.0]),
    "duct_trunk_at_3d": ("trunk", 176, [352] * 4 + [3], [0.0, 0.1, 0.1, 0.0]),
}


def engine_3d_call(case, gen, cuda, b, n_int, n_bnd, dropout_on, requires_grad=True):
    """The engine's arguments for one of ENGINE_3D's launches at D = 3:
    (fn, plain fn, args, the tensors and parameters to differentiate)."""
    kind, n_local, widths, rates = ENGINE_3D[case]
    rates = rates if dropout_on else [0.0] * len(rates)
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda).requires_grad_(  # noqa: E731
        requires_grad)
    v, jt, ht = rnd(b, n_int, n_local), rnd(b, 3, n_int, n_local), rnd(b, 3, n_int, n_local)
    v_b = rnd(b, n_bnd, n_local)
    if kind == "decoder":
        mod = MLP(widths, activation="silu", last_activation=False, generator=gen).to(cuda)
        g = rnd(b, 1, widths[0] - n_local)
        args = (mod.linears, n_local, v, jt, ht, v_b, g, "silu", rates, False, 1234)
        return (decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_plain, args,
                [v, jt, ht, v_b, g] + _params(mod))
    f, n_out = widths[0], widths[-1]
    ops = NeuralOperatorSequential(len(widths) - 1, f, (0.0,) * (len(widths) - 1), "silu",
                                   generator=gen).to(cuda)
    red = dense(f, n_out, gen).to(cuda)
    geom = rnd(b, 1, f - n_local)
    par = (torch.rand((b, 1, f), generator=gen) + 0.5).to(cuda).requires_grad_(requires_grad)
    args = (ops.linears, red, n_local, v, jt, ht, v_b, geom, par, "silu", rates, False, 4321)
    return (neural_op_cuda.neural_ops_prop, neural_op_cuda.neural_ops_prop_plain, args,
            [v, jt, ht, v_b, geom, par] + _params(ops) + _params(red))


@pytest.mark.parametrize("dropout_on", [False, True], ids=["no-dropout", "dropout"])
@pytest.mark.parametrize("case", list(ENGINE_3D))
def test_engine_3d_launches_match_plain(cuda, case, dropout_on):
    gen = torch.Generator().manual_seed(len(case))
    fn, plain, args, inputs = engine_3d_call(case, gen, cuda, 2, 301, 77, dropout_on)
    out, cots, got = _grads_through(fn, args, inputs, gen, cuda)
    ref_out = plain(*args)
    for a, r in zip(out, ref_out):
        assert_close(a.detach(), r.detach())
    ref = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref_out, cots)), inputs)
    for a, r in zip(got, ref):
        assert_close(a, r)


def test_engine_3d_past_the_shared_limit_raises(cuda):
    """A 1024-wide trunk at D = 3 needs 328,600 shared bytes a block (28
    rows of two 1028-float buffers and the weight ring): refused before any
    launch, with the widths, D and the bytes in the message."""
    gen = torch.Generator().manual_seed(3)
    ops = NeuralOperatorSequential(2, 1024, (0.0, 0.0), "silu", generator=gen).to(cuda)
    red = dense(1024, 4, gen).to(cuda)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)  # noqa: E731
    v, jt, ht = rnd(1, 9, 512), rnd(1, 3, 9, 512), rnd(1, 3, 9, 512)
    par = torch.rand((1, 1, 1024), generator=gen).to(cuda)
    before = (neural_op_cuda.neural_ops_prop.launches,
              neural_op_cuda.neural_ops_prop_backward.launches)
    with pytest.raises(ValueError, match=r"D = 3 need 328600 shared bytes"):
        neural_op_cuda.neural_ops_prop(ops.linears, red, 512, v, jt, ht, None, rnd(1, 1, 512),
                                       par, "silu")
    assert (neural_op_cuda.neural_ops_prop.launches,
            neural_op_cuda.neural_ops_prop_backward.launches) == before


# The 3D experiments' shapes on the other kernels: every SetAbstraction
# level at D = 3 (abc at 16 neighbours, windbreaks at 64; static and
# dynamic as the models run them), pointnet_global at the 3D zoos' widths,
# FPS over 3D clouds in both designs. (static, B, source rows, centroids,
# K, layers)
SA_3D = {
    "abc_pp_sa0": (True, 13, 1000, 500, 16, [10, 64, 128]),
    "abc_pp_sa1": (False, 13, 500, 125, 16, [131, 128, 256]),
    "abc_unet_sa0": (False, 4, 2500, 1250, 16, [11, 64, 64, 128]),
    "abc_unet_sa1": (False, 4, 1250, 313, 16, [131, 128, 128, 256]),
    "wb_pp_sa0": (True, 13, 1000, 500, 64, [11, 64, 128]),
    "wb_pp_sa1": (False, 13, 500, 125, 64, [131, 128]),
    "wb_unet_sa0": (False, 4, 2500, 1250, 64, [12, 64, 64, 128]),
    "wb_unet_sa1": (False, 4, 1250, 313, 64, [131, 128, 128, 256]),
}


@pytest.mark.parametrize("case", list(SA_3D))
def test_sa_kernel_matches_plain_3d(cuda, case):
    """Values within RTOL, the argmax equal wherever the top two rows differ
    by more than RTOL, and every gradient (dx through dP in the dynamic
    variant) against the plain level at the kernel's argmax (at these sizes
    some channels' top two rows lie within the kernels' 3xTF32 rounding),
    at D = 3 with emptied neighbourhoods, one launch each way."""
    from porous_cfd_tpu_torch.ops import sa_cuda
    static, b, n, c, k, layers = SA_3D[case]
    gen = torch.Generator().manual_seed(c + k)
    mlp = MLP(layers, activation="silu", generator=gen).to(cuda)
    lin = mlp.linears
    x, idx, mask, rel, xg = _sa_inputs(gen, cuda, b, n, c, k, layers[0] - 3, 3, 7)
    xg = xg if static else None
    xr = x.clone().requires_grad_(not static)
    cot = torch.randn((b, c, layers[-1]), generator=gen).to(cuda)
    wrt = ([] if static else [xr]) + _params(mlp)
    before = (sa_cuda.sa_neighborhood.launches, sa_cuda.sa_neighborhood_backward.launches)
    out = sa_cuda.sa_neighborhood(lin, xr, idx, mask, rel, "silu", xg)
    got = torch.autograd.grad((out * cot).sum(), wrt)
    torch.cuda.synchronize()
    assert (sa_cuda.sa_neighborhood.launches - before[0],
            sa_cuda.sa_neighborhood_backward.launches - before[1]) == (1, 1)
    _, arg = sa_cuda._forward(sa_cuda.level_call(lin, x, idx, mask, rel, "silu", xg))
    with torch.no_grad():
        ref_out, ref_arg = sa_cuda.sa_neighborhood_plain(lin, x, idx, mask, rel, "silu", xg,
                                                         with_argmax=True)
        h = sa_cuda._plain_rows(lin, x, idx, mask, rel, "silu", xg)
        top2 = torch.topk(h.masked_fill(~mask[..., None], -1e30), 2, dim=2).values
        decided = ((top2[:, :, 0] - top2[:, :, 1]) > RTOL * ref_out.abs().max()) | \
            (mask.sum(-1, keepdim=True) < 2)
        del h, top2
    assert_close(out.detach(), ref_out)
    assert torch.equal(arg[decided], ref_arg[decided])
    ref_at = sa_cuda.sa_neighborhood_at(lin, xr, idx, mask, rel, "silu", arg, xg)
    ref = torch.autograd.grad((ref_at * cot).sum(), wrt)
    for a, r in zip(got, ref):
        assert_close(a, r)


@pytest.mark.parametrize("layers,n", [
    ([69, 96, 128, 1024], 2500),     # abc pipn
    ([259, 256, 1024], 125),         # abc pipn-pp's global level
    ([259, 1024], 313),              # abc pipn-pp-full's global level
    ([9, 256, 256, 256], 2500),      # windbreaks' geometry
    ([10, 256, 256, 512], 1750),     # windbreaks' branch
    ([10, 256, 256, 256], 1750),     # windbreaks pi-gano-pp-full's branch
    ([131, 256, 256], 125),          # windbreaks pi-gano-pp's global level
    ([259, 512, 1024], 313),         # windbreaks pi-gano-pp-full's global level
], ids=["abc-pipn", "abc-pp-global", "abc-unet-global", "wb-geometry", "wb-branch",
        "wb-unet-branch", "wb-pp-global", "wb-unet-global"])
def test_pointnet_at_3d_widths(cuda, layers, n):
    gen = torch.Generator().manual_seed(layers[0] + n)
    mlp = MLP(layers, activation="silu", generator=gen).to(cuda)
    x = torch.randn((13, n, layers[0]), generator=gen).to(cuda).requires_grad_()
    cot = torch.randn((13, 1, layers[-1]), generator=gen).to(cuda)
    m, arg = pointnet_cuda.pointnet_global(mlp.linears, x, "silu")
    got = torch.autograd.grad((m * cot).sum(), [x] + _params(mlp))
    torch.cuda.synchronize()
    with torch.no_grad():
        rm, _ = pointnet_cuda.pointnet_global_plain(mlp.linears, x, "silu")
        g = analytic.mlp_value(mlp.linears, x, "silu")
    assert_close(m.detach(), rm)
    top2 = torch.topk(g, 2, dim=-2).values
    decided = (top2[:, 0] - top2[:, 1]) > RTOL * rm.abs().max()
    assert torch.equal(arg[:, 0][decided], torch.argmax(g, dim=-2)[decided])
    ref_m = pointnet_cuda.pointnet_global_at(mlp.linears, x, "silu", arg)
    ref = torch.autograd.grad((ref_m * cot).sum(), [x] + _params(mlp))
    for a, r in zip(got, ref):
        assert_close(a, r)


@pytest.mark.parametrize("b,n,n_samples", [(13, 1000, 500), (13, 500, 125), (13, 2500, 1250),
                                           (13, 1250, 313)])
def test_fps_kernel_equals_plain_3d(cuda, b, n, n_samples):
    """Real 3D duct clouds' sizes: PIPN++'s levels (design A) and the
    U-Nets' all-points level (design B), indices equal."""
    from porous_cfd_tpu_torch.ops import fps_cuda
    gen = torch.Generator().manual_seed(n)
    pos = (torch.rand((b, n, 3), generator=gen) * torch.tensor([1.0, 0.6, 0.6]) - 0.4).to(cuda)
    got = fps_cuda.farthest_point_sampling(pos, n_samples)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_cuda.farthest_point_sampling_plain(pos, n_samples))


def test_fvm_batch_graph_replay_matches_eager_launches(cuda):
    """The batched 2D solver's step replayed as a CUDA graph gives the eager
    march's steps and fields on the JAX test's three cases (cuBLAS may pick
    other algorithms under capture: fields within 1e-5 of their norm, steps
    within one), at two check cadences."""
    import numpy as np
    from porous_cfd_tpu_torch.datagen import fvm_batch
    cases = [dict(shape="circle", cx=0.10, cy=0.00, size=0.12, theta=0.0),
             dict(shape="square", cx=0.08, cy=0.02, size=0.12, theta=np.radians(30),
                  sx=0.875, sy=0.75),
             dict(shape="ellipse", cx=0.12, cy=-0.02, size=0.13, theta=np.radians(70),
                  d=(12000.0, 20000.0), f=30.80, u_inlet=0.15 * np.cos(np.radians(20)),
                  v_inlet=0.15 * np.sin(np.radians(20)))]
    kw = dict(tol=5e-4, max_steps=8000, device=cuda, nx=40, ny=24)
    eager = fvm_batch.solve_duct_batch(cases, graph=False, **kw)
    for check_every in (1, 200):
        graphed = fvm_batch.solve_duct_batch(cases, check_every=check_every, **kw)
        for got, want in zip(graphed, eager):
            assert abs(got.steps - want.steps) <= 1 and got.residual < 5e-4
            scale = np.linalg.norm(np.stack([want.u, want.v]))
            for name in ("u", "v"):
                err = np.linalg.norm(getattr(got, name) - getattr(want, name))
                assert err / scale < 1e-5
            assert np.linalg.norm(got.p - want.p) / np.linalg.norm(want.p) < 1e-5


# ---------------------------------------------------------------------------
# A share of a batch (a sharded training step): the kernels draw the plain
# version's masks at the share's place


@pytest.mark.parametrize("at", [dict(case0=5), dict(case0=3, int_row0=40, bnd_row0=130)],
                         ids=["cases", "cases_and_rows"])
def test_kernels_with_a_placement_match_plain(cuda, at):
    """decoder_prop and neural_ops_prop under a share's placement, dropout
    on, forward and backward, against their plain versions under it (and
    not their masks at the whole batch's origin)."""
    from porous_cfd_tpu_torch.ops import dropout
    gen = torch.Generator().manual_seed(17)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)  # noqa: E731
    n_local = 16
    dec = MLP([32, 64, 32, 3], activation="silu", last_activation=False, generator=gen).to(cuda)
    ops = NeuralOperatorSequential(2, 32, (0.0, 0.0), "silu", generator=gen).to(cuda)
    red = dense(32, 3, gen).to(cuda)
    v, jt, ht, v_b = rnd(3, 50, n_local), rnd(3, 2, 50, n_local), rnd(3, 2, 50, n_local), \
        rnd(3, 30, n_local)
    g, par = rnd(3, 1, 16), torch.rand((3, 1, 32), generator=gen).to(cuda) + 0.5
    calls = {"decoder": (decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_plain,
                         (dec.linears, n_local, v, jt, ht, v_b, g, "silu", [0.5, 0.5, 0.0],
                          False, dropout.fold_in(1, 2)), list(dec.parameters())),
             "trunk": (neural_op_cuda.neural_ops_prop, neural_op_cuda.neural_ops_prop_plain,
                       (ops.linears, red, n_local, v, jt, ht, v_b, g, par, "silu", [0.5, 0.5],
                        False, dropout.fold_in(1, 3)), list(ops.parameters()))}
    pl = dropout.Placement(**at)
    for name, (kernel, plain, args, params) in calls.items():
        outs = []
        for fn in (kernel, plain):
            res = fn(*args, placement=pl)
            loss = sum((o * o).sum() for o in res)
            grads = torch.autograd.grad(loss, params)
            outs.append((res, grads))
        for a, r in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
            assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item(), name
        with torch.no_grad():
            origin = plain(*args)[0]
        assert not torch.allclose(outs[0][0][0], origin), name
