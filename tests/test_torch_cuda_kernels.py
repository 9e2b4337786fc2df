"""The hand-written CUDA kernels against their plain PyTorch versions on the
card. Skipped without a CUDA device. On the GPU machine (no JAX there):

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda_kernels.py
"""
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
# order (the kernels' FMA chains against cuBLAS; the backward's weight
# gradients add row chunks in another order, and pointnet's winner-row
# scatter adds with atomics in no fixed order).
RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def assert_close(got, ref):
    assert got.shape == ref.shape
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= RTOL * scale


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
               scalers=make_scalers())
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


def _sa_inputs(gen, cuda, b, n, c, k, f_in, d, empty_every):
    """Random level inputs: idx into n source rows (padding at index 0 with
    mask False), some neighbourhoods emptied."""
    x = torch.randn((b, n, f_in), generator=gen)
    idx = torch.randint(0, n, (b, c, k), generator=gen)
    mask = torch.rand((b, c, k), generator=gen) > 0.2
    if empty_every:
        mask[:, ::empty_every] = False
    idx = torch.where(mask, idx, torch.zeros_like(idx))
    rel = torch.rand((b, c, k, d), generator=gen) * 2 - 1
    xg = torch.gather(x, 1, idx.reshape(b, -1)[..., None].expand(-1, -1, f_in))
    return [t.to(cuda) for t in (x, idx, mask, rel, xg)]


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


@pytest.mark.parametrize("b,n,d,n_samples", [(52, 1000, 2, 500), (52, 500, 2, 125),
                                             (2, 57, 3, 19), (3, 300, 1, 50)])
def test_fps_kernel_equals_plain(cuda, b, n, d, n_samples):
    """Indices equal, not close: the first two are PIPN++'s levels."""
    from porous_cfd_tpu_torch.ops import fps_cuda
    pos = (torch.rand((b, n, d), generator=torch.Generator().manual_seed(n)) * 2 - 1).to(cuda)
    before = fps_cuda.farthest_point_sampling.launches
    got = fps_cuda.farthest_point_sampling(pos, n_samples)
    torch.cuda.synchronize()
    assert fps_cuda.farthest_point_sampling.launches == before + 1
    assert torch.equal(got, fps_cuda.farthest_point_sampling_plain(pos, n_samples))


def test_fps_kernel_ties_take_the_first_index(cuda):
    from porous_cfd_tpu_torch.ops import fps_cuda
    square = torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]] * 2, dtype=torch.float32,
                          device=cuda)[None]
    assert fps_cuda.farthest_point_sampling(square, 4).tolist() == [[0, 3, 1, 2]]


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
