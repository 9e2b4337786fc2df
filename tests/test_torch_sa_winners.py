"""The plain pieces beside the SetAbstraction kernel, on the CPU:
``sa_cuda.sa_winner_rows`` (the backward's compaction of a forward's argmax,
which the kernel's must equal) against a numpy loop, and the argmax of the
plain path (``sa_neighborhood_plain(..., with_argmax=True)``) against
numpy's first maximal valid neighbour, with exact ties and emptied
neighbourhoods; ``sa_neighborhood_at`` at that argmax is the plain level and
its gradients are the plain level's."""
import numpy as np
import pytest
import torch

from porous_cfd_tpu_torch.models.mlp import MLP
from porous_cfd_tpu_torch.ops import sa_cuda


def numpy_winner_rows(arg, mask):
    """rows (B, C * min(K, F)), slot (B, C, F), count (B,) by loops."""
    b_cases, n_cent, f = arg.shape
    k = mask.shape[-1]
    rcap = n_cent * min(k, f)
    rows = -np.ones((b_cases, rcap), dtype=np.int64)
    slot = -np.ones((b_cases, n_cent, f), dtype=np.int64)
    count = np.zeros(b_cases, dtype=np.int64)
    for b in range(b_cases):
        found = []
        for c in range(n_cent):
            if not mask[b, c].any():
                continue
            ks = sorted({int(a) for a in arg[b, c] if a >= 0})
            base = len(found)
            found += [c * k + kk for kk in ks]
            for ch in range(f):
                if arg[b, c, ch] >= 0:
                    slot[b, c, ch] = base + ks.index(int(arg[b, c, ch]))
        rows[b, :len(found)] = found
        count[b] = len(found)
    return rows, slot, count


def argmax_case(case, rng):
    """(argmax int8 (B, C, F), mask (B, C, K)) of one compaction case."""
    b_cases, n_cent, k, f = 3, 7, 12, 9
    mask = rng.random((b_cases, n_cent, k)) > 0.3
    mask[:, :, 0] = True  # a centroid is its own neighbour
    if case == "emptied":
        mask[:, ::3] = False
    arg = rng.integers(0, k, size=(b_cases, n_cent, f))
    if case == "ties":  # few distinct winners: many channels share a row
        arg = rng.integers(0, 2, size=(b_cases, n_cent, f)) * 5
    elif case == "one_row":
        n_cent = 1
        mask, arg = mask[:, :1], np.full((b_cases, 1, f), 4)
    elif case == "every_row":
        k, f = 6, 9
        mask = np.ones((b_cases, n_cent, k), dtype=bool)
        arg = np.tile(np.arange(f) % k, (b_cases, n_cent, 1))
    arg = np.where(mask.any(-1)[..., None], arg, -1)
    return torch.from_numpy(arg.astype(np.int8)), torch.from_numpy(mask)


@pytest.mark.parametrize("case", ["random", "ties", "emptied", "one_row", "every_row"])
def test_winner_rows_matches_numpy(case):
    arg, mask = argmax_case(case, np.random.default_rng(len(case)))
    rows, slot, count = sa_cuda.sa_winner_rows(arg, mask)
    ref = numpy_winner_rows(arg.numpy(), mask.numpy())
    for got, want in zip((rows, slot, count), ref):
        np.testing.assert_array_equal(got.numpy(), want)
    n_cent, k = mask.shape[1:]
    if case == "one_row":
        assert count.tolist() == [1] * arg.shape[0]
    if case == "every_row":
        assert count.tolist() == [n_cent * k] * arg.shape[0]
    # a channel's winner row is its argmax
    b, c, ch = torch.nonzero(slot >= 0, as_tuple=True)
    win = rows[b, slot[b, c, ch]]
    assert torch.equal(win // k, c) and torch.equal(win % k, arg[b, c, ch].long())


def level_inputs(static, empty_every, ties, seed):
    """A small level: (mlp, x, idx, mask, rel, xg), some neighbourhoods
    emptied and, with ``ties``, source rows repeated at equal rel so that
    neighbours tie exactly on every channel."""
    rng = np.random.default_rng(seed)
    b_cases, n_src, n_cent, k, f_in, d = 2, 30, 9, 8, 5, 2
    x = rng.normal(size=(b_cases, n_src, f_in)).astype(np.float32)
    idx = rng.integers(0, n_src, size=(b_cases, n_cent, k))
    mask = rng.random((b_cases, n_cent, k)) > 0.25
    rel = rng.uniform(-1, 1, size=(b_cases, n_cent, k, d)).astype(np.float32)
    if ties:  # neighbours 1, 3 and 6 read the same row at the same rel
        idx[:, :, 3] = idx[:, :, 6] = idx[:, :, 1]
        rel[:, :, 3] = rel[:, :, 6] = rel[:, :, 1]
        mask[:, :, [1, 3, 6]] = True
    if empty_every:
        mask[:, ::empty_every] = False
    idx = np.where(mask, idx, 0)
    xg = np.take_along_axis(x, idx.reshape(b_cases, -1)[..., None], axis=1)
    mlp = MLP([f_in + d, 16, 12], activation="silu",
              generator=torch.Generator().manual_seed(seed))
    t = [torch.from_numpy(a) for a in (x, idx, mask, rel, xg)]
    return mlp, t[0], t[1], t[2], t[3], t[4] if static else None


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("act", ["silu", "tanh"])
@pytest.mark.parametrize("empty_every,ties", [(3, False), (0, True), (4, True)])
def test_plain_argmax_is_the_first_maximal_valid_neighbour(static, act, empty_every, ties):
    mlp, x, idx, mask, rel, xg = level_inputs(static, empty_every, ties, 7 + empty_every)
    out, arg = sa_cuda.sa_neighborhood_plain(mlp.linears, x, idx, mask, rel, act, xg,
                                             with_argmax=True)
    assert arg.dtype == torch.int8 and arg.shape == out.shape
    h = sa_cuda._plain_rows(mlp.linears, x, idx, mask, rel, act, xg).detach().numpy()
    m = mask.numpy()
    want = -np.ones(out.shape, dtype=np.int64)
    for b, c, ch in np.ndindex(*out.shape):
        ks = np.flatnonzero(m[b, c])
        if ks.size:
            want[b, c, ch] = ks[np.argmax(h[b, c, ks, ch])]
    np.testing.assert_array_equal(arg.numpy(), want)
    if ties:  # the first of the tied neighbours wins wherever one of them does
        tied = np.isin(want, [1, 3, 6])
        assert tied.any() and np.all(want[tied] == 1)
    # the public wrapper on the CPU is the plain path
    got = sa_cuda.sa_neighborhood(mlp.linears, x, idx, mask, rel, act, xg)
    assert torch.equal(got, out)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_values_at_the_argmax_are_the_plain_level(static):
    """sa_neighborhood_at at the plain argmax gives the plain level, and the
    same gradients: the kernels' backward is held to it on the card."""
    mlp, x, idx, mask, rel, xg = level_inputs(static, 3, True, 11)
    x.requires_grad_(not static)
    wrt = list(mlp.parameters()) + ([] if static else [x])
    out, arg = sa_cuda.sa_neighborhood_plain(mlp.linears, x, idx, mask, rel, "silu", xg,
                                             with_argmax=True)
    at = sa_cuda.sa_neighborhood_at(mlp.linears, x, idx, mask, rel, "silu", arg, xg)
    assert torch.equal(at, out)
    cot = torch.from_numpy(np.random.default_rng(2).normal(size=out.shape).astype(np.float32))
    for a, b in zip(torch.autograd.grad((out * cot).sum(), wrt),
                    torch.autograd.grad((at * cot).sum(), wrt)):
        assert torch.equal(a, b)
