"""3xTF32, the arithmetic of the engine's tensor-core products
(``porous_cfd_tpu_torch/ops/csrc/common.cuh``: ``split_tf32`` and
``mma_3xtf32``), emulated on the CPU, where no card is.

``cvt.rna.tf32.f32`` keeps 10 of f32's 23 mantissa bits, rounding to nearest
with ties away from zero: on the bits, add 0x1000 and clear the low 13. Each
operand x is split into big = tf32(x) and small = tf32(x - big); the card
multiplies TF32 operands exactly and adds in f32, so a product of tf32 values
is emulated by an f32 matrix product of those values. The kernels form
a_big b_small + a_small b_big + a_big b_big. These tests hold that sum to
float64 within the card gate's 1e-4 * max|ref| at the decoder's and the
trunk's layer widths, and show that one TF32 product misses it: the reason
for three passes.
"""
import numpy as np
import pytest
import torch

RTOL = 1e-4                      # chip_smoke.py's gate, |a - ref| <= RTOL max|ref|
# the contraction depths of the decoder's (64, 512, 256, 128) and the
# trunk's (176 is the local width, 352 the operators') layers, and the
# coupled decoder's full layer-0 width
DEPTHS = [64, 512, 256, 128, 352, 1088]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ab, as_), (bb, bs) = split(a), split(b)
    return ab @ bs + as_ @ bb + ab @ bb


def product_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def operands(k: int, seed: int = 0):
    rng = np.random.default_rng(seed + k)
    a = rng.standard_normal((40, k)).astype(np.float32)       # a block's 40 rows
    b = rng.standard_normal((k, 128)).astype(np.float32)      # a 128-column chunk
    return torch.from_numpy(a), torch.from_numpy(b)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                                         # TF32's ulp at 1
    x = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2 ** -23, -(one + ulp / 2),
                      one + 3 * ulp / 2, 3.0e-30, -7.5], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one, -(one + ulp), one + 2 * ulp],
                        dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:5], want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(got[6], x[6])                          # exact in TF32 already


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(100_000).astype(np.float32))
    big, small = split(x)
    assert torch.equal(x - big, (x.double() - big.double()).float())   # exact in f32
    err = (big.double() + small.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21
    assert float(((big.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("k", DEPTHS)
def test_three_products_hold_the_gate(k):
    a, b = operands(k)
    ref = a.double() @ b.double()
    assert rel_err(product_3xtf32(a, b), ref) <= RTOL / 10


@pytest.mark.parametrize("k", DEPTHS)
def test_one_product_misses_the_gate(k):
    a, b = operands(k)
    ref = a.double() @ b.double()
    assert rel_err(product_1xtf32(a, b), ref) > RTOL


def test_weight_gradient_depth_holds_the_gate():
    """dW = A^T GZ contracts over every row: 97,500 at pipn's internal
    decoder launch, added 1,500 rows a chunk as the kernel does."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((97_500, 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((97_500, 8)).astype(np.float32))
    ref = a.double().t() @ g.double()
    parts = [product_3xtf32(a[i:i + 1500].t(), g[i:i + 1500])
             for i in range(0, a.shape[0], 1500)]
    got = torch.zeros_like(parts[0])
    for p in parts:                                           # sum_partials' order
        got = got + p
    assert rel_err(got, ref) <= RTOL / 10
    one = torch.zeros_like(got)
    for i in range(0, a.shape[0], 1500):
        one = one + product_1xtf32(a[i:i + 1500].t(), g[i:i + 1500])
    assert rel_err(one, ref) > RTOL
