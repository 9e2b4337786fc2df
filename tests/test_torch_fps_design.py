"""``fps_cuda.fps_design``, the host function that chooses the FPS kernel's
launch: design A (one block a cloud, its points in registers) or design B
(a thread-block cluster a cloud), the block's threads and points a thread.
Pinned at the paths' shapes, at the crossover, at the old one-block cap of
shared memory, at the new limit and past it. Plain Python: no card, no
nvcc."""
import math

import pytest

from porous_cfd_tpu_torch.ops import fps_cuda
from porous_cfd_tpu_torch.ops.fps_cuda import Design, fps_design


@pytest.mark.parametrize("b,n,d,want", [
    (52, 1000, 2, Design("A", 1, 128, 8)),        # PIPN++'s level 0, 52 cases
    (52, 500, 2, Design("A", 1, 128, 4)),         # its level 1
    (13, 1000, 2, Design("A", 1, 128, 8)),        # one batch through attach_neighbors
    (1, 1000, 2, Design("A", 1, 128, 8)),         # one new geometry
    (1, 500, 2, Design("A", 1, 128, 4)),
    (1, 32, 2, Design("A", 1, 32, 1)),            # the latency floor: a point a lane
    (1, 33, 2, Design("A", 1, 64, 1)),
    (2, 1001, 2, Design("A", 1, 128, 8)),
    (2, 100, 3, Design("A", 1, 128, 1)),
    (1, 2048, 3, Design("A", 1, 128, 16)),        # the crossover
    (1, 2049, 3, Design("B", 16, 32, 8)),         # one warp a CTA
    (1, 100_000, 3, Design("B", 16, 224, 32)),    # chip_smoke.py's design-B cloud
    (1, 40_000, 2, Design("B", 16, 96, 32)),
    (2, 20_000, 3, Design("B", 16, 96, 16)),
])
def test_design_at_the_paths_shapes(b, n, d, want):
    assert fps_design(b, n, d) == want


@pytest.mark.parametrize("d", [1, 2, 3])
def test_crossover(d):
    """Design A up to CROSSOVER points, design B from the next one."""
    at = fps_design(1, fps_cuda.CROSSOVER, d)
    past = fps_design(1, fps_cuda.CROSSOVER + 1, d)
    assert at.kind == "A" and at.ctas == 1
    assert past.kind == "B" and past.ctas == fps_cuda.CLUSTER
    assert fps_cuda.CROSSOVER <= fps_cuda.BLOCK_CAPACITY


@pytest.mark.parametrize("n,d", [(19_360, 2), (14_520, 3), (40_000, 2), (20_000, 3)])
def test_past_the_old_shared_memory_cap_runs_as_a_cluster(n, d):
    """The kernel this one replaced refused a cloud whose coordinates and
    minima (4 (d + 1) bytes a point) and its 132 bytes of reduction slots
    did not fit one block's 232,448 bytes of shared memory."""
    assert 4 * (d + 1) * n + 132 > 232_448
    got = fps_design(1, n, d)
    assert got.kind == "B" and got.ctas * got.threads * got.per_thread >= n


@pytest.mark.parametrize("d", [1, 2, 3])
def test_the_limit_and_past_it(d):
    """131,072 points in any dimension: 16 CTAs of 256 threads of 32."""
    assert fps_cuda.MAX_POINTS == 131_072
    at = fps_design(1, fps_cuda.MAX_POINTS, d)
    assert at == Design("B", 16, 256, 32)
    with pytest.raises(ValueError, match="exceed the kernel's limit"):
        fps_design(1, fps_cuda.MAX_POINTS + 1, d)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_every_design_covers_its_cloud(d):
    """Threads a multiple of 32 and at most eight warps, points a thread one
    of the kernel's instantiations, and enough of both (with the cluster's
    CTAs) for every point, with no warp more than the block needs."""
    for n in sorted({1, 2, 31, 32, 33, 127, 128, 129, 500, 1000, 2047, 2048, 2049,
                     *range(3000, fps_cuda.MAX_POINTS + 1, 7919), fps_cuda.MAX_POINTS}):
        got = fps_design(3, n, d)
        assert got.per_thread in fps_cuda.PER_THREAD
        assert got.threads % 32 == 0 and 32 <= got.threads <= fps_cuda.MAX_THREADS
        assert got.ctas * got.threads * got.per_thread >= n
        assert (got.threads - 32) * got.per_thread < math.ceil(n / got.ctas)


@pytest.mark.parametrize("b,n,d", [(1, 10, 0), (1, 10, 4), (1, 0, 2), (0, 10, 2)])
def test_no_design_for_bad_shapes(b, n, d):
    with pytest.raises(ValueError):
        fps_design(b, n, d)
