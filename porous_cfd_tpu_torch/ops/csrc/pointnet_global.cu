// pointnet_global: max over points of act(...act(x W1^T + b1)... W_L^T + b_L)
// with every layer activated, the first maximal row per channel, and the
// backward of that max.
//
// Replaces the TPU kernels porous_cfd_tpu/ops/pointnet_pallas.py:_fwd_kernel
// (pallas_call at :125) and :_bwd_kernel (pallas_call at :146).
//
// What bounds them on an H100. The forward: operations. At the PIPN
// reference envelope (13 cases x 2500 points, widths 69 -> 96 -> 128 -> 1024)
// it does 32,500 x 149,984 multiply-adds = 9.75 GFLOP against 9.7 MB of
// input: 0.059 ms at f32 accuracy on the tensor cores (3xTF32, common.cuh),
// 0.003 ms of bytes. Measured, the products take about a quarter of the
// kernel and the epilogues (bias, activation, the max) most of the rest.
// The backward: the pooled cotangent reaches one row per (case, channel),
// so its work is that of the winner rows (about 6,200 of 32,500 at pipn),
// 0.7 GFLOP and 19 MB, a few microseconds at the card's rates: what it costs
// is the serial depth of its steps, the weights every block streams for few
// rows, and its launches.
//
// Forward design. The TPU kernel walks the point tiles in order and carries
// a running (max, argmax) in its output block. Here each block takes one
// tile of points of one case and runs the whole chain in shared memory, on
// the tensor cores in 3xTF32 (tc.cuh: weights split once per launch into
// ready TF32 tiles; wgmma m64n128k8 with A from registers). A block has one
// or two consumer warpgroups; each owns 64 rows of the tile (64 points, or
// fewer where the row buffers would not fit in shared memory: pi-gano's
// 352-wide branch takes 40) and runs every weight tile's full depth over
// them, so the two warpgroups of a 128-point block (pipn) share each tile of
// the ring and halve the weight stream per point. Row buffers carry real
// points only. The first layer's depth (7, 8, 69, ...) is zero-padded to the
// product's 8-deep steps. One thread keeps three weight tiles in flight by
// bulk copy (the TMA) along the block's whole schedule of tiles, across
// chunk and layer boundaries. Per tile each thread splits its A fragments of
// all four 8-deep steps first, then the warpgroup issues the twelve
// products back to back. The epilogue of a hidden layer applies the bias
// and the activation to the accumulators and writes the next layer's rows;
// the last layer is never stored: each 128-column chunk's epilogue packs
// (activated value, row) of the thread's two rows into one 64-bit key whose
// unsigned order is the pooling's (a larger value, then the lower row),
// takes the max across the 8 lanes that share a column by shuffles, then
// across the warps in shared memory, and writes one key per (tile,
// channel). pointnet_reduce takes the max over the tiles: the largest value
// at its first row, as on the TPU, whatever the order. Rows past n_pts
// never win. The activations there use the fast exponential and division
// (__expf, __fdividef; a few ulp, against the 1e-4 relative tolerance), and
// are computed without branches so that they overlap: the IEEE versions
// made the epilogues slower than the products. When tiles x cases would
// leave SMs idle (the ++ models' global levels: 13 cases x 125 points), the
// last layer's chunks are split over a third grid dimension and each block
// recomputes the (cheap) lower layers. The forward writes nothing for the
// backward: there is no stash.
//
// Backward design. The TPU kernel recomputes the chain per tile and
// multiplies a dense, mostly-zero cotangent through the last layer, because
// Mosaic has no scatter. Here only the winner rows are touched, and nothing
// depends on the schedule (no atomics; two runs give the same bits):
//  1. pointnet_bwd_prep: one block per case sorts its (argmax, channel)
//     keys (a bitonic sort, shuffles within a warp, shared memory across),
//     which gives the winner rows in ascending order (slots), each channel's
//     slot and, per slot, its channels in channel order; the other blocks
//     transpose the weights into the (in, out) layout the products read.
//  2. pointnet_bwd_tiles, one block per 16 winner slots of a case (so that a
//     case's few winners spread over many SMs): it gathers x at its rows,
//     recomputes the hidden layers for them (3xTF32 mma.sync, one m16 tile
//     of rows, each warp 16 columns), computes z = a[slot] . W[c, :] + b[c]
//     and gz = dm act'(z) for the channels of its slots (a warp a dot
//     product), da[slot] = the sum of gz_c W[c, :] over the slot's channels
//     in channel order (a thread a column), and sweeps the hidden layers in
//     reverse (GZ_i = GA act'(Z_i), GA = GZ_i W_i) down to dx's rows. Every
//     buffer is compact: R_max = cases x min(N, F) rows, sized on the host
//     without knowing the winners; rows past a case's count are zero.
//  3. pointnet_bwd_finish: dW and db of the last layer, the sum over cases
//     in case order of gz a[slot] (a ones column appended to every layer's
//     input rows makes db the last row of each dW); and dx, zero but at the
//     winner rows (the compaction also gives each row its slot).
//  4. The hidden layers' dW (db riding on the ones column) contract over the
//     R_max compact rows in common.cuh's 3xTF32 weight_grad_partial, one
//     launch each, and one pointnet_sum_parts adds every layer's chunks in
//     order. At pipn's three layers that is six launches in all, none of
//     which waits on the host.
#include "tc.cuh"

using namespace pct;

// (in pct's anonymous namespace, as tc.cuh's kernels: a second one at
// global scope makes nvcc's generated launch stubs ambiguous)
namespace pct {
namespace {

// The order in which a block consumes the split weight tiles, across all
// its layers and chunks, so that the ring's copies run ahead over chunk and
// layer boundaries: tile j of the block is ts.base + ts.off[j] * kSplitTile.
struct TileSchedule {
  const float* base;
  const int* off;   // shared memory
  int n;
  int slots;        // the ring's slots in use (2 or kRing)
};

// The two ways a block's two warpgroups share the work. kOwnRows (COLS =
// 128): each warpgroup owns 64 rows of the tile and all 128 columns of a
// chunk. kSplitCols (COLS = 64): both take the same rows (as many as fit,
// at most 64), each 64 columns of every chunk, so that a tile whose row
// buffers leave room for only 64 points still runs eight warps.
constexpr int kOwnRows = 128;
constexpr int kSplitCols = 64;

// d += the 64-row A of this thread's warpgroup (local rows past lrows are
// zero registers) x W[0 .. k, its COLS columns of the chunk] in 3xTF32,
// every 8-deep step of every tile (the block's warpgroups share each ring
// tile). One thread keeps ts.slots tiles of the block's schedule in flight
// by bulk copy, refilling a slot as soon as it is consumed. Per tile each
// thread loads and splits its A fragments of the tile's four 8-deep steps
// into four register sets (steps past the layer's depth read 0: the split
// weights are 0 there too), then the warpgroup issues a_big b_small,
// a_small b_big, a_big b_big of every step back to back, with no branch
// between them, in one commit group. Every thread of the block must call
// it; it starts with a barrier (A is complete). (A warpgroup whose columns
// all lie past the layer computes zeros all the same: a branch around its
// products made the kernel 9-17% slower on an H100.)
template <int COLS>
__device__ __forceinline__ void tile_wgmma(float (&d)[COLS / 2], const float* A, int lda,
                                           int lrows, int k, Ring& ring,
                                           const TileSchedule& ts) {
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const int r0 = ((warp & 3) << 4) + g;
  const bool ok0 = r0 < lrows;
  const bool ok1 = r0 + 8 < lrows;
  const int n_tiles = (k + kChunkK - 1) / kChunkK;
  const int k_end = round8(k);
  // kOwnRows: the warpgroup's rows; kSplitCols: its columns, 8 core
  // matrices (2,048 floats of each part) into the tile
  const float* aw = A + (COLS == kOwnRows ? (size_t)wg * lrows * lda : 0);
  const int b_off = COLS == kOwnRows ? 0 : wg * 2048;
  __syncthreads();  // A is complete
  for (int tt = 0; tt < n_tiles; ++tt) {
    const unsigned j = ring.seq + tt;
    const unsigned sl = j % ts.slots;
    float* slot = ring.tiles + sl * kSplitTile;
    ring_wait(ring.bars + sl, (j / ts.slots) & 1);
    const uint64_t d_big = tile_desc(slot + b_off);
    const uint64_t d_small = tile_desc(slot + kWTile + b_off);
    const float* a0 = aw + r0 * lda + tt * kChunkK + t;
    const float* a1 = a0 + 8 * lda;
    const int kk_end = min(kChunkK, k_end - tt * kChunkK);
    unsigned ab[4][4], as[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool in = 8 * s < kk_end;
      split_tf32(in && ok0 ? a0[8 * s] : 0.f, ab[s][0], as[s][0]);
      split_tf32(in && ok1 ? a1[8 * s] : 0.f, ab[s][1], as[s][1]);
      split_tf32(in && ok0 ? a0[8 * s + 4] : 0.f, ab[s][2], as[s][2]);
      split_tf32(in && ok1 ? a1[8 * s + 4] : 0.f, ab[s][3], as[s][3]);
    }
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if constexpr (COLS == kOwnRows) {
        wgmma_tf32(d, ab[s], d_small + 16 * s);
        wgmma_tf32(d, as[s], d_big + 16 * s);
        wgmma_tf32(d, ab[s], d_big + 16 * s);
      } else {
        wgmma_tf32_n64(d, ab[s], d_small + 16 * s);
        wgmma_tf32_n64(d, as[s], d_big + 16 * s);
        wgmma_tf32_n64(d, ab[s], d_big + 16 * s);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    __syncthreads();  // everyone is done with the slot: refill it
    if (threadIdx.x == 0 && j + ts.slots < (unsigned)ts.n)
      ring_load(slot, ts.base + (size_t)ts.off[j + ts.slots] * kSplitTile, ring.bars + sl);
  }
  ring.seq += n_tiles;
}

// One tile of points of case blockIdx.y through the whole chain, by two
// warpgroups sharing the work as COLS says (lrows rows a warpgroup);
// blockIdx.z picks the group of the last layer's 128-column chunks (cpg
// chunks a group). Writes the tile's best (value, row) key per channel of
// its chunks to part (n_cases, n_tiles, F).
template <int ACT, int COLS>
__global__ void __launch_bounds__(256, 1)
    pointnet_fwd_tiles(const float* __restrict__ x, int n_pts, Mlp mlp, Split sp, int lrows,
                       int slots, int bw0, int bw1, int cpg,
                       unsigned long long* __restrict__ part) {
  constexpr int kNW = COLS == kOwnRows ? 8 : 4;   // warps of distinct rows
  constexpr int kNI = COLS / 8;                   // n8 tiles of a warpgroup
  extern __shared__ __align__(128) float smem[];
  const int rows = COLS == kOwnRows ? 2 * lrows : lrows;
  float* const buf0 = smem;
  float* const buf1 = smem + rows * bw0;
  Ring ring{buf1 + rows * bw1,
            reinterpret_cast<uint64_t*>(buf1 + rows * bw1 + slots * kSplitTile), 0u};
  auto* red = reinterpret_cast<unsigned long long*>(ring.bars + kRing);  // [kNW][kChunkN]
  int* sched = reinterpret_cast<int*>(red + kNW * kChunkN);
  ring_init(ring.bars);

  // the block's weight tiles in consumption order; the first copies
  const int nl = mlp.n_layers;
  const int n_chunks_last = (mlp.layer[nl - 1].n + kChunkN - 1) / kChunkN;
  const int ch_begin = blockIdx.z * cpg;
  const int ch_end = min(n_chunks_last, ch_begin + cpg);
  int n_sched = 0;
  for (int li = 0; li < nl; ++li) {
    const int kt = sp.kp[li] / kChunkK;
    const int c0 = li < nl - 1 ? 0 : ch_begin;
    const int c1 = li < nl - 1 ? (mlp.layer[li].n + kChunkN - 1) / kChunkN : ch_end;
    const int base = (int)(sp.off[li] / kSplitTile);
    for (int c = c0; c < c1; ++c) {
      if (threadIdx.x == 0)
        for (int t = 0; t < kt; ++t) sched[n_sched + t] = base + c * kt + t;
      n_sched += kt;
    }
  }
  const TileSchedule ts{sp.base, sched, n_sched, slots};
  if (threadIdx.x == 0)
    for (int j = 0; j < slots && j < n_sched; ++j)
      ring_load(ring.tiles + j * kSplitTile, ts.base + (size_t)sched[j] * kSplitTile,
                ring.bars + j);

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int row0 = tile * rows;
  const int valid = min(rows, n_pts - row0);
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const int r0 = ((warp & 3) << 4) + g;      // the thread's first local row
  const int rbase = COLS == kOwnRows ? wg * lrows : 0;  // its warpgroup's first tile row
  const int cbase = COLS == kOwnRows ? 0 : wg * 64;     // and first column of a chunk
  const int wr = COLS == kOwnRows ? warp : warp & 3;   // its rows' slot in red

  // stage the tile's input rows (contiguous in x); rows past n_pts and the
  // padding columns read 0
  const int l0 = mlp.layer[0].k;
  const int ld0 = row_ld(l0);
  const float* xb = x + ((size_t)b * n_pts + row0) * l0;
  for (int e = threadIdx.x; e < rows * ld0; e += 256) {
    const int r = e / ld0;
    const int c = e % ld0;
    buf0[e] = (r < valid && c < l0) ? xb[(size_t)r * l0 + c] : 0.f;
  }

  int cur = 0;
  for (int li = 0; li < nl - 1; ++li) {
    const Layer L = mlp.layer[li];
    const float* A = cur ? buf1 : buf0;
    float* out = cur ? buf0 : buf1;
    const int lda = row_ld(L.k);
    const int ldo = row_ld(L.n);
    const int n_pad = round8(L.n);
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float d[COLS / 2] = {};
      tile_wgmma<COLS>(d, A, lda, lrows, L.k, ring, ts);
      // the activations without branches (so that they overlap), the
      // stores under their conditions
#pragma unroll
      for (int i = 0; i < kNI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int lr = r0 + ((q >> 1) << 3);
          const int n = n0 + cbase + 8 * i + 2 * t + (q & 1);
          const float v = act_fast<ACT>(d[4 * i + q] + L.b[min(n, L.n - 1)]);
          if (lr < lrows && n < n_pad) out[(rbase + lr) * ldo + n] = n < L.n ? v : 0.f;
        }
    }
    cur ^= 1;
  }

  // the last layer: one 128-column chunk at a time, reduced over the tile
  const Layer L = mlp.layer[nl - 1];
  const float* A = cur ? buf1 : buf0;
  // the thread's two rows: tile rows rbase + r0 (+ 8), if real points
  const int tr0 = rbase + r0;
  const bool in0 = r0 < lrows && tr0 < valid;
  const bool in1 = r0 + 8 < lrows && tr0 + 8 < valid;
  for (int ch = ch_begin; ch < ch_end; ++ch) {
    const int n0 = ch * kChunkN;
    float d[COLS / 2] = {};
    tile_wgmma<COLS>(d, A, row_ld(L.k), lrows, L.k, ring, ts);
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cbase + 8 * i + 2 * t + e;
        const int n = n0 + c;
        const float bias = L.b[min(n, L.n - 1)];
        const float v0 = act_fast<ACT>(d[4 * i + e] + bias);
        const float v1 = act_fast<ACT>(d[4 * i + 2 + e] + bias);
        unsigned long long key = max(in0 ? pack_key(v0, row0 + tr0) : 0ull,
                                     in1 ? pack_key(v1, row0 + tr0 + 8) : 0ull);
        // the 8 lanes that share this column (lane group g = lane / 4)
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1) key = max(key, __shfl_xor_sync(kFullMask, key, off));
        if (lane < 4) red[wr * kChunkN + c] = key;
      }
    __syncthreads();
    if (threadIdx.x < kChunkN) {
      const int c = threadIdx.x;
      const int n = n0 + c;
      unsigned long long key = red[c];
      for (int w = 1; w < kNW; ++w) key = max(key, red[w * kChunkN + c]);
      if (n < L.n) part[((size_t)b * n_tiles + tile) * L.n + n] = key;
    }
    // the next chunk's product starts with a barrier before red is reused
  }
}

// fold the per-tile keys: their maximum is the largest value's first row
__global__ void pointnet_reduce(const unsigned long long* __restrict__ part, int n_cases,
                                int n_tiles, int f, float* __restrict__ out_max,
                                int* __restrict__ out_arg) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_cases * f) return;
  const int b = idx / f;
  const int n = idx % f;
  const unsigned long long* p = part + (size_t)b * n_tiles * f + n;
  unsigned long long key = p[0];
  for (int t = 1; t < n_tiles; ++t) key = max(key, p[(size_t)t * f]);
  out_max[idx] = key_value(key);
  out_arg[idx] = key_row(key);
}

// ---------------------------------------------------------------------------
// Backward

// winner slots per block: one m16 tile, so that a case's few winner rows
// still spread over many blocks (pi-gano's branch has about 140 a case)
constexpr int kTileRows = 16;

// The compact buffers of one backward launch (R_max = n_cases x rcap rows,
// rcap = min(n_pts, F); row b * rcap + slot holds case b's slot-th winner).
struct BwdArgs {
  const float* x;          // (n_cases, n_pts, widths[0])
  const int* argmax;       // (n_cases, F)
  const float* dm;         // (n_cases, F)
  const float* w_last;     // the last layer's nn.Linear weight (F, K)
  const float* b_last;
  int n_pts, f, rcap, sort_n;  // sort_n: a power of two >= F
  int lda[kMaxLayers];     // row stride of a[i]
  float* a[kMaxLayers];    // layer i's input rows, then a ones column (0 past count)
  float* z[kMaxLayers];    // hidden layer i's pre-activations (R_max x n_i)
  float* gz[kMaxLayers];   // and their cotangents
  float* dxc;              // (R_max x widths[0]) dx at the winner rows, or null
  float* gz_last;          // (n_cases, F): dm act'(z) at each channel's winner
  int* crow;               // (n_cases, F): the compact row of each channel's winner
  int* rows;               // (n_cases, rcap): the winner rows ascending, -1 past count
  int* count;              // (n_cases): distinct winner rows
  int* sorted_c;           // (n_cases, F): the channels by (winner row, channel)
  int* sorted_slot;        // (n_cases, F): the slot of each of them
  int* cst;                // (n_cases, rcap + 1): where each slot's channels start
  int* slot_of;            // (n_cases, n_pts): each row's slot, -1 if it wins nothing
};

// One block per kTileRows winner slots of case blockIdx.y, on the
// compaction pointnet_bwd_prep made: the recomputed hidden layers at its
// rows, the last layer's gz at its channels, da, and the reverse sweep (see
// the head of this file). fwd is the stack as (in, out) weights with
// biases; bwd.layer[i] is W_i in nn.Linear's (out, in) layout read as a (k =
// n_i) x (n = k_i) matrix, so block_mma16 computes GA = GZ_i W_i.
template <int ACT>
__global__ void __launch_bounds__(kThreads, 2)
    pointnet_bwd_tiles(BwdArgs p, Mlp fwd, Mlp bwd, int bw0, int bw1) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = buf0 + kTileRows * bw0;
  float* const w_tiles = buf1 + kTileRows * bw1;
  float* gzs = w_tiles + kBwdStages * kWTileFloats;  // gz of the tile's channels
  int* tch = reinterpret_cast<int*>(gzs + p.f);      // the tile's channels, sorted
  int* tsl = tch + p.f;                              // and their rows in the tile
  int* trow = tsl + p.f;                             // the tile's rows
  int* cst = trow + kTileRows;  // sorted position where each slot's channels start

  const int b = blockIdx.y;
  const int F = p.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nl = fwd.n_layers;

  // the tile's slots [slot0, slot0 + valid), their rows and channels
  const int count = p.count[b];
  const int slot0 = blockIdx.x * kTileRows;
  const int valid = max(0, min(kTileRows, count - slot0));
  const int tile_rows = min(kTileRows, p.rcap - slot0);  // its rows of the compact buffers
  const size_t rbase = (size_t)b * p.rcap + slot0;
  const int* cst_g = p.cst + (size_t)b * (p.rcap + 1) + slot0;
  for (int r = threadIdx.x; r <= valid; r += kThreads) cst[r] = cst_g[r];
  for (int r = threadIdx.x; r < valid; r += kThreads) trow[r] = p.rows[rbase + r];
  __syncthreads();
  const int lo = cst[0];
  const int hi = cst[valid];
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    tch[i - lo] = p.sorted_c[(size_t)b * F + i];
    tsl[i - lo] = p.sorted_slot[(size_t)b * F + i] - slot0;
  }

  if (valid == 0) {  // past the case's winners: zero rows only
    for (int li = 0; li < nl; ++li) {
      const int kk = fwd.layer[li].k, nn = fwd.layer[li].n;
      for (int e = threadIdx.x; e < tile_rows * p.lda[li]; e += kThreads)
        p.a[li][rbase * p.lda[li] + e] = 0.f;
      if (li < nl - 1)
        for (int e = threadIdx.x; e < tile_rows * nn; e += kThreads) {
          p.z[li][rbase * nn + e] = 0.f;
          p.gz[li][rbase * nn + e] = 0.f;
        }
      if (li == 0 && p.dxc)
        for (int e = threadIdx.x; e < tile_rows * kk; e += kThreads) p.dxc[rbase * kk + e] = 0.f;
    }
    return;
  }

  // 3. gather x at the tile's rows
  const int l0 = fwd.layer[0].k;
  {
    const int ld0 = padded(l0);
    float* a0 = p.a[0];
    const int lda0 = p.lda[0];
    for (int e = threadIdx.x; e < kTileRows * ld0; e += kThreads) {
      const int r = e / ld0;
      const int c = e % ld0;
      const float v = (r < valid && c < l0) ? p.x[((size_t)b * p.n_pts + trow[r]) * l0 + c] : 0.f;
      buf0[e] = v;
      if (r < tile_rows && c <= l0)
        a0[(rbase + r) * lda0 + c] = c < l0 ? v : (r < valid ? 1.f : 0.f);
    }
  }

  // 4. the hidden layers at the tile's rows: Z_i, and A_{i+1} = act(Z_i)
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  int cur = 0;
  for (int li = 0; li < nl - 1; ++li) {
    const Layer L = fwd.layer[li];
    const float* A = cur ? buf1 : buf0;
    float* out = cur ? buf0 : buf1;
    const int ldo = padded(L.n);
    const int n_pad = round8(L.n);
    float* zg = p.z[li];
    float* an = p.a[li + 1];
    const int ldn = p.lda[li + 1];
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[2][4];
      block_mma16(acc, A, padded(L.k), L, n0, w_tiles);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q >> 1);
          const int n = n0 + 16 * warp + 8 * j + 2 * t + (q & 1);
          if (n >= n_pad) continue;
          const bool in = n < L.n;
          const bool ok = in && row < valid;
          const float z = acc[j][q] + (in ? L.b[n] : 0.f);
          const float v = ok ? act_value<ACT>(z) : 0.f;
          out[row * ldo + n] = v;
          if (in && row < tile_rows) {
            zg[(rbase + row) * L.n + n] = ok ? z : 0.f;
            an[(rbase + row) * ldn + n] = v;
          }
        }
    }
    for (int r = threadIdx.x; r < tile_rows; r += kThreads)
      an[(rbase + r) * ldn + L.n] = r < valid ? 1.f : 0.f;
    cur ^= 1;
  }
  __syncthreads();  // the last epilogue's rows are complete

  // 5. the last layer at the tile's channels: z = a[slot] . W[c, :] + b[c],
  // gz = dm act'(z), a warp four channels at a time
  const int K = fwd.layer[nl - 1].k;
  {
    const float* A = cur ? buf1 : buf0;
    const int lda = padded(K);
    for (int i = lo + warp; i < hi; i += 4 * kWarps) {
      const float* ar[4];
      const float* wr[4];
      float acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int at = (i + q * kWarps < hi ? i + q * kWarps : i) - lo;
        ar[q] = A + tsl[at] * lda;
        wr[q] = p.w_last + (size_t)tch[at] * K;
        acc[q] = 0.f;
      }
      for (int k = lane; k < K; k += 32)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(ar[q][k], wr[q][k], acc[q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += __shfl_xor_sync(kFullMask, acc[q], off);
      if (lane == 0)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ii = i + q * kWarps;
          if (ii >= hi) break;
          const int c = tch[ii - lo];
          const float gz = p.dm[(size_t)b * F + c] * act_d1<ACT>(acc[q] + p.b_last[c]);
          gzs[ii - lo] = gz;
          p.gz_last[(size_t)b * F + c] = gz;
        }
    }
  }
  __syncthreads();

  // 6. da[slot] = sum of gz_c W[c, :] over the slot's channels, in channel
  // order (a thread a column, the channels in sorted order, eight loads in
  // flight); then GZ of the top hidden layer (into the buffer of a), or dx
  {
    float* G = cur ? buf1 : buf0;
    const int ldg = padded(K);
    for (int e = threadIdx.x; e < kTileRows * ldg; e += kThreads) G[e] = 0.f;
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += kThreads) {
      int i = lo;
      for (; i + 8 <= hi; i += 8) {
        float w[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = p.w_last[(size_t)tch[i + q - lo] * K + k];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float* gk = G + tsl[i + q - lo] * ldg + k;
          *gk = fmaf(gzs[i + q - lo], w[q], *gk);
        }
      }
      for (; i < hi; ++i) {
        float* gk = G + tsl[i - lo] * ldg + k;
        *gk = fmaf(gzs[i - lo], p.w_last[(size_t)tch[i - lo] * K + k], *gk);
      }
    }
    __syncthreads();
    const float* ztop = nl > 1 ? p.z[nl - 2] : nullptr;
    float* gtop = nl > 1 ? p.gz[nl - 2] : p.dxc;
    for (int e = threadIdx.x; e < kTileRows * ldg; e += kThreads) {
      const int r = e / ldg;
      const int k = e % ldg;
      float g = G[e];
      if (ztop && r < valid && k < K) {
        g *= act_d1<ACT>(ztop[(rbase + r) * K + k]);
        G[e] = g;
      }
      if (gtop && k < K && r < tile_rows) gtop[(rbase + r) * K + k] = g;
    }
  }

  // 7. the hidden layers in reverse: GA = GZ_i W_i, GZ_{i-1} = GA act'(Z_{i-1});
  // layer 0's GA is dx at the tile's rows
  for (int li = nl - 2; li >= 0; --li) {
    if (li == 0 && !p.dxc) break;
    const Layer L = bwd.layer[li];
    const float* A = cur ? buf1 : buf0;
    float* out = cur ? buf0 : buf1;
    const int ldo = padded(L.n);
    const int n_pad = round8(L.n);
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[2][4];
      block_mma16(acc, A, padded(L.k), L, n0, w_tiles);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q >> 1);
          const int n = n0 + 16 * warp + 8 * j + 2 * t + (q & 1);
          if (n >= n_pad) continue;
          const bool in = n < L.n;
          const bool ok = in && row < valid;
          if (li == 0) {
            if (in && row < tile_rows) p.dxc[(rbase + row) * L.n + n] = ok ? acc[j][q] : 0.f;
            continue;
          }
          const float gv =
              ok ? acc[j][q] * act_d1<ACT>(p.z[li - 1][(rbase + row) * L.n + n]) : 0.f;
          out[row * ldo + n] = gv;
          if (in && row < tile_rows) p.gz[li - 1][(rbase + row) * L.n + n] = gv;
        }
    }
    cur ^= 1;
  }
}

// Blocks [0, blocks_w): dW_last and db_last, (K + 1) x F in (in, out) layout
// (row K is db: the ones column of a_last), each the sum over cases in case
// order of gz_last a_last[crow] (consecutive threads on consecutive k of one
// channel). Blocks past that: dx (n_cases, n_pts, l0), zero but at the
// winner rows (the compaction's slot of each row).
__global__ void pointnet_bwd_finish(const float* __restrict__ gz_last,
                                    const int* __restrict__ crow,
                                    const float* __restrict__ a_last, int lda_last, int n_cases,
                                    int K, int F, float* __restrict__ dw_last, int blocks_w,
                                    const float* __restrict__ dxc,
                                    const int* __restrict__ slot_of, int rcap, int n_pts, int l0,
                                    float* __restrict__ dx) {
  if ((int)blockIdx.x < blocks_w) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (K + 1) * F) return;
    const int c = idx / (K + 1);
    const int k = idx % (K + 1);
    float s = 0.f;
    for (int b = 0; b < n_cases; ++b)
      s = fmaf(gz_last[(size_t)b * F + c], a_last[(size_t)crow[(size_t)b * F + c] * lda_last + k],
               s);
    dw_last[(size_t)k * F + c] = s;
    return;
  }
  const long long idx = (long long)(blockIdx.x - blocks_w) * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_cases * n_pts * l0) return;
  const long long pt = idx / l0;               // the row, b * n_pts + n
  const int slot = slot_of[pt];
  const int b = (int)(pt / n_pts);
  dx[idx] = slot >= 0 ? dxc[((size_t)b * rcap + slot) * l0 + idx % l0] : 0.f;
}

__global__ void pointnet_transpose(Transposes tr) { transpose_blocks(tr, blockIdx.x, gridDim.x); }

// The backward's first launch. Blocks [0, n_cases): the compaction of case
// blockIdx.x: its (argmax, channel) keys sorted (bitonic, in shared memory)
// give the winner rows ascending (slots), each channel's slot and, per slot,
// its channels in channel order. The other blocks: the weights transposed.
constexpr int kPrepThreads = 1024;

__global__ void __launch_bounds__(kPrepThreads)
    pointnet_bwd_prep(BwdArgs p, Transposes tr, int n_cases) {
  if ((int)blockIdx.x >= n_cases) {
    transpose_blocks(tr, blockIdx.x - n_cases, gridDim.x - n_cases);
    return;
  }
  extern __shared__ unsigned long long keys[];   // sort_n, then 33 ints
  int* ws = reinterpret_cast<int*>(keys + p.sort_n);
  const int b = blockIdx.x;
  const int F = p.f;
  const int P = p.sort_n;
  const int* arg = p.argmax + (size_t)b * F;
  int* slot_of = p.slot_of + (size_t)b * p.n_pts;
  for (int r = threadIdx.x; r < p.n_pts; r += kPrepThreads) slot_of[r] = -1;
  auto key = [&](int i) {
    return i < F ? ((unsigned long long)(unsigned)arg[i] << 32) | (unsigned)i : ~0ull;
  };
  if (P <= kPrepThreads) {
    // one key a thread: exchanges within a warp by shuffles, the longer
    // ones through shared memory
    const int i = threadIdx.x;
    unsigned long long v = key(i);
    for (int k = 2; k <= P; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned long long o;
        if (j >= 32) {  // threads past P hold padding among themselves
          if (i < P) keys[i] = v;
          __syncthreads();
          o = i < P ? keys[i ^ j] : v;
          __syncthreads();
        } else {
          o = __shfl_xor_sync(kFullMask, v, j);
        }
        // the lower of a pair keeps the min in an ascending run, else the max
        v = (((i & j) == 0) == ((i & k) == 0)) ? min(v, o) : max(v, o);
      }
    if (i < P) keys[i] = v;
    __syncthreads();
  } else {
    for (int i = threadIdx.x; i < P; i += kPrepThreads) keys[i] = key(i);
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < P; i += kPrepThreads) {
          const int l = i ^ j;
          if (l > i) {
            const unsigned long long u = keys[i], v = keys[l];
            if ((u > v) == ((i & k) == 0)) {
              keys[i] = v;
              keys[l] = u;
            }
          }
        }
        __syncthreads();
      }
  }
  // a sorted position starts a slot where its row differs from the one before
  auto starts = [&](int i) { return i == 0 || (keys[i] >> 32) != (keys[i - 1] >> 32); };
  const int per = (P + kPrepThreads - 1) / kPrepThreads;
  const int i0 = threadIdx.x * per;
  const int i1 = min(i0 + per, F);
  int n_new = 0;
  for (int i = i0; i < i1; ++i) n_new += starts(i);
  int count;
  int slot = block_exclusive_scan<kPrepThreads / 32>(n_new, ws, &count) - 1;
  const size_t fb = (size_t)b * F;
  int* cst = p.cst + (size_t)b * (p.rcap + 1);
  for (int i = i0; i < i1; ++i) {
    const int row = (int)(keys[i] >> 32);
    const int c = (int)(unsigned)keys[i];
    if (starts(i)) {
      ++slot;
      p.rows[(size_t)b * p.rcap + slot] = row;
      cst[slot] = i;
      slot_of[row] = slot;
    }
    p.sorted_c[fb + i] = c;
    p.sorted_slot[fb + i] = slot;
    p.crow[fb + c] = b * p.rcap + slot;
  }
  for (int sl = count + threadIdx.x; sl <= p.rcap; sl += kPrepThreads) {
    if (sl < p.rcap) p.rows[(size_t)b * p.rcap + sl] = -1;
    cst[sl] = F;
  }
  if (threadIdx.x == 0) p.count[b] = count;
}

inline cudaError_t launch_transposes(const Transposes& tr, cudaStream_t s) {
  const long long total = tr.start[tr.n];
  const int blocks = (int)std::min<long long>((total + 255) / 256, 1024);
  pointnet_transpose<<<blocks, 256, 0, s>>>(tr);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pct

namespace pct {
namespace {

// The forward's block: its two warpgroups' arrangement (cols: kOwnRows or
// kSplitCols; 0 when no block fits), lrows rows a warpgroup, and its
// shared bytes.
struct FwdConfig {
  int cols, lrows, slots, bw0, bw1;
  size_t smem;
};

inline int fwd_rows(int cols, int lrows) { return cols == kOwnRows ? 2 * lrows : lrows; }

inline size_t fwd_smem(int cols, int lrows, int slots, int bw0, int bw1, int n_sched) {
  const int nw = cols == kOwnRows ? 8 : 4;
  return sizeof(float) * ((size_t)fwd_rows(cols, lrows) * (bw0 + bw1) + slots * kSplitTile) +
         sizeof(uint64_t) * (kRing + (size_t)nw * kChunkN) + sizeof(int) * (size_t)n_sched;
}

// 64 rows a warpgroup where two warpgroups' row buffers fit beside a ring of
// three tiles; else both warpgroups on the same rows, as many as fit (a
// multiple of 8, at most 64) beside three tiles, or beside two where that
// takes more rows (pi-gano's branch: 56 rows, not 40).
inline FwdConfig fwd_config(int n_layers, const int* widths) {
  FwdConfig c{0, 0, kRing, 0, 0, 0};
  for (int i = 0; i < n_layers; ++i) {
    int& w = (i % 2 == 0) ? c.bw0 : c.bw1;
    w = std::max(w, row_ld(widths[i]));
  }
  int n_sched = 0;  // every weight tile of the stack: the longest schedule
  for (int i = 0; i < n_layers; ++i)
    n_sched += (round32(widths[i]) / kChunkK) * (round128(widths[i + 1]) / kChunkN);
  const size_t cap = (size_t)max_shared_bytes();
  auto most_rows = [&](int slots) {
    for (int lr = 64; lr >= 8; lr -= 8)
      if (fwd_smem(kSplitCols, lr, slots, c.bw0, c.bw1, n_sched) <= cap) return lr;
    return 0;
  };
  if (fwd_smem(kOwnRows, 64, kRing, c.bw0, c.bw1, n_sched) <= cap) {
    c.cols = kOwnRows;
    c.lrows = 64;
  } else if (const int lr3 = most_rows(kRing), lr2 = most_rows(2); lr3 > 0 || lr2 > 0) {
    c.cols = kSplitCols;
    c.slots = lr2 > lr3 ? 2 : kRing;
    c.lrows = std::max(lr2, lr3);
  }
  c.smem = fwd_smem(c.cols, c.lrows, c.slots, c.bw0, c.bw1, n_sched);
  return c;
}

inline int fwd_tiles(const FwdConfig& c, int n_pts) {
  const int rows = fwd_rows(c.cols, c.lrows);
  return (n_pts + rows - 1) / rows;
}

template <int ACT, int COLS>
cudaError_t launch_fwd(const FwdConfig& c, dim3 grid, const float* x, int n_pts, const Mlp& mlp,
                       const Split& sp, int cpg, unsigned long long* part, cudaStream_t s) {
  auto kernel = pointnet_fwd_tiles<ACT, COLS>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  kernel<<<grid, 256, c.smem, s>>>(x, n_pts, mlp, sp, c.lrows, c.slots, c.bw0, c.bw1, cpg,
                                    part);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pct

extern "C" long long pointnet_global_forward_workspace(int n_cases, int n_pts, int n_layers,
                                                       const int* widths) {
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  const FwdConfig c = fwd_config(n_layers, widths);
  if (c.cols == 0) return -1;
  Transposes tr;
  Split sp;
  const long long trans = make_transposes(n_layers, nullptr, widths, nullptr, &tr);
  const long long split = make_split(make_mlp(n_layers, nullptr, nullptr, widths), widths[0],
                                     nullptr, &sp);
  return round32ll(trans) + round32ll(split) +
         2LL * n_cases * fwd_tiles(c, n_pts) * widths[n_layers];
}

// x (n_cases, n_pts, widths[0]) f32; layer i has nn.Linear's weight w[i]
// (widths[i+1], widths[i]) row-major and bias b[i]; scratch holds
// pointnet_global_forward_workspace floats (the weights transposed, then
// split, then the per-tile partials); out_* (n_cases, F). Returns the CUDA
// error code of the launches (0 = ok).
extern "C" int pointnet_global_forward(const float* x, int n_cases, int n_pts, int n_layers,
                                       const float* const* w, const float* const* b,
                                       const int* widths, int act, float* scratch,
                                       long long scratch_floats, float* out_max, int* out_arg,
                                       void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_cases < 1 || n_pts < 1 || (act != kSilu &&
                                                                           act != kTanh))
    return (int)cudaErrorInvalidValue;
  const long long need = pointnet_global_forward_workspace(n_cases, n_pts, n_layers, widths);
  if (need < 0 || need > scratch_floats) return (int)cudaErrorInvalidValue;
  const FwdConfig c = fwd_config(n_layers, widths);
  Transposes tr;
  const long long trans = make_transposes(n_layers, w, widths, scratch, &tr);
  const Mlp mlp = make_mlp(n_layers, tr.dst, b, widths);
  float* split_base = scratch + round32ll(trans);
  Split sp;
  const long long split = make_split(mlp, widths[0], split_base, &sp);
  const int n_tiles = fwd_tiles(c, n_pts);
  const int f = widths[n_layers];
  auto* part = reinterpret_cast<unsigned long long*>(split_base + round32ll(split));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_transposes(tr, s);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_split(mlp, sp, widths[0], split_base, s)) != cudaSuccess) return (int)err;
  // too few blocks for the SMs: the last layer's chunks split over grid.z
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_chunks = (f + kChunkN - 1) / kChunkN;
  const int blocks = n_tiles * n_cases;
  const int groups = blocks >= sms ? 1 : std::min(n_chunks, (sms + blocks - 1) / blocks);
  const int cpg = (n_chunks + groups - 1) / groups;
  const dim3 grid(n_tiles, n_cases, (n_chunks + cpg - 1) / cpg);
  if (act == kSilu)
    err = c.cols == kOwnRows
              ? launch_fwd<kSilu, kOwnRows>(c, grid, x, n_pts, mlp, sp, cpg, part, s)
              : launch_fwd<kSilu, kSplitCols>(c, grid, x, n_pts, mlp, sp, cpg, part, s);
  else
    err = c.cols == kOwnRows
              ? launch_fwd<kTanh, kOwnRows>(c, grid, x, n_pts, mlp, sp, cpg, part, s)
              : launch_fwd<kTanh, kSplitCols>(c, grid, x, n_pts, mlp, sp, cpg, part, s);
  if (err != cudaSuccess) return (int)err;
  const int total = n_cases * f;
  pointnet_reduce<<<(total + 255) / 256, 256, 0, s>>>(part, n_cases, n_tiles, f, out_max,
                                                      out_arg);
  return (int)cudaGetLastError();
}

namespace pct {
namespace {

// The backward's scratch: the compact buffers, then the weight gradients'
// partials, each region 32-float aligned. With base null, sizes only.
struct BwdLayout {
  BwdArgs args;
  Transposes tr;
  float* parts[kMaxLayers];
  int chunks[kMaxLayers];
  long long floats;
};

inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// chunks of rows of a hidden layer's weight gradient: about two blocks an
// SM, at least 128 rows a chunk (the compact rows are few: weight_grad's
// 512-row chunks would leave most SMs idle)
inline int pn_grad_chunks(int rows, int K, int N) {
  const int tiles = ((N + grad_tile(N) - 1) / grad_tile(N)) * ((K + grad_tile(K) - 1) / grad_tile(K));
  const int chunks = std::min((2 * 132 + tiles - 1) / tiles, (rows + 127) / 128);
  return std::max(chunks, 1);
}

inline BwdLayout bwd_layout(int n_cases, int n_pts, int n_layers, const int* widths, bool need_dx,
                            float* base) {
  BwdLayout l{};
  const int F = widths[n_layers];
  const int rcap = std::min(n_pts, F);
  const long long R = (long long)n_cases * rcap;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base ? base + off : nullptr;
    off += round32ll(n);
    return p;
  };
  take(make_transposes(n_layers, nullptr, widths, base, &l.tr));
  BwdArgs& a = l.args;
  a.n_pts = n_pts;
  a.f = F;
  a.rcap = rcap;
  a.sort_n = next_pow2(F);
  for (int i = 0; i < n_layers; ++i) {
    a.lda[i] = round4(widths[i] + 1);
    a.a[i] = take(R * a.lda[i]);
  }
  for (int i = 0; i < n_layers - 1; ++i) {
    a.z[i] = take(R * widths[i + 1]);
    a.gz[i] = take(R * widths[i + 1]);
  }
  a.dxc = need_dx ? take(R * widths[0]) : nullptr;
  a.gz_last = take((long long)n_cases * F);
  a.crow = reinterpret_cast<int*>(take((long long)n_cases * F));
  a.rows = reinterpret_cast<int*>(take(R));
  a.count = reinterpret_cast<int*>(take(n_cases));
  a.sorted_c = reinterpret_cast<int*>(take((long long)n_cases * F));
  a.sorted_slot = reinterpret_cast<int*>(take((long long)n_cases * F));
  a.cst = reinterpret_cast<int*>(take((long long)n_cases * (rcap + 1)));
  a.slot_of = reinterpret_cast<int*>(take((long long)n_cases * n_pts));
  for (int i = 0; i < n_layers - 1; ++i) {
    l.chunks[i] = pn_grad_chunks((int)R, widths[i] + 1, widths[i + 1]);
    l.parts[i] = take((long long)l.chunks[i] * (widths[i] + 1) * widths[i + 1]);
  }
  l.floats = off;
  return l;
}

inline size_t bwd_smem(const Mlp& fwd, int F, int* bw0, int* bw1) {
  buffer_widths(fwd, bw0, bw1);
  return sizeof(float) * ((size_t)kTileRows * (*bw0 + *bw1) + kBwdStages * kWTileFloats + F) +
         sizeof(int) * (2 * (size_t)F + 2 * kTileRows + 1);
}

template <int BM, int BN>
cudaError_t launch_partials(const float* A, int lda, const float* G, int ldg, int rows, int K,
                            int N, int chunks, float* parts, cudaStream_t s) {
  int per = (rows + chunks - 1) / chunks;
  per = (per + kGradDepth - 1) / kGradDepth * kGradDepth;
  constexpr size_t smem = grad_smem_bytes<BM, BN>();
  auto kernel = weight_grad_partial<-1, BM, BN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, chunks);
  kernel<<<grid, kThreads, smem, s>>>(A, lda, G, ldg, rows, K, N, per, parts, nullptr);
  return cudaGetLastError();
}

// C (K x N) partial blocks of A^T G over the rows, one per chunk, in
// common.cuh's 3xTF32 weight_grad_partial (the tile weight_grad picks)
cudaError_t grad_partials(const float* A, int lda, const float* G, int ldg, int rows, int K, int N,
                          int chunks, float* parts, cudaStream_t s) {
  if (grad_tile(K) == 128)
    return grad_tile(N) == 128
               ? launch_partials<128, 128>(A, lda, G, ldg, rows, K, N, chunks, parts, s)
               : launch_partials<128, 64>(A, lda, G, ldg, rows, K, N, chunks, parts, s);
  return grad_tile(N) == 128
             ? launch_partials<64, 128>(A, lda, G, ldg, rows, K, N, chunks, parts, s)
             : launch_partials<64, 64>(A, lda, G, ldg, rows, K, N, chunks, parts, s);
}

}  // namespace
}  // namespace pct

// Scratch floats pointnet_global_backward needs.
extern "C" long long pointnet_global_backward_workspace(int n_cases, int n_pts, int n_layers,
                                                        const int* widths, int need_dx) {
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  return bwd_layout(n_cases, n_pts, n_layers, widths, need_dx != 0, nullptr).floats;
}

// Backward of pointnet_global_forward. w[i] is layer i's nn.Linear weight
// (widths[i+1], widths[i]) and b[i] its bias; argmax/dm (n_cases, F) the forward's first maximal rows and the
// pooled cotangent. Writes dx (n_cases, n_pts, widths[0]) (null: not wanted)
// at every row, zero where no cotangent arrives, and grads[i] ((widths[i] +
// 1) x widths[i+1]): dW_i in (in, out) layout, then db_i as its last row.
// winners (null: not wanted) receives the compaction: rows (n_cases, rcap)
// ascending with -1 past the count, the compact row of each (case, channel)
// (n_cases, F) and the counts (n_cases), rcap = min(n_pts, F).
extern "C" int pointnet_global_backward(const float* x, int n_cases, int n_pts, int n_layers,
                                        const float* const* w_orig, const float* const* b,
                                        const int* widths, int act, const int* argmax, const float* dm, float* dx,
                                        float* const* grads, float* scratch,
                                        long long scratch_floats, int* const* winners,
                                        void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_cases < 1 || n_pts < 1 || (act != kSilu &&
                                                                           act != kTanh))
    return (int)cudaErrorInvalidValue;
  const bool need_dx = dx != nullptr;
  BwdLayout l = bwd_layout(n_cases, n_pts, n_layers, widths, need_dx, scratch);
  if (l.floats > scratch_floats) return (int)cudaErrorInvalidValue;
  const int nl = n_layers;
  const int F = widths[nl];
  const int K = widths[nl - 1];
  BwdArgs& a = l.args;
  a.x = x;
  a.argmax = argmax;
  a.dm = dm;
  a.w_last = w_orig[nl - 1];
  a.b_last = b[nl - 1];
  for (int i = 0; i < nl; ++i) l.tr.src[i] = w_orig[i];
  const Mlp fwd = make_mlp(nl, l.tr.dst, b, widths);
  Mlp bwd{};
  bwd.n_layers = nl;
  for (int i = 0; i < nl; ++i) {
    bwd.layer[i].w = w_orig[i];
    bwd.layer[i].b = nullptr;
    bwd.layer[i].k = widths[i + 1];
    bwd.layer[i].n = widths[i];
    bwd.layer[i].ldw = widths[i];
  }
  int bw0, bw1;
  const size_t smem = bwd_smem(fwd, F, &bw0, &bw1);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int prep_blocks = (int)std::min<long long>((l.tr.start[nl] + kPrepThreads - 1) /
                                                   kPrepThreads, 256);
  const size_t prep_smem = sizeof(unsigned long long) * a.sort_n + sizeof(int) * 33;
  if (prep_smem > 48 * 1024)
    cudaFuncSetAttribute(pointnet_bwd_prep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)prep_smem);
  pointnet_bwd_prep<<<n_cases + prep_blocks, kPrepThreads, prep_smem, s>>>(a, l.tr, n_cases);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void (*tiles)(BwdArgs, Mlp, Mlp, int, int) =
      act == kSilu ? &pointnet_bwd_tiles<kSilu> : &pointnet_bwd_tiles<kTanh>;
  cudaFuncSetAttribute(tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((a.rcap + kTileRows - 1) / kTileRows, n_cases);
  tiles<<<grid, kThreads, smem, s>>>(a, fwd, bwd, bw0, bw1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int blocks_w = ((K + 1) * F + 255) / 256;
  const long long dx_len = need_dx ? (long long)n_cases * n_pts * widths[0] : 0;
  const int blocks_x = (int)((dx_len + 255) / 256);
  pointnet_bwd_finish<<<blocks_w + blocks_x, 256, 0, s>>>(
      a.gz_last, a.crow, a.a[nl - 1], a.lda[nl - 1], n_cases, K, F, grads[nl - 1], blocks_w,
      a.dxc, a.slot_of, a.rcap, n_pts, widths[0], dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (nl > 1) {
    const int R = n_cases * a.rcap;
    PartSums ps{};
    ps.n = nl - 1;
    long long total = 0;
    for (int i = 0; i < nl - 1; ++i) {
      const int k = widths[i] + 1, n = widths[i + 1];
      err = grad_partials(a.a[i], a.lda[i], a.gz[i], n, R, k, n, l.chunks[i], l.parts[i], s);
      if (err != cudaSuccess) return (int)err;
      ps.parts[i] = l.parts[i];
      ps.out[i] = grads[i];
      ps.n_parts[i] = l.chunks[i];
      ps.start[i] = total;
      total += (long long)k * n;
    }
    ps.start[nl - 1] = total;
    sum_layer_parts<<<(int)((total * kSumLanes + 255) / 256), 256, 0, s>>>(ps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (winners) {
    // the compaction, for the checks: copies of the scratch's int blocks
    const size_t fb = sizeof(int) * n_cases * F;
    if ((err = cudaMemcpyAsync(winners[0], a.rows, sizeof(int) * n_cases * a.rcap,
                               cudaMemcpyDeviceToDevice, s)) != cudaSuccess ||
        (err = cudaMemcpyAsync(winners[1], a.crow, fb, cudaMemcpyDeviceToDevice, s)) !=
            cudaSuccess ||
        (err = cudaMemcpyAsync(winners[2], a.count, sizeof(int) * n_cases,
                               cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
      return (int)err;
  }
  return 0;
}

// The blocks of both kernels at these widths: out = {the forward's
// columns a warpgroup (128: each warpgroup its own 64 rows; 64: both on the
// same rows), its points a block, its shared bytes, the backward tiles'
// shared bytes}.
extern "C" int pointnet_global_blocks(int n_layers, const int* widths, int* out) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  const FwdConfig c = fwd_config(n_layers, widths);
  int bw0, bw1;
  const size_t bwd = bwd_smem(make_mlp(n_layers, nullptr, nullptr, widths), widths[n_layers],
                              &bw0, &bw1);
  out[0] = c.cols;
  out[1] = fwd_rows(c.cols, c.lrows);
  out[2] = (int)c.smem;
  out[3] = (int)bwd;
  return (c.cols == 0 || bwd > (size_t)max_shared_bytes()) ? (int)cudaErrorInvalidValue : 0;
}
