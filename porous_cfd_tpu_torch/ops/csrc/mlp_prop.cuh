// The (value, Jacobian, Hessian-diagonal) propagation through a dense stack
// whose hidden layers are activated and dropped out, and whose last layer is
// linear, forward and backward: the kernels and launch sequences that
// decoder_prop.cu (the PIPN decoder) and neural_op_prop.cu (the PI-GANO
// trunk) instantiate. With MOD every hidden layer's output is also
// multiplied per case by a vector par (B, F) after its dropout, and the
// backward adds up the per-case cotangent dpar.
//
// Which TPU kernels. mlp_prop_fwd replaces decoder_pallas.py:_fwd_kernel
// (pallas_call at :433) and neural_op_pallas.py:_fwd_kernel (:357);
// mlp_prop_bwd_rows with the host sequence of prop_backward (and common.cuh's
// weight_grad) replaces decoder_pallas.py:_bwd_kernel (:473) and
// neural_op_pallas.py:_bwd_kernel (:391).
//
// Two launch-time modes serve the trunk of PiGanoFull (neural_op_prop.cu;
// the decoder uses neither). The first n_act layers are the "operators":
// dense, activation rules, dropout and modulation. With a reduction (n_act =
// n_layers - 1) the last layer is linear; without one (reduce = false, n_act
// = n_layers) the last operator's (v, J, H) go straight from its epilogue to
// ov/oj/oh, F wide. With last_linear the last operator takes the identity's
// rules (val = z, d1 = 1, d2 = d3 = 0) in place of the activation's: a
// linear operator that is still dropped out and modulated. Only the MODES
// instantiations (MOD's alone) test these flags; the default mode's launches
// go to instantiations whose epilogues carry none of their branches: on an
// H100 the branches cost the default trunk's internal launches 3% forward
// and 8% backward (PR 6).
//
// What bounds it on an H100: operations. pipn's decoder forward is 43.5
// GFLOP on 33 MB, the trunk's 96 GFLOP on 81 MB; the backward twice that.
// f32-accurate tensor-core work (3xTF32, common.cuh) runs at 164.9 TFLOP/s:
// 0.264 ms for the decoder forward, 0.583 ms for the trunk's, against 0.01
// and 0.02 ms of bytes at 3.35 TB/s.
//
// Forward design. With D = 2 every point carries 1 + 2D = 5 rows. A block
// holds 40 rows: in the internal launch 8 points x 5 components, row comp * 8
// + point; in the boundary launch 40 points. At D = 3 (7 rows a point) a
// block holds 4 points, 28 rows, row comp * 4 + point (tile_points): 8
// points would make 56 rows, whose two buffers beside the weight ring pass
// the H100's 232,448 bytes a block at the 3D experiments' widths (abc's
// decoder [1088, 512, 256, 128, 4]: 272,152 B; windbreaks' 512-wide trunk:
// 329,496 B), where 28 rows take 185,240 and 213,912 B. Lane groups 4-7
// then idle in the epilogues, and 28 of a wgmma's 64 rows are real. Rows
// with D <= 2 keep the 8-point tile and its code. Two row buffers as wide as the
// widest layer keep every intermediate in shared memory (row strides of 8k
// + 4 words, so the 8 rows a warp reads at once fall in distinct banks).
// Every dense layer is a product of the block's rows and a 128-column chunk
// of the weight on the tensor cores (rows_wgmma): the block's two
// warpgroups split each weight tile's depth and each computes all 128
// columns, through wgmma.m64n128k8 in TF32 with A (the rows) from
// registers and B (the weight) from shared memory, three products per step
// (3xTF32); their partial sums add up in the dump below (on the H100 this
// ran 3-9% faster than two warpgroups of 64 columns each over all the depth). The 64 rows of a wgmma hold the 40 real ones
// and 24 zero registers, so 3/8 of the tensor work is padding: the price of
// one thread per point in the epilogue below, and of two row buffers that
// fit (a 64-row tile of pipn's decoder would need 64 x (516 + 260) x 4 B =
// 199 KB of them, and the weight ring on top). The weights are split into
// their TF32 parts once per launch (split_weights) and laid out in global
// memory as ready tiles, so one thread brings each 32 x 128 tile (32 KB,
// both parts) by bulk copy (cp.async.bulk, the TMA) into a ring of three,
// tracked by mbarriers: no thread spends instructions on weight copies (a
// per-thread cp.async ring of the same tiles ran the decoder's forward
// 1.8x slower on the H100). A block
// barrier per tile frees the slot for the next copy; mbarrier-released
// slots with products overlapping across tiles measured slower. Shared
// memory: 40 x (260 + 516) x 4 B + 96 KB = 217 KB for pipn's decoder,
// 207 KB for the trunk's 352-wide rows: one block (two warpgroups) per SM.
// After the last step of a chunk the two warpgroups' accumulators leave
// through the ring (rows_dump), added, into the epilogues' layout: in the mma C layout one thread
// holds, for two columns of each of its two n8 tiles, the rows g, g + 8,
// 16 + g, ... of the tile, i.e. all 5 rows of point g, so the derivative
// rules v' = s(z), J' = s'(z) zJ, H' = s''(z) zJ^2 + s'(z) zH, the dropout
// factors (one Philox call per point and 4 columns) and the modulation are
// applied in registers. Every block streams the whole weight stack (both
// parts, padded) from L2: 1.64 MB for pipn's decoder, 4.0 GB per internal
// forward, about 3.1 TB/s at the measured speed. Sharing each tile across
// a cluster of two blocks (each multicasting half of every tile to both,
// a cluster barrier before a slot is refilled) halves that stream, but ran
// the decoder's forward 1.55x slower on the H100: the barriers cost more
// than the bytes saved, so the tiles are not shared. Layer 0 adds the
// per-case ctx = g W0[:, L:]^T + b0 (computed outside by torch) on the
// value rows in place of a bias; biases touch value rows only. Every
// column loop masks the tail of a layer whose width is not a multiple of
// the 128-column chunk; columns [n, round8(n)) of each row buffer are zero
// for the next layer's 8-deep steps, and the split weights are zero past
// the layer. The last (linear) layer goes through the same product, its
// few outputs in one 128-column chunk. The
// outputs are written straight into the engine's layouts: values into rows
// [row0, row0 + n) of the merged (B, Ni + Nb, O) tensor, J/H as (B, Ni, O,
// D). Rows past n_pts are computed on zeros and never stored. On the H100
// the decoder's forward reaches 17% of its 3xTF32 bound (PERF.md): the 3/8
// padding, the epilogues and the weight stream above are the known costs.
//
// Two layer-0 modes carry the max-pool-coupled decoder (decoder_prop.cu;
// the trunk uses neither). j0_add: two (B, D, N, F1) tensors are added to
// the J/H rows' layer-0 pre-activations in the product's epilogue, before
// the activation rules, and the backward writes their cotangents (the J/H
// rows of GZ_0) in the same layout. Context columns: the J/H rows are wider
// than the value rows (lv local columns, then context columns up to
// widths[0]); the value rows read zeros there, as the ctx vector already
// carries their context. Only the lv local columns are staged with the input
// rows; the context columns go through the same accumulators kCtxChunk at a
// time from a staging tile of their own, so shared memory does not grow with
// the context width, and the stash holds the full rows for dW_0.
//
// Backward design. The TPU kernels recompute the forward per tile and carry
// dW, db, dctx (and dpar) across their sequential grid; Hopper's blocks run
// in parallel, and per-block copies of the weights do not fit. So:
//  1. the training forward also writes each layer's input rows A_i and
//     pre-activations Z_i to device memory (written once and read once);
//  2. mlp_prop_bwd_rows walks the layers in reverse for the same 40-row
//     tiles: GA_i = GZ_i W_i^T through rows_wgmma (W_i in nn.Linear's (out,
//     in) layout, split once per launch like the forward's), and in the product's
//     epilogue the third-derivative rules (decoder_pallas.py:310-331, masks
//     applied first) turn GA_i into GZ_{i-1} while one thread holds all 5
//     rows of a point. Each GZ_i is written to device memory. With MOD the
//     same epilogue recomputes the pre-modulation triple from Z (value, J and
//     H of the activation, times the mask) and writes, per point and column,
//     its product with GA summed over the point's rows: dpar's addends;
//  3. dW_i = A_i^T GZ_i contracts over all rows in common.cuh's weight_grad
//     (3xTF32 tiles per chunk of rows, the chunks added in order), and db_i,
//     dctx and dpar are column sums (group_colsum, per case where the
//     quantity is). No atomics: the result does not depend on the schedule,
//     and two runs on the same inputs give the same bits.
// Every product of the three kernels runs on the tensor cores in 3xTF32
// (the row kernels' on wgmma, weight_grad's on mma.sync); only the
// epilogues' rules, the Philox masks and the column sums use the CUDA cores.
#pragma once

#include "common.cuh"
#include "tc.cuh"

#include <algorithm>
#include <cstdint>

namespace pct {
namespace {

// context columns of layer 0 staged per pass (context-column mode)
constexpr int kCtxChunk = 128;
// the product's accumulators leave through the (then idle) ring, rows
// kDumpLd words apart
constexpr int kDumpLd = kChunkN + 4;

// Per-layer device pointers: for the training stash a[i] (rows x k_i) holds
// layer i's input rows and z[i] (rows x n_i) its pre-activations (hidden
// layers only), rows ((b * n_pts + pt) * C + comp); the backward also uses
// the a[] slots for per-layer cotangent blocks.
struct Stash {
  float* a[kMaxLayers];
  float* z[kMaxLayers];
};

// the operators' count: every layer but the reduction, or (MODES) all of them
inline __host__ __device__ int operators(int n_layers, bool reduce) {
  return reduce ? n_layers - 1 : n_layers;
}

// Points of a block's tile with derivatives, one per lane group of a warp:
// 8 to D = 2 (40 rows at D = 2); 4 at D = 3, whose 7 rows a point would
// make 56 rows of 8 points, and row buffers that do not fit beside the
// weight ring at the 3D experiments' widths (28 rows do). Lane groups past
// the tile's points idle in the epilogues.
template <int D>
__host__ __device__ constexpr int tile_points() {
  return D <= 2 ? kWarps : kWarps / 2;
}
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return (1 + 2 * D) * tile_points<D>();
}

// A thread's accumulators over NC rows, one a component of its point (lane
// group g = lane / 4): (i, j, e) is component i, column 2t + e (t = lane %
// 4) of the warp's n8 tile j, as the mma's C fragment lays out row groups.
template <int NC>
struct RowAcc {
  float v[(NC + 1) / 2][2][4];
  __device__ __forceinline__ float& operator()(int i, int j, int e) {
    return v[i >> 1][j][((i & 1) << 1) + e];
  }
};

// the first of the thread's two columns in its n8 tile j (j < 2) of a
// chunk, in the epilogues' layout: warp w owns columns 32 (w % 4) + 16 (w
// / 4) .. + 15; its point slot is lane_group()
__device__ __forceinline__ int mma_col(int j) {
  const int w = threadIdx.x >> 5;
  return ((w & 3) << 5) + ((((w >> 2) << 1) + j) << 3) + ((threadIdx.x & 3) << 1);
}


// d += rows x W[kpos .. kpos + k, n0 : n0 + 128] in 3xTF32 for the R
// rows of A (row stride lda, columns [k, round8(k)) zero), over the half of
// each tile's depth that belongs to this thread's warpgroup: warpgroup h of
// the block's two takes the 8-deep steps 2h and 2h + 1 of every 32-deep
// tile, all 128 columns; warp w of it the rows 16w .. 16w + 15 (rows past
// R are zero registers). One thread keeps
// kRing - 1 tiles in flight by bulk copy. Per 8-deep step each thread
// loads its A fragment, splits it, and the warpgroup issues a_big b_small,
// a_small b_big, a_big b_big on the tile's two parts; two register sets let
// one step's products run while the next step's fragment is formed. Every
// thread of the block must call it; it starts with a barrier (the ring's
// last readers are done and A is complete).
template <int R>
__device__ __forceinline__ void rows_wgmma(float (&d)[64], const float* A, int lda,
                                           const SplitW& W, int kpos, int k, int n0,
                                           Ring& ring) {
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const int r0 = ((warp & 3) << 4) + g;
  const bool ok0 = r0 < R;
  const bool ok1 = r0 + 8 < R;
  const int n_tiles = (k + kChunkK - 1) / kChunkK;
  const int k_end = round8(k);
  const float* src = W.tiles + ((size_t)(n0 / kChunkN) * W.k_tiles + kpos / kChunkK) * kSplitTile;
  // the ring's generic reads and writes (the last dump) come before the
  // copies that follow
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kRing && s < n_tiles; ++s) {
      const unsigned j = ring.seq + s;
      ring_load(ring.tiles + (j % kRing) * kSplitTile, src + (size_t)s * kSplitTile,
                ring.bars + j % kRing);
    }
  for (int tt = 0; tt < n_tiles; ++tt) {
    const unsigned j = ring.seq + tt;
    float* slot = ring.tiles + (j % kRing) * kSplitTile;
    ring_wait(ring.bars + j % kRing, (j / kRing) & 1);
    const uint64_t d_big = tile_desc(slot);
    const uint64_t d_small = tile_desc(slot + kWTile);
    const float* a0 = A + r0 * lda + tt * kChunkK + t;
    const float* a1 = a0 + 8 * lda;
    const int kk_end = min(kChunkK, k_end - tt * kChunkK);
    unsigned ab[2][4], as[2][4];
    fence_acc(d);
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int s = 2 * wg + s2;             // this warpgroup's half of the tile
      if (8 * s >= kk_end) break;
      unsigned (&big)[4] = ab[s2];
      unsigned (&small)[4] = as[s2];
      split_tf32(ok0 ? a0[8 * s] : 0.f, big[0], small[0]);
      split_tf32(ok1 ? a1[8 * s] : 0.f, big[1], small[1]);
      split_tf32(ok0 ? a0[8 * s + 4] : 0.f, big[2], small[2]);
      split_tf32(ok1 ? a1[8 * s + 4] : 0.f, big[3], small[3]);
      wgmma_fence();
      // the step's 8 k of each part: two core matrices, 256 bytes on
      wgmma_tf32(d, big, d_small + 16 * s);
      wgmma_tf32(d, small, d_big + 16 * s);
      wgmma_tf32(d, big, d_big + 16 * s);
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done with its register set
    }
    wgmma_wait<0>();
    fence_acc(d);
    __syncthreads();  // everyone is done with the slot: refill it
    if (threadIdx.x == 0 && tt + kRing < n_tiles)
      ring_load(slot, src + (size_t)(tt + kRing) * kSplitTile, ring.bars + j % kRing);
  }
  ring.seq += n_tiles;
}

// The accumulators of the product over NC * P rows (row i * P + point)
// into acc, in the epilogues' layout (mma_col; the thread's point is its
// lane group g), through the ring: each warpgroup writes its partial sums
// to an area of its own, and each thread reads the two areas' sum at its
// places; columns past n_cols, and lane groups g >= P, read 0.
template <int NC, int P>
__device__ __forceinline__ void rows_dump(RowAcc<NC>& acc, const float (&d)[64], float* ring,
                                          int n0, int n_cols) {
  const int warp = threadIdx.x >> 5;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const int r0 = ((warp & 3) << 4) + g;
  float* mine = ring + (warp >> 2) * (NC * P * kDumpLd);
  const float* other = ring + NC * P * kDumpLd;
  __syncthreads();  // both warpgroups are done with the ring's tiles
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + ((q >> 1) << 3);
      if (r < NC * P) mine[r * kDumpLd + 8 * i + 2 * t + (q & 1)] = d[4 * i + q];
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = mma_col(j) + e;
        const int o = (i * P + g) * kDumpLd + c;
        acc(i, j, e) = (P == kWarps || g < P) && n0 + c < n_cols ? ring[o] + other[o] : 0.f;
      }
}

template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_prop_fwd(const float* __restrict__ v, const float* __restrict__ jt,
                 const float* __restrict__ ht, const float* __restrict__ ja,
                 const float* __restrict__ ha, int lv, int n_pts, const float* __restrict__ ctx,
                 const float* __restrict__ par, Mlp mlp, Split sp, Dropout dr, Stash st, int bw0,
                 int bw1, float* __restrict__ ov, int ov_rows, int ov_row0,
                 float* __restrict__ oj, float* __restrict__ oh, bool reduce, bool last_linear) {
  constexpr int kComps = 1 + 2 * D;          // rows per point with derivatives
  constexpr int kPts = tile_points<D>();     // points of the tile with derivatives
  constexpr int kRows = kComps * kPts;       // rows of the block's tile
  constexpr int kPoints = DERIV ? kPts : kRows;
  constexpr int C = DERIV ? kComps : 1;      // stash rows per point
  // the two row buffers and the weight ring; the buffers are picked by
  // select, not from an array, so that every access stays a shared-memory
  // one (an array of pointers goes to local memory and its loads become
  // generic ones)
  extern __shared__ __align__(128) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + kRows * bw0;
  Ring ring{buf1 + kRows * bw1,
            reinterpret_cast<uint64_t*>(buf1 + kRows * bw1 + kRing * kSplitTile), 0u};
  ring_init(ring.bars);

  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kPoints;
  const int p = lane_group();
  const bool live = kPts == kWarps || p < kPts;  // the lane group holds a point
  const int l0 = mlp.layer[0].k;             // J/H (and stash) row width
  const int ld0 = row_ld(lv);                // the staged local columns
  const int f1 = mlp.layer[0].n;
  const bool stash = st.a[0] != nullptr;

  // stage the local input columns: row r = comp * kPts + point (internal) or
  // point r (boundary); padding columns and rows past n_pts read 0
  for (int e = threadIdx.x; e < kRows * ld0; e += kThreads) {
    const int r = e / ld0;
    const int c = e % ld0;
    const int comp = DERIV ? r / kPts : 0;
    const int pt = pt0 + (DERIV ? r % kPts : r);
    float val = 0.f;
    if (pt < n_pts && c < lv) {
      if (comp == 0) {
        val = v[((size_t)b * n_pts + pt) * lv + c];
      } else if (comp <= D) {
        val = jt[(((size_t)b * D + comp - 1) * n_pts + pt) * l0 + c];
      } else {
        val = ht[(((size_t)b * D + comp - 1 - D) * n_pts + pt) * l0 + c];
      }
      if (stash) st.a[0][(((size_t)b * n_pts + pt) * C + comp) * l0 + c] = val;
    }
    buf0[e] = val;
  }

  int cur = 0;
  const int nl = mlp.n_layers;
  const bool no_red = MODES && !reduce;
  const int n_act = operators(nl, !no_red);
  for (int li = 0; li < n_act; ++li) {
    Layer L = mlp.layer[li];
    if (li == 0) L.k = lv;                   // the context columns follow below
    const bool lin = MODES && last_linear && li == n_act - 1;  // identity rules
    const bool last = no_red && li == nl - 1;  // outputs to ov/oj/oh
    const float* A = cur ? buf1 : buf0;
    float* out = cur ? buf0 : buf1;
    const int lda = row_ld(L.k);
    const int ldo = row_ld(L.n);
    const int n_pad = round8(L.n);
    const float* bias_row = (li == 0) ? ctx + (size_t)b * f1 : L.b;
    const float* par_row = MOD ? par + (size_t)b * L.n : nullptr;
    float* za = stash ? st.z[li] : nullptr;
    float* an = (stash && !last) ? st.a[li + 1] : nullptr;
    const LayerDrop drop = layer_drop(dr, li);
    const SplitW W = split_layer(sp, li, L.n);
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float d[64] = {};
      rows_wgmma<kRows>(d, A, lda, W, 0, L.k, n0, ring);
      if (DERIV && li == 0 && lv < l0) {
        // context columns [lv, l0) of the J/H rows (zeros in the value
        // rows), a chunk at a time through the same accumulators; the
        // first output chunk also writes them to the stash
        float* cbuf = buf0 + kRows * ld0;
        const int ldc = row_ld(kCtxChunk);
        for (int c0 = lv; c0 < l0; c0 += kCtxChunk) {
          const int kc = min(kCtxChunk, l0 - c0);
          __syncthreads();  // the last product is done with cbuf
          for (int e = threadIdx.x; e < kRows * ldc; e += kThreads) {
            const int r = e / ldc;
            const int c = e % ldc;
            const int comp = r / kPts;
            const int pt = pt0 + r % kPts;
            float val = 0.f;
            if (pt < n_pts && c < kc) {
              if (comp > 0) {
                const float* src = comp <= D ? jt : ht;
                const int d = comp <= D ? comp - 1 : comp - 1 - D;
                val = src[(((size_t)b * D + d) * n_pts + pt) * l0 + c0 + c];
              }
              if (stash && n0 == 0)
                st.a[0][(((size_t)b * n_pts + pt) * C + comp) * l0 + c0 + c] = val;
            }
            cbuf[e] = val;
          }
          rows_wgmma<kRows>(d, cbuf, ldc, W, round32(lv) + (c0 - lv), kc, n0, ring);
        }
      }
      RowAcc<kComps> acc;
      rows_dump<kComps, kPts>(acc, d, ring.tiles, n0, L.n);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + mma_col(j);       // the thread's first column (even)
        if (!live || c >= n_pad) continue;
        // dropout factors of columns c, c + 1: one Philox call per point
        float m[DERIV ? 1 : kComps][2];
#pragma unroll
        for (int i = 0; i < (DERIV ? 1 : kComps); ++i) {
          const int pt = pt0 + (DERIV ? p : i * kPts + p);
          keep2(drop, b, ov_row0 + pt, c, m[i]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = c + e;
          if (n >= L.n) {  // padding columns of the next layer's input
            if (!last) {
#pragma unroll
              for (int i = 0; i < kComps; ++i) out[(i * kPts + p) * ldo + n] = 0.f;
            }
            continue;
          }
          const float bias = bias_row[n];
          const float pm = MOD ? par_row[n] : 1.f;  // modulation after dropout
          if (DERIV) {
            const int pt = pt0 + p;
            const size_t g0 = ((size_t)b * n_pts + pt) * C;
            const bool keep_row = stash && pt < n_pts;
            const bool store = last && pt < n_pts;
            float val, d1, d2;
            const float z = acc(0, j, e) + bias;
            if (lin) {
              val = z;
              d1 = 1.f;
              d2 = 0.f;
            } else {
              act_rules<ACT>(z, val, d1, d2);
            }
            const float mk = m[0][e] * pm;
            if (!last) out[p * ldo + n] = val * mk;
            if (store) ov[((size_t)b * ov_rows + ov_row0 + pt) * L.n + n] = val * mk;
            if (keep_row) {
              za[g0 * L.n + n] = z;
              if (!last) an[g0 * L.n + n] = val * mk;
            }
#pragma unroll
            for (int d = 0; d < D; ++d) {
              float zj = acc(1 + d, j, e);
              float zh = acc(1 + D + d, j, e);
              if (li == 0 && ja != nullptr && pt < n_pts) {  // j0_add mode
                const size_t o = (((size_t)b * D + d) * n_pts + pt) * L.n + n;
                zj += ja[o];
                zh += ha[o];
              }
              const float oj_ = d1 * zj * mk;
              const float oh_ = (d2 * zj * zj + d1 * zh) * mk;
              if (!last) {
                out[((1 + d) * kPts + p) * ldo + n] = oj_;
                out[((1 + D + d) * kPts + p) * ldo + n] = oh_;
              }
              if (store) {
                oj[(((size_t)b * n_pts + pt) * L.n + n) * D + d] = oj_;
                oh[(((size_t)b * n_pts + pt) * L.n + n) * D + d] = oh_;
              }
              if (keep_row) {
                za[(g0 + 1 + d) * L.n + n] = zj;
                za[(g0 + 1 + D + d) * L.n + n] = zh;
                if (!last) {
                  an[(g0 + 1 + d) * L.n + n] = oj_;
                  an[(g0 + 1 + D + d) * L.n + n] = oh_;
                }
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < kComps; ++i) {
              const int pt = pt0 + i * kPts + p;
              const float z = acc(i, j, e) + bias;
              const float a = (lin ? z : act_value<ACT>(z)) * (m[DERIV ? 0 : i][e] * pm);
              if (!last) out[(i * kPts + p) * ldo + n] = a;
              if (pt < n_pts) {
                if (stash) {
                  za[((size_t)b * n_pts + pt) * L.n + n] = z;
                  if (!last) an[((size_t)b * n_pts + pt) * L.n + n] = a;
                }
                if (last) ov[((size_t)b * ov_rows + ov_row0 + pt) * L.n + n] = a;
              }
            }
          }
        }
      }
    }
    cur ^= 1;
  }
  if (no_red) return;

  // the last layer (linear, a few outputs) through the same product
  const Layer L = mlp.layer[nl - 1];
  const float* A = cur ? buf1 : buf0;
  const float* bias_row = (nl == 1) ? ctx + (size_t)b * f1 : L.b;
  const SplitW W = split_layer(sp, nl - 1, L.n);
  for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
    float d[64] = {};
    rows_wgmma<kRows>(d, A, row_ld(L.k), W, 0, L.k, n0, ring);
    RowAcc<kComps> acc;
    rows_dump<kComps, kPts>(acc, d, ring.tiles, n0, L.n);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n0 + mma_col(j) + e;
        if (!live || o >= L.n) continue;
#pragma unroll
        for (int i = 0; i < kComps; ++i) {
          const int comp = DERIV ? i : 0;
          const int pt = pt0 + (DERIV ? p : i * kPts + p);
          if (pt >= n_pts) continue;
          const float z = acc(i, j, e);
          if (comp == 0) {
            ov[((size_t)b * ov_rows + ov_row0 + pt) * L.n + o] = z + bias_row[o];
          } else if (comp <= D) {
            oj[(((size_t)b * n_pts + pt) * L.n + o) * D + comp - 1] = z;
          } else {
            oh[(((size_t)b * n_pts + pt) * L.n + o) * D + comp - 1 - D] = z;
          }
        }
      }
  }
}

// Reverse sweep over one 40-row tile. wt.layer[i] is W_i in nn.Linear's
// (out, in) layout read as a (k = n_i) x (n = k_i) matrix, so rows_wgmma
// computes GA_i = GZ_i W_i^T. z[i] / gz[i] are the stash and cotangent rows
// of layer i (rows as in Stash); with MOD, dps.a[i] (n_cases * n_pts x n_i)
// receives layer i's dpar addends, one row per point. dv rows hold the lv
// local columns; dja/dha (j0_add mode, else null) receive the J/H rows of
// GZ_0 as (n_cases, D, n_pts, F1).
template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_prop_bwd_rows(const float* __restrict__ gv, int ov_rows, int ov_row0,
                      const float* __restrict__ gj, const float* __restrict__ gh, int n_pts,
                      const float* __restrict__ par, Mlp wt, Split sp, Dropout dr, Stash st,
                      Stash gzs,
                      Stash dps, int bw0, int bw1, int lv, float* __restrict__ dv,
                      float* __restrict__ djt, float* __restrict__ dht,
                      float* __restrict__ dja, float* __restrict__ dha, bool reduce,
                      bool last_linear) {
  constexpr int kComps = 1 + 2 * D;
  constexpr int kPts = tile_points<D>();
  constexpr int kRows = kComps * kPts;
  constexpr int kPoints = DERIV ? kPts : kRows;
  constexpr int C = DERIV ? kComps : 1;
  // the two row buffers and the weight ring; the buffers are picked by
  // select, not from an array, so that every access stays a shared-memory
  // one (an array of pointers goes to local memory and its loads become
  // generic ones)
  extern __shared__ __align__(128) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + kRows * bw0;
  Ring ring{buf1 + kRows * bw1,
            reinterpret_cast<uint64_t*>(buf1 + kRows * bw1 + kRing * kSplitTile), 0u};
  ring_init(ring.bars);

  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kPoints;
  const int p = lane_group();
  const bool live = kPts == kWarps || p < kPts;  // the lane group holds a point
  const int nl = wt.n_layers;
  const int n_out = wt.layer[nl - 1].k;       // O, or F without a reduction
  // without a reduction the staged cotangents are GA of the last operator,
  // whose rules a first step (li = nl, no product) applies
  const bool no_red = MODES && !reduce;
  const int n_act = operators(nl, !no_red);

  // stage the output cotangents (GZ of the linear last layer)
  {
    const int ld = row_ld(n_out);
    float* gzl = gzs.a[nl - 1];
    for (int e = threadIdx.x; e < kRows * ld; e += kThreads) {
      const int r = e / ld;
      const int c = e % ld;
      const int comp = DERIV ? r / kPts : 0;
      const int pt = pt0 + (DERIV ? r % kPts : r);
      float val = 0.f;
      if (pt < n_pts && c < n_out) {
        if (comp == 0) {
          val = gv[((size_t)b * ov_rows + ov_row0 + pt) * n_out + c];
        } else if (comp <= D) {
          val = gj[(((size_t)b * n_pts + pt) * n_out + c) * D + comp - 1];
        } else {
          val = gh[(((size_t)b * n_pts + pt) * n_out + c) * D + comp - 1 - D];
        }
        if (!no_red) gzl[(((size_t)b * n_pts + pt) * C + comp) * n_out + c] = val;
      }
      buf0[e] = val;
    }
  }

  int cur = 0;
  for (int li = no_red ? nl : nl - 1; li >= 0; --li) {
    const bool pre = no_red && li == nl;       // GA_nl is the staged rows
    // k = n_li (GZ width), n = k_li
    const Layer L = pre ? Layer{nullptr, nullptr, n_out, n_out, n_out} : wt.layer[li];
    const float* A = cur ? buf1 : buf0;
    float* out = cur ? buf0 : buf1;
    const int lda = row_ld(L.k);
    const int ldo = row_ld(L.n);
    const int n_pad = round8(L.n);
    const int lz = li - 1;                     // layer whose rules GA_li meets
    const float* z = li > 0 ? st.z[lz] : nullptr;
    float* gz = li > 0 ? gzs.a[lz] : nullptr;
    const float* par_row = MOD ? par + (size_t)b * L.n : nullptr;
    float* dpr = (MOD && li > 0) ? dps.a[lz] : nullptr;
    const LayerDrop drop = layer_drop(dr, li > 0 ? lz : 0);
    const bool lin = MODES && last_linear && lz == n_act - 1;  // identity rules
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      RowAcc<kComps> acc;
      if (pre) {
        __syncthreads();  // the staged rows are complete
#pragma unroll
        for (int i = 0; i < kComps; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + mma_col(j) + e;
              acc(i, j, e) = live && n < L.n ? A[(i * kPts + p) * lda + n] : 0.f;
            }
      } else {
        float d[64] = {};
        rows_wgmma<kRows>(d, A, lda, split_layer(sp, li, L.n), 0, L.k, n0, ring);
        rows_dump<kComps, kPts>(acc, d, ring.tiles, n0, L.n);
      }
      if (li == 0) {  // input cotangents: dv, djt, dht
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + mma_col(j) + e;
            if (!live || n >= L.n) continue;
#pragma unroll
            for (int i = 0; i < kComps; ++i) {
              const int comp = DERIV ? i : 0;
              const int pt = pt0 + (DERIV ? p : i * kPts + p);
              if (pt >= n_pts) continue;
              if (comp == 0) {
                if (n < lv) dv[((size_t)b * n_pts + pt) * lv + n] = acc(i, j, e);
              } else if (comp <= D) {
                djt[(((size_t)b * D + comp - 1) * n_pts + pt) * L.n + n] = acc(i, j, e);
              } else {
                dht[(((size_t)b * D + comp - 1 - D) * n_pts + pt) * L.n + n] = acc(i, j, e);
              }
            }
          }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + mma_col(j);
        if (!live || c >= n_pad) continue;
        float m[DERIV ? 1 : kComps][2];
#pragma unroll
        for (int i = 0; i < (DERIV ? 1 : kComps); ++i) {
          const int pt = pt0 + (DERIV ? p : i * kPts + p);
          keep2(drop, b, ov_row0 + pt, c, m[i]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = c + e;
          if (n >= L.n) {
#pragma unroll
            for (int i = 0; i < kComps; ++i) out[(i * kPts + p) * ldo + n] = 0.f;
            continue;
          }
          const float pm = MOD ? par_row[n] : 1.f;
          if (DERIV) {
            const int pt = pt0 + p;
            if (pt >= n_pts) {
#pragma unroll
              for (int i = 0; i < kComps; ++i) out[(i * kPts + p) * ldo + n] = 0.f;
              continue;
            }
            const size_t g0 = ((size_t)b * n_pts + pt) * C;
            const float mk = m[0][e];
            const float mke = mk * pm;
            const float zv = z[g0 * L.n + n];
            float d1, d2, d3;
            if (lin) {
              d1 = 1.f;
              d2 = 0.f;
              d3 = 0.f;
            } else {
              act_rules3<ACT>(zv, d1, d2, d3);
            }
            float gzv = acc(0, j, e) * mke * d1;
            // dpar addend: GA against the pre-modulation (v, J, H) of the point
            float dp = MOD ? acc(0, j, e) * (lin ? zv : act_value<ACT>(zv)) : 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float zj = z[(g0 + 1 + d) * L.n + n];
              const float zh = z[(g0 + 1 + D + d) * L.n + n];
              const float gad = acc(1 + d, j, e);
              const float gah = acc(1 + D + d, j, e);
              if (MOD) dp += gad * (d1 * zj) + gah * (d2 * zj * zj + d1 * zh);
              const float gjd = gad * mke;
              const float ghd = gah * mke;
              gzv += gjd * zj * d2 + ghd * (zj * zj * d3 + zh * d2);
              const float gzj = gjd * d1 + 2.f * ghd * zj * d2;
              const float gzh = ghd * d1;
              out[((1 + d) * kPts + p) * ldo + n] = gzj;
              out[((1 + D + d) * kPts + p) * ldo + n] = gzh;
              gz[(g0 + 1 + d) * L.n + n] = gzj;
              gz[(g0 + 1 + D + d) * L.n + n] = gzh;
              if (lz == 0 && dja != nullptr) {  // j0_add mode: GZ_0's J/H rows
                const size_t o = (((size_t)b * D + d) * n_pts + pt) * L.n + n;
                dja[o] = gzj;
                dha[o] = gzh;
              }
            }
            out[p * ldo + n] = gzv;
            gz[g0 * L.n + n] = gzv;
            if (MOD) dpr[((size_t)b * n_pts + pt) * L.n + n] = dp * mk;
          } else {
#pragma unroll
            for (int i = 0; i < kComps; ++i) {
              const int pt = pt0 + i * kPts + p;
              float g = 0.f;
              if (pt < n_pts) {
                const size_t g0 = (size_t)b * n_pts + pt;
                const float zv = z[g0 * L.n + n];
                const float mi = m[DERIV ? 0 : i][e];
                g = acc(i, j, e) * (mi * pm) * (lin ? 1.f : act_d1<ACT>(zv));
                gz[g0 * L.n + n] = g;
                if (MOD) dpr[g0 * L.n + n] = acc(i, j, e) * (lin ? zv : act_value<ACT>(zv)) * mi;
              }
              out[(i * kPts + p) * ldo + n] = g;
            }
          }
        }
      }
    }
    cur ^= 1;
  }
}

struct PropArgs {
  int n_cases, n_pts, ov_rows, ov_row0;
  const float* par;                            // (n_cases, F) with MOD, else null
  Mlp mlp;
  Dropout dr;
  Stash st;
  int lv;                                      // local (value-row) input width
  const float* ja;                             // j0_add mode's addends, else null
  const float* ha;
  float* dja;                                  // and their cotangents
  float* dha;
  bool reduce;                                 // the trunk's modes (MOD only)
  bool last_linear;
  float* wsplit;                               // the split weights (split_weights)
};

// Row-buffer strides of a forward launch (layer i reads buffer i % 2; in
// the context-column mode buffer 0 also holds the context staging tile
// beside the local columns) and its shared bytes.
inline size_t fwd_smem(const Mlp& m, int lv, int n_rows, int* bw) {
  bw[0] = bw[1] = 0;
  for (int i = 0; i < m.n_layers; ++i)
    bw[i & 1] = std::max(bw[i & 1], row_ld(i == 0 ? lv : m.layer[i].k));
  if (lv < m.layer[0].k) bw[0] = std::max(bw[0], row_ld(lv) + row_ld(kCtxChunk));
  return sizeof(float) * ((size_t)n_rows * (bw[0] + bw[1]) + kRingFloats);
}

// The same for a backward launch: step li reads buffer (top - li) & 1:
// buffer 0 holds the staged rows and the GZ of layers top-2, top-4, ...;
// buffer 1 the others (top = nl - 1, or nl for the first, product-less
// step of the no-reduction mode).
inline size_t bwd_smem(const Mlp& wt, bool reduce, int n_rows, int* bw) {
  bw[0] = bw[1] = 0;
  const int nl = wt.n_layers;
  const int top = reduce ? nl - 1 : nl;
  const int n_out = wt.layer[nl - 1].k;
  for (int li = top; li >= 0; --li) {
    const int in_buf = (top - li) & 1;
    bw[in_buf] = std::max(bw[in_buf], row_ld(li == nl ? n_out : wt.layer[li].k));
    if (li > 0)
      bw[in_buf ^ 1] = std::max(bw[in_buf ^ 1], row_ld(li == nl ? n_out : wt.layer[li].n));
  }
  return sizeof(float) * ((size_t)n_rows * (bw[0] + bw[1]) + kRingFloats);
}

template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
int launch_prop_fwd(const float* v, const float* jt, const float* ht, const float* ctx,
                    const PropArgs& a, float* ov, float* oj, float* oh, cudaStream_t s) {
  constexpr int kRows = tile_rows<D>();
  constexpr int kPoints = DERIV ? tile_points<D>() : kRows;
  int bw[2];
  const size_t smem = fwd_smem(a.mlp, a.lv, kRows, bw);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  Split sp;
  make_split(a.mlp, a.lv, a.wsplit, &sp);
  const cudaError_t err = launch_split(a.mlp, sp, a.lv, a.wsplit, s);
  if (err != cudaSuccess) return (int)err;
  auto kernel = mlp_prop_fwd<D, ACT, DERIV, MOD, MODES>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((a.n_pts + kPoints - 1) / kPoints, a.n_cases);
  kernel<<<grid, kThreads, smem, s>>>(v, jt, ht, a.ja, a.ha, a.lv, a.n_pts, ctx, a.par, a.mlp, sp,
                                      a.dr, a.st, bw[0], bw[1], ov, a.ov_rows, a.ov_row0, oj,
                                      oh, a.reduce, a.last_linear);
  return (int)cudaGetLastError();
}

template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
int launch_prop_bwd(const float* gv, const float* gj, const float* gh, const PropArgs& a,
                    const Mlp& wt, const Stash& gzs, const Stash& dps, float* dv, float* djt,
                    float* dht, cudaStream_t s) {
  constexpr int kRows = tile_rows<D>();
  constexpr int kPoints = DERIV ? tile_points<D>() : kRows;
  int bw[2];
  const size_t smem = bwd_smem(wt, a.reduce, kRows, bw);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  Split sp;
  make_split(wt, wt.layer[0].k, a.wsplit, &sp);
  const cudaError_t err = launch_split(wt, sp, wt.layer[0].k, a.wsplit, s);
  if (err != cudaSuccess) return (int)err;
  auto kernel = mlp_prop_bwd_rows<D, ACT, DERIV, MOD, MODES>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((a.n_pts + kPoints - 1) / kPoints, a.n_cases);
  kernel<<<grid, kThreads, smem, s>>>(gv, a.ov_rows, a.ov_row0, gj, gh, a.n_pts, a.par, wt, sp, a.dr,
                                      a.st, gzs, dps, bw[0], bw[1], a.lv, dv, djt, dht, a.dja,
                                      a.dha, a.reduce, a.last_linear);
  return (int)cudaGetLastError();
}

#define PCT_PROP_DISPATCH(FN, MOD, MODES, ...)                               \
  switch (d_dims * 4 + act * 2 + (deriv ? 1 : 0)) {                          \
    case 4: return FN<1, kSilu, false, MOD, MODES>(__VA_ARGS__);             \
    case 5: return FN<1, kSilu, true, MOD, MODES>(__VA_ARGS__);              \
    case 6: return FN<1, kTanh, false, MOD, MODES>(__VA_ARGS__);             \
    case 7: return FN<1, kTanh, true, MOD, MODES>(__VA_ARGS__);              \
    case 8: return FN<2, kSilu, false, MOD, MODES>(__VA_ARGS__);             \
    case 9: return FN<2, kSilu, true, MOD, MODES>(__VA_ARGS__);              \
    case 10: return FN<2, kTanh, false, MOD, MODES>(__VA_ARGS__);            \
    case 11: return FN<2, kTanh, true, MOD, MODES>(__VA_ARGS__);             \
    case 12: return FN<3, kSilu, false, MOD, MODES>(__VA_ARGS__);            \
    case 13: return FN<3, kSilu, true, MOD, MODES>(__VA_ARGS__);             \
    case 14: return FN<3, kTanh, false, MOD, MODES>(__VA_ARGS__);            \
    case 15: return FN<3, kTanh, true, MOD, MODES>(__VA_ARGS__);             \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// lv < widths[0] (context columns) and the j0_add addends are layer-0 modes
// of a launch with derivatives through an activated layer 0 and a
// reduction; the trunk's modes (no reduction, a linear last operator) are
// MOD's alone and need an operator
template <bool MOD>
inline bool prop_valid(int d_dims, int act, int n_layers, int n_cases, int n_pts,
                       const int* widths, bool deriv, int lv, bool j0_add, bool reduce,
                       bool last_linear) {
  const bool coupled = lv < widths[0] || j0_add;
  return d_dims >= 1 && d_dims <= 3 && (act == kSilu || act == kTanh) && n_layers >= 1 &&
         n_layers <= kMaxLayers && n_cases >= 1 && n_pts >= 1 && lv >= 1 &&
         lv <= widths[0] && (MOD || (reduce && !last_linear)) &&
         (!last_linear || operators(n_layers, reduce) >= 1) &&
         (!coupled || (deriv && n_layers >= 2 && reduce && !last_linear));
}

// stash pointers of one launch: a[i] for every layer, then z[i] for the
// first n_act (the operators), each a (rows x width) block of one buffer
inline Stash make_stash(float* a_base, float* z_base, size_t rows, int n_layers, int n_act,
                        const int* widths) {
  Stash st{};
  size_t oa = 0, oz = 0;
  for (int i = 0; i < n_layers; ++i) {
    st.a[i] = a_base ? a_base + oa : nullptr;
    oa += rows * widths[i];
    if (i < n_act) {
      st.z[i] = z_base ? z_base + oz : nullptr;
      oz += rows * widths[i + 1];
    }
  }
  return st;
}

// layer i's nn.Linear weight (widths[i+1] x ldw[i], row-major) read as a
// (k = widths[i+1]) x (n = widths[i]) matrix: the backward's operand W_i^T
inline Mlp transposed_mlp(int n_layers, const float* const* w_orig, const int* ldw,
                          const int* widths) {
  Mlp wt{};
  wt.n_layers = n_layers;
  for (int i = 0; i < n_layers && i < kMaxLayers; ++i) {
    wt.layer[i].w = w_orig ? w_orig[i] : nullptr;
    wt.layer[i].b = nullptr;
    wt.layer[i].k = widths[i + 1];
    wt.layer[i].n = widths[i];
    wt.layer[i].ldw = ldw ? ldw[i] : widths[i];
  }
  return wt;
}

// Scratch floats prop_forward needs for the split weights of one launch
// (layer 0 reads lv local rows, then context rows up to widths[0]).
inline long long prop_forward_workspace(int n_layers, const int* widths, int lv) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  Split sp;
  return make_split(make_mlp(n_layers, nullptr, nullptr, widths), lv, nullptr, &sp);
}

// Forward of one launch (see the extern "C" entry points for the arguments).
template <bool MOD>
int prop_forward(int d_dims, int act, bool deriv, const float* v, const float* jt,
                 const float* ht, int n_cases, int n_pts, const float* ctx, const float* par,
                 int n_layers, const float* const* w, const float* const* b, const int* widths,
                 float* ov, int ov_rows, int ov_row0, float* oj, float* oh, const Dropout& dr,
                 float* stash_a, float* stash_z, int lv, const float* ja, const float* ha,
                 float* wsplit, long long wsplit_floats, cudaStream_t s, bool reduce = true,
                 bool last_linear = false) {
  if (!prop_valid<MOD>(d_dims, act, n_layers, n_cases, n_pts, widths, deriv, lv, ja != nullptr,
                       reduce, last_linear) ||
      (ja == nullptr) != (ha == nullptr) ||
      prop_forward_workspace(n_layers, widths, lv) > wsplit_floats)
    return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)n_cases * n_pts * (deriv ? 1 + 2 * d_dims : 1);
  PropArgs a{n_cases, n_pts, ov_rows, ov_row0, par, make_mlp(n_layers, w, b, widths), dr,
             make_stash(stash_a, stash_z, rows, n_layers, operators(n_layers, reduce), widths),
             lv, ja, ha, nullptr, nullptr, reduce, last_linear, wsplit};
  if constexpr (MOD) {
    if (!reduce || last_linear) {
      PCT_PROP_DISPATCH(launch_prop_fwd, MOD, true, v, jt, ht, ctx, a, ov, oj, oh, s)
    }
  }
  PCT_PROP_DISPATCH(launch_prop_fwd, MOD, false, v, jt, ht, ctx, a, ov, oj, oh, s)
}

// Scratch floats prop_backward needs for one launch of `rows` stash rows:
// the split weights during the row sweep, then the weight gradients'
// partials and the column sums.
inline long long prop_backward_workspace(int n_cases, long long rows, int n_layers,
                                         const int* widths) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  Split sp;
  size_t need = (size_t)make_split(transposed_mlp(n_layers, nullptr, nullptr, widths),
                                   widths[1], nullptr, &sp);
  for (int i = 0; i < n_layers; ++i) {
    need = std::max(need, grad_scratch_floats((int)rows, widths[i], widths[i + 1]));
    need = std::max(need, (size_t)n_cases * widths[i + 1]);
  }
  return (long long)need;
}

// Backward of one prop_forward launch (see the extern "C" entry points).
// With MOD, dpar_rows (n_cases * n_pts x sum of the n_act operators' output
// widths) receives the per-point dpar addends, layer after layer, and dpar
// (n_cases, F) gets their per-case column sums ADDED, layer by layer.
template <bool MOD>
int prop_backward(int d_dims, int act, bool deriv, const float* gv, int ov_rows, int ov_row0,
                  const float* gj, const float* gh, int n_cases, int n_pts, int n_layers,
                  const float* const* w_orig, const int* ldw, const int* widths,
                  const Dropout& dr, const float* par, const float* stash_a,
                  const float* stash_z, float* gz_stash, float* dpar_rows, float* dv,
                  float* djt, float* dht, float* const* dw, float* const* db, float* dctx,
                  float* dpar, float* scratch, long long scratch_floats, int lv, float* dja,
                  float* dha, cudaStream_t s, bool reduce = true, bool last_linear = false) {
  if (!prop_valid<MOD>(d_dims, act, n_layers, n_cases, n_pts, widths, deriv, lv,
                       dja != nullptr, reduce, last_linear) ||
      (dja == nullptr) != (dha == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_act = operators(n_layers, reduce);
  const int C = deriv ? 1 + 2 * d_dims : 1;
  const size_t rows = (size_t)n_cases * n_pts * C;
  if (prop_backward_workspace(n_cases, (long long)rows, n_layers, widths) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  const Mlp wt = transposed_mlp(n_layers, w_orig, ldw, widths);
  PropArgs a{n_cases, n_pts, ov_rows, ov_row0, par, Mlp{}, dr,
             make_stash(const_cast<float*>(stash_a), const_cast<float*>(stash_z), rows,
                        n_layers, n_act, widths),
             lv, nullptr, nullptr, dja, dha, reduce, last_linear, scratch};
  // gz[i] (rows x widths[i+1]) and dpar addends (points x widths[i+1]),
  // layer after layer, in the a[] slots
  Stash gzs{}, dps{};
  size_t off = 0, off_p = 0;
  for (int i = 0; i < n_layers; ++i) {
    gzs.a[i] = gz_stash + off;
    off += rows * widths[i + 1];
    if (MOD && i < n_act) {
      dps.a[i] = dpar_rows + off_p;
      off_p += (size_t)n_cases * n_pts * widths[i + 1];
    }
  }
  int err;
  {
    auto run = [&]() -> int {
      if constexpr (MOD) {
        if (!reduce || last_linear) {
          PCT_PROP_DISPATCH(launch_prop_bwd, MOD, true, gv, gj, gh, a, wt, gzs, dps, dv, djt,
                            dht, s)
        }
      }
      PCT_PROP_DISPATCH(launch_prop_bwd, MOD, false, gv, gj, gh, a, wt, gzs, dps, dv, djt, dht,
                        s)
    };
    err = run();
  }
  if (err) return err;
  for (int i = 0; i < n_layers; ++i) {
    cudaError_t e = weight_grad<-1>(a.st.a[i], widths[i], gzs.a[i], widths[i + 1], (int)rows,
                                    widths[i], widths[i + 1], scratch, dw[i], s);
    if (e != cudaSuccess) return (int)e;
    const int n = widths[i + 1];
    float* target = i == 0 ? dctx : scratch;
    group_colsum<<<dim3((n + 31) / 32, n_cases), dim3(32, 8), 0, s>>>(
        gzs.a[i], n, C, n_pts, n_cases * n_pts, n, target, i == 0 ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (i > 0) {
      sum_partials<<<(n + 255) / 256, 256, 0, s>>>(scratch, n_cases, n, db[i]);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    if (MOD && i < n_act) {
      group_colsum<<<dim3((n + 31) / 32, n_cases), dim3(32, 8), 0, s>>>(
          dps.a[i], n, 1, n_pts, n_cases * n_pts, n, dpar, 1);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

// Blocks per SM and shared bytes of the default mode's row kernels (silu,
// with derivatives; the internal launch) at D and these widths, and of
// weight_grad's widest tile: out = {fwd blocks, fwd bytes, bwd blocks, bwd
// bytes, weight_grad blocks, weight_grad bytes}. A launch whose bytes pass
// the card's limit reads 0 blocks.
template <int D, bool MOD>
int prop_occupancy_d(int n_layers, const int* widths, int lv, bool reduce, int* out) {
  const Mlp m = make_mlp(n_layers, nullptr, nullptr, widths);
  const Mlp wt = transposed_mlp(n_layers, nullptr, nullptr, widths);
  constexpr int kRows = tile_rows<D>();
  int bw[2];
  const size_t fb = fwd_smem(m, lv, kRows, bw);
  const size_t bb = bwd_smem(wt, reduce, kRows, bw);
  const size_t limit = (size_t)max_shared_bytes();
  auto fk = mlp_prop_fwd<D, kSilu, true, MOD, false>;
  auto bk = mlp_prop_bwd_rows<D, kSilu, true, MOD, false>;
  out[0] = out[2] = 0;
  if (fb <= limit) {
    cudaFuncSetAttribute(fk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fb);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fk, kThreads, fb);
  }
  if (bb <= limit) {
    cudaFuncSetAttribute(bk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bb);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], bk, kThreads, bb);
  }
  out[1] = (int)fb;
  out[3] = (int)bb;
  out[4] = weight_grad_blocks_per_sm();
  out[5] = (int)grad_smem_bytes<128, 128>();
  return (int)cudaGetLastError();
}

template <bool MOD>
int prop_occupancy(int d_dims, int n_layers, const int* widths, int lv, bool reduce, int* out) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  switch (d_dims) {
    case 1: return prop_occupancy_d<1, MOD>(n_layers, widths, lv, reduce, out);
    case 2: return prop_occupancy_d<2, MOD>(n_layers, widths, lv, reduce, out);
    case 3: return prop_occupancy_d<3, MOD>(n_layers, widths, lv, reduce, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace pct
