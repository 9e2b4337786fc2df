// sa_neighborhood: one SetAbstraction radius level, the masked max over each
// centroid's K neighbours of an MLP (every layer activated) on the
// neighbour's row, its argmax (the first maximal valid neighbour), and the
// backward of that max.
//
// Replaces the TPU kernels porous_cfd_tpu/ops/sa_pallas.py:_fwd_kernel
// (pallas_call at :215 through _build, the dynamic variant, and at :284
// through _build_static, the static one) and :_bwd_kernel (pallas_call at
// :235 and :304).
//
// The first layer's input row of neighbour j of centroid c is
//   static:  [xg_j || rel_j] W0 + b0   (xg: level 0's input rows gathered
//            once per dataset, data without a gradient);
//   dynamic: P[idx_j] + rel_j W0r      (P = x W0x + b0 computed densely
//            outside; its gradient dP goes back to P's rows).
// rel = (pos_j - pos_c) / r comes precomputed. Masked-out neighbours never
// win; a centroid with none gives 0, argmax -1 and no gradient.
//
// What bounds them on an H100. The forward: operations, and the epilogues
// beside them. PIPN++'s level 0 (13 x 500 centroids x 64 neighbours, 8 -> 64
// -> 64) does 3.8 GFLOP and level 1 (13 x 125 x 64, P 128 wide, 128 -> 128)
// 3.5 GFLOP: 0.044 ms together at f32 accuracy on the tensor cores
// (3xTF32, common.cuh), while each of their 80 M activations costs about a
// dozen instructions on the CUDA cores. The backward: the pooled cotangent
// reaches one row per (centroid, channel), and only 29-97% of those are
// distinct rows, so its work is that of the winners, 0.6-0.7 GFLOP, a few
// microseconds at the card's rates: latency and launches bound it.
//
// Forward design (sa_fwd_split, sa_fwd_tiles: two launches). A tile is 64
// neighbour rows, one warpgroup's wgmma M: 64 / Kp centroids, Kp = K rounded
// up to a power of two (rows k >= K of a centroid are padding that never
// wins). A block of two warpgroups walks pairs of tiles (persistent: one or
// two blocks an SM). The layers run on the tensor cores in 3xTF32 (tc.cuh:
// weights split once per launch into TF32 big and small parts laid out as
// K-major tiles; wgmma with A from registers), in chunks of NC columns, NC in
// {64, 128, 176} chosen to fit the widths (176 = 128 + 32 + 16 as three
// products of one chunk), so that 64- and 176-wide layers are not padded to
// 128s. Where the level's split weights fit in shared memory (PIPN++'s two
// levels, 48 and 128 KB) a block loads them once by bulk copy (the TMA) and
// keeps them, and each warpgroup walks its own tiles at its own pace (named
// barriers); where they do not (PI-GANO++'s 176 -> 176 level) they stream
// through a ring of bulk-copied tiles that both warpgroups take in step.
// The dynamic level's depth-2 first layer is not a product: act(P[idx] +
// rel W0r) goes straight into the next layer's rows on the CUDA cores, 16
// bytes of P a load. A hidden layer's epilogue applies bias and the fast
// branch-free activation in registers and writes the next layer's A rows
// once. The last layer is never stored: its epilogue packs (activated
// value, k) into a key whose unsigned order is the pooling's (a larger
// value, then a lower k), takes the max over each neighbourhood by shuffles
// across the lanes that share a column and, for Kp of 32 and 64, across
// warps in shared memory, and writes the max and its k.
//
// Backward design (sa_bwd_prep, sa_bwd_tiles, sa_bwd_dwl, sum_layer_parts
// and, dynamic, sa_bwd_dp: 4 launches static, 5 dynamic, and a
// weight_grad_partial for each layer between the first and the last of a
// deeper stack). Only the winner rows are touched; nothing depends on the
// schedule (no atomics anywhere; two runs give the same bits); nothing waits
// on the host. Every compact buffer has B x C x min(K, F) rows, sized from
// the shapes, and is read only below the count the card found.
//  1. sa_bwd_prep, a block per case: each centroid's winning k as a 64-bit
//     mask of its argmax row, popcounts and a block scan give each winner row
//     its compact slot, in (centroid, k) order; the dynamic variant then
//     groups the case's slots by source row for dP (a counting sort: per-warp
//     counts by __match_any_sync, scanned; in passes over as many source
//     rows as shared memory holds counts for, one pass at the paths' 500).
//     Other blocks transpose the hidden layers' weights for the products.
//  2. sa_bwd_tiles, persistent blocks over 64 compact rows, a warp a row and
//     its lanes the columns: the first layer at the rows on the CUDA cores
//     (2 or 8 deep on the paths: a product would pad it), the hidden layers
//     of a deeper stack in 3xTF32 mma.sync (tc.cuh's block_mma16; its own
//     instantiation, so that two-layer stacks keep few registers and three
//     blocks an SM). Then the last layer at its winners only: each row's
//     channels from a ballot over its centroid's argmax row, the (row,
//     channel) pairs listed in that order, z = a . W[c, :] + b[c] at each
//     pair (eight lanes a pair) and gz = dout act'(z), da[row] = the sum of
//     gz W[c, :] over the row's pairs in channel order. GZ of the top hidden
//     layer = da act'(Z), layer 0's Z recomputed rather than stored; the
//     reverse sweep below it is block_mma16 on W_i as stored. Layer 0's dW
//     (and static db) and every hidden layer's db are summed per block over
//     its tiles, rows in order. The activations here use the fast
//     exponential and division too.
//  3. sa_bwd_dwl: the last layer's dW and db over its winners, a block a
//     (channel, run of centroids), the centroids in order. A deeper stack's
//     middle layers contract their dW over the compact rows in common.cuh's
//     3xTF32 weight_grad_partial, the count read on the card.
//  4. sum_layer_parts adds every partial (tile blocks, runs, chunks) in a
//     fixed order, and, dynamic, sa_bwd_dp sums each source row's winner
//     rows' layer-0 GZ in slot order from the prep's runs.
//
// Limits. K <= 64 and at most 8 layers. Source rows, centroids and cases
// are limited only by B x C x K < 2^31 (the compaction keeps its winner
// masks in device memory where shared memory does not hold them). The
// widths are limited by shared memory: the forward holds both warpgroups'
// 64-row tiles of a layer's input rows, alternate layers in two buffers (a
// hidden width to 360 in a two-layer stack, to 184 in a deeper one); the
// backward takes a last layer of at most 1024 channels
// (a pair packs its channel in 10 bits) on at most 256 inputs (kMaxCols
// registers a lane), and its 64-row tile of the widths must fit. Past a
// limit, sa_forward_workspace or sa_backward_workspace returns -1 and the
// wrapper raises before any launch. The paths' widths (64 to 176) and
// PIPN++ MRG's levels (to 256 channels on 128 inputs) fit.
#include "tc.cuh"

using namespace pct;

// (in pct's anonymous namespace, as tc.cuh's kernels: a second one at
// global scope makes nvcc's generated launch stubs ambiguous)
namespace pct {
namespace {

constexpr int kRows = 64;          // a warpgroup's tile: wgmma's M
constexpr int kMaxNeighbors = 64;  // a centroid's winners are a 64-bit mask
constexpr int kBwdRows = 64;       // compact rows of a backward tile
constexpr int kPairCap = 1024;     // (row, channel) pairs of a backward round
constexpr int kMaxCols = 8;        // the last layer's inputs: <= 32 * kMaxCols
constexpr int kPrepThreads = 1024;

// ---------------------------------------------------------------------------
// Narrow warpgroup products (m64n32k8, m64n16k8, m64n8k8; TF32, A from
// registers), beside tc.cuh's m64n128k8 and m64n64k8

__device__ __forceinline__ void wgmma_tf32_n32(float* d, const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32_n16(float* d, const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32_n8(float* d, const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x N of the warpgroup, N a multiple of 8) += a b as products of 128,
// 64, 32, 16 and 8 columns: their accumulators follow one another as one
// m64nN's would, and the piece at column o reads B o x 128 bytes on (a split
// tile's groups of 8 columns are 1024 bytes apart; the descriptor counts 16)
template <int N>
__device__ __forceinline__ void wgmma_cols(float* d, const unsigned (&a)[4], uint64_t b) {
  if constexpr (N >= 128) {
    wgmma_tf32(*reinterpret_cast<float(*)[64]>(d), a, b);
    if constexpr (N > 128) wgmma_cols<N - 128>(d + 64, a, b + 128 * 8);
  } else if constexpr (N >= 64) {
    wgmma_tf32_n64(*reinterpret_cast<float(*)[32]>(d), a, b);
    if constexpr (N > 64) wgmma_cols<N - 64>(d + 32, a, b + 64 * 8);
  } else if constexpr (N >= 32) {
    wgmma_tf32_n32(d, a, b);
    if constexpr (N > 32) wgmma_cols<N - 32>(d + 16, a, b + 32 * 8);
  } else if constexpr (N >= 16) {
    wgmma_tf32_n16(d, a, b);
    if constexpr (N > 16) wgmma_cols<N - 16>(d + 8, a, b + 16 * 8);
  } else {
    static_assert(N == 8, "a chunk is a multiple of 8 columns");
    wgmma_tf32_n8(d, a, b);
  }
}

// ---------------------------------------------------------------------------
// Forward

// One launch's level. Tensor-core layer li (static: every layer; dynamic:
// from 1) has its split tiles from tile toff[li] on (tiles of 2 x 32 x NC
// floats: chunk c's k-tile t is tile toff + c * kt + t).
struct SaFwd {
  int n_cent, k, kp_log2, per_tile, tiles_per_case, n_tiles;
  int stat, f_in, d, n_src, n_layers;
  const float* xg;             // static: (B, C * K, f_in)
  const float* rel;            // (B, C * K, d)
  const unsigned char* mask;   // (B, C, K)
  const float* p;              // dynamic: (B, n_src, F1)
  const long long* idx;        // dynamic: (B, C, K)
  const float* w0r;            // dynamic: W0r[j][n] = w0r[n * (f_in + d) + j]
  const float* bias[kMaxLayers];
  int width[kMaxLayers + 1];   // width[0]: static f_in + d, dynamic d
  const float* split;
  int toff[kMaxLayers], kt[kMaxLayers];
};

// The split weights in shared memory: every tile of a step resident (slots
// == n_sched: loaded once, never waited on again), or a ring of `slots`
// tiles refilled as they are consumed. seq counts the tiles a block has
// taken; tile j of its life is schedule entry j % n_sched.
struct SaRing {
  float* tiles;
  uint64_t* bars;
  const int* sched;
  const float* base;
  int n_sched, slots;
  unsigned seq, total;  // total: the tiles the block takes in all
};

// the neighbour row (b * C + c) * K + kk that row r of a tile holds, or -1
__device__ __forceinline__ int tile_nbr(const SaFwd& s, int b, int c0, int r) {
  const int g = r >> s.kp_log2;
  const int kk = r & ((1 << s.kp_log2) - 1);
  const int c = c0 + g;
  if (g >= s.per_tile || c >= s.n_cent || kk >= s.k) return -1;
  return (b * s.n_cent + c) * s.k + kk;
}

// A barrier of the whole block (the warpgroups share a ring of weight
// tiles) or of this thread's warpgroup alone (resident weights: each
// warpgroup walks its own tiles at its own pace)
__device__ __forceinline__ void step_sync(bool whole_block) {
  if (whole_block) __syncthreads();
  else asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)(threadIdx.x >> 7)) : "memory");
}

// d += the 64 A rows of this thread's warpgroup x W[0 .. k, the chunk] in
// 3xTF32, every 8-deep step of every 32-deep tile (steps past the layer's
// depth multiply zeros: a branch around the products costs more). With a
// ring both warpgroups take each tile together and every thread of the
// block calls it; it starts with a barrier (A is complete).
template <int NC>
__device__ __forceinline__ void sa_tile_wgmma(float (&d)[NC / 2], const float* A, int lda, int k,
                                              SaRing& ring) {
  constexpr int kTile = 2 * kChunkK * NC;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const int r0 = ((warp & 3) << 4) + g;
  const int n_tiles = (k + kChunkK - 1) / kChunkK;
  const int k_end = round8(k);
  const float* aw = A + (size_t)wg * kRows * lda;
  const bool resident = ring.slots == ring.n_sched;
  step_sync(!resident);  // A is complete
  for (int tt = 0; tt < n_tiles; ++tt) {
    const unsigned j = ring.seq + tt;
    const int sl = (int)(j % (unsigned)ring.slots);
    float* slot = ring.tiles + (size_t)sl * kTile;
    ring_wait(ring.bars + sl, resident ? 0u : (j / (unsigned)ring.slots) & 1u);
    const uint64_t d_big = tile_desc(slot);
    const uint64_t d_small = tile_desc(slot + kChunkK * NC);
    const float* a0 = aw + r0 * lda + tt * kChunkK + t;
    const float* a1 = a0 + 8 * lda;
    const int kk_end = min(kChunkK, k_end - tt * kChunkK);
    unsigned ab[4][4], as[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const bool in = 8 * st < kk_end;
      split_tf32(in ? a0[8 * st] : 0.f, ab[st][0], as[st][0]);
      split_tf32(in ? a1[8 * st] : 0.f, ab[st][1], as[st][1]);
      split_tf32(in ? a0[8 * st + 4] : 0.f, ab[st][2], as[st][2]);
      split_tf32(in ? a1[8 * st + 4] : 0.f, ab[st][3], as[st][3]);
    }
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      wgmma_cols<NC>(d, ab[st], d_small + 16 * st);
      wgmma_cols<NC>(d, as[st], d_big + 16 * st);
      wgmma_cols<NC>(d, ab[st], d_big + 16 * st);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    if (!resident) {
      __syncthreads();  // everyone is done with the slot: refill it
      if (threadIdx.x == 0 && j + ring.slots < ring.total)
        ring_load(slot,
                  ring.base + (size_t)ring.sched[(j + ring.slots) % ring.n_sched] * kTile,
                  ring.bars + sl, kTile * 4);
    }
  }
  ring.seq += n_tiles;
}

// The dynamic first layer at this thread's accumulator positions (rows r0,
// r0 + 8 of its warpgroup's tile; the chunk's columns from n0): P[idx] +
// rel W0r on the CUDA cores, 0 on rows that hold no neighbour.
template <int NC>
__device__ __forceinline__ void gather_layer(float (&d)[NC / 2], const SaFwd& s, int b, int n0,
                                             int f1, const float* w0r, const float* rel_w,
                                             const int* src_w, int r0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int src = src_w[r];
    const float* prow = s.p + ((size_t)b * s.n_src + max(src, 0)) * f1;
    const float* rr = rel_w + r * s.d;
#pragma unroll
    for (int i = 0; i < NC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * i + 2 * t + e;
        float z = 0.f;
        if (src >= 0 && n < f1) {
          z = prow[n];
          for (int j = 0; j < s.d; ++j) z = fmaf(rr[j], w0r[j * f1 + n], z);
        }
        d[4 * i + 2 * h + e] = z;
      }
  }
}

__device__ __forceinline__ void store_max(unsigned long long key, int b, int c, int n, int f,
                                          int n_cent, float* out, signed char* arg) {
  if (c >= n_cent) return;
  const size_t o = ((size_t)b * n_cent + c) * f + n;
  out[o] = key ? key_value(key) : 0.f;
  arg[o] = key ? (signed char)key_row(key) : (signed char)-1;
}

// The last layer's epilogue for one chunk: act(d + bias) keyed with its k,
// the max over each neighbourhood (kp rows): across the lanes of a column
// (rows g, g + 8 of each warp), then, for kp of 32 and 64, across the warps
// of the warpgroup through red; the max and its k go to out and arg.
template <int ACT, int NC>
__device__ __forceinline__ void pool_chunk(const float (&d)[NC / 2], const float* bias, int n0,
                                           int f, int kp_log2, bool ok0, bool ok1, int b,
                                           int c0, bool tile_ok, int n_cent,
                                           unsigned long long* red, float* out,
                                           signed char* arg, bool whole_block) {
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const int r0 = ((warp & 3) << 4) + g;
  const int kp = 1 << kp_log2;
  const int lead = kp < 8 ? kp : 8;  // a neighbourhood's rows among a column's 8 lanes
  const int k0 = r0 & (kp - 1), k1 = (r0 + 8) & (kp - 1);
#pragma unroll
  for (int i = 0; i < NC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * i + 2 * t + e;
      const int n = n0 + c;
      const float bb = bias ? bias[min(n, f - 1)] : 0.f;
      const float v0 = act_fast<ACT>(d[4 * i + e] + bb);
      const float v1 = act_fast<ACT>(d[4 * i + 2 + e] + bb);
      unsigned long long key0 = ok0 ? pack_key(v0, k0) : 0ull;
      unsigned long long key1 = ok1 ? pack_key(v1, k1) : 0ull;
      if (kp >= 16) key0 = max(key0, key1);
      for (int off = 4; off < 4 * lead; off <<= 1) {  // lanes g ^ 1, g ^ 2, g ^ 4
        key0 = max(key0, __shfl_xor_sync(kFullMask, key0, off));
        if (kp < 16) key1 = max(key1, __shfl_xor_sync(kFullMask, key1, off));
      }
      if (kp <= 16) {
        if ((g & (lead - 1)) == 0 && tile_ok && n < f) {
          store_max(key0, b, c0 + (r0 >> kp_log2), n, f, n_cent, out, arg);
          if (kp < 16) store_max(key1, b, c0 + ((r0 + 8) >> kp_log2), n, f, n_cent, out, arg);
        }
      } else if (g == 0) {
        red[warp * NC + c] = key0;
      }
    }
  if (kp > 16) {
    step_sync(whole_block);
    const int tw = threadIdx.x & 127;
    const int wpn = kp >> 4;  // warps of a neighbourhood: 2 or 4
    for (int e = tw; e < (kRows / kp) * NC; e += 128) {
      const int seg = e / NC;
      const int c = e % NC;
      unsigned long long key = 0ull;
      for (int w = seg * wpn; w < (seg + 1) * wpn; ++w) key = max(key, red[(wg * 4 + w) * NC + c]);
      if (tile_ok && n0 + c < f) store_max(key, b, c0 + seg, n0 + c, f, n_cent, out, arg);
    }
  }
}

// byte offsets of the forward block's shared memory: the split tiles, the
// two row buffers (both warpgroups' rows), W0r, the rel rows and source rows
// of the dynamic variant, the schedule, the barriers, the pooling's keys;
// returns the bytes in all
constexpr int kFwdParts = 9;
__host__ __device__ inline size_t fwd_smem(int nc, int slots, int n_sched, int bw0, int bw1,
                                           int dyn_d, int f1, size_t* off) {
  off[0] = 0;
  off[1] = off[0] + (size_t)slots * 2 * kChunkK * nc * 4;
  off[2] = off[1] + (size_t)2 * kRows * bw0 * 4;
  off[3] = off[2] + (size_t)2 * kRows * bw1 * 4;
  off[4] = off[3] + (size_t)dyn_d * f1 * 4;
  off[5] = off[4] + (size_t)2 * kRows * dyn_d * 4;
  off[6] = off[5] + (size_t)2 * kRows * 4;
  off[7] = (off[6] + (size_t)n_sched * 4 + 7) & ~(size_t)7;
  off[8] = off[7] + (size_t)slots * 8;
  return off[8] + (size_t)kWarps * nc * 8;
}

// Pairs of tiles (one a warpgroup) through every layer, blocks walking the
// pairs; out and arg (B, C, F).
template <int ACT, int NC>
__global__ void __launch_bounds__(kThreads, NC == 64 ? 2 : 1)
    sa_fwd_tiles(SaFwd s, int slots, int n_sched, int bw0, int bw1, float* __restrict__ out,
                 signed char* __restrict__ arg) {
  constexpr int kTile = 2 * kChunkK * NC;
  extern __shared__ __align__(128) float smem[];
  const int nl = s.n_layers;
  const int f1 = s.width[1];
  const int f = s.width[nl];
  size_t off[kFwdParts];
  fwd_smem(NC, slots, n_sched, bw0, bw1, s.stat ? 0 : s.d, f1, off);
  char* const base = reinterpret_cast<char*>(smem);
  float* const ring_tiles = reinterpret_cast<float*>(base + off[0]);
  float* const buf0 = reinterpret_cast<float*>(base + off[1]);
  float* const buf1 = reinterpret_cast<float*>(base + off[2]);
  float* const w0r = reinterpret_cast<float*>(base + off[3]);
  float* const rel_s = reinterpret_cast<float*>(base + off[4]);
  int* const src_s = reinterpret_cast<int*>(base + off[5]);
  int* const sched = reinterpret_cast<int*>(base + off[6]);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(base + off[7]);
  auto* const red = reinterpret_cast<unsigned long long*>(base + off[8]);

  const int n_pairs = (s.n_tiles + 1) / 2;
  const int steps = (int)blockIdx.x < n_pairs
                        ? (n_pairs - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  // one step's schedule: each tensor-core layer's chunks, each chunk's k-tiles
  if (threadIdx.x == 0) {
    int j = 0;
    for (int li = s.stat ? 0 : 1; li < nl; ++li) {
      const int nch = (s.width[li + 1] + NC - 1) / NC;
      for (int c = 0; c < nch; ++c)
        for (int kt = 0; kt < s.kt[li]; ++kt) sched[j++] = s.toff[li] + c * s.kt[li] + kt;
    }
    for (int i = 0; i < slots; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!s.stat)
    for (int e = threadIdx.x; e < s.d * f1; e += kThreads)
      w0r[e] = s.w0r[(size_t)(e % f1) * (s.f_in + s.d) + e / f1];
  __syncthreads();
  SaRing ring{ring_tiles, bars, sched, s.split, n_sched, slots, 0u,
              (unsigned)steps * (unsigned)n_sched};
  if (threadIdx.x == 0)
    for (unsigned j = 0; j < (unsigned)slots && j < ring.total; ++j)
      ring_load(ring_tiles + (size_t)j * kTile, s.split + (size_t)sched[j % n_sched] * kTile,
                bars + j, kTile * 4);

  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const int tw = threadIdx.x & 127;      // the thread in its warpgroup
  const int r0 = ((warp & 3) << 4) + g;  // its first accumulator row
  const bool whole = slots < n_sched;    // a shared ring: the warpgroups in step
  float* const rel_w = rel_s + wg * kRows * s.d;
  int* const src_w = src_s + wg * kRows;
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    const int tile = 2 * pair + wg;
    const bool tile_ok = tile < s.n_tiles;
    const int b = tile_ok ? tile / s.tiles_per_case : 0;
    const int c0 = tile_ok ? (tile % s.tiles_per_case) * s.per_tile : s.n_cent;
    step_sync(whole);  // the previous step is done with every buffer
    if (s.stat) {  // the first layer's input rows [xg || rel], zero past them
      const int in_w = s.width[0];
      const int ld0 = row_ld(in_w);
      float* a0 = buf0 + (size_t)wg * kRows * ld0;
      for (int e = tw; e < kRows * ld0; e += 128) {
        const int r = e / ld0;
        const int c = e % ld0;
        const int nr = tile_nbr(s, b, c0, r);
        float v = 0.f;
        if (nr >= 0 && c < in_w)
          v = c < s.f_in ? s.xg[(size_t)nr * s.f_in + c]
                         : s.rel[(size_t)nr * s.d + c - s.f_in];
        a0[e] = v;
      }
    } else {  // the rows' sources and rel
      for (int r = tw; r < kRows; r += 128) {
        const int nr = tile_nbr(s, b, c0, r);
        src_w[r] = nr >= 0 ? (int)s.idx[nr] : -1;
      }
      for (int e = tw; e < kRows * s.d; e += 128) {
        const int nr = tile_nbr(s, b, c0, e / s.d);
        rel_w[e] = nr >= 0 ? s.rel[(size_t)nr * s.d + e % s.d] : 0.f;
      }
    }
    const int nr0 = tile_nbr(s, b, c0, r0);
    const int nr1 = tile_nbr(s, b, c0, r0 + 8);
    const bool ok0 = nr0 >= 0 && s.mask[nr0] != 0;
    const bool ok1 = nr1 >= 0 && s.mask[nr1] != 0;
    step_sync(whole);  // the staged rows are complete

    int cur = 0;
    for (int li = 0; li < nl; ++li) {
      const int n_out = s.width[li + 1];
      const float* A = cur ? buf1 : buf0;
      float* O = cur ? buf0 : buf1;
      const int lda = row_ld(s.width[li]);
      const int ldo = row_ld(n_out);
      const float* bias = s.bias[li];
      if (li == 0 && !s.stat && nl > 1 && (f1 & 3) == 0) {
        // the dynamic first layer straight into the next layer's rows:
        // act(P[idx] + rel W0r), 16 bytes a load, zero past the rows
        float* o = O + (size_t)wg * kRows * ldo;
        const int nq = round8(f1) / 4;
        for (int e = tw; e < kRows * nq; e += 128) {
          const int r = e / nq;
          const int n = 4 * (e % nq);
          const int src = src_w[r];
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (src >= 0 && n < f1) {
            float4 z =
                *reinterpret_cast<const float4*>(s.p + ((size_t)b * s.n_src + src) * f1 + n);
            for (int j = 0; j < s.d; ++j) {
              const float rj = rel_w[r * s.d + j];
              const float* wj = w0r + j * f1 + n;
              z.x = fmaf(rj, wj[0], z.x);
              z.y = fmaf(rj, wj[1], z.y);
              z.z = fmaf(rj, wj[2], z.z);
              z.w = fmaf(rj, wj[3], z.w);
            }
            v = make_float4(act_fast<ACT>(z.x), act_fast<ACT>(z.y), act_fast<ACT>(z.z),
                            act_fast<ACT>(z.w));
          }
          *reinterpret_cast<float4*>(o + r * ldo + n) = v;
        }
        cur ^= 1;
        continue;
      }
      for (int n0 = 0; n0 < n_out; n0 += NC) {
        float d[NC / 2];
        if (li == 0 && !s.stat) {
          gather_layer<NC>(d, s, b, n0, f1, w0r, rel_w, src_w, r0);
        } else {
#pragma unroll
          for (int i = 0; i < NC / 2; ++i) d[i] = 0.f;
          sa_tile_wgmma<NC>(d, A, lda, s.width[li], ring);
        }
        if (li == nl - 1) {
          pool_chunk<ACT, NC>(d, bias, n0, f, s.kp_log2, ok0, ok1, b, c0, tile_ok, s.n_cent, red,
                              out, arg, whole);
          continue;
        }
        // a hidden layer: bias and activation without branches, the next
        // layer's rows (zero on the padding columns it reads)
        const int n_pad = round8(n_out);
#pragma unroll
        for (int i = 0; i < NC / 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int lr = r0 + ((q >> 1) << 3);
            const int n = n0 + 8 * i + 2 * t + (q & 1);
            const float bb = bias ? bias[min(n, n_out - 1)] : 0.f;
            const float v = act_fast<ACT>(d[4 * i + q] + bb);
            if (n < n_pad) O[((size_t)wg * kRows + lr) * ldo + n] = n < n_out ? v : 0.f;
          }
      }
      cur ^= 1;
    }
  }
}

// The tensor-core layers' weights (nn.Linear's (out, in)) split into the
// launch's tiles: tile (c, t) of layer l holds B(k, n) = W[n][k] for k in
// [32 t, 32 t + 32), n in [nc c, nc c + nc), big part then small, each in
// wgmma's K-major core-matrix order (as tc.cuh's split_weights, nc wide)
struct SaSplit {
  const float* w[kMaxLayers];  // null: no tiles (the dynamic first layer)
  int k[kMaxLayers], n[kMaxLayers], kt[kMaxLayers];
  long long start[kMaxLayers + 1];
  int n_layers, nc;
};

__global__ void sa_fwd_split(SaSplit sp, float* __restrict__ out) {
  const long long total = sp.start[sp.n_layers];
  const int half = kChunkK * sp.nc;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    int li = 0;
    while (e >= sp.start[li + 1]) ++li;
    const int local = (int)(e - sp.start[li]);
    const int tile = local / (2 * half);
    const int within = local - tile * 2 * half;
    const bool small = within >= half;
    const int idx = small ? within - half : within;
    const int core = idx >> 5;  // (n / 8, k / 4) in the tile
    const int n = (tile / sp.kt[li]) * sp.nc + ((core >> 3) << 3) + ((idx >> 2) & 7);
    const int k = (tile % sp.kt[li]) * kChunkK + ((core & 7) << 2) + (idx & 3);
    const float v = (k < sp.k[li] && n < sp.n[li]) ? sp.w[li][(size_t)n * sp.k[li] + k] : 0.f;
    const float big = __uint_as_float(to_tf32(v));
    out[e] = small ? __uint_as_float(to_tf32(v - big)) : big;
  }
}

// ---------------------------------------------------------------------------
// Backward

// act'(z) from the fast exponential and division, without branches (as
// act_fast; a few ulp against the 1e-4 relative tolerance)
template <int ACT>
__device__ __forceinline__ float act_d1_fast(float z) {
  if (ACT == kSilu) {
    const float sg = __fdividef(1.f, 1.f + __expf(-z));
    return sg * (1.f + z * (1.f - sg));
  }
  const float th = 1.f - __fdividef(2.f, __expf(2.f * z) + 1.f);
  return 1.f - th * th;
}

struct SaBwd {
  int n_cases, n_cent, k, f, stat, f_in, d, n_src, n_layers, rcap;
  int cm_in_smem, src_tile;  // sa_bwd_prep's plan (PrepPlan)
  int width[kMaxLayers + 1];
  const float* xg;
  const float* rel;
  const float* p;
  const long long* idx;
  const signed char* arg;   // (B, C, F): the forward's first maximal k, -1 if none
  const float* dout;        // (B, C, F)
  const float* w[kMaxLayers];  // nn.Linear's (out, in); dynamic w[0]: W0r as in SaFwd
  const float* b[kMaxLayers];
  const float* w0t;         // static W0 as [j][n] where it does not fit shared memory
  int* count;               // (B): winner rows of each case
  int* case_off;            // (B + 1): each case's first compact row; [B] = all
  int* rows;                // (B, rcap): each case's winner rows c * K + k ascending
  int* perm;                // dynamic (B, rcap): its slots by (source row, slot)
  int* seg;                 // dynamic (B, n_src, 2): each source row's run in perm
  unsigned long long* cmask;  // (B, C): each centroid's winning k
  int* cbase;               // (B, C): its first slot in its case
  int* slot;                // null, or (B, C, F): each channel's slot (-1: none), and
                            // rows past each count to -1 (the compaction for checks)
  float* gzc;               // (B, C, F): the last layer's gz at each winner (nl > 1)
  float* a[kMaxLayers];     // compact input rows of layer i, then a ones column
  int lda[kMaxLayers];
  float* z[kMaxLayers];     // hidden layers' pre-activations (R x width[i + 1])
  float* gz[kMaxLayers];    // and their cotangents; gz[L - 1]: the last layer's (R x F)
};

// sa_bwd_prep's shared memory: each centroid's winner mask and first slot
// where they fit (else they stay in cmask and cbase), the scan's warp sums
// and, dynamic, each warp's count of each source row of a pass (src_tile
// rows a pass, as many as fit: one pass at the paths' 500 source rows)
struct PrepPlan {
  size_t smem;
  int cm_in_smem, src_tile;
};

inline PrepPlan prep_plan(int n_cent, int n_src, size_t cap) {
  constexpr int kW = kPrepThreads / 32;
  const size_t ws = 4 * (kW + 1);
  const size_t cm = (size_t)n_cent * 12;
  const size_t per_src = 4 * kW;
  PrepPlan pl{};
  const size_t want = n_src ? per_src * std::min(n_src, 1024) : 0;
  pl.cm_in_smem = ws + cm + want <= cap;
  const size_t room = cap - ws - (pl.cm_in_smem ? cm : 0);
  pl.src_tile = n_src ? (int)std::min<size_t>(n_src, room / per_src) : 0;
  pl.smem = ws + (pl.cm_in_smem ? cm : 0) + per_src * pl.src_tile;
  return pl;
}

// Blocks [0, B): the compaction of case blockIdx.x and, dynamic, dP's order
// (see the head of this file). The other blocks: the weight transposes.
__global__ void __launch_bounds__(kPrepThreads) sa_bwd_prep(SaBwd p, Transposes tr) {
  if ((int)blockIdx.x >= p.n_cases) {
    transpose_blocks(tr, blockIdx.x - p.n_cases, gridDim.x - p.n_cases);
    return;
  }
  extern __shared__ unsigned long long prep_buf[];
  const int C = p.n_cent;
  const int K = p.k;
  const int F = p.f;
  const int b = blockIdx.x;
  // each centroid's winners and its first slot
  unsigned long long* cm = p.cm_in_smem ? prep_buf : p.cmask + (size_t)b * C;
  int* cb = p.cm_in_smem ? reinterpret_cast<int*>(prep_buf + C) : p.cbase + (size_t)b * C;
  int* ws = p.cm_in_smem ? cb + C : reinterpret_cast<int*>(prep_buf);  // the scan's warp sums
  constexpr int kW = kPrepThreads / 32;
  int* cnt = ws + kW + 1;  // a pass's [source row][warp] counts

  // 1. the winners of each centroid: the k of its argmax row as a mask
  for (int c = threadIdx.x; c < C; c += kPrepThreads) {
    const signed char* a = p.arg + ((size_t)b * C + c) * F;
    unsigned long long m = 0ull;
    if ((F & 3) == 0) {
      const int* a4 = reinterpret_cast<const int*>(a);
      for (int q = 0; q < F / 4; ++q) {
        const int v = a4[q];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = (signed char)(v >> (8 * e));
          if (kk >= 0) m |= 1ull << kk;
        }
      }
    } else {
      for (int ch = 0; ch < F; ++ch) {
        const int kk = a[ch];
        if (kk >= 0) m |= 1ull << kk;
      }
    }
    cm[c] = m;
  }
  __syncthreads();
  // 2. each centroid's first slot: runs of centroids a thread, one block scan
  const int per = (C + kPrepThreads - 1) / kPrepThreads;
  const int c_lo = min(C, (int)threadIdx.x * per);
  const int c_hi = min(C, c_lo + per);
  int mine = 0;
  for (int c = c_lo; c < c_hi; ++c) mine += __popcll(cm[c]);
  int total;
  int at = block_exclusive_scan<kW>(mine, ws, &total);
  for (int c = c_lo; c < c_hi; ++c) {
    cb[c] = at;
    at += __popcll(cm[c]);
  }
  __syncthreads();
  if (threadIdx.x == 0) p.count[b] = total;
  // 3. the winner rows in slot order
  int* rows = p.rows + (size_t)b * p.rcap;
  for (int e = threadIdx.x; e < C * K; e += kPrepThreads) {
    const int c = e / K;
    const int kk = e - c * K;
    const unsigned long long m = cm[c];
    if ((m >> kk) & 1ull) rows[cb[c] + __popcll(m & ((1ull << kk) - 1ull))] = e;
  }
  if (p.cm_in_smem) {
    for (int c = threadIdx.x; c < C; c += kPrepThreads) {
      p.cmask[(size_t)b * C + c] = cm[c];
      p.cbase[(size_t)b * C + c] = cb[c];
    }
  }
  if (p.slot) {  // the compaction as sa_cuda.sa_winner_rows gives it
    for (int e = total + threadIdx.x; e < p.rcap; e += kPrepThreads) rows[e] = -1;
    for (int e = threadIdx.x; e < C * F; e += kPrepThreads) {
      const int c = e / F;
      const int kk = p.arg[(size_t)b * C * F + e];
      p.slot[(size_t)b * C * F + e] =
          kk < 0 ? -1 : cb[c] + __popcll(cm[c] & ((1ull << kk) - 1ull));
    }
  }
  if (p.stat) return;
  __syncthreads();  // rows[] written
  // 4. dP's order: the slots grouped by source row, in slot order within a
  // row, each source row's run [start, end) marked. A counting sort in
  // passes over src_tile source rows: warp w walks its run of slots and
  // counts the pass's source rows among them (a key's lanes found by
  // __match_any_sync); the counts, scanned source row by source row and
  // warp by warp after the earlier passes' slots, are each (row, warp)'s
  // first place; a second walk puts every slot at its place.
  const int n_src = p.n_src;
  const long long* idx = p.idx + (size_t)b * C * K;
  int* seg = p.seg + (size_t)b * n_src * 2;
  int* perm = p.perm + (size_t)b * p.rcap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int run = (total + kW - 1) / kW;
  const int lo = min(total, warp * run);
  const int hi = min(total, lo + run);
  int placed = 0;  // slots of the earlier passes
  for (int s0 = 0; s0 < n_src; s0 += p.src_tile) {
    const int ns = min(p.src_tile, n_src - s0);
    for (int i = threadIdx.x; i < kW * ns; i += kPrepThreads) cnt[i] = 0;
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      int key = -1 - lane;  // distinct where no slot of this pass
      if (i < hi) {
        const int s = (int)idx[rows[i]] - s0;
        if (s >= 0 && s < ns) key = s;
      }
      const unsigned m = __match_any_sync(kFullMask, key);
      if (key >= 0 && (m & ((1u << lane) - 1u)) == 0u) cnt[key * kW + warp] += __popc(m);
      __syncwarp();
    }
    __syncthreads();
    const int per_s = (ns + kPrepThreads - 1) / kPrepThreads;
    const int s_lo = min(ns, (int)threadIdx.x * per_s);
    const int s_hi = min(ns, s_lo + per_s);
    int n_mine = 0;
    for (int e = s_lo * kW; e < s_hi * kW; ++e) n_mine += cnt[e];
    int all;
    int pos = placed + block_exclusive_scan<kW>(n_mine, ws, &all);
    for (int s = s_lo; s < s_hi; ++s) {
      seg[2 * (s0 + s)] = pos;
      for (int w = 0; w < kW; ++w) {
        const int c = cnt[s * kW + w];
        cnt[s * kW + w] = pos;
        pos += c;
      }
      seg[2 * (s0 + s) + 1] = pos;
    }
    placed += all;
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      int key = -1 - lane;
      if (i < hi) {
        const int s = (int)idx[rows[i]] - s0;
        if (s >= 0 && s < ns) key = s;
      }
      const unsigned m = __match_any_sync(kFullMask, key);
      const unsigned before = m & ((1u << lane) - 1u);
      const int first = key >= 0 ? cnt[key * kW + warp] : 0;
      if (key >= 0) perm[first + __popc(before)] = i;
      __syncwarp();
      if (key >= 0 && before == 0u) cnt[key * kW + warp] = first + __popc(m);
      __syncwarp();
    }
    __syncthreads();
  }
}

// A block's partial sums over its tiles, one slice a block (added in block
// order by sum_layer_parts): layer 0's dW (the dynamic variant's: W0r's),
// then, static, its db; and the db of every hidden layer from 1 on (the
// last layer's come from sa_bwd_dwl). They live in shared memory when they
// fit (in_smem), else in the block's own slice.
struct TileSums {
  float* dw0;               // (blocks, dw0_len)
  float* db[kMaxLayers];    // hidden layer i >= 1: (blocks, width[i + 1])
  int dw0_len, in_smem;
};

// byte offsets of the backward tile's shared memory: the first layer's input
// rows, the two row buffers, block_mma16's weight tiles, the block's sums,
// the first layer's weights (w0s_floats; 0: read from device memory), the
// last layer's (wl_floats; likewise), a round's pairs (gz, then row << 10 |
// channel), the rows' channel masks and each mask word's first pair, the
// rows' first pairs, the cases' first rows, the rows' centroid, k and source
constexpr int kBwdParts = 14;
__host__ __device__ inline size_t bwd_smem(int ld0, int bw, int w_floats, int n_sums,
                                           int w0s_floats, int wl_floats, int nw, int n_cases,
                                           size_t* off) {
  off[0] = 0;
  off[1] = off[0] + (size_t)kBwdRows * ld0 * 4;
  off[2] = off[1] + (size_t)kBwdRows * bw * 4;
  off[3] = off[2] + (size_t)kBwdRows * bw * 4;
  off[4] = off[3] + (size_t)w_floats * 4;
  off[5] = off[4] + (((size_t)n_sums * 4 + 15) & ~(size_t)15);
  off[6] = off[5] + (((size_t)w0s_floats * 4 + 15) & ~(size_t)15);
  off[7] = off[6] + (size_t)wl_floats * 4;
  off[8] = off[7] + (size_t)kPairCap * 4;
  off[9] = off[8] + (size_t)kPairCap * 4;
  off[10] = off[9] + (size_t)kBwdRows * nw * 4;
  off[11] = off[10] + (size_t)kBwdRows * nw * 4;
  off[12] = off[11] + (size_t)(kBwdRows + 1) * 4;
  off[13] = off[12] + (size_t)(n_cases + 1) * 4;
  return off[13] + (size_t)3 * kBwdRows * 4;
}

// Blocks walking tiles of 64 compact rows (see the head of this file); a
// warp takes rows, its lanes columns. fwd_t.layer[i] (1 <= i < L - 1):
// hidden layer i's transposed (in, out) weight and bias; bwd_o.layer[i] (i
// >= 1): W_i as stored, read as a (k = out) x (n = in) matrix, so
// block_mma16 gives GA = GZ_i W_i. bw: the row buffers' stride room;
// w_floats: block_mma16's weight tiles (0 where no layer needs them);
// n_sums: the block's sums in shared memory (0: in ts); the first layer's
// weights in shared memory where they fit (w0s_floats; 0: p.w0t), the last
// layer's likewise (wl_floats; 0: read as stored), rows ldw apart. HIDDEN: the
// stack has layers between the first and the last (their products need
// registers that would cost the other stacks blocks an SM).
template <int ACT, bool HIDDEN>
__global__ void __launch_bounds__(kThreads, HIDDEN ? 1 : 3)
    sa_bwd_tiles(SaBwd p, Mlp fwd_t, Mlp bwd_o, TileSums ts, int bw, int w_floats,
                 int n_sums, int w0s_floats, int wl_floats) {
  extern __shared__ __align__(128) float smem[];
  const int nl = p.n_layers;
  const int C = p.n_cent;
  const int K = p.k;
  const int F = p.f;
  const bool stat = p.stat != 0;
  const int d = p.d;
  const int f_in = p.f_in;
  const int n_src = p.n_src;
  const int w0 = p.width[0];
  const int f1 = p.width[1];
  const int nw = (F + 31) / 32;
  const int ld0 = padded(w0);
  size_t off[kBwdParts];
  bwd_smem(ld0, bw, w_floats, n_sums, w0s_floats, wl_floats, nw, p.n_cases, off);
  char* const base = reinterpret_cast<char*>(smem);
  float* const a0 = reinterpret_cast<float*>(base + off[0]);
  float* const bufA = reinterpret_cast<float*>(base + off[1]);
  float* const bufB = reinterpret_cast<float*>(base + off[2]);
  float* const w_tiles = reinterpret_cast<float*>(base + off[3]);
  float* const sums = reinterpret_cast<float*>(base + off[4]);
  float* const w0s_sm = reinterpret_cast<float*>(base + off[5]);  // [j][n], static b0 after
  const float* const w0s = w0s_floats ? w0s_sm : p.w0t;
  float* const wls = reinterpret_cast<float*>(base + off[6]);
  float* const pg = reinterpret_cast<float*>(base + off[7]);
  int* const pr = reinterpret_cast<int*>(base + off[8]);
  unsigned* const msk = reinterpret_cast<unsigned*>(base + off[9]);
  int* const pbase = reinterpret_cast<int*>(base + off[10]);  // each mask word's first pair
  int* const poff = reinterpret_cast<int*>(base + off[11]);
  int* const coff = reinterpret_cast<int*>(base + off[12]);
  int* const trc = reinterpret_cast<int*>(base + off[13]);  // each row's centroid b * C + c
  int* const trk = trc + kBwdRows;                           // its k
  int* const trs = trk + kBwdRows;                           // dynamic: its source row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane_group();
  const int t = threadIdx.x & 3;
  const float* const P = p.p;
  const float* const b0s = w0s_floats ? w0s_sm + w0 * f1 : p.b[0];
  float* const a1g = nl > 1 ? p.a[1] : nullptr;
  const int lda1 = p.lda[1];
  // the block's sums: layer 0's dW (and db), then the db of the hidden
  // layers from 1 on
  float* const s_dw0 = ts.in_smem ? sums : ts.dw0 + (size_t)blockIdx.x * ts.dw0_len;
  {
    int at = ts.dw0_len;
    for (int li = 1; li < nl - 1; ++li) {
      float* q = ts.in_smem ? sums + at : ts.db[li] + (size_t)blockIdx.x * p.width[li + 1];
      at += p.width[li + 1];
      for (int e = threadIdx.x; e < p.width[li + 1]; e += kThreads) q[e] = 0.f;
    }
  }
  for (int e = threadIdx.x; e < ts.dw0_len; e += kThreads) s_dw0[e] = 0.f;
  // the first layer's weights as [j][n] (static: b0 after them) and the
  // last layer's, rows ldw apart, where they fit
  if (w0s_floats) {
    const int ld = stat ? w0 : f_in + d;
    for (int j = warp; j < w0; j += kWarps)
      for (int n = lane; n < f1; n += 32) w0s_sm[j * f1 + n] = p.w[0][(size_t)n * ld + j];
    if (stat)
      for (int n = threadIdx.x; n < f1; n += kThreads) w0s_sm[w0 * f1 + n] = p.b[0][n];
  }
  const int kl = p.width[nl - 1];
  const int ldw = wl_floats ? kl + 4 : kl;  // 4 words apart: no bank conflicts
  for (int c = warp; c < (wl_floats ? F : 0); c += kWarps)
    for (int k = lane; k < kl; k += 32) wls[c * ldw + k] = p.w[nl - 1][(size_t)c * kl + k];
  const float* const Wl = wl_floats ? wls : p.w[nl - 1];
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int b = 0; b < p.n_cases; ++b) {
      coff[b] = sum;
      sum += p.count[b];
    }
    coff[p.n_cases] = sum;
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b <= p.n_cases; b += kThreads) p.case_off[b] = coff[b];
  const int T = coff[p.n_cases];

  for (int tile = blockIdx.x; tile * kBwdRows < T; tile += gridDim.x) {
    const int s0 = tile * kBwdRows;
    const int nv = min(kBwdRows, T - s0);
    __syncthreads();  // the previous tile is done with every buffer
    if (threadIdx.x < kBwdRows) {
      const int r = threadIdx.x;
      int cg = 0, kk = 0, src = 0;
      if (r < nv) {
        const int s = s0 + r;
        int lo = 0, hi = p.n_cases;  // the case: the last b with coff[b] <= s
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (coff[mid] <= s) lo = mid;
          else hi = mid;
        }
        const int e = p.rows[(size_t)lo * p.rcap + s - coff[lo]];
        cg = lo * C + e / K;
        kk = e % K;
        if (!stat) src = (int)p.idx[(size_t)cg * K + kk];
      }
      trc[r] = cg;
      trk[r] = kk;
      trs[r] = src;
    }
    __syncthreads();
    // the first layer's input rows: static [xg || rel], dynamic rel
    for (int e = threadIdx.x; e < kBwdRows * ld0; e += kThreads) {
      const int r = e / ld0;
      const int c = e - r * ld0;
      float v = 0.f;
      if (r < nv && c < w0) {
        const size_t nr = (size_t)trc[r] * K + trk[r];
        v = !stat ? p.rel[nr * d + c]
                  : (c < f_in ? p.xg[nr * f_in + c] : p.rel[nr * d + c - f_in]);
      }
      a0[e] = v;
    }
    __syncthreads();
    // the first layer at the rows, on the CUDA cores (2 to 8 deep on the
    // paths): A1 = act(Z0); Z0 kept where a product sweeps down to it
    int cur = 1;  // the buffer holding the next layer's input rows
    if (nl > 1) {
      const int ld1 = padded(f1);
      const bool vec = (f1 & 3) == 0;
      for (int r = warp; r < kBwdRows; r += kWarps) {
        const float* a0r = a0 + r * ld0;
        const float* zr = stat ? b0s : P + ((size_t)(trc[r] / C) * n_src + trs[r]) * f1;
        float* a1r = a1g + (size_t)(s0 + r) * lda1;
        if (vec) {  // 16 bytes a lane
          for (int n = 4 * lane; n < ld1; n += 128) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < nv && n < f1) {
              float4 z = *reinterpret_cast<const float4*>(zr + n);
              for (int j = 0; j < w0; ++j) {
                const float a = a0r[j];
                const float4 w = *reinterpret_cast<const float4*>(w0s + j * f1 + n);
                z.x = fmaf(a, w.x, z.x);
                z.y = fmaf(a, w.y, z.y);
                z.z = fmaf(a, w.z, z.z);
                z.w = fmaf(a, w.w, z.w);
              }
              v = make_float4(act_fast<ACT>(z.x), act_fast<ACT>(z.y), act_fast<ACT>(z.z),
                              act_fast<ACT>(z.w));
              if (HIDDEN) *reinterpret_cast<float4*>(p.z[0] + (size_t)(s0 + r) * f1 + n) = z;
              *reinterpret_cast<float4*>(a1r + n) = v;
            }
            *reinterpret_cast<float4*>(bufB + r * ld1 + n) = v;
          }
          continue;
        }
        for (int n = lane; n < ld1; n += 32) {
          float v = 0.f;
          if (r < nv && n < f1) {
            float z = zr[n];
            for (int j = 0; j < w0; ++j) z = fmaf(a0r[j], w0s[j * f1 + n], z);
            v = act_fast<ACT>(z);
            if (HIDDEN) p.z[0][(size_t)(s0 + r) * f1 + n] = z;
            a1r[n] = v;
          }
          bufB[r * ld1 + n] = v;
        }
      }
    }
    // the hidden layers above it in 3xTF32
    for (int li = 1; HIDDEN && li < nl - 1; ++li) {
      const Layer L = fwd_t.layer[li];
      const float* A = cur ? bufB : bufA;
      float* O = cur ? bufA : bufB;
      const int lda = padded(L.k);
      const int ldo = padded(L.n);
      const int n_pad = round8(L.n);
      for (int n0 = 0; n0 < L.n; n0 += kChunkN)
        for (int sub = 0; sub < kBwdRows / 16; ++sub) {
          float acc[2][4];
          block_mma16(acc, A + sub * 16 * lda, lda, L, n0, w_tiles);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = sub * 16 + g + 8 * (q >> 1);
              const int n = n0 + 16 * warp + 8 * j + 2 * t + (q & 1);
              if (n >= n_pad) continue;
              const bool ok = n < L.n && row < nv;
              const float z = acc[j][q] + (n < L.n ? L.b[n] : 0.f);
              const float v = ok ? act_fast<ACT>(z) : 0.f;
              O[row * ldo + n] = v;
              if (ok) {
                p.z[li][(size_t)(s0 + row) * L.n + n] = z;
                p.a[li + 1][(size_t)(s0 + row) * p.lda[li + 1] + n] = v;
              }
            }
        }
      cur ^= 1;
    }

    // the last layer at the winners
    const float* Al = nl == 1 ? a0 : (cur ? bufB : bufA);
    const int ldl = nl == 1 ? ld0 : padded(kl);
    float* const Gt = cur ? bufA : bufB;  // da (nl > 1) or the rows' G (nl == 1)
    const int ldt = nl == 1 ? padded(F) : ldl;
    const float* bl = p.b[nl - 1];
    float* const G = p.gz[0];  // the dynamic one-layer level's GZ rows (dP reads them)
    const bool rows_g = nl == 1 && !stat;
    // the rows' argmax, 4 bytes a load where the rows allow, in the buffer
    // of da until the masks are made
    auto* const targ = reinterpret_cast<signed char*>(Gt);  // rows nw * 32 apart
    if ((F & 3) == 0) {
      const int wpr = F / 4;
      for (int e = threadIdx.x; e < nv * wpr; e += kThreads) {
        const int r = e / wpr;
        const int q = e - r * wpr;
        reinterpret_cast<int*>(targ + r * nw * 32)[q] =
            reinterpret_cast<const int*>(p.arg + (size_t)trc[r] * F)[q];
      }
    } else {
      for (int e = threadIdx.x; e < nv * F; e += kThreads) {
        const int r = e / F;
        const int c = e - r * F;
        targ[r * nw * 32 + c] = p.arg[(size_t)trc[r] * F + c];
      }
    }
    __syncthreads();
    // (a) each row's channels: a ballot over its centroid's argmax, a word
    // of 32 channels at a time
    for (int r = warp; r < kBwdRows; r += kWarps) {
      int n_r = 0;
      for (int j = 0; j < nw; ++j) {
        const int ch = 32 * j + lane;
        const bool won = r < nv && ch < F && targ[r * nw * 32 + ch] == trk[r];
        const unsigned m = __ballot_sync(kFullMask, won);
        if (lane == 0) msk[r * nw + j] = m;
        n_r += __popc(m);
      }
      if (lane == 0) poff[r] = n_r;
    }
    __syncthreads();
    // (b) each row's first pair: the counts scanned by one warp; each mask
    // word's first pair
    if (warp == 0) {
      const int c0 = poff[2 * lane], c1 = poff[2 * lane + 1];
      int x = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
      }
      __syncwarp();
      poff[2 * lane] = x - c0 - c1;
      poff[2 * lane + 1] = x - c1;
      if (lane == 31) poff[kBwdRows] = x;
      __syncwarp();
      for (int r = lane; r < kBwdRows; r += 32) {
        int q = poff[r];
        for (int j = 0; j < nw; ++j) {
          pbase[r * nw + j] = q;
          q += __popc(msk[r * nw + j]);
        }
      }
    }
    // the rows' G (rows_g): 0 on the channels they do not win (gz where
    // they do, below); da from 0
    for (int r = warp; r < kBwdRows; r += kWarps) {
      for (int c = lane; rows_g && r < nv && c < F; c += 32)
        if (!((msk[r * nw + (c >> 5)] >> lane) & 1u)) G[(size_t)(s0 + r) * F + c] = 0.f;
      for (int c = lane; c < ldt; c += 32) Gt[r * ldt + c] = 0.f;
    }
    __syncthreads();
    const int n_pairs = poff[kBwdRows];
    for (int pb = 0; pb < n_pairs; pb += kPairCap) {
      const int np = min(kPairCap, n_pairs - pb);
      // (c) the round's (row, channel) pairs, in that order
      for (int e = threadIdx.x; e < kBwdRows * nw; e += kThreads) {
        unsigned m = msk[e];
        int q = pbase[e] - pb;
        const int c0 = 32 * (e % nw);
        const int rr = (e / nw) << 10;
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          if (q >= 0 && q < np) pr[q] = rr | (c0 + bit);
          ++q;
        }
      }
      __syncthreads();
      // (d) z and gz = dout act'(z) at each pair: 8 lanes a pair
      {
        const int sub = lane >> 3;  // the pair among the warp's four
        const int l8 = lane & 7;
        for (int q0 = 4 * warp; q0 < np; q0 += 4 * kWarps) {
          const int q = q0 + sub;
          const bool ok = q < np;
          const int r = ok ? pr[q] >> 10 : 0;
          const int c = ok ? pr[q] & 1023 : 0;
          float z = 0.f;
          if (nl == 1 && !stat) {  // the dynamic one-layer level: P[src] + rel W0r
            if (l8 == 0 && ok) {
              z = P[((size_t)(trc[r] / C) * n_src + trs[r]) * f1 + c];
              for (int j = 0; j < w0; ++j) z = fmaf(a0[r * ld0 + j], w0s[j * f1 + c], z);
            }
          } else {  // four partial sums, so that the loads run ahead
            const float* ar = Al + r * ldl;
            const float* wr = Wl + (size_t)c * ldw;
            float z1 = 0.f, z2 = 0.f, z3 = 0.f;
            int k = l8;
            for (; k + 24 < kl; k += 32) {
              z = fmaf(ar[k], wr[k], z);
              z1 = fmaf(ar[k + 8], wr[k + 8], z1);
              z2 = fmaf(ar[k + 16], wr[k + 16], z2);
              z3 = fmaf(ar[k + 24], wr[k + 24], z3);
            }
            for (; k < kl; k += 8) z = fmaf(ar[k], wr[k], z);
            z = (z + z1) + (z2 + z3);
          }
          z += __shfl_xor_sync(kFullMask, z, 1);
          z += __shfl_xor_sync(kFullMask, z, 2);
          z += __shfl_xor_sync(kFullMask, z, 4);
          if (ok && l8 == 0) {
            if (!(nl == 1 && !stat)) z += bl[c];
            const float gz = p.dout[(size_t)trc[r] * F + c] * act_d1_fast<ACT>(z);
            pg[q] = gz;
            if (nl > 1) p.gzc[(size_t)trc[r] * F + c] = gz;
            else Gt[r * ldt + c] = gz;
            if (rows_g) G[(size_t)(s0 + r) * F + c] = gz;
          }
        }
      }
      __syncthreads();
      if (nl > 1) {
        // (e) da[r] += gz W[c, :] over the row's pairs, in channel order: a
        // lane's columns in registers, a pair's row of W loaded at once
        for (int r = warp; r < nv; r += kWarps) {
          const int q0 = max(poff[r] - pb, 0);
          const int q1 = min(poff[r + 1] - pb, np);
          if (q0 >= q1) continue;
          float acc[kMaxCols];
#pragma unroll
          for (int i = 0; i < kMaxCols; ++i)
            acc[i] = lane + 32 * i < kl ? Gt[r * ldl + lane + 32 * i] : 0.f;
          for (int q = q0; q < q1; ++q) {
            const float gq = pg[q];
            const float* wr = Wl + (size_t)(pr[q] & 1023) * ldw + lane;
#pragma unroll
            for (int i = 0; i < kMaxCols; ++i)
              if (lane + 32 * i < kl) acc[i] = fmaf(gq, wr[32 * i], acc[i]);
          }
#pragma unroll
          for (int i = 0; i < kMaxCols; ++i)
            if (lane + 32 * i < kl) Gt[r * ldl + lane + 32 * i] = acc[i];
        }
      }
      __syncthreads();  // the round's pairs are used
    }

    float* gz0 = Gt;  // the rows' GZ of layer 0, when known
    if (nl > 1) {
      // (g) GZ of the top hidden layer = da act'(Z), Z recomputed for layer 0
      const int lt = nl - 2;
      const bool keep = lt > 0 || !stat;  // weight_grad's or dP's
      for (int r = warp; r < nv; r += kWarps) {
        const float* a0r = a0 + r * ld0;
        const float* zr = stat ? b0s : P + ((size_t)(trc[r] / C) * n_src + trs[r]) * f1;
        if (lt == 0 && (kl & 3) == 0) {  // 16 bytes a lane
          for (int k = 4 * lane; k < kl; k += 128) {
            float4 z = *reinterpret_cast<const float4*>(zr + k);
            for (int j = 0; j < w0; ++j) {
              const float a = a0r[j];
              const float4 w = *reinterpret_cast<const float4*>(w0s + j * f1 + k);
              z.x = fmaf(a, w.x, z.x);
              z.y = fmaf(a, w.y, z.y);
              z.z = fmaf(a, w.z, z.z);
              z.w = fmaf(a, w.w, z.w);
            }
            float4* gt = reinterpret_cast<float4*>(Gt + r * ldl + k);
            float4 v = *gt;
            v.x *= act_d1_fast<ACT>(z.x);
            v.y *= act_d1_fast<ACT>(z.y);
            v.z *= act_d1_fast<ACT>(z.z);
            v.w *= act_d1_fast<ACT>(z.w);
            *gt = v;
            if (keep) *reinterpret_cast<float4*>(p.gz[0] + (size_t)(s0 + r) * kl + k) = v;
          }
          continue;
        }
        for (int k = lane; k < kl; k += 32) {
          float z;
          if (lt == 0) {
            z = zr[k];
            for (int j = 0; j < w0; ++j) z = fmaf(a0r[j], w0s[j * f1 + k], z);
          } else {
            z = p.z[lt][(size_t)(s0 + r) * kl + k];
          }
          const float v = Gt[r * ldl + k] * act_d1_fast<ACT>(z);
          Gt[r * ldl + k] = v;
          if (keep) p.gz[lt][(size_t)(s0 + r) * kl + k] = v;
        }
      }
      __syncthreads();
      // the reverse sweep: GZ_{i-1} = (GZ_i W_i) act'(Z_{i-1})
      int gc = cur ^ 1;
      for (int lr = nl - 2; HIDDEN && lr >= 0; --lr) {
        if (lr > 0) {  // this hidden layer's db: its GZ's column sums
          const float* Gs = gc ? bufB : bufA;
          const int ldg = padded(p.width[lr + 1]);
          float* db = ts.in_smem ? sums + ts.dw0_len : ts.db[lr] + (size_t)blockIdx.x *
                                                                      p.width[lr + 1];
          for (int i = 1; ts.in_smem && i < lr; ++i) db += p.width[i + 1];
          for (int n = threadIdx.x; n < p.width[lr + 1]; n += kThreads) {
            float acc = db[n];
            for (int r = 0; r < nv; ++r) acc += Gs[r * ldg + n];
            db[n] = acc;
          }
        }
        if (lr == 0) {
          gz0 = gc ? bufB : bufA;
          break;
        }
        const Layer L = bwd_o.layer[lr];
        const float* Gs = gc ? bufB : bufA;
        float* O = gc ? bufA : bufB;
        const int ldg = padded(L.k);
        const int ldo = padded(L.n);
        const int n_pad = round8(L.n);
        const bool keep_b = lr - 1 > 0 || !stat;
        for (int n0 = 0; n0 < L.n; n0 += kChunkN)
          for (int sub = 0; sub < kBwdRows / 16; ++sub) {
            float acc[2][4];
            block_mma16(acc, Gs + sub * 16 * ldg, ldg, L, n0, w_tiles);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int row = sub * 16 + g + 8 * (q >> 1);
                const int n = n0 + 16 * warp + 8 * j + 2 * t + (q & 1);
                if (n >= n_pad) continue;
                const bool ok = n < L.n && row < nv;
                const float v =
                    ok ? acc[j][q] * act_d1_fast<ACT>(p.z[lr - 1][(size_t)(s0 + row) * L.n + n])
                       : 0.f;
                O[row * ldo + n] = v;
                if (ok && keep_b) p.gz[lr - 1][(size_t)(s0 + row) * L.n + n] = v;
              }
          }
        gc ^= 1;
        __syncthreads();
      }
    }
    __syncthreads();
    // (h) layer 0's dW (and static db): a0^T GZ0 over the rows, in order
    {
      const int ldz = padded(f1);
      const int rows0 = stat ? w0 + 1 : w0;
      for (int j = warp; j < rows0; j += kWarps)
        for (int n = lane; n < f1; n += 32) {
          float acc = 0.f;
          if (j < w0)
            for (int r = 0; r < nv; ++r) acc = fmaf(a0[r * ld0 + j], gz0[r * ldz + n], acc);
          else
            for (int r = 0; r < nv; ++r) acc += gz0[r * ldz + n];
          s_dw0[j * f1 + n] += acc;
        }
    }
  }
  if (ts.in_smem) {  // the block's sums to its slices
    __syncthreads();
    for (int e = threadIdx.x; e < ts.dw0_len; e += kThreads)
      ts.dw0[(size_t)blockIdx.x * ts.dw0_len + e] = s_dw0[e];
    int at = ts.dw0_len;
    for (int li = 1; li < nl - 1; ++li) {
      for (int e = threadIdx.x; e < p.width[li + 1]; e += kThreads)
        ts.db[li][(size_t)blockIdx.x * p.width[li + 1] + e] = sums[at + e];
      at += p.width[li + 1];
    }
  }
}

// The last layer's dW and db over its winners (nl > 1), a block a (channel
// c, chunk of kDwlCents centroids), a thread a column k of dW: dW[k][c] +=
// gz A[winner row][k] and db[c] += gz, the centroids in order; the chunk's
// partials go to parts (chunk, kl, F) and dbp (chunk, F).
constexpr int kDwlCents = 128;

__global__ void __launch_bounds__(kThreads) sa_bwd_dwl(SaBwd p, float* __restrict__ parts,
                                                       float* __restrict__ dbp) {
  __shared__ int srow[kDwlCents];
  __shared__ float sg[kDwlCents];
  const int c = blockIdx.x;
  const int chunk = blockIdx.y;
  const int F = p.f;
  const int kl = p.width[p.n_layers - 1];
  const int e0 = chunk * kDwlCents;
  const int ne = min(kDwlCents, p.n_cases * p.n_cent - e0);
  for (int i = threadIdx.x; i < kDwlCents; i += blockDim.x) {
    int row = -1;
    float g = 0.f;
    if (i < ne) {
      const int cg = e0 + i;
      const int kk = p.arg[(size_t)cg * F + c];
      if (kk >= 0) {
        row = p.case_off[cg / p.n_cent] + p.cbase[cg] +
              __popcll(p.cmask[cg] & ((1ull << kk) - 1ull));
        g = p.gzc[(size_t)cg * F + c];
      }
    }
    srow[i] = row;
    sg[i] = g;
  }
  __syncthreads();
  const float* A = p.a[p.n_layers - 1];
  const int lda = p.lda[p.n_layers - 1];
  for (int k = threadIdx.x; k < kl; k += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < ne; ++i) {
      const int row = srow[i];
      if (row >= 0) acc = fmaf(sg[i], A[(size_t)row * lda + k], acc);
    }
    parts[((size_t)chunk * kl + k) * F + c] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < ne; ++i) acc += sg[i];
    dbp[(size_t)chunk * F + c] = acc;
  }
}

// dP (B, n_src, F1): at each source row the sum of its winner rows' layer-0
// GZ, in slot order (the run sa_bwd_prep sorted)
__global__ void sa_bwd_dp(SaBwd p, float* __restrict__ dp) {
  const int f1 = p.width[1];
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)p.n_cases * p.n_src * f1) return;
  const int n = (int)(e % f1);
  const long long row = e / f1;  // b * n_src + source row
  const int b = (int)(row / p.n_src);
  const int* sg = p.seg + row * 2;
  const int* perm = p.perm + (size_t)b * p.rcap;
  const size_t off = p.case_off[b];
  float sum = 0.f;
  for (int i = sg[0]; i < sg[1]; ++i) sum += p.gz[0][(off + perm[i]) * f1 + n];
  dp[e] = sum;
}

// ---------------------------------------------------------------------------
// Host side

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

struct Shape {
  int stat, act, n_cases, n_cent, k, f_in, d, n_src, n_layers;
  int width[kMaxLayers + 1];
  const float* xg;
  const float* rel;
  const unsigned char* mask;
  const float* p;
  const long long* idx;
  const float* const* w;
  const float* const* b;
};

// Validate the arguments (see sa_forward) into a Shape.
bool make_shape(Shape& sh, int stat, int act, int n_cases, int n_cent, int k, int f_in, int d,
                const float* xg, const float* rel, const unsigned char* mask, const float* p,
                const long long* idx, int n_src, int n_layers, const float* const* w,
                const float* const* b, const int* widths) {
  if (n_cases < 1 || n_cent < 1 || k < 1 || k > kMaxNeighbors || d < 1 || n_layers < 1 ||
      n_layers > kMaxLayers || (act != kSilu && act != kTanh))
    return false;
  if (widths[0] != (stat ? f_in + d : d) || (!stat && n_src < 1) || f_in < 0) return false;
  if ((long long)n_cases * n_cent * k >= (1LL << 31)) return false;
  sh = Shape{};
  sh.stat = stat;
  sh.act = act;
  sh.n_cases = n_cases;
  sh.n_cent = n_cent;
  sh.k = k;
  sh.f_in = f_in;
  sh.d = d;
  sh.n_src = n_src;
  sh.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return false;
    sh.width[i] = widths[i];
  }
  sh.xg = xg;
  sh.rel = rel;
  sh.mask = mask;
  sh.p = p;
  sh.idx = idx;
  sh.w = w;
  sh.b = b;
  return true;
}

// The forward's arrangement: chunk width, split tiles (resident when slots
// == n_sched, else a ring of slots), row buffers and shared bytes; nc = 0
// when nothing fits.
struct FwdPlan {
  int nc, slots, n_sched, bw0, bw1, kp_log2;
  size_t smem;
  long long split_floats;
  int toff[kMaxLayers], kt[kMaxLayers];
};

inline bool fwd_plan_at(const Shape& sh, int nc, FwdPlan* pl) {
  const int nl = sh.n_layers;
  FwdPlan q{};
  q.nc = nc;
  int tiles = 0;
  for (int li = 0; li < nl; ++li) {
    if (!sh.stat && li == 0) continue;
    q.toff[li] = tiles;
    q.kt[li] = round32(sh.width[li]) / kChunkK;
    tiles += q.kt[li] * ((sh.width[li + 1] + nc - 1) / nc);
    int& bw = (li % 2 == 0) ? q.bw0 : q.bw1;
    bw = std::max(bw, row_ld(sh.width[li]));
  }
  q.n_sched = tiles;
  q.split_floats = (long long)tiles * 2 * kChunkK * nc;
  q.kp_log2 = 0;
  while ((1 << q.kp_log2) < sh.k) ++q.kp_log2;
  const size_t cap = (size_t)max_shared_bytes();
  const int dyn_d = sh.stat ? 0 : sh.d;
  size_t off[kFwdParts];
  const int options[3] = {tiles, kRing, 2};  // resident, then rings
  for (int slots : options) {
    if (slots > tiles || (slots < tiles && slots < 2)) continue;
    q.slots = slots;
    q.smem = fwd_smem(nc, slots, tiles, q.bw0, q.bw1, dyn_d, sh.width[1], off);
    if (q.smem <= cap) {
      *pl = q;
      return true;
    }
  }
  return false;
}

// The chunk width: the fewest padded columns over the layers (the wider on
// a tie), the first that fits.
inline FwdPlan fwd_plan(const Shape& sh) {
  int cand[3] = {176, 128, 64};
  int cost[3];
  for (int i = 0; i < 3; ++i) {
    cost[i] = 0;
    for (int li = 0; li < sh.n_layers; ++li)
      cost[i] += (sh.width[li + 1] + cand[i] - 1) / cand[i] * cand[i];
  }
  for (int i = 0; i < 3; ++i)  // by cost, then width (already descending)
    for (int j = i + 1; j < 3; ++j)
      if (cost[j] < cost[i]) {
        std::swap(cost[i], cost[j]);
        std::swap(cand[i], cand[j]);
      }
  FwdPlan pl{};
  for (int i = 0; i < 3; ++i)
    if (fwd_plan_at(sh, cand[i], &pl)) return pl;
  pl.nc = 0;
  return pl;
}

inline SaFwd make_fwd(const Shape& sh, const FwdPlan& pl, const float* split) {
  SaFwd s{};
  s.n_cent = sh.n_cent;
  s.k = sh.k;
  s.kp_log2 = pl.kp_log2;
  s.per_tile = kRows >> pl.kp_log2;
  s.tiles_per_case = (sh.n_cent + s.per_tile - 1) / s.per_tile;
  s.n_tiles = sh.n_cases * s.tiles_per_case;
  s.stat = sh.stat;
  s.f_in = sh.f_in;
  s.d = sh.d;
  s.n_src = sh.n_src;
  s.n_layers = sh.n_layers;
  s.xg = sh.xg;
  s.rel = sh.rel;
  s.mask = sh.mask;
  s.p = sh.p;
  s.idx = sh.idx;
  s.w0r = sh.stat ? nullptr : sh.w[0];
  for (int i = 0; i < sh.n_layers; ++i) {
    s.bias[i] = sh.b ? sh.b[i] : nullptr;
    s.toff[i] = pl.toff[i];
    s.kt[i] = pl.kt[i];
  }
  for (int i = 0; i <= sh.n_layers; ++i) s.width[i] = sh.width[i];
  s.split = split;
  return s;
}

template <int ACT, int NC>
cudaError_t launch_fwd_tiles(const SaFwd& s, const FwdPlan& pl, float* out, signed char* arg,
                             cudaStream_t st, int* per_sm_out) {
  auto kernel = sa_fwd_tiles<ACT, NC>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, pl.smem);
  if (per_sm_out) {
    *per_sm_out = per_sm;
    return cudaGetLastError();
  }
  const int n_pairs = (s.n_tiles + 1) / 2;
  const int blocks = std::max(1, std::min(n_pairs, std::max(per_sm, 1) * sm_count()));
  kernel<<<blocks, kThreads, pl.smem, st>>>(s, pl.slots, pl.n_sched, pl.bw0, pl.bw1, out, arg);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_fwd_act(const SaFwd& s, const FwdPlan& pl, float* out, signed char* arg,
                           cudaStream_t st, int* per_sm_out) {
  switch (pl.nc) {
    case 176:
      return launch_fwd_tiles<ACT, 176>(s, pl, out, arg, st, per_sm_out);
    case 128:
      return launch_fwd_tiles<ACT, 128>(s, pl, out, arg, st, per_sm_out);
    default:
      return launch_fwd_tiles<ACT, 64>(s, pl, out, arg, st, per_sm_out);
  }
}

// The backward's scratch, each region 32-float aligned (base null: sizes
// only), and its launch shapes.
struct BwdLayout {
  SaBwd p;
  Transposes tr;
  Mlp fwd_t, bwd_o;
  TileSums ts;
  float* parts[kMaxLayers];  // hidden layer i >= 1: weight_grad's chunks of dW_i
  int chunks[kMaxLayers];
  float *dwl, *dbl;          // the last layer's chunks of dW and db (sa_bwd_dwl)
  int dwl_chunks;
  long long floats;
  int bw, w_floats, n_sums, w0s_floats, wl_floats, blocks, per_sm;
  size_t tile_smem, prep_smem;
};

// weight_grad_partial's tile along a width: 128 where it pads no more than
// 64 does (176 takes three 64s, not two 128s)
inline int sa_grad_tile(int width) {
  return (width + 127) / 128 * 128 <= (width + 63) / 64 * 64 ? 128 : 64;
}

// chunks of a layer's weight-gradient rows: about two blocks an SM, at
// least 128 rows a chunk
inline int sa_grad_chunks(long long rows, int K, int N) {
  const int tiles = ((N + sa_grad_tile(N) - 1) / sa_grad_tile(N)) *
                    ((K + sa_grad_tile(K) - 1) / sa_grad_tile(K));
  const long long chunks = std::min<long long>((2 * 132 + tiles - 1) / tiles, (rows + 127) / 128);
  return (int)std::max<long long>(chunks, 1);
}

// the tile kernel's blocks an SM at this shared size
template <int ACT, bool HIDDEN>
int bwd_tiles_per_sm(size_t smem) {
  auto kernel = sa_bwd_tiles<ACT, HIDDEN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return per_sm;
}

inline BwdLayout bwd_layout(const Shape& sh, float* base, int* const* winners) {
  BwdLayout l{};
  const int nl = sh.n_layers;
  const int F = sh.width[nl];
  SaBwd& p = l.p;
  p.n_cases = sh.n_cases;
  p.n_cent = sh.n_cent;
  p.k = sh.k;
  p.f = F;
  p.stat = sh.stat;
  p.f_in = sh.f_in;
  p.d = sh.d;
  p.n_src = sh.stat ? 0 : sh.n_src;
  p.n_layers = nl;
  p.rcap = sh.n_cent * std::min(sh.k, F);
  for (int i = 0; i <= nl; ++i) p.width[i] = sh.width[i];
  const long long R = (long long)sh.n_cases * p.rcap;
  // the tile kernel's shared memory and blocks
  l.bw = nl == 1 ? padded(F) : 0;
  for (int i = 1; i <= nl; ++i) l.bw = std::max(l.bw, padded(sh.width[i]));
  l.w_floats = nl > 2 ? kBwdStages * kWTileFloats : 0;
  l.ts.dw0_len = sh.width[0] * sh.width[1] + (sh.stat ? sh.width[1] : 0);
  l.ts.in_smem = 1;
  int n_sums = l.ts.dw0_len;
  for (int i = 1; i < nl - 1; ++i) n_sums += sh.width[i + 1];
  if (n_sums > 4096) {  // too many to keep in shared memory: in the block's slice
    n_sums = 0;
    l.ts.in_smem = 0;
  }
  l.n_sums = n_sums;
  // the first layer's weights in shared memory; the last layer's where two
  // blocks an SM still fit beside them
  l.w0s_floats = sh.width[0] * sh.width[1] + (sh.stat ? sh.width[1] : 0);
  size_t off[kBwdParts];
  const int nw = (F + 31) / 32;
  l.tile_smem = bwd_smem(padded(sh.width[0]), l.bw, l.w_floats, n_sums, l.w0s_floats, 0, nw,
                         sh.n_cases, off);
  if (l.tile_smem > (size_t)max_shared_bytes() && sh.stat) {  // W0 from device memory
    l.w0s_floats = 0;
    l.tile_smem = bwd_smem(padded(sh.width[0]), l.bw, l.w_floats, n_sums, 0, 0, nw,
                           sh.n_cases, off);
  }
  const int wl = (sh.width[nl - 1] + 4) * F;
  if ((nl > 1 || sh.stat) && l.tile_smem + sizeof(float) * wl <= 110 * 1024) {
    l.wl_floats = wl;
    l.tile_smem = bwd_smem(padded(sh.width[0]), l.bw, l.w_floats, n_sums, l.w0s_floats, wl,
                           nw, sh.n_cases, off);
  }
  l.per_sm = l.tile_smem <= (size_t)max_shared_bytes()
                 ? (nl > 2 ? (sh.act == kSilu ? bwd_tiles_per_sm<kSilu, true>(l.tile_smem)
                                              : bwd_tiles_per_sm<kTanh, true>(l.tile_smem))
                           : (sh.act == kSilu ? bwd_tiles_per_sm<kSilu, false>(l.tile_smem)
                                              : bwd_tiles_per_sm<kTanh, false>(l.tile_smem)))
                 : 0;
  l.blocks = (int)std::max<long long>(
      1, std::min<long long>((R + kBwdRows - 1) / kBwdRows,
                             (long long)std::max(l.per_sm, 1) * sm_count()));
  long long at = 0;
  auto take = [&](long long n) {
    float* q = base ? base + at : nullptr;
    at += round32ll(n);
    return q;
  };
  // the hidden layers' weights (from layer 1) transposed for the recompute,
  // and the static W0 where it does not fit the tile's shared memory
  l.tr.n = 0;
  long long tstart = 0;
  const bool w0_out = l.w0s_floats == 0;
  if (w0_out) {
    l.tr.src[0] = sh.w ? sh.w[0] : nullptr;
    l.tr.k_in[0] = sh.width[0];
    l.tr.n_out[0] = sh.width[1];
    l.tr.start[0] = 0;
    l.tr.n = 1;
    tstart = (long long)sh.width[0] * sh.width[1];
  }
  for (int li = 1; li < nl - 1; ++li) {
    const int j = l.tr.n++;
    l.tr.src[j] = sh.w ? sh.w[li] : nullptr;
    l.tr.k_in[j] = sh.width[li];
    l.tr.n_out[j] = sh.width[li + 1];
    l.tr.start[j] = tstart;
    tstart += (long long)sh.width[li] * sh.width[li + 1];
  }
  l.tr.start[l.tr.n] = tstart;
  float* tbase = take(tstart);
  l.fwd_t.n_layers = nl;
  l.bwd_o.n_layers = nl;
  for (int j = 0; j < l.tr.n; ++j) l.tr.dst[j] = tbase ? tbase + l.tr.start[j] : nullptr;
  p.w0t = w0_out ? l.tr.dst[0] : nullptr;
  for (int j = w0_out, li = 1; j < l.tr.n; ++j, ++li)
    l.fwd_t.layer[li] = Layer{l.tr.dst[j], sh.b ? sh.b[li] : nullptr, sh.width[li],
                              sh.width[li + 1], sh.width[li + 1]};
  for (int li = 1; li < nl; ++li)
    l.bwd_o.layer[li] = Layer{sh.w ? sh.w[li] : nullptr, nullptr, sh.width[li + 1],
                              sh.width[li], sh.width[li]};
  const bool own = winners == nullptr;
  p.count = own ? reinterpret_cast<int*>(take(sh.n_cases)) : winners[2];
  p.case_off = reinterpret_cast<int*>(take(sh.n_cases + 1));
  p.rows = own ? reinterpret_cast<int*>(take(R)) : winners[0];
  p.slot = own ? nullptr : winners[1];
  p.cmask = reinterpret_cast<unsigned long long*>(take(2LL * sh.n_cases * sh.n_cent));
  p.cbase = reinterpret_cast<int*>(take((long long)sh.n_cases * sh.n_cent));
  if (!sh.stat) {
    p.perm = reinterpret_cast<int*>(take(R));
    p.seg = reinterpret_cast<int*>(take(2LL * sh.n_cases * sh.n_src));
  }
  // compact rows: the inputs of the layers from 1 on (their dW), the hidden
  // layers' Z where a product sweeps through them, the cotangents
  // weight_grad and dP read; the last layer's gz at each winner
  for (int i = 1; i < nl; ++i) {
    p.lda[i] = round4(sh.width[i]);
    p.a[i] = take(R * p.lda[i]);
  }
  for (int i = 0; i < nl - 1 && nl > 2; ++i) p.z[i] = take(R * sh.width[i + 1]);
  for (int i = 0; i < nl - 1; ++i)
    if (i > 0 || !sh.stat) p.gz[i] = take(R * sh.width[i + 1]);
  if (nl == 1 && !sh.stat) p.gz[0] = take(R * F);
  if (nl > 1) p.gzc = take((long long)sh.n_cases * sh.n_cent * F);
  // the partial sums: weight_grad's and sa_bwd_dwl's chunks, the tile
  // blocks' slices
  for (int i = 1; i < nl - 1; ++i) {
    l.chunks[i] = sa_grad_chunks(R, sh.width[i], sh.width[i + 1]);
    l.parts[i] = take((long long)l.chunks[i] * sh.width[i] * sh.width[i + 1]);
  }
  l.dwl_chunks = (sh.n_cases * sh.n_cent + kDwlCents - 1) / kDwlCents;
  if (nl > 1) {
    l.dwl = take((long long)l.dwl_chunks * sh.width[nl - 1] * F);
    l.dbl = take((long long)l.dwl_chunks * F);
  }
  l.ts.dw0 = take((long long)l.blocks * l.ts.dw0_len);
  for (int i = 1; i < nl - 1; ++i) l.ts.db[i] = take((long long)l.blocks * sh.width[i + 1]);
  l.floats = at;
  const PrepPlan pp = prep_plan(sh.n_cent, p.n_src, (size_t)max_shared_bytes());
  l.prep_smem = pp.smem;
  p.cm_in_smem = pp.cm_in_smem;
  p.src_tile = pp.src_tile;
  return l;
}

// whether the backward's kernels take these shapes
inline bool bwd_fits(const Shape& sh, const BwdLayout& l) {
  const size_t cap = (size_t)max_shared_bytes();
  if (l.tile_smem > cap || l.prep_smem > cap || l.per_sm < 1) return false;
  if (sh.width[sh.n_layers] > 1024) return false;  // a pair packs its channel in 10 bits
  if (sh.width[sh.n_layers - 1] > 32 * kMaxCols) return false;
  return true;
}

template <int ACT, bool HIDDEN>
cudaError_t launch_bwd_tiles(const BwdLayout& l, cudaStream_t st) {
  auto kernel = sa_bwd_tiles<ACT, HIDDEN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.tile_smem);
  kernel<<<l.blocks, kThreads, l.tile_smem, st>>>(l.p, l.fwd_t, l.bwd_o, l.ts, l.bw, l.w_floats,
                                                  l.n_sums, l.w0s_floats, l.wl_floats);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_grad(const float* A, int lda, const float* G, int ldg, int K, int N,
                        int chunks, float* parts, const int* rows, cudaStream_t s) {
  constexpr size_t smem = grad_smem_bytes<BM, BN>();
  auto kernel = weight_grad_partial<-1, BM, BN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, chunks);
  kernel<<<grid, kThreads, smem, s>>>(A, lda, G, ldg, 0, K, N, 0, parts, rows);
  return cudaGetLastError();
}

// C (K x N) partial blocks of A^T G over the first *rows compact rows
cudaError_t grad_partials(const float* A, int lda, const float* G, int ldg, int K, int N,
                          int chunks, float* parts, const int* rows, cudaStream_t s) {
  if (sa_grad_tile(K) == 128)
    return sa_grad_tile(N) == 128
               ? launch_grad<128, 128>(A, lda, G, ldg, K, N, chunks, parts, rows, s)
               : launch_grad<128, 64>(A, lda, G, ldg, K, N, chunks, parts, rows, s);
  return sa_grad_tile(N) == 128
             ? launch_grad<64, 128>(A, lda, G, ldg, K, N, chunks, parts, rows, s)
             : launch_grad<64, 64>(A, lda, G, ldg, K, N, chunks, parts, rows, s);
}

}  // namespace
}  // namespace pct

#define SA_ARGS                                                                             \
  int stat, int act, int n_cases, int n_cent, int k, int f_in, int d, const float *xg,      \
      const float *rel, const unsigned char *mask, const float *p, const long long *idx,    \
      int n_src, int n_layers, const float *const *w, const float *const *b,                \
      const int *widths
#define SA_PASS \
  stat, act, n_cases, n_cent, k, f_in, d, xg, rel, mask, p, idx, n_src, n_layers, w, b, widths

// Scratch floats sa_forward needs (the split weights); -1 if no block fits.
extern "C" long long sa_forward_workspace(SA_ARGS) {
  Shape sh;
  if (!make_shape(sh, SA_PASS)) return -1;
  const FwdPlan pl = fwd_plan(sh);
  return pl.nc ? pl.split_floats : -1;
}

// Forward. stat = 1: xg (n_cases, n_cent * k, f_in); w[0] is layer 0's
// nn.Linear weight (F1, f_in + d), b[0] its bias. stat = 0: P (n_cases,
// n_src, F1) = x W0x + b0, idx (n_cases, n_cent, k), w[0] points at W0r =
// w0[:, f_in:] (rows f_in + d apart), b[0] null. rel (n_cases, n_cent * k,
// d), mask (n_cases, n_cent, k) bytes; layer i >= 1 as nn.Linear's weight
// (widths[i+1], widths[i]) and bias. widths[0] = f_in + d (static) or d. k
// <= 64. scratch holds sa_forward_workspace floats. out (n_cases, n_cent, F)
// and arg (the first maximal valid k, -1 where none). Returns the CUDA
// error code (0 = ok).
extern "C" int sa_forward(SA_ARGS, float* scratch, long long scratch_floats, float* out,
                          signed char* arg, void* stream) {
  Shape sh;
  if (!make_shape(sh, SA_PASS)) return (int)cudaErrorInvalidValue;
  const FwdPlan pl = fwd_plan(sh);
  if (!pl.nc || pl.split_floats > scratch_floats) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.split_floats > 0) {
    SaSplit sp{};
    sp.n_layers = sh.n_layers;
    sp.nc = pl.nc;
    long long at = 0;
    for (int li = 0; li < sh.n_layers; ++li) {
      sp.start[li] = at;
      sp.k[li] = sh.width[li];
      sp.n[li] = sh.width[li + 1];
      sp.kt[li] = pl.kt[li];
      if (!sh.stat && li == 0) continue;  // no tiles
      sp.w[li] = sh.w[li];
      at += (long long)pl.kt[li] * ((sh.width[li + 1] + pl.nc - 1) / pl.nc) * 2 * kChunkK * pl.nc;
    }
    sp.start[sh.n_layers] = at;
    const int blocks = (int)std::min<long long>((at + 255) / 256, 1024);
    sa_fwd_split<<<blocks, 256, 0, st>>>(sp, scratch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const SaFwd s = make_fwd(sh, pl, scratch);
  return (int)(act == kSilu ? launch_fwd_act<kSilu>(s, pl, out, arg, st, nullptr)
                            : launch_fwd_act<kTanh>(s, pl, out, arg, st, nullptr));
}

// Scratch floats sa_backward needs; -1 if its blocks do not fit.
extern "C" long long sa_backward_workspace(SA_ARGS) {
  Shape sh;
  if (!make_shape(sh, SA_PASS)) return -1;
  const BwdLayout l = bwd_layout(sh, nullptr, nullptr);
  return bwd_fits(sh, l) ? l.floats : -1;
}

// Backward of sa_forward (same arguments, w[i] as there). arg and dout
// (n_cases, n_cent, F): the forward's argmax and the pooled cotangent.
// grads[i] receives ((widths[i] + 1) x widths[i+1]): dW_i in (in, out)
// layout, then db_i as its last row (the dynamic layer 0 has none: that row
// is not written). The dynamic variant writes dP (n_cases, n_src, F1) to
// dp. winners (null: not wanted) receives the compaction: rows (n_cases,
// rcap) of c * k + kk ascending, -1 past the count, each channel's slot
// (n_cases, n_cent, F) (-1: none) and the counts (n_cases), rcap = n_cent *
// min(k, F).
extern "C" int sa_backward(SA_ARGS, const signed char* arg, const float* dout, float* scratch,
                           long long scratch_floats, float* const* grads, float* dp,
                           int* const* winners, void* stream) {
  Shape sh;
  if (!make_shape(sh, SA_PASS)) return (int)cudaErrorInvalidValue;
  BwdLayout l = bwd_layout(sh, scratch, winners);
  if (!bwd_fits(sh, l) || l.floats > scratch_floats || (!stat && !dp))
    return (int)cudaErrorInvalidValue;
  const int nl = n_layers;
  SaBwd& q = l.p;
  q.xg = xg;
  q.rel = rel;
  q.p = p;
  q.idx = idx;
  q.arg = arg;
  q.dout = dout;
  for (int i = 0; i < nl; ++i) {
    q.w[i] = w[i];
    q.b[i] = b ? b[i] : nullptr;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 1. compaction, dP's order and the transposes
  const long long n_tr = l.tr.start[l.tr.n];
  const int tr_blocks =
      n_tr ? (int)std::min<long long>((n_tr + kPrepThreads - 1) / kPrepThreads, 64) : 0;
  if (l.prep_smem > 48 * 1024)
    cudaFuncSetAttribute(sa_bwd_prep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)l.prep_smem);
  sa_bwd_prep<<<n_cases + tr_blocks, kPrepThreads, l.prep_smem, st>>>(q, l.tr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 2. the winner rows
  if (nl > 2)
    err = act == kSilu ? launch_bwd_tiles<kSilu, true>(l, st)
                       : launch_bwd_tiles<kTanh, true>(l, st);
  else
    err = act == kSilu ? launch_bwd_tiles<kSilu, false>(l, st)
                       : launch_bwd_tiles<kTanh, false>(l, st);
  if (err != cudaSuccess) return (int)err;
  // 3. dW of the layers from 1 on over the compact rows; every sum's
  // partials added in order: layer 0's dW (and db) and every db over the
  // tile blocks, the other dW over weight_grad's chunks
  PartSums ps{};
  long long total = 0;
  auto add = [&](const float* parts, int n_parts, long long len, float* out) {
    ps.parts[ps.n] = parts;
    ps.n_parts[ps.n] = n_parts;
    ps.out[ps.n] = out;
    ps.start[ps.n++] = total;
    total += len;
  };
  add(l.ts.dw0, l.blocks, l.ts.dw0_len, grads[0]);
  for (int i = 1; i < nl - 1; ++i) {
    const int kk = sh.width[i], nn = sh.width[i + 1];
    err = grad_partials(q.a[i], q.lda[i], q.gz[i], nn, kk, nn, l.chunks[i], l.parts[i],
                        q.case_off + n_cases, st);
    if (err != cudaSuccess) return (int)err;
    add(l.parts[i], l.chunks[i], (long long)kk * nn, grads[i]);
    add(l.ts.db[i], l.blocks, nn, grads[i] + (size_t)kk * nn);
  }
  if (nl > 1) {  // the last layer's, over its winners
    const int kk = sh.width[nl - 1], nn = sh.width[nl];
    sa_bwd_dwl<<<dim3(nn, l.dwl_chunks), std::min(kThreads, (kk + 31) / 32 * 32), 0, st>>>(
        q, l.dwl, l.dbl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    add(l.dwl, l.dwl_chunks, (long long)kk * nn, grads[nl - 1]);
    add(l.dbl, l.dwl_chunks, nn, grads[nl - 1] + (size_t)kk * nn);
  }
  ps.start[ps.n] = total;
  sum_layer_parts<<<(int)((total * kSumLanes + 255) / 256), 256, 0, st>>>(ps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. dP
  if (!stat) {
    const long long n_dp = (long long)n_cases * n_src * sh.width[1];
    sa_bwd_dp<<<(int)((n_dp + 255) / 256), 256, 0, st>>>(q, dp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The kernels' blocks at these shapes: out = {the forward's chunk width,
// its weight tiles in shared memory (all of a step's when equal to the
// next), a step's tiles, its shared bytes, its blocks an SM; the backward
// tiles' shared bytes and blocks an SM; the compaction's shared bytes}.
extern "C" int sa_blocks(SA_ARGS, int* out) {
  Shape sh;
  if (!make_shape(sh, SA_PASS)) return (int)cudaErrorInvalidValue;
  const FwdPlan pl = fwd_plan(sh);
  const BwdLayout l = bwd_layout(sh, nullptr, nullptr);
  if (!pl.nc || !bwd_fits(sh, l)) return (int)cudaErrorInvalidValue;
  int fwd_sm = 0;
  const SaFwd s = make_fwd(sh, pl, nullptr);
  const cudaError_t err =
      act == kSilu ? launch_fwd_act<kSilu>(s, pl, nullptr, nullptr, nullptr, &fwd_sm)
                   : launch_fwd_act<kTanh>(s, pl, nullptr, nullptr, nullptr, &fwd_sm);
  out[0] = pl.nc;
  out[1] = pl.slots;
  out[2] = pl.n_sched;
  out[3] = (int)pl.smem;
  out[4] = fwd_sm;
  out[5] = (int)l.tile_smem;
  out[6] = l.per_sm;
  out[7] = (int)l.prep_smem;
  return (int)err;
}
