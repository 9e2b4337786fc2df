// Hopper's f32-accurate tensor-core pieces shared by the row kernels of
// mlp_prop.cuh (the (v, J, H) engine), pointnet_global.cu and
// sa_neighborhood.cu: weights split
// once per launch into their big and small TF32 parts and laid out as ready
// K-major tiles (split_weights), a ring of those tiles in shared memory fed
// by one thread's bulk copies (cp.async.bulk, the TMA) and tracked by
// mbarriers, and the warpgroup product wgmma.m64n128k8 in TF32 with A from
// registers and B from a ring slot. common.cuh's head explains 3xTF32.
#pragma once

#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace pct {
namespace {

// the weight ring: kRing slots, each the big and the small TF32 part of a
// kChunkK x kChunkN weight tile in wgmma's K-major core-matrix layout
constexpr int kRing = 3;
constexpr int kWTile = kChunkK * kChunkN;
constexpr int kRingFloats = kRing * 2 * kWTile + 2 * kRing;  // tiles, then the barriers

__host__ __device__ inline int round8(int k) { return (k + 7) & ~7; }

// Row stride of a row buffer holding k values: a multiple of 8 plus 4, so
// the 8 rows of an A fragment start in distinct 4-bank groups, and columns
// [k, round8(k)) exist to be zeroed (the products step 8 deep).
__host__ __device__ inline int row_ld(int k) { return round8(k) + 4; }

// the thread's lane group g = lane / 4 (its row in the mma fragments)
__device__ __forceinline__ int lane_group() { return (threadIdx.x & 31) >> 2; }

// ---------------------------------------------------------------------------
// The weights, split once per launch (split_weights) into their big and
// small TF32 parts and laid out as the ring's tiles: for layer i, output
// columns padded to np (a multiple of 128) and input rows to kp (a multiple
// of 32, zeros past the layer), tile (n / 128, kpos / 32) is 2 x 4096
// floats, the big part then the small, each in wgmma's K-major core-matrix
// order: core matrix (n % 128 / 8, kpos % 32 / 4) of 8 rows x 4 floats. So
// one bulk copy (cp.async.bulk, the TMA's one-dimensional form) brings a
// tile, issued by one thread. Layer 0 of a context-column launch keeps its
// lv local rows at kpos [0, round32(lv)) and its context rows from
// round32(lv), so every context chunk starts on a tile boundary.
__host__ __device__ inline int round32(int k) { return (k + 31) & ~31; }
__host__ __device__ inline int round128(int k) { return (k + 127) & ~127; }

// floats of one split tile (big and small parts), and its bytes
constexpr int kSplitTile = 2 * kWTile;
constexpr int kSplitBytes = kSplitTile * 4;

struct Split {
  const float* base;
  long long off[kMaxLayers + 1];   // floats: layer i's tiles from off[i]
  int kp[kMaxLayers];              // input rows, padded
  int np[kMaxLayers];              // output columns, padded
};

// one layer's split weights, as the product reads them
struct SplitW {
  const float* tiles;
  int n;                           // valid output columns
  int k_tiles;                     // kp / 32
};

__device__ __forceinline__ SplitW split_layer(const Split& sp, int li, int n) {
  return {sp.base + sp.off[li], n, sp.kp[li] / kChunkK};
}

// kp of layer i (k rows, lv of them local when i == 0 and lv < k)
inline int split_kp(int i, int k, int lv) {
  return (i == 0 && lv < k) ? round32(lv) + round32(k - lv) : round32(k);
}

// B(k, n) = m.layer[i].w[k * ldw + n] for every layer, split into out as
// Split describes; grid-stride over all layers' floats
__global__ void split_weights(Mlp m, Split sp, int lv, float* __restrict__ out) {
  const long long total = sp.off[m.n_layers];
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    int li = 0;
    while (li + 1 < m.n_layers && e >= sp.off[li + 1]) ++li;
    const Layer L = m.layer[li];
    const int local = (int)(e - sp.off[li]);   // a layer's block fits in 32 bits
    const int tile = local / kSplitTile;
    const int within = local - tile * kSplitTile;
    const bool small = within >= kWTile;
    const int idx = within & (kWTile - 1);
    const int core = idx >> 5;                 // (n / 8, k / 4) in the tile
    const int k_tiles = sp.kp[li] / kChunkK;
    const int n = (tile / k_tiles) * kChunkN + ((core >> 3) << 3) + ((idx >> 2) & 7);
    const int kpos = (tile % k_tiles) * kChunkK + ((core & 7) << 2) + (idx & 3);
    int k = kpos;
    if (li == 0 && lv < L.k) {
      const int l32 = round32(lv);
      k = kpos < l32 ? (kpos < lv ? kpos : -1) : lv + (kpos - l32);
    }
    const float v = (k >= 0 && k < L.k && n < L.n) ? L.w[(size_t)k * L.ldw + n] : 0.f;
    const float big = __uint_as_float(to_tf32(v));
    out[e] = small ? __uint_as_float(to_tf32(v - big)) : big;
  }
}

// the Split of a launch's layers over `base` (null: sizes only); returns
// the floats it takes
inline long long make_split(const Mlp& m, int lv, const float* base, Split* sp) {
  long long off = 0;
  for (int i = 0; i < m.n_layers; ++i) {
    sp->off[i] = off;
    sp->kp[i] = split_kp(i, m.layer[i].k, lv);
    sp->np[i] = round128(m.layer[i].n);
    off += 2LL * sp->kp[i] * sp->np[i];
  }
  sp->off[m.n_layers] = off;
  sp->base = base;
  return off;
}

inline cudaError_t launch_split(const Mlp& m, const Split& sp, int lv, float* out,
                                cudaStream_t s) {
  const long long total = sp.off[m.n_layers];
  const int blocks = (int)std::min<long long>((total + 255) / 256, 1024);
  split_weights<<<blocks, 256, 0, s>>>(m, sp, lv, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The ring's bulk copies: one mbarrier a slot, armed with the tile's bytes
// by the thread that issues the copy; the consumers wait on its phase.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_init(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// copy one split tile (bytes: a multiple of 16) into a ring slot; completes
// the slot's barrier phase
__device__ __forceinline__ void ring_load(float* slot, const float* src, uint64_t* bar,
                                          unsigned bytes = kSplitBytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(slot)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ring_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma, m64n128k8, TF32, A from registers, B from
// shared memory)

// shared-memory matrix descriptor of a K-major tile without swizzling:
// core matrices of 8 rows x 16 bytes, 128 bytes apart along K (LBO) and
// 1024 bytes apart along N (SBO)
__device__ __forceinline__ uint64_t tile_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching the accumulators while products run
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 of the warpgroup) += a (registers) b (descriptor)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 64 of the warpgroup) += a (registers) b (descriptor)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const unsigned (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The ring's state across the products of a block: `seq` counts the tiles
// it has taken, so tile j sits in slot j % kRing at barrier phase
// (j / kRing) & 1.
struct Ring {
  float* tiles;
  uint64_t* bars;
  unsigned seq;
};

// ---------------------------------------------------------------------------
// Pieces of the max-pooling kernels (pointnet_global.cu, sa_neighborhood.cu):
// the pooling's (value, row) keys, the fast activations of the forward's
// epilogues, a block scan, the backward's 16-row 3xTF32 mma.sync product,
// the in-order sum of weight-gradient chunks and the weight transposes.

constexpr unsigned kFullMask = 0xffffffffu;

// (value, row) as one key whose unsigned order is the pooling's: a larger
// value, then a lower row. The value's bits are mapped to an order-preserving
// unsigned (negative values flipped); 0 is below every key ("no row yet").
__device__ __forceinline__ unsigned long long pack_key(float v, int row) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)~row;
}
__device__ __forceinline__ float key_value(unsigned long long k) {
  unsigned u = (unsigned)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}
__device__ __forceinline__ int key_row(unsigned long long k) { return (int)~(unsigned)k; }

// The activation in the forward's epilogues, from the fast exponential and
// division (a few ulp of f32, against the 1e-4 relative tolerance the kernel
// is held to): the IEEE expf, division and tanhf cost more than the
// products here.
template <int ACT>
__device__ __forceinline__ float act_fast(float z) {
  if (ACT == kSilu) return __fdividef(z, 1.f + __expf(-z));
  return 1.f - __fdividef(2.f, __expf(2.f * z) + 1.f);
}

// exclusive prefix sum of v over the block (W warps); *total gets the sum.
// ws holds W + 1 ints.
template <int W>
__device__ __forceinline__ int block_exclusive_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < W; ++w) {
      const int t = ws[w];
      ws[w] = s;
      s += t;
    }
    ws[W] = s;
  }
  __syncthreads();
  *total = ws[W];
  return ws[warp] + x - v;
}

constexpr int kBwdStages = 3;  // weight tiles in flight in block_mma16

// acc[j][q] = sum over k of A[g + 8 (q >> 1)][k] W[k][n0 + 16 w + 8 j + 2 t +
// (q & 1)] for the block's 16 rows (w = warp, g = lane / 4, t = lane % 4): a
// 16 x 128 chunk of one dense layer in 3xTF32 mma.sync (m16n8k8), each warp
// on 16 columns. A is a shared-memory tile whose columns [k, round8(k)) are
// zero; W, (in, out) row-major, streams through kBwdStages 32 x 128 shared
// tiles by cp.async, the next ones' copies in flight while one is used. Every thread of the block must call it; it
// starts and ends with a barrier.
__device__ __forceinline__ void block_mma16(float (&acc)[2][4], const float* A, int lda,
                                            const Layer& L, int n0, float* w_tiles) {
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  float part[2][2][4];  // the a_big b_small and a_small b_big products
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = part[0][j][q] = part[1][j][q] = 0.f;
  const int n_tiles = (L.k + kChunkK - 1) / kChunkK;
  const int k_end = round8(L.k);
  // 16-byte copies where the rows allow (rows and columns past the layer
  // read 0); one commit group a tile, empty past the last
  auto load = [&](int tt) {
    if (tt < n_tiles)
      load_tile_async<kChunkK, kChunkN>(w_tiles + (tt % kBwdStages) * kWTileFloats, kChunkN,
                                        L.w, L.ldw, tt * kChunkK, L.k, n0, L.n);
    cp_async_commit();
  };
  for (int tt = 0; tt < kBwdStages - 1; ++tt) load(tt);
  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();  // tile tt and A are complete and visible; tile tt - 1's slot is free
    load(tt + kBwdStages - 1);
    const float* w = w_tiles + (tt % kBwdStages) * kWTileFloats + 16 * warp + g;
    const float* a = A + g * lda + tt * kChunkK + t;
    const int kk_end = min(kChunkK, k_end - tt * kChunkK);
    // the tile's four 8-deep steps: every fragment first (steps past the
    // layer's depth read 0), then the products, each of the three into an
    // accumulator of its own so that they do not wait on one another
    unsigned ab[4][4], as[4][4], bb[4][2][2], bs[4][2][2];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const int kk = 8 * st;
      const bool in = kk < kk_end;
      split_tf32(in ? a[kk] : 0.f, ab[st][0], as[st][0]);
      split_tf32(in ? a[8 * lda + kk] : 0.f, ab[st][1], as[st][1]);
      split_tf32(in ? a[kk + 4] : 0.f, ab[st][2], as[st][2]);
      split_tf32(in ? a[8 * lda + kk + 4] : 0.f, ab[st][3], as[st][3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        split_tf32(in ? w[(kk + t) * kChunkN + 8 * j] : 0.f, bb[st][j][0], bs[st][j][0]);
        split_tf32(in ? w[(kk + t + 4) * kChunkN + 8 * j] : 0.f, bb[st][j][1], bs[st][j][1]);
      }
    }
#pragma unroll
    for (int st = 0; st < 4; ++st)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_tf32(part[0][j], ab[st], bs[st][j][0], bs[st][j][1]);
        mma_tf32(part[1][j], as[st], bb[st][j][0], bb[st][j][1]);
        mma_tf32(acc[j], ab[st], bb[st][j][0], bb[st][j][1]);
      }
    __syncthreads();  // everyone is done with tile tt before it is refilled
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] += part[0][j][q] + part[1][j][q];
}

// out[l] = the sum of the n_parts[l] partial blocks of sum l, in order
// (up to two sums a layer: its weight and its bias)
constexpr int kMaxSums = 2 * kMaxLayers;
struct PartSums {
  const float* parts[kMaxSums];
  float* out[kMaxSums];
  int n_parts[kMaxSums];
  long long start[kMaxSums + 1];
  int n;
};

// eight lanes an element: lane i adds the parts i, i + 8, ... in order, then
// a fixed shuffle tree adds the eight (launch kSumLanes * elements threads)
constexpr int kSumLanes = 8;
__global__ void sum_layer_parts(PartSums ps) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kSumLanes;
  const int i = threadIdx.x % kSumLanes;
  const bool in = j < ps.start[ps.n];
  float s = 0.f;
  int l = 0;
  long long o = 0;
  if (in) {
    while (j >= ps.start[l + 1]) ++l;
    o = j - ps.start[l];
    const long long len = ps.start[l + 1] - ps.start[l];
    for (int q = i; q < ps.n_parts[l]; q += kSumLanes) s += ps.parts[l][q * len + o];
  }
#pragma unroll
  for (int off = 1; off < kSumLanes; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (in && i == 0) ps.out[l][o] = s;
}

// Every layer's nn.Linear weight (out, in) into the (in, out) layout the
// products read, in one launch
struct Transposes {
  const float* src[kMaxLayers];
  float* dst[kMaxLayers];
  int n_out[kMaxLayers];
  int k_in[kMaxLayers];
  long long start[kMaxLayers + 1];
  int n;
};

__device__ __forceinline__ void transpose_blocks(const Transposes& tr, int block, int n_blocks) {
  const long long total = tr.start[tr.n];
  for (long long j = (long long)block * blockDim.x + threadIdx.x; j < total;
       j += (long long)n_blocks * blockDim.x) {
    int l = 0;
    while (j >= tr.start[l + 1]) ++l;
    const long long o = j - tr.start[l];
    const int k = (int)(o / tr.n_out[l]);
    const int n = (int)(o % tr.n_out[l]);
    tr.dst[l][o] = tr.src[l][(size_t)n * tr.k_in[l] + k];
  }
}

// n rounded up to a multiple of 32 (scratch regions 128-byte aligned)
inline long long round32ll(long long n) { return (n + 31) & ~31LL; }

// the transposed weights of n_layers layers over base (null: sizes only);
// returns the floats they take
inline long long make_transposes(int n_layers, const float* const* w, const int* widths,
                                 float* base, Transposes* tr) {
  long long off = 0;
  tr->n = n_layers;
  for (int i = 0; i < n_layers; ++i) {
    tr->src[i] = w ? w[i] : nullptr;
    tr->dst[i] = base ? base + off : nullptr;
    tr->k_in[i] = widths[i];
    tr->n_out[i] = widths[i + 1];
    tr->start[i] = off;
    off += (long long)widths[i] * widths[i + 1];
  }
  tr->start[n_layers] = off;
  return off;
}

}  // namespace
}  // namespace pct
