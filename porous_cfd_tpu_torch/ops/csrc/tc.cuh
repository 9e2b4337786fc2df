// Hopper's f32-accurate tensor-core pieces shared by the row kernels of
// mlp_prop.cuh (the (v, J, H) engine) and pointnet_global.cu: weights split
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

// copy one split tile into a ring slot; completes the slot's barrier phase
__device__ __forceinline__ void ring_load(float* slot, const float* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(kSplitBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(slot)),
      "l"(src), "r"(kSplitBytes), "r"(smem_addr(bar))
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

}  // namespace
}  // namespace pct
