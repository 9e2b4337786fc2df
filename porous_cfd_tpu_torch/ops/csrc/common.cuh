// Shared pieces of the hand-written Hopper kernels: the layer table passed by
// value to a kernel, the activation rules, and one block-level f32 GEMM on the
// CUDA cores that every dense layer of the port's kernels goes through.
//
// block_gemm computes a (rows x 128) output chunk of one dense layer for a
// block of 8 warps. Thread layout (the SIMT layout of CUTLASS's warp-level
// GEMM): warp = (wr, wc) in 2 x 4, lane = (lr, lc) in 4 x 8. A thread owns
// the rows i * 8 + p, p = wr * 4 + lr (i < RM), and the 4 adjacent columns
// wc * 32 + lc * 4 + j of the chunk, so its RM x 4 accumulators stay in
// registers. Per step of 4 k it reads RM float4 of the activation tile (4
// distinct rows per warp, in distinct banks thanks to a padded row stride)
// and 4 float4 of the weight tile (8 distinct addresses per warp): about one
// shared-memory wavefront per 2 FMA instructions, so the FMA pipe and not
// shared memory is the limit. Weights, given as (in, out) row-major, stream
// through two 32 x 128 shared-memory tiles: cp.async fills the next tile
// while the current one is used.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace pct {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkN = 128;                 // output columns per pass
constexpr int kChunkK = 32;                  // depth of one weight tile
constexpr int kWTileFloats = kChunkK * kChunkN;
constexpr int kMaxLayers = 8;

enum Act { kSilu = 0, kTanh = 1 };

// One dense layer y = x W + b with W given transposed from nn.Linear, i.e.
// (in, out) row-major with row stride ldw (= n).
struct Layer {
  const float* w;
  const float* b;
  int k;
  int n;
  int ldw;
};

struct Mlp {
  Layer layer[kMaxLayers];
  int n_layers;
};

__host__ __device__ inline int round4(int k) { return (k + 3) & ~3; }

// Row stride in shared memory of a tile row holding k values: a multiple of
// 4 (float4 reads) plus 4, so rows i and i + 1 start 4 banks apart.
__host__ __device__ inline int padded(int k) { return round4(k) + 4; }

inline Mlp make_mlp(int n_layers, const float* const* w, const float* const* b,
                    const int* widths) {
  Mlp m{};
  m.n_layers = n_layers;
  for (int i = 0; i < n_layers && i < kMaxLayers; ++i) {
    m.layer[i].w = w[i];
    m.layer[i].b = b[i];
    m.layer[i].k = widths[i];
    m.layer[i].n = widths[i + 1];
    m.layer[i].ldw = widths[i + 1];
  }
  return m;
}

// Layer i reads its input tile from buffer i % 2, so each buffer's row
// stride is the largest padded input width it ever holds.
inline void buffer_widths(const Mlp& m, int* w0, int* w1) {
  *w0 = 0;
  *w1 = 0;
  for (int i = 0; i < m.n_layers; ++i) {
    int* w = (i % 2 == 0) ? w0 : w1;
    if (padded(m.layer[i].k) > *w) *w = padded(m.layer[i].k);
  }
}

template <int ACT>
__device__ __forceinline__ float act_value(float z) {
  if (ACT == kSilu) return z * (1.f / (1.f + expf(-z)));
  return tanhf(z);
}

// value, first and second derivative of the activation (the silu rules are
// physics/analytic.py's silu_rules, written out)
template <int ACT>
__device__ __forceinline__ void act_rules(float z, float& val, float& d1, float& d2) {
  if (ACT == kSilu) {
    const float s = 1.f / (1.f + expf(-z));
    const float ds = s * (1.f - s);
    val = z * s;
    d1 = s + z * ds;
    d2 = 2.f * ds + z * ds * (1.f - 2.f * s);
  } else {
    const float t = tanhf(z);
    val = t;
    d1 = 1.f - t * t;
    d2 = -2.f * t * d1;
  }
}

// this thread's row slot p (rows i * 8 + p) and first column in a chunk
__device__ __forceinline__ int row_slot() {
  return ((threadIdx.x >> 7) << 2) + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int first_col() {
  return (((threadIdx.x >> 5) & 3) << 5) + ((threadIdx.x & 7) << 2);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;  // 0: nothing is read, the word is zeroed
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start copying W[k0 : k0 + 32, n0 : n0 + 128] into a tile; rows and columns
// past the layer read as 0 (consecutive threads copy consecutive columns)
__device__ __forceinline__ void load_w_tile(const Layer& L, int k0, int n0, float* tile) {
  for (int e = threadIdx.x; e < kWTileFloats; e += kThreads) {
    const int k = k0 + e / kChunkN;
    const int n = n0 + e % kChunkN;
    const bool valid = k < L.k && n < L.n;
    cp_async4(tile + e, valid ? L.w + (size_t)k * L.ldw + n : L.w, valid);
  }
  cp_async_commit();
}

// acc[i][j] = sum_k A[(i * 8 + p) * lda + k] * W[k][n0 + first_col() + j].
// A is a shared-memory tile whose columns [k, round4(k)) are zero. Every
// thread of the block must call it; it starts and ends with a barrier, so A
// may be written just before the call and the tiles reused just after.
template <int RM>
__device__ __forceinline__ void block_gemm(float (&acc)[RM][4], const float* A, int lda,
                                           const Layer& L, int n0, float* w_tiles) {
  const int p = row_slot();
  const int col = first_col();
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_tiles = (L.k + kChunkK - 1) / kChunkK;
  const int k_end = round4(L.k);
  load_w_tile(L, 0, n0, w_tiles);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_w_tile(L, (t + 1) * kChunkK, n0, w_tiles + ((t + 1) & 1) * kWTileFloats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t and A are complete and visible
    const float* w = w_tiles + (t & 1) * kWTileFloats + col;
    const float* a_row = A + p * lda + t * kChunkK;
    const int kk_end = min(kChunkK, k_end - t * kChunkK);
    for (int kk = 0; kk < kk_end; kk += 4) {
      float4 wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(w + (kk + q) * kChunkN);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(a_row + i * kWarps * lda + kk);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(av[q], wv[q].x, acc[i][0]);
          acc[i][1] = fmaf(av[q], wv[q].y, acc[i][1]);
          acc[i][2] = fmaf(av[q], wv[q].z, acc[i][2]);
          acc[i][3] = fmaf(av[q], wv[q].w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // everyone is done with tile t before it is refilled
  }
}

inline int max_shared_bytes() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

}  // namespace pct
