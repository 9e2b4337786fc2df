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

// acc[i][j] = sum_k A[(i * 8 + p) * lda + k] * W[k][n0 + first_col() + j]
// (with ACC, that sum is added to acc). A is a shared-memory tile whose
// columns [k, round4(k)) are zero. Every thread of the block must call it;
// it starts and ends with a barrier, so A may be written just before the
// call and the tiles reused just after.
template <int RM, bool ACC = false>
__device__ __forceinline__ void block_gemm(float (&acc)[RM][4], const float* A, int lda,
                                           const Layer& L, int n0, float* w_tiles) {
  const int p = row_slot();
  const int col = first_col();
  if (!ACC) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

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

// ---------------------------------------------------------------------------
// Backward pieces

// value and first three derivatives of the activation (the TPU kernel's
// _silu_rules3 / _tanh_rules3, decoder_pallas.py:46-59)
template <int ACT>
__device__ __forceinline__ void act_rules3(float z, float& d1, float& d2, float& d3) {
  if (ACT == kSilu) {
    const float s = 1.f / (1.f + expf(-z));
    const float s1 = s * (1.f - s);
    const float s2 = s1 * (1.f - 2.f * s);
    const float s3 = s2 * (1.f - 2.f * s) - 2.f * s1 * s1;
    d1 = s + z * s1;
    d2 = 2.f * s1 + z * s2;
    d3 = 3.f * s2 + z * s3;
  } else {
    const float t = tanhf(z);
    d1 = 1.f - t * t;
    d2 = -2.f * t * d1;
    d3 = -2.f * d1 * d1 - 2.f * t * d2;
  }
}

template <int ACT>
__device__ __forceinline__ float act_d1(float z) {
  float d1, d2, d3;
  act_rules3<ACT>(z, d1, d2, d3);
  return d1;
}

// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// dropout masks; ops/dropout.py computes the same function in torch.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Inverted dropout after the activation of layer i, where on[i] is set. The
// keep bit of (layer, case, merged row, column) is output column % 4 of
// philox(counter (column / 4, row, case, layer), key (k0, k1)), compared with
// the threshold as an UNSIGNED integer (a signed compare turns rate 0.05
// into about 55% dropped).
struct Dropout {
  unsigned k0, k1;
  unsigned thresh[kMaxLayers];
  float scale[kMaxLayers];
  int on[kMaxLayers];
};

inline Dropout make_dropout(unsigned k0, unsigned k1, int n_layers, const unsigned* thresh,
                            const float* scale, const int* on) {
  Dropout d{};
  d.k0 = k0;
  d.k1 = k1;
  for (int i = 0; i < n_layers && i < kMaxLayers; ++i) {
    d.thresh[i] = thresh ? thresh[i] : 0u;
    d.scale[i] = scale ? scale[i] : 1.f;
    d.on[i] = on ? on[i] : 0;
  }
  return d;
}

// the factors (0 or 1 / keep) of columns 4 * col4 .. 4 * col4 + 3 of one
// merged row; all 1 where layer i has no dropout
__device__ __forceinline__ void keep4(const Dropout& dr, int layer, int case_, int row,
                                      int col4, float (&m)[4]) {
  if (!dr.on[layer]) {
    m[0] = m[1] = m[2] = m[3] = 1.f;
    return;
  }
  const uint4 r = philox4x32_10(make_uint4((unsigned)col4, (unsigned)row, (unsigned)case_,
                                           (unsigned)layer),
                                dr.k0, dr.k1);
  const unsigned t = dr.thresh[layer];
  const float s = dr.scale[layer];
  m[0] = r.x < t ? s : 0.f;
  m[1] = r.y < t ? s : 0.f;
  m[2] = r.z < t ? s : 0.f;
  m[3] = r.w < t ? s : 0.f;
}

// Weight gradient C (K x N) = sum over rows r of A[r][k] G[r][n], the
// contraction over all rows that Hopper's parallel blocks cannot carry across
// the grid as the TPU does. Each block computes one 64 x 64 tile of C over
// one chunk of rows into parts[chunk]; sum_partials then adds the chunks in
// order, so the result does not depend on the schedule. 256 threads, each
// with a 4 x 4 register tile; 16 rows of A and G staged per step.
// A_ACT >= 0 applies that activation to A as it is loaded (A holds
// pre-activations).
constexpr int kGradTile = 64;
constexpr int kGradRows = 16;

template <int A_ACT>
__global__ void __launch_bounds__(256)
    weight_grad_partial(const float* __restrict__ A, int lda, const float* __restrict__ G,
                        int ldg, int rows, int K, int N, int rows_per_chunk,
                        float* __restrict__ parts) {
  __shared__ __align__(16) float As[kGradRows][kGradTile];
  __shared__ __align__(16) float Gs[kGradRows][kGradTile];
  const int n0 = blockIdx.x * kGradTile;
  const int k0 = blockIdx.y * kGradTile;
  const int chunk = blockIdx.z;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);
  const int tk = threadIdx.x >> 4;
  const int tn = threadIdx.x & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kGradRows) {
    for (int e = threadIdx.x; e < kGradRows * kGradTile; e += 256) {
      const int rr = e / kGradTile;
      const int c = e % kGradTile;
      const int r = r0 + rr;
      float a = 0.f, g = 0.f;
      if (r < r_end) {
        if (k0 + c < K) {
          a = A[(size_t)r * lda + k0 + c];
          if constexpr (A_ACT >= 0) a = act_value<A_ACT>(a);
        }
        if (n0 + c < N) g = G[(size_t)r * ldg + n0 + c];
      }
      As[rr][c] = a;
      Gs[rr][c] = g;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kGradRows; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&As[rr][tk * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&Gs[rr][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < N) parts[((size_t)chunk * K + k) * N + n] = acc[i][j];
    }
  }
}

// out[j] += sum over p < n_parts of parts[p * len + j], in order of p
__global__ void sum_partials(const float* __restrict__ parts, int n_parts, int len,
                            float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += parts[(size_t)p * len + j];
  out[j] += s;
}

// Column sums of the value rows in groups: out[g][n] (+)= sum over value
// rows p in [g * per_group, min((g + 1) * per_group, n_rows)) of
// G[p * stride][n] (stride = rows per point, so only value rows count).
// Block (32 columns, 8 row lanes), the lanes added in a fixed order.
__global__ void group_colsum(const float* __restrict__ G, int ldg, int stride, int per_group,
                             int n_rows, int N, float* __restrict__ out, int accumulate) {
  __shared__ float red[8][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int g = blockIdx.y;
  const int p_end = min(n_rows, (g + 1) * per_group);
  float s = 0.f;
  if (n < N)
    for (int p = g * per_group + threadIdx.y; p < p_end; p += 8)
      s += G[(size_t)p * stride * ldg + n];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float t = 0.f;
    for (int y = 0; y < 8; ++y) t += red[y][threadIdx.x];
    float* o = out + (size_t)g * N + n;
    *o = accumulate ? *o + t : t;
  }
}

inline int grad_chunks(int rows, int K, int N) {
  const int tiles = ((N + kGradTile - 1) / kGradTile) * ((K + kGradTile - 1) / kGradTile);
  int chunks = (4 * 132 + tiles - 1) / tiles;  // about 4 blocks per SM
  const int most = (rows + 511) / 512;        // at least 512 rows a chunk
  if (chunks > most) chunks = most;
  return chunks < 1 ? 1 : chunks;
}

inline size_t grad_scratch_floats(int rows, int K, int N) {
  return (size_t)grad_chunks(rows, K, N) * K * N;
}

// out (K x N) += A^T G over all rows; scratch holds grad_scratch_floats
template <int A_ACT>
cudaError_t weight_grad(const float* A, int lda, const float* G, int ldg, int rows, int K,
                        int N, float* scratch, float* out, cudaStream_t s) {
  if (rows < 1) return cudaSuccess;
  const int chunks = grad_chunks(rows, K, N);
  int per = (rows + chunks - 1) / chunks;
  per = (per + kGradRows - 1) / kGradRows * kGradRows;
  const dim3 grid((N + kGradTile - 1) / kGradTile, (K + kGradTile - 1) / kGradTile, chunks);
  weight_grad_partial<A_ACT><<<grid, 256, 0, s>>>(A, lda, G, ldg, rows, K, N, per, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int len = K * N;
  sum_partials<<<(len + 255) / 256, 256, 0, s>>>(scratch, chunks, len, out);
  return cudaGetLastError();
}

// out (N) += column sums of the value rows of G (n_rows value rows, stride
// rows apart); scratch holds ceil(n_rows / 256) * N floats
inline cudaError_t value_colsum(const float* G, int ldg, int stride, int n_rows, int N,
                                float* scratch, float* out, cudaStream_t s) {
  const int per = 256;
  const int groups = (n_rows + per - 1) / per;
  group_colsum<<<dim3((N + 31) / 32, groups), dim3(32, 8), 0, s>>>(G, ldg, stride, per, n_rows,
                                                                   N, scratch, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<<<(N + 255) / 256, 256, 0, s>>>(scratch, groups, N, out);
  return cudaGetLastError();
}

inline size_t colsum_scratch_floats(int n_rows, int N) {
  return (size_t)((n_rows + 255) / 256) * N;
}

}  // namespace pct
