// Shared pieces of the hand-written Hopper kernels: the layer table passed by
// value to a kernel, the activation rules, the dropout generator, the
// f32-accurate tensor-core primitives (3xTF32) and the weight-gradient
// contraction built on them.
//
// 3xTF32. The H100's TF32 tensor cores (494.7 TFLOP/s dense on the SXM
// part) keep 10 mantissa bits of each operand, about 3 decimal digits: one
// pass misses the port's 1e-4 * max|ref| gate at the widths of its layers
// (tests/test_torch_tf32_split.py shows it). Each operand x is split into
// big = tf32(x) and small = tf32(x - big), which together hold 22 of f32's
// 24 bits, and a b accumulates in f32 as a_big b_small + a_small b_big +
// a_big b_big (CUTLASS's OpMultiplyAddFastF32; a_small b_small, about 2^-22
// of a b, is dropped): three TF32 products, 494.7 / 3 = 164.9 TFLOP/s of
// f32-accurate work at the data sheet's rate, against 67 TFLOP/s of f32
// FMA. The rounding is two integer operations (to_tf32). On the H100
// (tools/tc_ceiling.py) mma.sync.m16n8k8 reaches about 322 TFLOP/s of TF32
// and wgmma about 487, so the engine's row kernels (mlp_prop.cuh) use
// wgmma and weight_grad, below, mma.sync.
//
// weight_grad replaces the contraction over rows that the TPU kernels carry
// in scratch across their sequential grid (decoder_pallas.py:_bwd_kernel,
// neural_op_pallas.py:_bwd_kernel, pointnet_pallas.py:_bwd_kernel): dW = A^T
// GZ over all rows, half of every backward's FLOP. On the H100 operations
// and bytes bound it nearly alike: at pipn's internal decoder launch
// (97,500 rows through 64 -> 512 -> 256 -> 128 -> 3) it does 38.4 GFLOP on
// 0.73 GB of stash, 0.23 ms at 164.9 TFLOP/s against 0.22 ms at 3.35 TB/s.
// Design: a block computes a BM x BN tile of dW (BM, BN in {64, 128} by the
// widths) over one chunk of rows with 8 warps of 3xTF32 mma.sync (a warp
// tile of BM/2 x BN/4, the three passes issued pass by pass over all its
// tiles), A and GZ staged 32 rows at a time in a 3-stage cp.async ring (one
// barrier per stage; 104 KB of shared memory and 183 registers a thread at
// 128 x 128: one block per SM). wgmma would want GZ K-major, i.e.
// transposed in shared memory: later work. The
// activation of a pre-activation operand (A_ACT) is applied in shared
// memory by the thread that copied each word, before the stage's barrier.
// Each chunk writes its own partial tile and sum_partials adds the chunks
// in order: no atomics, and the result does not depend on the schedule.
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
    m.layer[i].w = w ? w[i] : nullptr;
    m.layer[i].b = b ? b[i] : nullptr;
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
// into about 55% dropped). case and row are the batch's global ones: a
// launch on a share of the cases or rows adds case0 to its case index and
// row0 to its merged row (both 0 for a whole batch).
struct Dropout {
  unsigned k0, k1;
  int case0, row0;
  unsigned thresh[kMaxLayers];
  float scale[kMaxLayers];
  int on[kMaxLayers];
};

inline Dropout make_dropout(unsigned k0, unsigned k1, int n_layers, const unsigned* thresh,
                            const float* scale, const int* on, int case0, int row0) {
  Dropout d{};
  d.k0 = k0;
  d.k1 = k1;
  d.case0 = case0;
  d.row0 = row0;
  for (int i = 0; i < n_layers && i < kMaxLayers; ++i) {
    d.thresh[i] = thresh ? thresh[i] : 0u;
    d.scale[i] = scale ? scale[i] : 1.f;
    d.on[i] = on ? on[i] : 0;
  }
  return d;
}

// One layer's dropout, read once per layer from the kernel's table (whose
// run-time indexing goes through local memory).
struct LayerDrop {
  unsigned k0, k1, thresh;
  float scale;
  int layer, case0, row0;
  bool on;
};

__device__ __forceinline__ LayerDrop layer_drop(const Dropout& dr, int layer) {
  return {dr.k0,   dr.k1,    dr.thresh[layer], dr.scale[layer],
          layer,   dr.case0, dr.row0,          dr.on[layer] != 0};
}

// the factors (0 or 1 / keep) of columns c and c + 1 (c even) of one merged
// row, all 1 where the layer has no dropout: the half of Philox output
// (c / 4, row0 + row, case0 + case, layer) that holds them, selected
// without indexing
__device__ __forceinline__ void keep2(const LayerDrop& d, int case_, int row, int c,
                                      float (&f)[2]) {
  if (!d.on) {
    f[0] = f[1] = 1.f;
    return;
  }
  const uint4 r = philox4x32_10(make_uint4((unsigned)(c >> 2), (unsigned)(d.row0 + row),
                                           (unsigned)(d.case0 + case_), (unsigned)d.layer),
                                d.k0, d.k1);
  const bool hi = (c & 2) != 0;
  f[0] = (hi ? r.z : r.x) < d.thresh ? d.scale : 0.f;
  f[1] = (hi ? r.w : r.y) < d.thresh ? d.scale : 0.f;
}

// ---------------------------------------------------------------------------
// Tensor cores at f32 accuracy (3xTF32; see the head of this file)

// x rounded to TF32 (round to nearest, ties away from zero), as f32 bits:
// cvt.rna.tf32.f32 for finite x, in two integer operations (add half of the
// 13 dropped bits' range to the magnitude, then clear them; a carry moves
// into the exponent as rounding up should)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small to about 2^-22 |x|, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile. Fragments (g = lane / 4, t = lane % 4):
// a = (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (row t,
// col g), (t + 4, g); d = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of 16 bytes of which the first `bytes` are read, the rest zeroed
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

// Whether a tile of src (row stride ld) starting at column c0 goes in
// 16-byte copies: aligned rows; otherwise word by word.
__device__ __forceinline__ bool tile_vec(const float* src, int ld, int c0) {
  return (ld & 3) == 0 && (c0 & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0;
}

// Start copying src[r0 + r][c0 + c] (r < R, c < CW; row-major, ld floats a
// row) to dst[r * sld + c]; entries at rows >= r_end or columns >= c_end
// read as 0. Not committed: the caller commits the group.
template <int R, int CW>
__device__ __forceinline__ void load_tile_async(float* dst, int sld, const float* src, int ld,
                                                int r0, int r_end, int c0, int c_end) {
  if (tile_vec(src, ld, c0)) {
    constexpr int kV = CW / 4;
    for (int e = threadIdx.x; e < R * kV; e += kThreads) {
      const int r = e / kV;
      const int c = (e % kV) * 4;
      const int row = r0 + r;
      const int col = c0 + c;
      const int n = row < r_end ? min(4, c_end - col) : 0;
      cp_async16(dst + r * sld + c, n > 0 ? src + (size_t)row * ld + col : src,
                 n > 0 ? 4 * n : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * CW; e += kThreads) {
      const int r = e / CW;
      const int c = e % CW;
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      cp_async4(dst + r * sld + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// act() over the words of a tile that this thread copied with the same
// load_tile_async call (its own copies are complete after cp_async_wait)
template <int ACT, int R, int CW>
__device__ __forceinline__ void activate_own(float* dst, int sld, const float* src, int ld,
                                             int c0) {
  if (tile_vec(src, ld, c0)) {
    constexpr int kV = CW / 4;
    for (int e = threadIdx.x; e < R * kV; e += kThreads) {
      float4* p = reinterpret_cast<float4*>(dst + (e / kV) * sld + (e % kV) * 4);
      float4 v = *p;
      v.x = act_value<ACT>(v.x);
      v.y = act_value<ACT>(v.y);
      v.z = act_value<ACT>(v.z);
      v.w = act_value<ACT>(v.w);
      *p = v;
    }
  } else {
    for (int e = threadIdx.x; e < R * CW; e += kThreads) {
      float* p = dst + (e / CW) * sld + e % CW;
      *p = act_value<ACT>(*p);
    }
  }
}

// Weight gradient C (K x N) = sum over rows r of A[r][k] G[r][n] in 3xTF32
// (see the head of this file). Block (blockIdx.x, blockIdx.y) computes the
// BM x BN tile at (k0, n0) of C over chunk blockIdx.z of the rows into
// parts[chunk]; sum_partials adds the chunks in order. With rows_dev (not
// null) the row count is read on the card and split evenly over the chunks.
// The mma's M is k, its N is n, its depth the rows: both operands come as [row][column]
// shared tiles, whose strides of 8 (mod 32) words make every fragment load
// conflict-free.
constexpr int kGradDepth = 32;   // rows a stage
constexpr int kGradStages = 3;

template <int BM, int BN>
constexpr size_t grad_smem_bytes() {
  return sizeof(float) * kGradStages * kGradDepth * ((BM + 8) + (BN + 8));
}

template <int A_ACT, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    weight_grad_partial(const float* __restrict__ A, int lda, const float* __restrict__ G,
                        int ldg, int rows, int K, int N, int rows_per_chunk,
                        float* __restrict__ parts, const int* __restrict__ rows_dev) {
  constexpr int SA = BM + 8, SG = BN + 8;
  constexpr int kStage = kGradDepth * (SA + SG);
  constexpr int WM = BM / 2, WN = BN / 4, MT = WM / 16, NT = WN / 8;
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BM;
  const int chunk = blockIdx.z;
  if (rows_dev) {  // a count known on the card only: the chunks split it evenly
    rows = *rows_dev;
    const int per = (rows + gridDim.z - 1) / gridDim.z;
    rows_per_chunk = (per + kGradDepth - 1) / kGradDepth * kGradDepth;
  }
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);
  const int n_steps = r_end > r_begin ? (r_end - r_begin + kGradDepth - 1) / kGradDepth : 0;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wm = (warp >> 2) * WM;
  const int wn = (warp & 3) * WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  auto load = [&](int s) {
    float* st = smem + (s % kGradStages) * kStage;
    const int r0 = r_begin + s * kGradDepth;
    load_tile_async<kGradDepth, BM>(st, SA, A, lda, r0, r_end, k0, K);
    load_tile_async<kGradDepth, BN>(st + kGradDepth * SA, SG, G, ldg, r0, r_end, n0, N);
  };
  for (int s = 0; s < kGradStages - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kGradStages - 2>();
    float* as = smem + (s % kGradStages) * kStage;
    if constexpr (A_ACT >= 0) activate_own<A_ACT, kGradDepth, BM>(as, SA, A, lda, k0);
    __syncthreads();  // stage s is complete and visible; stage s - 1 is free
    if (s + kGradStages - 1 < n_steps) load(s + kGradStages - 1);
    cp_async_commit();
    const float* gs = as + kGradDepth * SA;
#pragma unroll
    for (int kk = 0; kk < kGradDepth; kk += 8) {
      unsigned ab[MT][4], asm_[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* p = as + (kk + t) * SA + wm + m * 16 + g;
        split_tf32(p[0], ab[m][0], asm_[m][0]);
        split_tf32(p[8], ab[m][1], asm_[m][1]);
        split_tf32(p[4 * SA], ab[m][2], asm_[m][2]);
        split_tf32(p[4 * SA + 8], ab[m][3], asm_[m][3]);
      }
      unsigned bb[NT][2], bs[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* p = gs + (kk + t) * SG + wn + n * 8 + g;
        split_tf32(p[0], bb[n][0], bs[n][0]);
        split_tf32(p[4 * SG], bb[n][1], bs[n][1]);
      }
      // the three passes one after another over all tiles: independent
      // products between the dependent ones
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ab[m], bs[n][0], bs[n][1]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], asm_[m], bb[n][0], bb[n][1]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ab[m], bb[n][0], bb[n][1]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + wm + m * 16 + g + (q >> 1) * 8;
        const int c = n0 + wn + n * 8 + 2 * t + (q & 1);
        if (k < K && c < N) parts[((size_t)chunk * K + k) * N + c] = acc[m][n][q];
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

// the tile of dW a block computes: 128 wide along k and n where the
// widths fill it, else 64
inline int grad_tile(int width) { return width > 64 ? 128 : 64; }

inline int grad_chunks(int rows, int K, int N) {
  const int tiles = ((N + grad_tile(N) - 1) / grad_tile(N)) * ((K + grad_tile(K) - 1) / grad_tile(K));
  int chunks = (2 * 132 + tiles - 1) / tiles;  // about two blocks per SM
  const int most = (rows + 511) / 512;        // at least 512 rows a chunk
  if (chunks > most) chunks = most;
  return chunks < 1 ? 1 : chunks;
}

inline size_t grad_scratch_floats(int rows, int K, int N) {
  return (size_t)grad_chunks(rows, K, N) * K * N;
}

template <int A_ACT, int BM, int BN>
cudaError_t launch_weight_grad(const float* A, int lda, const float* G, int ldg, int rows, int K,
                               int N, float* scratch, cudaStream_t s) {
  const int chunks = grad_chunks(rows, K, N);
  int per = (rows + chunks - 1) / chunks;
  per = (per + kGradDepth - 1) / kGradDepth * kGradDepth;
  constexpr size_t smem = grad_smem_bytes<BM, BN>();
  auto kernel = weight_grad_partial<A_ACT, BM, BN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, chunks);
  kernel<<<grid, kThreads, smem, s>>>(A, lda, G, ldg, rows, K, N, per, scratch, nullptr);
  return cudaGetLastError();
}

// out (K x N) += A^T G over all rows; scratch holds grad_scratch_floats
template <int A_ACT>
cudaError_t weight_grad(const float* A, int lda, const float* G, int ldg, int rows, int K,
                        int N, float* scratch, float* out, cudaStream_t s) {
  if (rows < 1) return cudaSuccess;
  cudaError_t err;
  if (grad_tile(K) == 128)
    err = grad_tile(N) == 128
              ? launch_weight_grad<A_ACT, 128, 128>(A, lda, G, ldg, rows, K, N, scratch, s)
              : launch_weight_grad<A_ACT, 128, 64>(A, lda, G, ldg, rows, K, N, scratch, s);
  else
    err = grad_tile(N) == 128
              ? launch_weight_grad<A_ACT, 64, 128>(A, lda, G, ldg, rows, K, N, scratch, s)
              : launch_weight_grad<A_ACT, 64, 64>(A, lda, G, ldg, rows, K, N, scratch, s);
  if (err != cudaSuccess) return err;
  const int len = K * N;
  sum_partials<<<(len + 255) / 256, 256, 0, s>>>(scratch, grad_chunks(rows, K, N), len, out);
  return cudaGetLastError();
}

// blocks per SM of weight_grad's widest tile (128 x 128, no activation)
inline int weight_grad_blocks_per_sm() {
  int blocks = 0;
  auto kernel = weight_grad_partial<-1, 128, 128>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)grad_smem_bytes<128, 128>());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                grad_smem_bytes<128, 128>());
  return blocks;
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
