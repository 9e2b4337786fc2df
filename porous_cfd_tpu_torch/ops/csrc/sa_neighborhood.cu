// sa_neighborhood: one SetAbstraction radius level, the masked max over each
// centroid's K neighbours of an MLP (every layer activated) on the
// neighbour's row, forward and backward.
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
//            outside, one indexed row load here; its gradient dP is
//            scattered back to the source rows).
// rel = (pos_j - pos_c) / r comes precomputed. Masked-out neighbours never
// win; a centroid with none gives 0.
//
// What bounds it on an H100: operations. At PIPN++'s level 0 (13 x 500
// centroids x 64 neighbours, 8 -> 64 -> 64) the forward does 3.8 GFLOP on
// 18 MB, at level 1 (13 x 125 x 64, P 128 wide, 128 -> 128) 3.5 GFLOP on
// 5 MB, both far above the f32 ridge point.
//
// Design. A tile is 64 neighbour rows: 64 / K centroids (one at K = 64).
// The block stages the tile's input rows in shared memory and runs the
// layers through common.cuh's block_gemm (8 warps, each thread 8 rows x 4
// columns in registers, weights streamed in cp.async double-buffered 32 x
// 128 tiles); each layer's pre-activations Z go to shared memory and an
// elementwise pass forms the next layer's input act(Z). The masked max is
// taken from shared memory per (centroid, channel), in neighbour order, so
// the first maximal neighbour is the one kept. Only the (B, C, F) result
// leaves the chip. Nothing of the TPU layout carries over: the gather that
// the TPU did as a one-hot (G*K, N) matmul is an indexed load of P's row in
// the first layer's epilogue, and no padding of the centroid axis is needed
// (rows past the last centroid are masked in the kernel).
//
// Backward: recompute, as the TPU kernel does, instead of a stash. A block
// walks tiles (tile = blockIdx.x + j * gridDim.x, about one block per SM it
// fits), recomputes the tile keeping every layer's Z, finds each (centroid,
// channel)'s first maximal valid neighbour again (the same arithmetic as
// the forward, so the same winner) and puts the pooled cotangent there:
// GZ = dout act'(Z) at that row, 0 elsewhere. Then per layer, top down:
// dW += A^T GZ and db += colsum(GZ) over the tile's 64 rows (4 x 4 register
// blocks from shared memory) into the block's own partial in device memory,
// and GZ of the layer below = (GZ W^T) act'(Z) through block_gemm, written
// over that layer's Z. The partials of all blocks are added in block order
// (sum_partials), so dW and db do not depend on the schedule. The dynamic
// variant's dP takes each row's first-layer GZ with atomicAdd into row
// idx_j of dP, as pointnet_global's winner scatter does: the order of the
// adds changes from run to run, so dP agrees with the plain version to
// 1e-4 * max|ref|, not bit for bit.
// All arithmetic is f32 FMA on the CUDA cores.
#include "common.cuh"

using namespace pct;

namespace {

constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kRowsPerThread * kWarps;  // 64 neighbour rows

struct Sa {
  int n_cent, k, per_tile, tiles_per_case;
  int stat;                      // 1: static (xg), 0: dynamic (P, idx)
  int f_in, d, in_w;             // in_w = f_in + d (static) or d (dynamic)
  const float* xg;               // static: (B, C * K, f_in)
  const float* rel;              // (B, C * K, d)
  const unsigned char* mask;     // (B, C, K)
  const float* p;                // dynamic: (B, n_src, F1)
  const long long* idx;          // dynamic: (B, C, K)
  int n_src;
  Mlp mlp;                       // layer 0 reads the staged input rows
  int zw;                        // row stride of the Z and act(Z) tiles
};

// per layer, the offsets of dW (in x out) and db (or -1) in a partial
struct GradOffsets {
  int dw[kMaxLayers];
  int db[kMaxLayers];
};

struct Tile {
  int b, c0;
};

__device__ __forceinline__ Tile tile_of(const Sa& s, int t) {
  return {t / s.tiles_per_case, (t % s.tiles_per_case) * s.per_tile};
}

// the neighbour row ((b * C + c) * K + k) that tile row r holds, or -1
__device__ __forceinline__ long long tile_row(const Sa& s, Tile t, int r) {
  const int g = r / s.k;
  const int c = t.c0 + g;
  if (g >= s.per_tile || c >= s.n_cent) return -1;
  return ((long long)t.b * s.n_cent + c) * s.k + r % s.k;
}

// stage the tile's first-layer input rows (zero past the input and on rows
// that hold no neighbour), and per row: valid and masked in, P's row
__device__ void stage(const Sa& s, Tile t, float* in, int* row_ok, int* row_src) {
  const int ld = padded(s.in_w);
  for (int e = threadIdx.x; e < kTileRows * ld; e += kThreads) {
    const int r = e / ld;
    const int col = e % ld;
    const long long gr = tile_row(s, t, r);
    float v = 0.f;
    if (gr >= 0 && col < s.in_w) {
      if (s.stat && col < s.f_in)
        v = s.xg[gr * s.f_in + col];
      else
        v = s.rel[gr * s.d + col - (s.stat ? s.f_in : 0)];
    }
    in[e] = v;
  }
  for (int r = threadIdx.x; r < kTileRows; r += kThreads) {
    const long long gr = tile_row(s, t, r);
    row_ok[r] = gr >= 0 && s.mask[gr] != 0;
    row_src[r] = (gr >= 0 && !s.stat) ? (int)s.idx[gr] : 0;
  }
}

// Every layer of the tile: Z_i to zbuf + i * z_stride (z_stride 0: one
// buffer reused), then abuf = act(Z_i), the next layer's input. On return
// abuf holds the last layer's activations.
template <int ACT>
__device__ void run_layers(const Sa& s, Tile t, const float* in, float* zbuf, size_t z_stride,
                           float* abuf, float* w_tiles, const int* row_src) {
  const int p = row_slot();
  const int col = first_col();
  for (int li = 0; li < s.mlp.n_layers; ++li) {
    const Layer L = s.mlp.layer[li];
    const float* A = li == 0 ? in : abuf;
    const int lda = li == 0 ? padded(s.in_w) : s.zw;
    float* Z = zbuf + li * z_stride;
    const int n_pad = round4(L.n);
    const bool gather = li == 0 && !s.stat;
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[kRowsPerThread][4];
      block_gemm<kRowsPerThread>(acc, A, lda, L, n0, w_tiles);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col + j;
        if (n >= n_pad) continue;
        const bool on = n < L.n;
        const float bias = (on && L.b) ? L.b[n] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = i * kWarps + p;
          float z = 0.f;
          if (on) {
            z = acc[i][j] + bias;
            if (gather) z += s.p[((size_t)t.b * s.n_src + row_src[row]) * L.n + n];
          }
          Z[row * s.zw + n] = z;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kTileRows * n_pad; e += kThreads) {
      const int r = e / n_pad;
      const int n = e % n_pad;
      abuf[r * s.zw + n] = act_value<ACT>(Z[r * s.zw + n]);  // act(0) = 0 on the padding
    }
    __syncthreads();
  }
}

__host__ __device__ inline size_t smem_floats(const Sa& s, int n_z) {
  return (size_t)kTileRows * (padded(s.in_w) + (size_t)(n_z + 1) * s.zw) + 2 * kWTileFloats +
         2 * kTileRows;  // + the two int row arrays
}

struct Smem {
  float* in;
  float* zbuf;
  float* abuf;
  float* w_tiles;
  int* row_ok;
  int* row_src;
};

__device__ __forceinline__ Smem carve(float* smem, const Sa& s, int n_z) {
  Smem m;
  m.in = smem;
  m.zbuf = m.in + kTileRows * padded(s.in_w);
  m.abuf = m.zbuf + (size_t)n_z * kTileRows * s.zw;
  m.w_tiles = m.abuf + kTileRows * s.zw;
  m.row_ok = reinterpret_cast<int*>(m.w_tiles + 2 * kWTileFloats);
  m.row_src = m.row_ok + kTileRows;
  return m;
}

template <int ACT>
__global__ void __launch_bounds__(kThreads) sa_fwd(Sa s, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const Smem m = carve(smem, s, 1);
  const Tile t = tile_of(s, blockIdx.x);
  stage(s, t, m.in, m.row_ok, m.row_src);
  __syncthreads();
  run_layers<ACT>(s, t, m.in, m.zbuf, 0, m.abuf, m.w_tiles, m.row_src);
  const int f = s.mlp.layer[s.mlp.n_layers - 1].n;
  for (int e = threadIdx.x; e < s.per_tile * f; e += kThreads) {
    const int g = e / f;
    const int n = e % f;
    const int c = t.c0 + g;
    if (c >= s.n_cent) continue;
    float best = 0.f;
    bool any = false;
    for (int kk = 0; kk < s.k; ++kk) {
      const int r = g * s.k + kk;
      if (!m.row_ok[r]) continue;
      const float v = m.abuf[r * s.zw + n];
      if (!any || v > best) {
        best = v;
        any = true;
      }
    }
    out[((size_t)t.b * s.n_cent + c) * f + n] = best;  // 0 when none is valid
  }
}

// dw (K x N) += A^T G and db (N) += column sums of G over the tile's rows;
// A's columns [K, round4(K)) and G's [N, round4(N)) are zero. Each thread
// owns whole 4 x 4 blocks of dw, so the read-modify-write needs no atomics.
__device__ void tile_wgrad(const float* A, int lda, int K, const float* G, int ldg, int N,
                           float* __restrict__ dw, float* __restrict__ db) {
  const int nbn = (N + 3) >> 2;
  const int nb = ((K + 3) >> 2) * nbn;
  for (int blk = threadIdx.x; blk < nb; blk += kThreads) {
    const int k0 = (blk / nbn) << 2;
    const int n0 = (blk % nbn) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < kTileRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k0);
      const float4 g = *reinterpret_cast<const float4*>(G + r * ldg + n0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + i >= K) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < N) dw[(size_t)(k0 + i) * N + n0 + j] += acc[i][j];
    }
  }
  if (db)
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < kTileRows; ++r) sum += G[r * ldg + n];
      db[n] += sum;
    }
}

// wt.layer[i] (i >= 1): layer i's weight as nn.Linear's (out, in), read as
// an (out x in) matrix for GZ_i W_i^T
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    sa_bwd(Sa s, Mlp wt, const float* __restrict__ dout, int n_tiles, float* __restrict__ dp,
           float* __restrict__ parts, int part_len, GradOffsets off) {
  extern __shared__ __align__(16) float smem[];
  const int nl = s.mlp.n_layers;
  const Smem m = carve(smem, s, nl);
  const size_t zs = (size_t)kTileRows * s.zw;
  float* part = parts + (size_t)blockIdx.x * part_len;
  const int p = row_slot();
  const int col = first_col();
  const int f = s.mlp.layer[nl - 1].n;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile t = tile_of(s, tile);
    __syncthreads();  // the previous tile is done with every buffer
    stage(s, t, m.in, m.row_ok, m.row_src);
    __syncthreads();
    run_layers<ACT>(s, t, m.in, m.zbuf, zs, m.abuf, m.w_tiles, m.row_src);

    // the pooled cotangent at each (centroid, channel)'s first maximal
    // valid neighbour, times act'(Z): GZ of the last layer over its Z
    float* zl = m.zbuf + (nl - 1) * zs;
    for (int e = threadIdx.x; e < s.per_tile * f; e += kThreads) {
      const int g = e / f;
      const int n = e % f;
      const int c = t.c0 + g;
      int arg = -1;
      float best = 0.f;
      if (c < s.n_cent)
        for (int kk = 0; kk < s.k; ++kk) {
          const int r = g * s.k + kk;
          if (!m.row_ok[r]) continue;
          const float v = m.abuf[r * s.zw + n];
          if (arg < 0 || v > best) {
            best = v;
            arg = kk;
          }
        }
      const float gd = arg >= 0 ? dout[((size_t)t.b * s.n_cent + c) * f + n] : 0.f;
      for (int kk = 0; kk < s.k; ++kk) {
        float* z = zl + (g * s.k + kk) * s.zw + n;
        *z = kk == arg ? gd * act_d1<ACT>(*z) : 0.f;
      }
    }
    for (int e = threadIdx.x; e < (kTileRows - s.per_tile * s.k) * f; e += kThreads)
      zl[(s.per_tile * s.k + e / f) * s.zw + e % f] = 0.f;  // rows of no centroid
    __syncthreads();

    for (int li = nl - 1; li >= 0; --li) {
      const Layer L = s.mlp.layer[li];
      const float* gz = m.zbuf + li * zs;
      const float* A = m.in;
      int lda = padded(s.in_w);
      if (li > 0) {  // this layer's input, act(Z) of the layer below
        const float* zp = m.zbuf + (li - 1) * zs;
        const int np = round4(L.k);
        for (int e = threadIdx.x; e < kTileRows * np; e += kThreads) {
          const int r = e / np;
          const int n = e % np;
          m.abuf[r * s.zw + n] = act_value<ACT>(zp[r * s.zw + n]);
        }
        __syncthreads();
        A = m.abuf;
        lda = s.zw;
      }
      tile_wgrad(A, lda, L.k, gz, s.zw, L.n, part + off.dw[li],
                 off.db[li] >= 0 ? part + off.db[li] : nullptr);
      if (li == 0) {
        if (!s.stat)  // dP[idx_j] += GZ_0[j]
          for (int e = threadIdx.x; e < kTileRows * L.n; e += kThreads) {
            const int r = e / L.n;
            const int n = e % L.n;
            const float v = gz[r * s.zw + n];
            if (m.row_ok[r] && v != 0.f)
              atomicAdd(dp + ((size_t)t.b * s.n_src + m.row_src[r]) * L.n + n, v);
          }
        continue;
      }
      // GZ of the layer below = (GZ W^T) act'(Z), over that layer's Z
      const Layer Lt = wt.layer[li];
      float* zp = m.zbuf + (li - 1) * zs;
      const int n_pad = round4(Lt.n);
      for (int n0 = 0; n0 < Lt.n; n0 += kChunkN) {
        float acc[kRowsPerThread][4];
        block_gemm<kRowsPerThread>(acc, gz, s.zw, Lt, n0, m.w_tiles);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + col + j;
          if (n >= n_pad) continue;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            float* z = zp + (i * kWarps + p) * s.zw + n;
            *z = n < Lt.n ? acc[i][j] * act_d1<ACT>(*z) : 0.f;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Validate the arguments and fill the kernel's description. widths =
// [in_w, F1, ..., F_nl]; b[0] may be null (the dynamic variant: P holds b0).
bool make_sa(Sa& s, int stat, int n_cent, int k, int f_in, int d, const float* xg,
             const float* rel, const unsigned char* mask, const float* p, const long long* idx,
             int n_src, int n_layers, const float* const* w, const float* const* b,
             const int* widths) {
  if (n_cent < 1 || k < 1 || k > kTileRows || d < 1 || n_layers < 1 || n_layers > kMaxLayers)
    return false;
  if (widths[0] != (stat ? f_in + d : d) || (!stat && n_src < 1)) return false;
  s = Sa{};
  s.n_cent = n_cent;
  s.k = k;
  s.per_tile = kTileRows / k;
  s.tiles_per_case = (n_cent + s.per_tile - 1) / s.per_tile;
  s.stat = stat;
  s.f_in = f_in;
  s.d = d;
  s.in_w = widths[0];
  s.xg = xg;
  s.rel = rel;
  s.mask = mask;
  s.p = p;
  s.idx = idx;
  s.n_src = n_src;
  s.mlp = make_mlp(n_layers, w, b, widths);
  s.zw = 0;
  for (int i = 1; i <= n_layers; ++i) s.zw = max(s.zw, padded(widths[i]));
  return true;
}

GradOffsets grad_offsets(int stat, int n_layers, const int* widths, int* total) {
  GradOffsets o{};
  int at = 0;
  for (int i = 0; i < n_layers; ++i) {
    o.dw[i] = at;
    at += widths[i] * widths[i + 1];
    o.db[i] = (i == 0 && !stat) ? -1 : at;
    if (o.db[i] >= 0) at += widths[i + 1];
  }
  *total = at;
  return o;
}

template <int ACT>
int forward_act(const Sa& s, int n_cases, float* out, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(s, 1);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(sa_fwd<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sa_fwd<ACT><<<n_cases * s.tiles_per_case, kThreads, smem, st>>>(s, out);
  return (int)cudaGetLastError();
}

template <int ACT>
int backward_blocks_act(const Sa& s, int n_cases) {
  const size_t smem = sizeof(float) * smem_floats(s, s.mlp.n_layers);
  if (smem > (size_t)max_shared_bytes()) return -1;
  cudaFuncSetAttribute(sa_bwd<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sa_bwd<ACT>, kThreads, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = n_cases * s.tiles_per_case;
  const int blocks = max(1, per_sm) * sms;
  return blocks < n_tiles ? blocks : n_tiles;
}

template <int ACT>
int backward_act(const Sa& s, const Mlp& wt, const float* dout, int n_tiles, float* dp,
                 float* parts, int n_blocks, int total, const GradOffsets& off, float* grads,
                 cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(s, s.mlp.n_layers);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(sa_bwd<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sa_bwd<ACT><<<n_blocks, kThreads, smem, st>>>(s, wt, dout, n_tiles, dp, parts, total, off);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials<<<(total + 255) / 256, 256, 0, st>>>(parts, n_blocks, total, grads);
  return (int)cudaGetLastError();
}

}  // namespace

#define SA_ARGS                                                                             \
  int stat, int act, int n_cases, int n_cent, int k, int f_in, int d, const float *xg,      \
      const float *rel, const unsigned char *mask, const float *p, const long long *idx,    \
      int n_src, int n_layers, const float *const *w, const float *const *b,                \
      const int *widths

// Forward. stat = 1: xg (n_cases, n_cent * k, f_in), layer 0's weight w[0]
// given as (f_in + d, F1) row-major ([W0x; W0r], nn.Linear's weight
// transposed) and bias b[0]; stat = 0: P (n_cases, n_src, F1) = x W0x + b0
// and idx (n_cases, n_cent, k), w[0] = W0r as (d, F1), b[0] null. rel
// (n_cases, n_cent * k, d), mask (n_cases, n_cent, k) bytes; layers i >= 1
// as (widths[i], widths[i+1]) row-major with bias b[i]. k <= 64. out
// (n_cases, n_cent, F). Returns the CUDA error code (0 = ok).
extern "C" int sa_forward(SA_ARGS, float* out, void* stream) {
  Sa s;
  if (n_cases < 1 || (act != kSilu && act != kTanh) ||
      !make_sa(s, stat, n_cent, k, f_in, d, xg, rel, mask, p, idx, n_src, n_layers, w, b, widths))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return act == kSilu ? forward_act<kSilu>(s, n_cases, out, st)
                      : forward_act<kTanh>(s, n_cases, out, st);
}

// Floats of one block's gradient partial (and of the summed gradient):
// per layer dW (widths[i] x widths[i+1], (in, out) layout) then db, except
// layer 0's db in the dynamic variant (P carries b0).
extern "C" int sa_grad_floats(int stat, int n_layers, const int* widths) {
  int total = 0;
  grad_offsets(stat, n_layers, widths, &total);
  return total;
}

// Blocks to launch sa_backward with (one partial each): as many as fit on
// the card at once, at most one per tile; -1 if the tile does not fit in
// shared memory. The count depends on the shapes only, so a caller may keep
// it for later calls at the same shapes.
extern "C" int sa_backward_blocks(SA_ARGS) {
  Sa s;
  if (n_cases < 1 || (act != kSilu && act != kTanh) ||
      !make_sa(s, stat, n_cent, k, f_in, d, xg, rel, mask, p, idx, n_src, n_layers, w, b, widths))
    return -1;
  return act == kSilu ? backward_blocks_act<kSilu>(s, n_cases)
                      : backward_blocks_act<kTanh>(s, n_cases);
}

// Backward of sa_forward (same arguments). w_orig[i] (i >= 1) is layer i's
// weight as nn.Linear's (widths[i+1], widths[i]); dout (n_cases, n_cent, F)
// the pooled cotangent. The blocks walk the tiles, so any n_blocks >= 1
// works; sa_backward_blocks gives the count that fills the card. parts
// (n_blocks x sa_grad_floats) must be zero; grads (sa_grad_floats) is ADDED
// to. The dynamic variant ADDS dP to dp (n_cases, n_src, F1).
extern "C" int sa_backward(SA_ARGS, const float* const* w_orig, const float* dout, float* dp,
                           float* parts, int n_blocks, float* grads, void* stream) {
  Sa s;
  if (n_cases < 1 || n_blocks < 1 || (act != kSilu && act != kTanh) ||
      !make_sa(s, stat, n_cent, k, f_in, d, xg, rel, mask, p, idx, n_src, n_layers, w, b, widths))
    return (int)cudaErrorInvalidValue;
  int total = 0;
  const GradOffsets off = grad_offsets(stat, n_layers, widths, &total);
  Mlp wt{};
  wt.n_layers = n_layers;
  for (int i = 1; i < n_layers; ++i) {
    wt.layer[i].w = w_orig[i];
    wt.layer[i].b = nullptr;
    wt.layer[i].k = widths[i + 1];
    wt.layer[i].n = widths[i];
    wt.layer[i].ldw = widths[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_cases * s.tiles_per_case;
  return act == kSilu
             ? backward_act<kSilu>(s, wt, dout, n_tiles, dp, parts, n_blocks, total, off, grads, st)
             : backward_act<kTanh>(s, wt, dout, n_tiles, dp, parts, n_blocks, total, off, grads, st);
}
