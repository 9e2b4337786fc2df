// pointnet_global forward: max over points of act(...act(x W1^T + b1)... W_L^T + b_L)
// with every layer activated, and the first maximal row per channel.
//
// Replaces the TPU kernel porous_cfd_tpu/ops/pointnet_pallas.py:_fwd_kernel
// (pallas_call at pointnet_pallas.py:125), forward only.
//
// What bounds it on an H100: operations. At the PIPN reference envelope
// (13 cases x 2500 points, widths 69 -> 96 -> 128 -> 1024) it does
// 32,500 x 149,984 multiply-adds = 9.75 GFLOP against 9 MB of input, far
// above the card's f32 ridge point, so the f32 CUDA-core rate is the limit.
//
// Design: the TPU kernel walks the point tiles in order and carries a running
// (max, argmax) in its output block. Here the tiles run in parallel, so the
// reduction takes two passes: pointnet_tiles gives each block 64 points of one
// case, runs the whole chain in shared memory and writes a per-tile partial
// (max, first row) of shape (B, n_tiles, F); pointnet_reduce folds the tiles
// in order. The 1024-wide last layer is never stored: it is computed in
// 128-column chunks and each chunk is reduced over the tile's rows at once
// (in registers, then across the 4 lanes that share a column by shuffles,
// then across the 2 warp rows in shared memory). The weights (0.6 MB) do not
// fit in shared memory and stream through double-buffered 32 x 128 tiles
// (common.cuh: block_gemm, which keeps the FMA pipe and not shared memory the
// limit); two blocks fit on an SM. Rows past n_pts are masked in the
// kernel (they never win); nothing is padded. Ties go to the lowest row in a
// tile and to the lowest tile, i.e. the first maximal row, as on the TPU.
//
// Backward: replaces porous_cfd_tpu/ops/pointnet_pallas.py:_bwd_kernel
// (pallas_call at :146). The pooled cotangent is non-zero at one row per
// (case, channel), the argmax row. The TPU kernel recomputes the whole chain
// per tile and multiplies a dense, mostly-zero cotangent through the
// 1024-wide last layer, because Mosaic has no scatter. Here the last layer's
// backward touches only the winners: per (case, channel) one 128-long dot
// product recomputes z at the winner, and gz W[:, c] is scattered into the
// winner row (atomics, as channels share rows), O(B x 128 x 1024) work
// instead of a dense (N x 1024) pass. The two lower layers (87% less work
// per row) run densely over all rows from the pre-activations the training
// forward stashed (13 x 2500 x 224 floats, 29 MB), in 64-row tiles through
// block_gemm; their dW contract over all rows in common.cuh's weight_grad
// (per-chunk partials added in order), and db are column sums. What bounds
// it: the dense lower layers' operations (about 3.7 GFLOP at the envelope)
// and the scattered reads of the winner rows.
// All arithmetic is f32 FMA on the CUDA cores; tensor cores are later work.
#include "common.cuh"

#include <climits>

using namespace pct;

namespace {

constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kRowsPerThread * kWarps;  // 64 points per block
constexpr unsigned kFullMask = 0xffffffffu;

// does (v, r) beat (best, best_row)? Larger value wins, then the lower row;
// row INT_MAX marks "no valid row yet"
__device__ __forceinline__ bool beats(float v, int r, float best, int best_row) {
  return r != INT_MAX && (best_row == INT_MAX || v > best || (v == best && r < best_row));
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
    pointnet_tiles(const float* __restrict__ x, int n_pts, Mlp mlp, int bw0, int bw1,
                   float* __restrict__ part_max, int* __restrict__ part_arg,
                   float* __restrict__ stash_z) {
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + kTileRows * bw0};
  float* w_tiles = buf[1] + kTileRows * bw1;
  float* red_val = w_tiles + 2 * kWTileFloats;                   // [2][kChunkN]
  int* red_row = reinterpret_cast<int*>(red_val + 2 * kChunkN);

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int p = row_slot();
  const int col = first_col();
  const int row0 = tile * kTileRows;
  const int valid = min(kTileRows, n_pts - row0);

  // stage the tile's input rows (contiguous in x); rows past n_pts and the
  // padding columns read 0
  const int l0 = mlp.layer[0].k;
  const int ld0 = padded(l0);
  const float* xb = x + ((size_t)b * n_pts + row0) * l0;
  for (int e = threadIdx.x; e < kTileRows * ld0; e += kThreads) {
    const int r = e / ld0;
    const int c = e % ld0;
    buf[0][e] = (r < valid && c < l0) ? xb[r * l0 + c] : 0.f;
  }

  int cur = 0;
  const int nl = mlp.n_layers;
  size_t zoff = 0;  // this layer's block of the training stash
  for (int li = 0; li < nl - 1; ++li) {
    const Layer L = mlp.layer[li];
    const float* A = buf[cur];
    float* out = buf[cur ^ 1];
    const int lda = padded(L.k);
    const int ldo = padded(L.n);
    const int n_pad = round4(L.n);
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[kRowsPerThread][4];
      block_gemm<kRowsPerThread>(acc, A, lda, L, n0, w_tiles);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col + j;
        if (n >= n_pad) continue;
        const bool in = n < L.n;
        const float bias = in ? L.b[n] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = i * kWarps + p;
          const float z = acc[i][j] + bias;
          out[row * ldo + n] = in ? act_value<ACT>(z) : 0.f;
          if (stash_z && in && row < valid)
            stash_z[zoff + ((size_t)b * n_pts + row0 + row) * L.n + n] = z;
        }
      }
    }
    zoff += (size_t)gridDim.y * n_pts * L.n;
    cur ^= 1;
  }

  // last layer: one 128-column chunk at a time, reduced over the tile's rows
  const Layer L = mlp.layer[nl - 1];
  const float* A = buf[cur];
  const int lda = padded(L.k);
  for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
    float acc[kRowsPerThread][4];
    block_gemm<kRowsPerThread>(acc, A, lda, L, n0, w_tiles);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + col + j;
      const float bias = (n < L.n) ? L.b[n] : 0.f;
      float best = -FLT_MAX;
      int best_row = INT_MAX;
      // this thread's rows ascend with i
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = i * kWarps + p;
        const float v = act_value<ACT>(acc[i][j] + bias);
        if (row < valid && beats(v, row, best, best_row)) {
          best = v;
          best_row = row;
        }
      }
      // the 4 lanes that share this column (lr = lane / 8)
#pragma unroll
      for (int off = 8; off <= 16; off <<= 1) {
        const float v = __shfl_xor_sync(kFullMask, best, off);
        const int r = __shfl_xor_sync(kFullMask, best_row, off);
        if (beats(v, r, best, best_row)) {
          best = v;
          best_row = r;
        }
      }
      if ((lane >> 3) == 0) {
        const int slot = (threadIdx.x >> 7) * kChunkN + col + j;   // [wr][column]
        red_val[slot] = best;
        red_row[slot] = best_row;
      }
    }
    __syncthreads();
    if (threadIdx.x < kChunkN) {
      const int c = threadIdx.x;
      const int n = n0 + c;
      float best = red_val[c];
      int best_row = red_row[c];
      if (beats(red_val[kChunkN + c], red_row[kChunkN + c], best, best_row)) {
        best = red_val[kChunkN + c];
        best_row = red_row[kChunkN + c];
      }
      if (n < L.n) {
        const size_t o = ((size_t)b * n_tiles + tile) * L.n + n;
        part_max[o] = best;
        part_arg[o] = row0 + best_row;
      }
    }
    // the next chunk's block_gemm starts with a barrier before red_* is reused
  }
}

// fold the per-tile partials in tile order: a later tile wins only if strictly
// greater, so the first maximal row is kept
__global__ void pointnet_reduce(const float* __restrict__ part_max,
                                const int* __restrict__ part_arg, int n_cases,
                                int n_tiles, int f, float* __restrict__ out_max,
                                int* __restrict__ out_arg) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_cases * f) return;
  const int b = idx / f;
  const int n = idx % f;
  const size_t base = (size_t)b * n_tiles * f + n;
  float best = part_max[base];
  int arg = part_arg[base];
  for (int t = 1; t < n_tiles; ++t) {
    const float v = part_max[base + (size_t)t * f];
    if (v > best) {
      best = v;
      arg = part_arg[base + (size_t)t * f];
    }
  }
  out_max[idx] = best;
  out_arg[idx] = arg;
}


// Backward of the last layer at the winners: for each (case, channel c) with
// winner row r = argmax, recompute z = a[r] . W[:, c] + b[c] (a = the last
// layer's input row), gz = dm * act'(z), and scatter gz W[:, c] into da[r].
// Channels share winner rows, so the scatter adds with atomics.
template <int ACT>
__global__ void pointnet_last_bwd(const float* __restrict__ a_src, bool a_is_z, int K, int F,
                                  int n_pts, const float* __restrict__ w_t,
                                  const float* __restrict__ bias, const int* __restrict__ arg,
                                  const float* __restrict__ dm, float* __restrict__ gz_last,
                                  float* __restrict__ da) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= F) return;
  const int r = arg[(size_t)b * F + c];
  const float* row = a_src + ((size_t)b * n_pts + r) * K;
  float z = bias[c];
  for (int k = 0; k < K; ++k) {
    const float a = a_is_z ? act_value<ACT>(row[k]) : row[k];
    z = fmaf(a, w_t[(size_t)k * F + c], z);
  }
  const float gz = dm[(size_t)b * F + c] * act_d1<ACT>(z);
  gz_last[(size_t)b * F + c] = gz;
  if (gz == 0.f) return;
  float* dst = da + ((size_t)b * n_pts + r) * K;
  for (int k = 0; k < K; ++k) atomicAdd(dst + k, gz * w_t[(size_t)k * F + c]);
}

// dW_last[k][c] += sum over cases of a[r_bc][k] * gz[b][c] (only winner rows
// carry a cotangent), in case order
template <int ACT>
__global__ void pointnet_last_wgrad(const float* __restrict__ a_src, bool a_is_z, int K, int F,
                                    int n_pts, int n_cases, const int* __restrict__ arg,
                                    const float* __restrict__ gz_last, float* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= K * F) return;
  const int k = idx / F;
  const int c = idx % F;
  float s = 0.f;
  for (int b = 0; b < n_cases; ++b) {
    const int r = arg[(size_t)b * F + c];
    const float v = a_src[((size_t)b * n_pts + r) * K + k];
    s = fmaf(a_is_z ? act_value<ACT>(v) : v, gz_last[(size_t)b * F + c], s);
  }
  dw[idx] += s;
}

// Reverse sweep of the lower layers over one 64-row tile: stage da (the
// scattered cotangent of the last layer's input), GZ = da * act'(Z) with the
// stashed pre-activations, then GA_i = GZ_i W_i^T through block_gemm (W_i in
// nn.Linear's (out, in) layout) with the next GZ formed in its epilogue; the
// first layer's GA is dx. Every GZ_i goes to gz_stash for the weight
// gradients. Rows past n_pts are zero and never stored.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    pointnet_lower_bwd(const float* __restrict__ da, int n_pts, Mlp wt,
                       const float* __restrict__ stash_z, float* __restrict__ gz_stash, int bw0,
                       int bw1, float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + kTileRows * bw0};
  float* w_tiles = buf[1] + kTileRows * bw1;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int valid = min(kTileRows, n_pts - row0);
  const int p = row_slot();
  const int col = first_col();
  const int nl = wt.n_layers;                 // the hidden layers 0 .. nl-1
  const size_t rows = (size_t)gridDim.y * n_pts;
  size_t off[kMaxLayers];
  {
    size_t o = 0;
    for (int i = 0; i < nl; ++i) {
      off[i] = o;
      o += rows * wt.layer[i].k;
    }
  }
  // stage GZ of the top hidden layer
  {
    const int kt = wt.layer[nl - 1].k;
    const int ld = padded(kt);
    for (int e = threadIdx.x; e < kTileRows * ld; e += kThreads) {
      const int r = e / ld;
      const int c = e % ld;
      float g = 0.f;
      if (r < valid && c < kt) {
        const size_t gi = ((size_t)b * n_pts + row0 + r) * kt + c;
        g = da[gi] * act_d1<ACT>(stash_z[off[nl - 1] + gi]);
        gz_stash[off[nl - 1] + gi] = g;
      }
      buf[0][e] = g;
    }
  }
  int cur = 0;
  for (int li = nl - 1; li >= 0; --li) {
    const Layer L = wt.layer[li];             // k = n_li, n = k_li
    const float* A = buf[cur];
    float* out = buf[cur ^ 1];
    const int lda = padded(L.k);
    const int ldo = padded(L.n);
    const int n_pad = round4(L.n);
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[kRowsPerThread][4];
      block_gemm<kRowsPerThread>(acc, A, lda, L, n0, w_tiles);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col + j;
        if (n >= n_pad) continue;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int row = i * kWarps + p;
          if (li == 0) {
            if (n < L.n && row < valid)
              dx[((size_t)b * n_pts + row0 + row) * L.n + n] = acc[i][j];
            continue;
          }
          float g = 0.f;
          if (n < L.n && row < valid) {
            const size_t gi = ((size_t)b * n_pts + row0 + row) * L.n + n;
            g = acc[i][j] * act_d1<ACT>(stash_z[off[li - 1] + gi]);
            gz_stash[off[li - 1] + gi] = g;
          }
          out[row * ldo + n] = g;
        }
      }
    }
    cur ^= 1;
  }
}

}  // namespace

extern "C" int pointnet_global_tile_rows() { return kTileRows; }

// x (n_cases, n_pts, widths[0]) f32; layer i has weight w[i] given as
// (widths[i], widths[i+1]) row-major, i.e. nn.Linear's weight transposed, and
// bias b[i]; part_* (n_cases, ceil(n_pts / 64), F) scratch;
// out_* (n_cases, F). stash_z (null: none) receives the pre-activations of
// every hidden layer for the backward, (n_cases * n_pts, widths[i+1]) blocks
// one after another. Returns the CUDA error code of the launches (0 = ok).
extern "C" int pointnet_global_forward(const float* x, int n_cases, int n_pts,
                                       int n_layers, const float* const* w,
                                       const float* const* b, const int* widths,
                                       int act, float* part_max, int* part_arg,
                                       float* out_max, int* out_arg, float* stash_z,
                                       void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_cases < 1 || n_pts < 1)
    return (int)cudaErrorInvalidValue;
  const Mlp mlp = make_mlp(n_layers, w, b, widths);
  int bw0, bw1;
  buffer_widths(mlp, &bw0, &bw1);
  const size_t smem = sizeof(float) * ((size_t)kTileRows * (bw0 + bw1) + 2 * kWTileFloats +
                                       2 * kChunkN) +
                      sizeof(int) * 2 * kChunkN;
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_pts + kTileRows - 1) / kTileRows;
  const int f = widths[n_layers];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, n_cases);
  if (act == kSilu) {
    cudaFuncSetAttribute(pointnet_tiles<kSilu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    pointnet_tiles<kSilu><<<grid, kThreads, smem, s>>>(x, n_pts, mlp, bw0, bw1, part_max,
                                                       part_arg, stash_z);
  } else if (act == kTanh) {
    cudaFuncSetAttribute(pointnet_tiles<kTanh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    pointnet_tiles<kTanh><<<grid, kThreads, smem, s>>>(x, n_pts, mlp, bw0, bw1, part_max,
                                                       part_arg, stash_z);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = n_cases * f;
  pointnet_reduce<<<(total + 255) / 256, 256, 0, s>>>(part_max, part_arg, n_cases, n_tiles,
                                                      f, out_max, out_arg);
  return (int)cudaGetLastError();
}

namespace {

template <int ACT>
int backward_act(const float* x, int n_cases, int n_pts, int n_layers, const float* const* w_t,
                 const float* const* w_orig, const float* const* b, const int* widths,
                 const float* stash_z, const int* argmax, const float* dm, float* da,
                 float* gz_last, float* gz_stash, float* dx, float* const* dw,
                 float* const* db, float* scratch, cudaStream_t s) {
  const int nl = n_layers;
  const int K = widths[nl - 1];
  const int F = widths[nl];
  const size_t rows = (size_t)n_cases * n_pts;
  // the last layer's input: x, or act(Z) of the top hidden layer
  size_t z_top = 0;
  for (int i = 0; i < nl - 2; ++i) z_top += rows * widths[i + 1];
  const float* a_src = nl > 1 ? stash_z + z_top : x;
  const bool a_is_z = nl > 1;
  float* scatter = nl > 1 ? da : dx;
  cudaError_t e = cudaMemsetAsync(scatter, 0, sizeof(float) * rows * K, s);
  if (e != cudaSuccess) return (int)e;
  pointnet_last_bwd<ACT><<<dim3((F + 127) / 128, n_cases), 128, 0, s>>>(
      a_src, a_is_z, K, F, n_pts, w_t[nl - 1], b[nl - 1], argmax, dm, gz_last, scatter);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pointnet_last_wgrad<ACT><<<(K * F + 255) / 256, 256, 0, s>>>(
      a_src, a_is_z, K, F, n_pts, n_cases, argmax, gz_last, dw[nl - 1]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  group_colsum<<<dim3((F + 31) / 32, 1), dim3(32, 8), 0, s>>>(gz_last, F, 1, n_cases, n_cases,
                                                              F, db[nl - 1], 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (nl == 1) return 0;

  // the hidden layers 0 .. nl-2 in reverse, one 64-row tile per block
  Mlp wt{};
  wt.n_layers = nl - 1;
  for (int i = 0; i < nl - 1; ++i) {
    wt.layer[i].w = w_orig[i];
    wt.layer[i].b = nullptr;
    wt.layer[i].k = widths[i + 1];
    wt.layer[i].n = widths[i];
    wt.layer[i].ldw = widths[i];
  }
  int bw[2] = {0, 0};
  for (int li = nl - 2; li >= 0; --li) {
    const int in_buf = (nl - 2 - li) & 1;
    bw[in_buf] = max(bw[in_buf], padded(wt.layer[li].k));
    if (li > 0) bw[in_buf ^ 1] = max(bw[in_buf ^ 1], padded(wt.layer[li].n));
  }
  const size_t smem = sizeof(float) * ((size_t)kTileRows * (bw[0] + bw[1]) + 2 * kWTileFloats);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(pointnet_lower_bwd<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((n_pts + kTileRows - 1) / kTileRows, n_cases);
  pointnet_lower_bwd<ACT><<<grid, kThreads, smem, s>>>(da, n_pts, wt, stash_z, gz_stash, bw[0],
                                                       bw[1], dx);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  size_t off = 0;
  for (int li = 0; li < nl - 1; ++li) {
    const int k = widths[li], n = widths[li + 1];
    const float* g = gz_stash + off;
    if (li == 0) {
      e = weight_grad<-1>(x, k, g, n, (int)rows, k, n, scratch, dw[0], s);
    } else {
      e = weight_grad<ACT>(stash_z + off - rows * k, k, g, n, (int)rows, k, n, scratch, dw[li],
                           s);
    }
    if (e != cudaSuccess) return (int)e;
    e = value_colsum(g, n, 1, (int)rows, n, scratch, db[li], s);
    if (e != cudaSuccess) return (int)e;
    off += rows * n;
  }
  return 0;
}

}  // namespace

// Scratch floats pointnet_global_backward needs.
extern "C" long long pointnet_global_backward_workspace(int n_cases, int n_pts, int n_layers,
                                                        const int* widths) {
  const int rows = n_cases * n_pts;
  size_t need = 1;
  for (int i = 0; i < n_layers - 1; ++i) {
    const size_t g = grad_scratch_floats(rows, widths[i], widths[i + 1]);
    const size_t c = colsum_scratch_floats(rows, widths[i + 1]);
    need = need > g ? need : g;
    need = need > c ? need : c;
  }
  return (long long)need;
}

// Backward of pointnet_global_forward (run with a stash). w_t[i] is layer
// i's weight as (widths[i], widths[i+1]) row-major, w_orig[i] nn.Linear's
// (widths[i+1], widths[i]); argmax/dm (n_cases, F) the forward's first
// maximal rows and the pooled cotangent. da (n_cases * n_pts,
// widths[n_layers-1]) and gz_last (n_cases, F) are scratch, gz_stash the size
// of the forward's stash. Writes dx (n_cases, n_pts, widths[0]) at every row
// (zero where no cotangent arrives) and ADDS dW_i ((in, out) layout) and db_i
// to dw[i] / db[i].
extern "C" int pointnet_global_backward(const float* x, int n_cases, int n_pts, int n_layers,
                                        const float* const* w_t, const float* const* w_orig,
                                        const float* const* b, const int* widths, int act,
                                        const float* stash_z, const int* argmax,
                                        const float* dm, float* da, float* gz_last,
                                        float* gz_stash, float* dx, float* const* dw,
                                        float* const* db, float* scratch,
                                        long long scratch_floats, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_cases < 1 || n_pts < 1)
    return (int)cudaErrorInvalidValue;
  if (pointnet_global_backward_workspace(n_cases, n_pts, n_layers, widths) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == kSilu)
    return backward_act<kSilu>(x, n_cases, n_pts, n_layers, w_t, w_orig, b, widths, stash_z,
                               argmax, dm, da, gz_last, gz_stash, dx, dw, db, scratch, s);
  if (act == kTanh)
    return backward_act<kTanh>(x, n_cases, n_pts, n_layers, w_t, w_orig, b, widths, stash_z,
                               argmax, dm, da, gz_last, gz_stash, dx, dw, db, scratch, s);
  return (int)cudaErrorInvalidValue;
}
