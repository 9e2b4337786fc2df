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
                   float* __restrict__ part_max, int* __restrict__ part_arg) {
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
        for (int i = 0; i < kRowsPerThread; ++i)
          out[(i * kWarps + p) * ldo + n] = in ? act_value<ACT>(acc[i][j] + bias) : 0.f;
      }
    }
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

}  // namespace

extern "C" int pointnet_global_tile_rows() { return kTileRows; }

// x (n_cases, n_pts, widths[0]) f32; layer i has weight w[i] given as
// (widths[i], widths[i+1]) row-major, i.e. nn.Linear's weight transposed, and
// bias b[i]; part_* (n_cases, ceil(n_pts / 64), F) scratch;
// out_* (n_cases, F). Returns the CUDA error code of the launches (0 = ok).
extern "C" int pointnet_global_forward(const float* x, int n_cases, int n_pts,
                                       int n_layers, const float* const* w,
                                       const float* const* b, const int* widths,
                                       int act, float* part_max, int* part_arg,
                                       float* out_max, int* out_arg, void* stream) {
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
                                                       part_arg);
  } else if (act == kTanh) {
    cudaFuncSetAttribute(pointnet_tiles<kTanh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    pointnet_tiles<kTanh><<<grid, kThreads, smem, s>>>(x, n_pts, mlp, bw0, bw1, part_max,
                                                       part_arg);
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
