// decoder_prop forward, decoupled-context mode: the PIPN decoder MLP on the
// value, Jacobian and Hessian-diagonal rows of every point, with the
// activation rules applied between layers and a linear last layer.
//
// Replaces the TPU kernel porous_cfd_tpu/ops/decoder_pallas.py:_fwd_kernel
// (pallas_call at decoder_pallas.py:433) in its decoupled mode (no ctx_width,
// no j0_add), forward only, deterministic. The same kernel serves the
// internal launch (v, J, H rows) and the value-only boundary launch.
//
// What bounds it on an H100: operations. At the reference envelope the
// internal launch runs 13 x 1500 x 5 = 97,500 rows through 64 -> 512 -> 256 ->
// 128 -> 3 (196,992 multiply-adds a row, 38.4 GFLOP) while reading 25 MB; the
// boundary launch runs 13,000 value rows (5.1 GFLOP). Both are far above the
// f32 ridge point, so the f32 CUDA-core rate is the limit.
//
// Design: with D = 2 every point carries 1 + 2D = 5 rows. A block holds 40
// rows: in the internal launch 8 points x 5 components, row comp * 8 + point.
// common.cuh's block_gemm gives each thread the rows i * 8 + p for one slot
// p, i.e. all 5 rows of one point, so the derivative rules v' = s(z),
// J' = s'(z) zJ, H' = s''(z) zJ^2 + s'(z) zH combine values that one thread
// already holds in registers, straight out of the GEMM. In the boundary
// launch the same 40 rows are 40 points. The widest stash is the 512-wide
// layer-0 output: 40 x 512 floats (80 KB) plus a 40 x 256 buffer for the
// other layers, so each block keeps every intermediate in shared memory (one
// block of 153 KB per SM) while the weights stream through double-buffered
// 32 x 128 tiles (block_gemm's register tiling keeps the FMA pipe, not shared
// memory, the limit).
// Layer 0 adds the per-case ctx = g W0[:, L:]^T + b0 (computed outside by
// torch) on the value rows in place of a bias; biases touch value rows only.
// The outputs are written straight into the engine's layouts: values into
// rows [row0, row0 + n) of the merged (B, Ni + Nb, O) tensor, J/H as
// (B, Ni, O, D). Rows past n_pts are computed on zeros and never stored.
// All arithmetic is f32 FMA on the CUDA cores; tensor cores are later work.
#include "common.cuh"

using namespace pct;

namespace {

template <int D, int ACT, bool DERIV>
__global__ void __launch_bounds__(kThreads)
    decoder_fwd(const float* __restrict__ v, const float* __restrict__ jt,
                const float* __restrict__ ht, int n_pts, const float* __restrict__ ctx,
                Mlp mlp, int bw0, int bw1, float* __restrict__ ov, int ov_rows, int ov_row0,
                float* __restrict__ oj, float* __restrict__ oh) {
  constexpr int kComps = 1 + 2 * D;          // rows per point with derivatives
  constexpr int kRows = kComps * kWarps;     // rows of the block's tile
  constexpr int kPoints = DERIV ? kWarps : kRows;
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + kRows * bw0};
  float* w_tiles = buf[1] + kRows * bw1;

  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kPoints;
  const int p = row_slot();
  const int col = first_col();
  const int l0 = mlp.layer[0].k;
  const int ld0 = padded(l0);
  const int f1 = mlp.layer[0].n;

  // stage the input rows: row r = comp * 8 + point (internal) or point r
  // (boundary); padding columns and rows past n_pts read 0
  for (int e = threadIdx.x; e < kRows * ld0; e += kThreads) {
    const int r = e / ld0;
    const int c = e % ld0;
    const int comp = DERIV ? r / kWarps : 0;
    const int pt = pt0 + (DERIV ? r % kWarps : r);
    float val = 0.f;
    if (pt < n_pts && c < l0) {
      if (comp == 0) {
        val = v[((size_t)b * n_pts + pt) * l0 + c];
      } else if (comp <= D) {
        val = jt[(((size_t)b * D + comp - 1) * n_pts + pt) * l0 + c];
      } else {
        val = ht[(((size_t)b * D + comp - 1 - D) * n_pts + pt) * l0 + c];
      }
    }
    buf[0][e] = val;
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
    const float* bias_row = (li == 0) ? ctx + (size_t)b * f1 : L.b;
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[kComps][4];
      block_gemm<kComps>(acc, A, lda, L, n0, w_tiles);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col + j;
        if (n >= n_pad) continue;
        if (n >= L.n) {  // padding columns of the next layer's input
#pragma unroll
          for (int i = 0; i < kComps; ++i) out[(i * kWarps + p) * ldo + n] = 0.f;
          continue;
        }
        const float bias = bias_row[n];
        if (DERIV) {
          float val, d1, d2;
          act_rules<ACT>(acc[0][j] + bias, val, d1, d2);
          out[p * ldo + n] = val;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float zj = acc[1 + d][j];
            const float zh = acc[1 + D + d][j];
            out[((1 + d) * kWarps + p) * ldo + n] = d1 * zj;
            out[((1 + D + d) * kWarps + p) * ldo + n] = d2 * zj * zj + d1 * zh;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kComps; ++i)
            out[(i * kWarps + p) * ldo + n] = act_value<ACT>(acc[i][j] + bias);
        }
      }
    }
    cur ^= 1;
  }

  // last layer (linear, a few outputs): one dot product per (row, output)
  const Layer L = mlp.layer[nl - 1];
  const float* A = buf[cur];
  const int lda = padded(L.k);
  const float* bias_row = (nl == 1) ? ctx + (size_t)b * f1 : L.b;
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * L.n; e += kThreads) {
    const int r = e / L.n;
    const int o = e % L.n;
    const int comp = DERIV ? r / kWarps : 0;
    const int pt = pt0 + (DERIV ? r % kWarps : r);
    if (pt >= n_pts) continue;
    const float* a = A + r * lda;
    float z = 0.f;
    for (int k = 0; k < L.k; ++k) z = fmaf(a[k], __ldg(&L.w[(size_t)k * L.ldw + o]), z);
    if (comp == 0) {
      ov[((size_t)b * ov_rows + ov_row0 + pt) * L.n + o] = z + bias_row[o];
    } else if (comp <= D) {
      oj[(((size_t)b * n_pts + pt) * L.n + o) * D + comp - 1] = z;
    } else {
      oh[(((size_t)b * n_pts + pt) * L.n + o) * D + comp - 1 - D] = z;
    }
  }
}

template <int D, int ACT, bool DERIV>
int launch(const float* v, const float* jt, const float* ht, int n_cases, int n_pts,
           const float* ctx, const Mlp& mlp, float* ov, int ov_rows, int ov_row0, float* oj,
           float* oh, cudaStream_t s) {
  constexpr int kRows = (1 + 2 * D) * kWarps;
  constexpr int kPoints = DERIV ? kWarps : kRows;
  int bw0, bw1;
  buffer_widths(mlp, &bw0, &bw1);
  const size_t smem = sizeof(float) * ((size_t)kRows * (bw0 + bw1) + 2 * kWTileFloats);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  auto kernel = decoder_fwd<D, ACT, DERIV>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((n_pts + kPoints - 1) / kPoints, n_cases);
  kernel<<<grid, kThreads, smem, s>>>(v, jt, ht, n_pts, ctx, mlp, bw0, bw1, ov, ov_rows,
                                      ov_row0, oj, oh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int act, int deriv, const float* v, const float* jt, const float* ht,
             int n_cases, int n_pts, const float* ctx, const Mlp& mlp, float* ov,
             int ov_rows, int ov_row0, float* oj, float* oh, cudaStream_t s) {
  if (act == kSilu && deriv)
    return launch<D, kSilu, true>(v, jt, ht, n_cases, n_pts, ctx, mlp, ov, ov_rows, ov_row0,
                                  oj, oh, s);
  if (act == kSilu)
    return launch<D, kSilu, false>(v, jt, ht, n_cases, n_pts, ctx, mlp, ov, ov_rows, ov_row0,
                                   oj, oh, s);
  if (act == kTanh && deriv)
    return launch<D, kTanh, true>(v, jt, ht, n_cases, n_pts, ctx, mlp, ov, ov_rows, ov_row0,
                                  oj, oh, s);
  if (act == kTanh)
    return launch<D, kTanh, false>(v, jt, ht, n_cases, n_pts, ctx, mlp, ov, ov_rows, ov_row0,
                                   oj, oh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// v (n_cases, n_pts, L) and, with derivatives, jt/ht (n_cases, D, n_pts, L);
// ctx (n_cases, F1) = g W0[:, L:]^T + b0; layer i has weight w[i] given as
// (widths[i], widths[i+1]) row-major, i.e. nn.Linear's weight transposed (for
// layer 0 only its first L input columns, the local block), and bias b[i]
// (b[0] unused: ctx takes its place); widths = (L, F1, ..., O). Values go to
// rows [ov_row0, ov_row0 + n_pts) of ov (n_cases, ov_rows, O); J/H to oj/oh
// (n_cases, n_pts, O, D). Returns the CUDA error code of the launch (0 = ok).
extern "C" int decoder_prop_forward(int d_dims, int act, int with_derivatives,
                                    const float* v, const float* jt, const float* ht,
                                    int n_cases, int n_pts, const float* ctx, int n_layers,
                                    const float* const* w, const float* const* b,
                                    const int* widths, float* ov, int ov_rows,
                                    int ov_row0, float* oj, float* oh, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_cases < 1 || n_pts < 1)
    return (int)cudaErrorInvalidValue;
  const Mlp mlp = make_mlp(n_layers, w, b, widths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_dims) {
    case 1:
      return launch_d<1>(act, with_derivatives, v, jt, ht, n_cases, n_pts, ctx, mlp, ov,
                         ov_rows, ov_row0, oj, oh, s);
    case 2:
      return launch_d<2>(act, with_derivatives, v, jt, ht, n_cases, n_pts, ctx, mlp, ov,
                         ov_rows, ov_row0, oj, oh, s);
    case 3:
      return launch_d<3>(act, with_derivatives, v, jt, ht, n_cases, n_pts, ctx, mlp, ov,
                         ov_rows, ov_row0, oj, oh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
