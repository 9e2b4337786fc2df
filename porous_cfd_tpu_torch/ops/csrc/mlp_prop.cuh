// The (value, Jacobian, Hessian-diagonal) propagation through a dense stack
// whose hidden layers are activated and dropped out, and whose last layer is
// linear, forward and backward: the kernels and launch sequences that
// decoder_prop.cu (the PIPN decoder) and neural_op_prop.cu (the PI-GANO
// trunk) instantiate. With MOD every hidden layer's output is also
// multiplied per case by a vector par (B, F) after its dropout, and the
// backward adds up the per-case cotangent dpar.
//
// Two launch-time modes serve the trunk of PiGanoFull (neural_op_prop.cu;
// the decoder uses neither). The first n_act layers are the "operators":
// dense, activation rules, dropout and modulation, through the block GEMM.
// With a reduction (n_act = n_layers - 1) the last layer is linear (the
// dot-product epilogue); without one (reduce = false, n_act = n_layers) the
// last operator's (v, J, H) go straight from its epilogue to ov/oj/oh, F
// wide. With last_linear the last operator takes the identity's rules (val
// = z, d1 = 1, d2 = d3 = 0) in place of the activation's: a linear operator
// that is still dropped out and modulated. Only the MODES instantiations
// (MOD's alone) test these flags; the default mode's launches go to
// instantiations whose epilogues carry none of their branches: on an H100
// the branches cost the default trunk's internal launches 3% forward and
// 8% backward.
//
// Forward design: with D = 2 every point carries 1 + 2D = 5 rows. A block
// holds 40 rows: in the internal launch 8 points x 5 components, row comp * 8
// + point. common.cuh's block_gemm gives each thread the rows i * 8 + p for
// one slot p, i.e. all 5 rows of one point, so the derivative rules v' =
// s(z), J' = s'(z) zJ, H' = s''(z) zJ^2 + s'(z) zH combine values that one
// thread already holds in registers, straight out of the GEMM; the dropout
// factors of its 4 columns come from one Philox call, shared by the 5 rows,
// and the modulation is one more factor on the same 5 rows. In the boundary
// launch the same 40 rows are 40 points. Two row buffers as wide as the
// widest layer keep every intermediate in shared memory while the weights
// stream through double-buffered 32 x 128 tiles. Layer 0 adds the per-case
// ctx = g W0[:, L:]^T + b0 (computed outside by torch) on the value rows in
// place of a bias; biases touch value rows only. Every column loop masks the
// tail of a layer whose width is not a multiple of the 128-column chunk. The
// outputs are written straight into the engine's layouts: values into rows
// [row0, row0 + n) of the merged (B, Ni + Nb, O) tensor, J/H as (B, Ni, O,
// D). Rows past n_pts are computed on zeros and never stored.
//
// Two layer-0 modes carry the max-pool-coupled decoder (decoder_prop.cu;
// the trunk uses neither). j0_add: two (B, D, N, F1) tensors are added to
// the J/H rows' layer-0 pre-activations in the GEMM's epilogue, before the
// activation rules, and the backward writes their cotangents (the J/H rows
// of GZ_0) in the same layout. Context columns: the J/H rows are wider than
// the value rows (lv local columns, then context columns up to widths[0]);
// the value rows read zeros there, as the ctx vector already carries their
// context. Only the lv local columns are staged with the input rows; the
// context columns go through the same accumulators kCtxChunk at a time
// from a staging tile of their own, so shared memory does not grow with
// the context width, and the stash holds the full rows for dW_0.
//
// Backward design. The TPU kernels recompute the forward per tile and carry
// dW, db, dctx (and dpar) across their sequential grid; Hopper's blocks run
// in parallel, and per-block copies of the weights do not fit. So:
//  1. the training forward also writes each layer's input rows A_i and
//     pre-activations Z_i to device memory (written once and read once);
//  2. mlp_prop_bwd_rows walks the layers in reverse for the same 40-row
//     tiles: GA_i = GZ_i W_i^T through block_gemm (W_i in nn.Linear's (out,
//     in) layout is already the transposed operand), and in the GEMM's
//     epilogue the third-derivative rules (decoder_pallas.py:310-331, masks
//     applied first) turn GA_i into GZ_{i-1} while one thread holds all 5
//     rows of a point. Each GZ_i is written to device memory. With MOD the
//     same epilogue recomputes the pre-modulation triple from Z (value, J and
//     H of the activation, times the mask) and writes, per point and column,
//     its product with GA summed over the point's rows: dpar's addends;
//  3. dW_i = A_i^T GZ_i contracts over all rows in common.cuh's weight_grad
//     (per-chunk partial tiles, added in order), and db_i, dctx and dpar are
//     column sums (group_colsum, per case where the quantity is). No
//     atomics: the result does not depend on the schedule.
// All arithmetic is f32 FMA on the CUDA cores; tensor cores are later work.
#pragma once

#include "common.cuh"

#include <algorithm>

namespace pct {
namespace {

// context columns of layer 0 staged per pass (context-column mode)
constexpr int kCtxChunk = 128;

// Per-layer device pointers: for the training stash a[i] (rows x k_i) holds
// layer i's input rows and z[i] (rows x n_i) its pre-activations (hidden
// layers only), rows ((b * n_pts + pt) * C + comp); the backward also uses
// the a[] slots for per-layer cotangent blocks.
struct Stash {
  float* a[kMaxLayers];
  float* z[kMaxLayers];
};

// the operators' count: every layer but the reduction, or (MODES) all of them
inline __host__ __device__ int operators(int n_layers, bool reduce) {
  return reduce ? n_layers - 1 : n_layers;
}

template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
__global__ void __launch_bounds__(kThreads)
    mlp_prop_fwd(const float* __restrict__ v, const float* __restrict__ jt,
                 const float* __restrict__ ht, const float* __restrict__ ja,
                 const float* __restrict__ ha, int lv, int n_pts, const float* __restrict__ ctx,
                 const float* __restrict__ par, Mlp mlp, Dropout dr, Stash st, int bw0, int bw1,
                 float* __restrict__ ov, int ov_rows, int ov_row0, float* __restrict__ oj,
                 float* __restrict__ oh, bool reduce, bool last_linear) {
  constexpr int kComps = 1 + 2 * D;          // rows per point with derivatives
  constexpr int kRows = kComps * kWarps;     // rows of the block's tile
  constexpr int kPoints = DERIV ? kWarps : kRows;
  constexpr int C = DERIV ? kComps : 1;      // stash rows per point
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + kRows * bw0};
  float* w_tiles = buf[1] + kRows * bw1;

  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kPoints;
  const int p = row_slot();
  const int col = first_col();
  const int l0 = mlp.layer[0].k;             // J/H (and stash) row width
  const int ld0 = padded(lv);                // the staged local columns
  const int f1 = mlp.layer[0].n;
  const bool stash = st.a[0] != nullptr;

  // stage the local input columns: row r = comp * 8 + point (internal) or
  // point r (boundary); padding columns and rows past n_pts read 0
  for (int e = threadIdx.x; e < kRows * ld0; e += kThreads) {
    const int r = e / ld0;
    const int c = e % ld0;
    const int comp = DERIV ? r / kWarps : 0;
    const int pt = pt0 + (DERIV ? r % kWarps : r);
    float val = 0.f;
    if (pt < n_pts && c < lv) {
      if (comp == 0) {
        val = v[((size_t)b * n_pts + pt) * lv + c];
      } else if (comp <= D) {
        val = jt[(((size_t)b * D + comp - 1) * n_pts + pt) * l0 + c];
      } else {
        val = ht[(((size_t)b * D + comp - 1 - D) * n_pts + pt) * l0 + c];
      }
      if (stash) st.a[0][(((size_t)b * n_pts + pt) * C + comp) * l0 + c] = val;
    }
    buf[0][e] = val;
  }

  int cur = 0;
  const int nl = mlp.n_layers;
  const bool no_red = MODES && !reduce;
  const int n_act = operators(nl, !no_red);
  for (int li = 0; li < n_act; ++li) {
    Layer L = mlp.layer[li];
    if (li == 0) L.k = lv;                   // the context columns follow below
    const bool lin = MODES && last_linear && li == n_act - 1;  // identity rules
    const bool last = no_red && li == nl - 1;  // outputs to ov/oj/oh
    const float* A = buf[cur];
    float* out = buf[cur ^ 1];
    const int lda = padded(L.k);
    const int ldo = padded(L.n);
    const int n_pad = round4(L.n);
    const float* bias_row = (li == 0) ? ctx + (size_t)b * f1 : L.b;
    const float* par_row = MOD ? par + (size_t)b * L.n : nullptr;
    float* za = stash ? st.z[li] : nullptr;
    float* an = (stash && !last) ? st.a[li + 1] : nullptr;
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[kComps][4];
      block_gemm<kComps>(acc, A, lda, L, n0, w_tiles);
      if (DERIV && li == 0 && lv < l0) {
        // context columns [lv, l0) of the J/H rows (zeros in the value
        // rows), a chunk at a time through the same accumulators; the
        // first output chunk also writes them to the stash
        float* cbuf = buf[0] + kRows * ld0;
        const int ldc = padded(kCtxChunk);
        for (int c0 = lv; c0 < l0; c0 += kCtxChunk) {
          const int kc = min(kCtxChunk, l0 - c0);
          for (int e = threadIdx.x; e < kRows * ldc; e += kThreads) {
            const int r = e / ldc;
            const int c = e % ldc;
            const int comp = r / kWarps;
            const int pt = pt0 + r % kWarps;
            float val = 0.f;
            if (pt < n_pts && c < kc) {
              if (comp > 0) {
                const float* src = comp <= D ? jt : ht;
                const int d = comp <= D ? comp - 1 : comp - 1 - D;
                val = src[(((size_t)b * D + d) * n_pts + pt) * l0 + c0 + c];
              }
              if (stash && n0 == 0)
                st.a[0][(((size_t)b * n_pts + pt) * C + comp) * l0 + c0 + c] = val;
            }
            cbuf[e] = val;
          }
          const Layer Lc{L.w + (size_t)c0 * L.ldw, nullptr, kc, L.n, L.ldw};
          block_gemm<kComps, true>(acc, cbuf, ldc, Lc, n0, w_tiles);
        }
      }
      // dropout factors of this thread's 4 columns: one Philox call per point
      float m[DERIV ? 1 : kComps][4];
#pragma unroll
      for (int i = 0; i < (DERIV ? 1 : kComps); ++i) {
        const int pt = pt0 + (DERIV ? p : i * kWarps + p);
        keep4(dr, li, b, ov_row0 + pt, (n0 + col) >> 2, m[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col + j;
        if (n >= n_pad) continue;
        if (n >= L.n) {  // padding columns of the next layer's input
          if (!last) {
#pragma unroll
            for (int i = 0; i < kComps; ++i) out[(i * kWarps + p) * ldo + n] = 0.f;
          }
          continue;
        }
        const float bias = bias_row[n];
        const float pm = MOD ? par_row[n] : 1.f;  // modulation after dropout
        if (DERIV) {
          const int pt = pt0 + p;
          const size_t g0 = ((size_t)b * n_pts + pt) * C;
          const bool keep_row = stash && pt < n_pts;
          const bool store = last && pt < n_pts;
          float val, d1, d2;
          const float z = acc[0][j] + bias;
          if (lin) {
            val = z;
            d1 = 1.f;
            d2 = 0.f;
          } else {
            act_rules<ACT>(z, val, d1, d2);
          }
          const float mk = m[0][j] * pm;
          if (!last) out[p * ldo + n] = val * mk;
          if (store) ov[((size_t)b * ov_rows + ov_row0 + pt) * L.n + n] = val * mk;
          if (keep_row) {
            za[g0 * L.n + n] = z;
            if (!last) an[g0 * L.n + n] = val * mk;
          }
#pragma unroll
          for (int d = 0; d < D; ++d) {
            float zj = acc[1 + d][j];
            float zh = acc[1 + D + d][j];
            if (li == 0 && ja != nullptr && pt < n_pts) {  // j0_add mode
              const size_t o = (((size_t)b * D + d) * n_pts + pt) * L.n + n;
              zj += ja[o];
              zh += ha[o];
            }
            const float oj_ = d1 * zj * mk;
            const float oh_ = (d2 * zj * zj + d1 * zh) * mk;
            if (!last) {
              out[((1 + d) * kWarps + p) * ldo + n] = oj_;
              out[((1 + D + d) * kWarps + p) * ldo + n] = oh_;
            }
            if (store) {
              oj[(((size_t)b * n_pts + pt) * L.n + n) * D + d] = oj_;
              oh[(((size_t)b * n_pts + pt) * L.n + n) * D + d] = oh_;
            }
            if (keep_row) {
              za[(g0 + 1 + d) * L.n + n] = zj;
              za[(g0 + 1 + D + d) * L.n + n] = zh;
              if (!last) {
                an[(g0 + 1 + d) * L.n + n] = oj_;
                an[(g0 + 1 + D + d) * L.n + n] = oh_;
              }
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < kComps; ++i) {
            const int pt = pt0 + i * kWarps + p;
            const float z = acc[i][j] + bias;
            const float a = (lin ? z : act_value<ACT>(z)) * (m[DERIV ? 0 : i][j] * pm);
            if (!last) out[(i * kWarps + p) * ldo + n] = a;
            if (pt < n_pts) {
              if (stash) {
                za[((size_t)b * n_pts + pt) * L.n + n] = z;
                if (!last) an[((size_t)b * n_pts + pt) * L.n + n] = a;
              }
              if (last) ov[((size_t)b * ov_rows + ov_row0 + pt) * L.n + n] = a;
            }
          }
        }
      }
    }
    cur ^= 1;
  }
  if (no_red) return;

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

// Reverse sweep over one 40-row tile. wt.layer[i] is W_i in nn.Linear's
// (out, in) layout read as a (k = n_i) x (n = k_i) matrix, so block_gemm
// computes GA_i = GZ_i W_i^T. z[i] / gz[i] are the stash and cotangent rows
// of layer i (rows as in Stash); with MOD, dps.a[i] (n_cases * n_pts x n_i)
// receives layer i's dpar addends, one row per point. dv rows hold the lv
// local columns; dja/dha (j0_add mode, else null) receive the J/H rows of
// GZ_0 as (n_cases, D, n_pts, F1).
template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
__global__ void __launch_bounds__(kThreads)
    mlp_prop_bwd_rows(const float* __restrict__ gv, int ov_rows, int ov_row0,
                      const float* __restrict__ gj, const float* __restrict__ gh, int n_pts,
                      const float* __restrict__ par, Mlp wt, Dropout dr, Stash st, Stash gzs,
                      Stash dps, int bw0, int bw1, int lv, float* __restrict__ dv,
                      float* __restrict__ djt, float* __restrict__ dht,
                      float* __restrict__ dja, float* __restrict__ dha, bool reduce,
                      bool last_linear) {
  constexpr int kComps = 1 + 2 * D;
  constexpr int kRows = kComps * kWarps;
  constexpr int kPoints = DERIV ? kWarps : kRows;
  constexpr int C = DERIV ? kComps : 1;
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + kRows * bw0};
  float* w_tiles = buf[1] + kRows * bw1;

  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kPoints;
  const int p = row_slot();
  const int col = first_col();
  const int nl = wt.n_layers;
  const int n_out = wt.layer[nl - 1].k;       // O, or F without a reduction
  // without a reduction the staged cotangents are GA of the last operator,
  // whose rules a first step (li = nl, no GEMM) applies
  const bool no_red = MODES && !reduce;
  const int n_act = operators(nl, !no_red);

  // stage the output cotangents (GZ of the linear last layer)
  {
    const int ld = padded(n_out);
    float* gzl = gzs.a[nl - 1];
    for (int e = threadIdx.x; e < kRows * ld; e += kThreads) {
      const int r = e / ld;
      const int c = e % ld;
      const int comp = DERIV ? r / kWarps : 0;
      const int pt = pt0 + (DERIV ? r % kWarps : r);
      float val = 0.f;
      if (pt < n_pts && c < n_out) {
        if (comp == 0) {
          val = gv[((size_t)b * ov_rows + ov_row0 + pt) * n_out + c];
        } else if (comp <= D) {
          val = gj[(((size_t)b * n_pts + pt) * n_out + c) * D + comp - 1];
        } else {
          val = gh[(((size_t)b * n_pts + pt) * n_out + c) * D + comp - 1 - D];
        }
        if (!no_red) gzl[(((size_t)b * n_pts + pt) * C + comp) * n_out + c] = val;
      }
      buf[0][e] = val;
    }
  }

  int cur = 0;
  for (int li = no_red ? nl : nl - 1; li >= 0; --li) {
    const bool pre = no_red && li == nl;       // GA_nl is the staged rows
    // k = n_li (GZ width), n = k_li
    const Layer L = pre ? Layer{nullptr, nullptr, n_out, n_out, n_out} : wt.layer[li];
    const float* A = buf[cur];
    float* out = buf[cur ^ 1];
    const int lda = padded(L.k);
    const int ldo = padded(L.n);
    const int n_pad = round4(L.n);
    const int lz = li - 1;                     // layer whose rules GA_li meets
    const float* z = li > 0 ? st.z[lz] : nullptr;
    float* gz = li > 0 ? gzs.a[lz] : nullptr;
    const float* par_row = MOD ? par + (size_t)b * L.n : nullptr;
    float* dpr = (MOD && li > 0) ? dps.a[lz] : nullptr;
    const bool lin = MODES && last_linear && lz == n_act - 1;  // identity rules
    for (int n0 = 0; n0 < L.n; n0 += kChunkN) {
      float acc[kComps][4];
      if (pre) {
        __syncthreads();  // the staged rows are complete
#pragma unroll
        for (int i = 0; i < kComps; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + col + j;
            acc[i][j] = n < L.n ? A[(i * kWarps + p) * lda + n] : 0.f;
          }
      } else {
        block_gemm<kComps>(acc, A, lda, L, n0, w_tiles);
      }
      if (li == 0) {  // input cotangents: dv, djt, dht
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + col + j;
          if (n >= L.n) continue;
#pragma unroll
          for (int i = 0; i < kComps; ++i) {
            const int comp = DERIV ? i : 0;
            const int pt = pt0 + (DERIV ? p : i * kWarps + p);
            if (pt >= n_pts) continue;
            if (comp == 0) {
              if (n < lv) dv[((size_t)b * n_pts + pt) * lv + n] = acc[i][j];
            } else if (comp <= D) {
              djt[(((size_t)b * D + comp - 1) * n_pts + pt) * L.n + n] = acc[i][j];
            } else {
              dht[(((size_t)b * D + comp - 1 - D) * n_pts + pt) * L.n + n] = acc[i][j];
            }
          }
        }
        continue;
      }
      float m[DERIV ? 1 : kComps][4];
#pragma unroll
      for (int i = 0; i < (DERIV ? 1 : kComps); ++i) {
        const int pt = pt0 + (DERIV ? p : i * kWarps + p);
        keep4(dr, lz, b, ov_row0 + pt, (n0 + col) >> 2, m[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col + j;
        if (n >= n_pad) continue;
        if (n >= L.n) {
#pragma unroll
          for (int i = 0; i < kComps; ++i) out[(i * kWarps + p) * ldo + n] = 0.f;
          continue;
        }
        const float pm = MOD ? par_row[n] : 1.f;
        if (DERIV) {
          const int pt = pt0 + p;
          if (pt >= n_pts) {
#pragma unroll
            for (int i = 0; i < kComps; ++i) out[(i * kWarps + p) * ldo + n] = 0.f;
            continue;
          }
          const size_t g0 = ((size_t)b * n_pts + pt) * C;
          const float mk = m[0][j];
          const float mke = mk * pm;
          const float zv = z[g0 * L.n + n];
          float d1, d2, d3;
          if (lin) {
            d1 = 1.f;
            d2 = 0.f;
            d3 = 0.f;
          } else {
            act_rules3<ACT>(zv, d1, d2, d3);
          }
          float gzv = acc[0][j] * mke * d1;
          // dpar addend: GA against the pre-modulation (v, J, H) of the point
          float dp = MOD ? acc[0][j] * (lin ? zv : act_value<ACT>(zv)) : 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float zj = z[(g0 + 1 + d) * L.n + n];
            const float zh = z[(g0 + 1 + D + d) * L.n + n];
            if (MOD) dp += acc[1 + d][j] * (d1 * zj) + acc[1 + D + d][j] * (d2 * zj * zj + d1 * zh);
            const float gjd = acc[1 + d][j] * mke;
            const float ghd = acc[1 + D + d][j] * mke;
            gzv += gjd * zj * d2 + ghd * (zj * zj * d3 + zh * d2);
            const float gzj = gjd * d1 + 2.f * ghd * zj * d2;
            const float gzh = ghd * d1;
            out[((1 + d) * kWarps + p) * ldo + n] = gzj;
            out[((1 + D + d) * kWarps + p) * ldo + n] = gzh;
            gz[(g0 + 1 + d) * L.n + n] = gzj;
            gz[(g0 + 1 + D + d) * L.n + n] = gzh;
            if (lz == 0 && dja != nullptr) {  // j0_add mode: GZ_0's J/H rows
              const size_t o = (((size_t)b * D + d) * n_pts + pt) * L.n + n;
              dja[o] = gzj;
              dha[o] = gzh;
            }
          }
          out[p * ldo + n] = gzv;
          gz[g0 * L.n + n] = gzv;
          if (MOD) dpr[((size_t)b * n_pts + pt) * L.n + n] = dp * mk;
        } else {
#pragma unroll
          for (int i = 0; i < kComps; ++i) {
            const int pt = pt0 + i * kWarps + p;
            float g = 0.f;
            if (pt < n_pts) {
              const size_t g0 = (size_t)b * n_pts + pt;
              const float zv = z[g0 * L.n + n];
              const float mi = m[DERIV ? 0 : i][j];
              g = acc[i][j] * (mi * pm) * (lin ? 1.f : act_d1<ACT>(zv));
              gz[g0 * L.n + n] = g;
              if (MOD) dpr[g0 * L.n + n] = acc[i][j] * (lin ? zv : act_value<ACT>(zv)) * mi;
            }
            out[(i * kWarps + p) * ldo + n] = g;
          }
        }
      }
    }
    cur ^= 1;
  }
}

struct PropArgs {
  int n_cases, n_pts, ov_rows, ov_row0;
  const float* par;                            // (n_cases, F) with MOD, else null
  Mlp mlp;
  Dropout dr;
  Stash st;
  int lv;                                      // local (value-row) input width
  const float* ja;                             // j0_add mode's addends, else null
  const float* ha;
  float* dja;                                  // and their cotangents
  float* dha;
  bool reduce;                                 // the trunk's modes (MOD only)
  bool last_linear;
};

template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
int launch_prop_fwd(const float* v, const float* jt, const float* ht, const float* ctx,
                    const PropArgs& a, float* ov, float* oj, float* oh, cudaStream_t s) {
  constexpr int kRows = (1 + 2 * D) * kWarps;
  constexpr int kPoints = DERIV ? kWarps : kRows;
  // buffer 0 stages only the local columns of layer 0's input, and in the
  // context-column mode the context chunk beside them
  Mlp staged = a.mlp;
  const bool ctx_cols = a.lv < staged.layer[0].k;
  staged.layer[0].k = a.lv;
  int bw0, bw1;
  buffer_widths(staged, &bw0, &bw1);
  if (ctx_cols) bw0 = max(bw0, padded(a.lv) + padded(kCtxChunk));
  const size_t smem = sizeof(float) * ((size_t)kRows * (bw0 + bw1) + 2 * kWTileFloats);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  auto kernel = mlp_prop_fwd<D, ACT, DERIV, MOD, MODES>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((a.n_pts + kPoints - 1) / kPoints, a.n_cases);
  kernel<<<grid, kThreads, smem, s>>>(v, jt, ht, a.ja, a.ha, a.lv, a.n_pts, ctx, a.par, a.mlp,
                                      a.dr, a.st, bw0, bw1, ov, a.ov_rows, a.ov_row0, oj, oh,
                                      a.reduce, a.last_linear);
  return (int)cudaGetLastError();
}

template <int D, int ACT, bool DERIV, bool MOD, bool MODES>
int launch_prop_bwd(const float* gv, const float* gj, const float* gh, const PropArgs& a,
                    const Mlp& wt, const Stash& gzs, const Stash& dps, float* dv, float* djt,
                    float* dht, cudaStream_t s) {
  constexpr int kRows = (1 + 2 * D) * kWarps;
  constexpr int kPoints = DERIV ? kWarps : kRows;
  // step li reads buffer (top - li) & 1: buffer 0 holds the staged rows and
  // the GZ of layers top-2, top-4, ...; buffer 1 the others (top = nl - 1,
  // or nl for the first, GEMM-less step of the no-reduction mode)
  int bw[2] = {0, 0};
  const int nl = wt.n_layers;
  const int top = a.reduce ? nl - 1 : nl;
  const int n_out = wt.layer[nl - 1].k;
  for (int li = top; li >= 0; --li) {
    const int in_buf = (top - li) & 1;
    bw[in_buf] = max(bw[in_buf], padded(li == nl ? n_out : wt.layer[li].k));
    if (li > 0) bw[in_buf ^ 1] = max(bw[in_buf ^ 1], padded(li == nl ? n_out : wt.layer[li].n));
  }
  const size_t smem = sizeof(float) * ((size_t)kRows * (bw[0] + bw[1]) + 2 * kWTileFloats);
  if (smem > (size_t)max_shared_bytes()) return (int)cudaErrorInvalidValue;
  auto kernel = mlp_prop_bwd_rows<D, ACT, DERIV, MOD, MODES>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((a.n_pts + kPoints - 1) / kPoints, a.n_cases);
  kernel<<<grid, kThreads, smem, s>>>(gv, a.ov_rows, a.ov_row0, gj, gh, a.n_pts, a.par, wt, a.dr,
                                      a.st, gzs, dps, bw[0], bw[1], a.lv, dv, djt, dht, a.dja,
                                      a.dha, a.reduce, a.last_linear);
  return (int)cudaGetLastError();
}

#define PCT_PROP_DISPATCH(FN, MOD, MODES, ...)                               \
  switch (d_dims * 4 + act * 2 + (deriv ? 1 : 0)) {                          \
    case 4: return FN<1, kSilu, false, MOD, MODES>(__VA_ARGS__);             \
    case 5: return FN<1, kSilu, true, MOD, MODES>(__VA_ARGS__);              \
    case 6: return FN<1, kTanh, false, MOD, MODES>(__VA_ARGS__);             \
    case 7: return FN<1, kTanh, true, MOD, MODES>(__VA_ARGS__);              \
    case 8: return FN<2, kSilu, false, MOD, MODES>(__VA_ARGS__);             \
    case 9: return FN<2, kSilu, true, MOD, MODES>(__VA_ARGS__);              \
    case 10: return FN<2, kTanh, false, MOD, MODES>(__VA_ARGS__);            \
    case 11: return FN<2, kTanh, true, MOD, MODES>(__VA_ARGS__);             \
    case 12: return FN<3, kSilu, false, MOD, MODES>(__VA_ARGS__);            \
    case 13: return FN<3, kSilu, true, MOD, MODES>(__VA_ARGS__);             \
    case 14: return FN<3, kTanh, false, MOD, MODES>(__VA_ARGS__);            \
    case 15: return FN<3, kTanh, true, MOD, MODES>(__VA_ARGS__);             \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// lv < widths[0] (context columns) and the j0_add addends are layer-0 modes
// of a launch with derivatives through an activated layer 0 and a
// reduction; the trunk's modes (no reduction, a linear last operator) are
// MOD's alone and need an operator
template <bool MOD>
inline bool prop_valid(int d_dims, int act, int n_layers, int n_cases, int n_pts,
                       const int* widths, bool deriv, int lv, bool j0_add, bool reduce,
                       bool last_linear) {
  const bool coupled = lv < widths[0] || j0_add;
  return d_dims >= 1 && d_dims <= 3 && (act == kSilu || act == kTanh) && n_layers >= 1 &&
         n_layers <= kMaxLayers && n_cases >= 1 && n_pts >= 1 && lv >= 1 &&
         lv <= widths[0] && (MOD || (reduce && !last_linear)) &&
         (!last_linear || operators(n_layers, reduce) >= 1) &&
         (!coupled || (deriv && n_layers >= 2 && reduce && !last_linear));
}

// stash pointers of one launch: a[i] for every layer, then z[i] for the
// first n_act (the operators), each a (rows x width) block of one buffer
inline Stash make_stash(float* a_base, float* z_base, size_t rows, int n_layers, int n_act,
                        const int* widths) {
  Stash st{};
  size_t oa = 0, oz = 0;
  for (int i = 0; i < n_layers; ++i) {
    st.a[i] = a_base ? a_base + oa : nullptr;
    oa += rows * widths[i];
    if (i < n_act) {
      st.z[i] = z_base ? z_base + oz : nullptr;
      oz += rows * widths[i + 1];
    }
  }
  return st;
}

// Forward of one launch (see the extern "C" entry points for the arguments).
template <bool MOD>
int prop_forward(int d_dims, int act, bool deriv, const float* v, const float* jt,
                 const float* ht, int n_cases, int n_pts, const float* ctx, const float* par,
                 int n_layers, const float* const* w, const float* const* b, const int* widths,
                 float* ov, int ov_rows, int ov_row0, float* oj, float* oh, const Dropout& dr,
                 float* stash_a, float* stash_z, int lv, const float* ja, const float* ha,
                 cudaStream_t s, bool reduce = true, bool last_linear = false) {
  if (!prop_valid<MOD>(d_dims, act, n_layers, n_cases, n_pts, widths, deriv, lv, ja != nullptr,
                       reduce, last_linear) ||
      (ja == nullptr) != (ha == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)n_cases * n_pts * (deriv ? 1 + 2 * d_dims : 1);
  PropArgs a{n_cases, n_pts, ov_rows, ov_row0, par, make_mlp(n_layers, w, b, widths), dr,
             make_stash(stash_a, stash_z, rows, n_layers, operators(n_layers, reduce), widths),
             lv, ja, ha, nullptr, nullptr, reduce, last_linear};
  if constexpr (MOD) {
    if (!reduce || last_linear) {
      PCT_PROP_DISPATCH(launch_prop_fwd, MOD, true, v, jt, ht, ctx, a, ov, oj, oh, s)
    }
  }
  PCT_PROP_DISPATCH(launch_prop_fwd, MOD, false, v, jt, ht, ctx, a, ov, oj, oh, s)
}

// Scratch floats prop_backward needs for one launch of `rows` stash rows.
inline long long prop_backward_workspace(int n_cases, long long rows, int n_layers,
                                         const int* widths) {
  size_t need = 0;
  for (int i = 0; i < n_layers; ++i) {
    need = std::max(need, grad_scratch_floats((int)rows, widths[i], widths[i + 1]));
    need = std::max(need, (size_t)n_cases * widths[i + 1]);
  }
  return (long long)need;
}

// Backward of one prop_forward launch (see the extern "C" entry points).
// With MOD, dpar_rows (n_cases * n_pts x sum of the n_act operators' output
// widths) receives the per-point dpar addends, layer after layer, and dpar
// (n_cases, F) gets their per-case column sums ADDED, layer by layer.
template <bool MOD>
int prop_backward(int d_dims, int act, bool deriv, const float* gv, int ov_rows, int ov_row0,
                  const float* gj, const float* gh, int n_cases, int n_pts, int n_layers,
                  const float* const* w_orig, const int* ldw, const int* widths,
                  const Dropout& dr, const float* par, const float* stash_a,
                  const float* stash_z, float* gz_stash, float* dpar_rows, float* dv,
                  float* djt, float* dht, float* const* dw, float* const* db, float* dctx,
                  float* dpar, float* scratch, long long scratch_floats, int lv, float* dja,
                  float* dha, cudaStream_t s, bool reduce = true, bool last_linear = false) {
  if (!prop_valid<MOD>(d_dims, act, n_layers, n_cases, n_pts, widths, deriv, lv,
                       dja != nullptr, reduce, last_linear) ||
      (dja == nullptr) != (dha == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_act = operators(n_layers, reduce);
  const int C = deriv ? 1 + 2 * d_dims : 1;
  const size_t rows = (size_t)n_cases * n_pts * C;
  if (prop_backward_workspace(n_cases, (long long)rows, n_layers, widths) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  Mlp wt{};
  wt.n_layers = n_layers;
  for (int i = 0; i < n_layers; ++i) {
    wt.layer[i].w = w_orig[i];
    wt.layer[i].b = nullptr;
    wt.layer[i].k = widths[i + 1];
    wt.layer[i].n = widths[i];
    wt.layer[i].ldw = ldw[i];
  }
  PropArgs a{n_cases, n_pts, ov_rows, ov_row0, par, Mlp{}, dr,
             make_stash(const_cast<float*>(stash_a), const_cast<float*>(stash_z), rows,
                        n_layers, n_act, widths),
             lv, nullptr, nullptr, dja, dha, reduce, last_linear};
  // gz[i] (rows x widths[i+1]) and dpar addends (points x widths[i+1]),
  // layer after layer, in the a[] slots
  Stash gzs{}, dps{};
  size_t off = 0, off_p = 0;
  for (int i = 0; i < n_layers; ++i) {
    gzs.a[i] = gz_stash + off;
    off += rows * widths[i + 1];
    if (MOD && i < n_act) {
      dps.a[i] = dpar_rows + off_p;
      off_p += (size_t)n_cases * n_pts * widths[i + 1];
    }
  }
  int err;
  {
    auto run = [&]() -> int {
      if constexpr (MOD) {
        if (!reduce || last_linear) {
          PCT_PROP_DISPATCH(launch_prop_bwd, MOD, true, gv, gj, gh, a, wt, gzs, dps, dv, djt,
                            dht, s)
        }
      }
      PCT_PROP_DISPATCH(launch_prop_bwd, MOD, false, gv, gj, gh, a, wt, gzs, dps, dv, djt, dht,
                        s)
    };
    err = run();
  }
  if (err) return err;
  for (int i = 0; i < n_layers; ++i) {
    cudaError_t e = weight_grad<-1>(a.st.a[i], widths[i], gzs.a[i], widths[i + 1], (int)rows,
                                    widths[i], widths[i + 1], scratch, dw[i], s);
    if (e != cudaSuccess) return (int)e;
    const int n = widths[i + 1];
    float* target = i == 0 ? dctx : scratch;
    group_colsum<<<dim3((n + 31) / 32, n_cases), dim3(32, 8), 0, s>>>(
        gzs.a[i], n, C, n_pts, n_cases * n_pts, n, target, i == 0 ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (i > 0) {
      sum_partials<<<(n + 255) / 256, 256, 0, s>>>(scratch, n_cases, n, db[i]);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    if (MOD && i < n_act) {
      group_colsum<<<dim3((n + 31) / 32, n_cases), dim3(32, 8), 0, s>>>(
          dps.a[i], n, 1, n_pts, n_cases * n_pts, n, dpar, 1);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

}  // namespace
}  // namespace pct
