// neural_ops_prop: the PI-GANO NeuralOperator trunk on the value, Jacobian
// and Hessian-diagonal rows of every point, and its fused linear reduction;
// forward and backward. Each operator is dense -> activation rules ->
// inverted dropout -> modulation of v, J and H by the pooled branch
// embedding par (per case, as wide as the trunk); the reduction is linear.
// Two modes of the TPU kernel's besides (neural_op_pallas.py:_Cfg): the last
// operator without an activation (last_activation=False, :74-75, :125-134),
// and no fused reduction (out_features=None, :64, :86-87, :143-147), where
// the output is the last operator's (v, J, H), F wide. PiGanoFull runs both
// together, once per output field. mlp_prop.cuh runs every operator through
// its product path (every layer is one without a reduction), the linear one
// with the identity's rules (d1 = 1, d2 = d3 = 0) and still dropped out and
// modulated; its backward first applies the last operator's rules to the
// staged output cotangents, whose products with the pre-modulation triple
// add to dpar like every other operator's.
//
// Replaces the TPU kernels porous_cfd_tpu/ops/neural_op_pallas.py:_fwd_kernel
// (:107; pallas_call at :357) and _bwd_kernel (:154; pallas_call at :391).
// The same kernels serve the internal launch (v, J, H rows) and the
// value-only boundary launch.
//
// What bounds it on an H100: operations. At the duct_variable_boundary
// envelope the internal launch runs 13 x 1500 x 5 = 97,500 rows through
// 176 -> 352 -> 352 -> 352 -> 352 -> 3 (434,720 multiply-adds a row, 84.8
// GFLOP) while reading 80 MB; the boundary launch runs 13,000 value rows
// (11.3 GFLOP). The backward does about twice the forward's work. At the
// f32-accurate tensor-core rate (3xTF32, 164.9 TFLOP/s) the forward takes
// 0.583 ms and the backward 1.165 ms, far above the bytes' time. Without
// the reduction (PiGanoFull) each trunk writes (13, 1500, 352, 2) J and H,
// 55 MB each, still below the operations' time.
//
// Design: mlp_prop.cuh's kernels with modulation (MOD = true), every
// product in 3xTF32 mma tiles; the TPU kernel's transposed (B, D, N, F)
// J/H, 128-row tiles and per-tile recompute are not carried over. The first
// operator's kernel is split by context: ctx = geom W0[176:] + b0 is
// computed once per case by torch and added to the value rows in place of a
// bias; J/H skip it. A 352-wide tile needs 40 x 356 floats per buffer: two
// buffers and the 52 KB weight ring come to 166 KB, one block per SM. 176
// and 352 are not multiples of the 128-column chunk: every epilogue, stash
// write, dropout factor and column sum masks the 96-wide tail. The training
// forward stashes each layer's (modulated) input rows and pre-activations
// (1.3 GB at the envelope); the backward's row sweep recomputes the
// pre-modulation triple from the pre-activations and the Philox masks and
// forms dpar's per-point addends in the epilogue of the same product that
// carries the cotangent down. dW, db, dctx and dpar are contracted or
// column-summed in order, without atomics.
#include "mlp_prop.cuh"

using namespace pct;

namespace pct {
namespace {

// there is at least one operator, and every operator's output is as wide as
// par: widths[1..n_act]
bool trunk_widths_ok(int n_layers, bool reduce, const int* widths) {
  const int n_act = operators(n_layers, reduce);
  if (n_act < 1) return false;
  for (int i = 2; i <= n_act; ++i)
    if (widths[i] != widths[1]) return false;
  return true;
}

}  // namespace
}  // namespace pct

// Arguments as decoder_prop_forward's (ctx = geom W0[L:] + b0; layer i <
// n_layers - 1 is operator i, the last layer the reduction F -> O; widths =
// (L, F, ..., F, O)), then par (n_cases, F), last_activation (0: the last
// operator is linear) and reduction (0: no reduction, every layer is an
// operator, widths = (L, F, ..., F), and the outputs are F wide), and wsplit
// as decoder_prop_forward's. Returns the CUDA error code (0 = ok).
extern "C" int neural_ops_prop_forward(int d_dims, int act, int with_derivatives,
                                       const float* v, const float* jt, const float* ht,
                                       int n_cases, int n_pts, const float* ctx, int n_layers,
                                       const float* const* w, const float* const* b,
                                       const int* widths, float* ov, int ov_rows,
                                       int ov_row0, float* oj, float* oh, unsigned k0,
                                       unsigned k1, const unsigned* thresh, const float* scale,
                                       const int* on, int case0, int row0, float* stash_a,
                                       float* stash_z, const float* par,
                                       int last_activation, int reduction,
                                       float* wsplit, long long wsplit_floats, void* stream) {
  if (par == nullptr || !trunk_widths_ok(n_layers, reduction != 0, widths))
    return (int)cudaErrorInvalidValue;
  return prop_forward<true>(d_dims, act, with_derivatives != 0, v, jt, ht, n_cases, n_pts,
                            ctx, par, n_layers, w, b, widths, ov, ov_rows, ov_row0, oj, oh,
                            make_dropout(k0, k1, n_layers, thresh, scale, on, case0, row0),
                            stash_a, stash_z, widths[0], nullptr, nullptr, wsplit, wsplit_floats,
                            static_cast<cudaStream_t>(stream), reduction != 0,
                            last_activation == 0);
}

// Floats of neural_ops_prop_forward's wsplit for one launch at these widths.
extern "C" long long neural_ops_prop_forward_workspace(int n_layers, const int* widths,
                                                       int v_width) {
  return prop_forward_workspace(n_layers, widths, v_width);
}

// Scratch floats neural_ops_prop_backward needs for one launch of `rows`
// stash rows over n_cases cases.
extern "C" long long neural_ops_prop_backward_workspace(int n_cases, long long rows,
                                                        int n_layers, const int* widths) {
  return prop_backward_workspace(n_cases, rows, n_layers, widths);
}

// Backward of one neural_ops_prop_forward launch (same inputs, dropout, par,
// modes and stash): arguments as decoder_prop_backward's, then par,
// dpar_rows (n_cases * n_pts x F * operators scratch for the per-point dpar
// addends), dpar (n_cases, F), to which the per-case cotangent of par is
// ADDED, operator by operator, and the forward's last_activation and
// reduction.
extern "C" int neural_ops_prop_backward(
    int d_dims, int act, int with_derivatives, const float* gv, int ov_rows, int ov_row0,
    const float* gj, const float* gh, int n_cases, int n_pts, int n_layers,
    const float* const* w_orig, const int* ldw, const int* widths, unsigned k0, unsigned k1,
    const unsigned* thresh, const float* scale, const int* on, int case0, int row0,
    const float* stash_a, const float* stash_z, float* gz_stash, float* dv, float* djt,
    float* dht, float* const* dw, float* const* db, float* dctx, float* scratch,
    long long scratch_floats, const float* par, float* dpar_rows, float* dpar,
    int last_activation, int reduction,
    void* stream) {
  if (par == nullptr || dpar == nullptr || dpar_rows == nullptr ||
      !trunk_widths_ok(n_layers, reduction != 0, widths))
    return (int)cudaErrorInvalidValue;
  return prop_backward<true>(d_dims, act, with_derivatives != 0, gv, ov_rows, ov_row0, gj, gh,
                             n_cases, n_pts, n_layers, w_orig, ldw, widths,
                             make_dropout(k0, k1, n_layers, thresh, scale, on, case0, row0),
                             par, stash_a, stash_z, gz_stash, dpar_rows, dv, djt, dht, dw, db,
                             dctx, dpar, scratch, scratch_floats, widths[0], nullptr, nullptr,
                             static_cast<cudaStream_t>(stream), reduction != 0,
                             last_activation == 0);
}

// Blocks per SM and shared bytes of the trunk's kernels at D and these
// widths (see prop_occupancy): out[6].
extern "C" int neural_ops_prop_occupancy(int d_dims, int n_layers, const int* widths,
                                         int reduction, int* out) {
  return prop_occupancy<true>(d_dims, n_layers, widths, widths[0], reduction != 0, out);
}
