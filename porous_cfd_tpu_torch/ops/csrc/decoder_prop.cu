// decoder_prop: the PIPN decoder MLP on the value, Jacobian and
// Hessian-diagonal rows of every point, with the activation rules and
// inverted dropout applied between layers and a linear last layer; forward
// and backward, in its three modes.
//
// Replaces the TPU kernels porous_cfd_tpu/ops/decoder_pallas.py:_fwd_kernel
// (pallas_call at decoder_pallas.py:433) and _bwd_kernel (pallas_call at
// :473): the decoupled mode (per-case context through ctx only), the
// j0_add mode (additive layer-0 J/H terms and their cotangents dja/dha,
// :153-156, :199-201, :283-285, :355-357; the max-pool-coupled PIPN path
// through models/pipn.py's winner gather) and the ctx_width mode (J/H rows
// carry the context columns too, the full first-layer weight for them,
// :134-139, :195, :334-344). The same kernels serve the internal launch
// (v, J, H rows) and the value-only boundary launch, which is the
// decoupled mode in all three.
//
// What bounds it on an H100: operations. At the reference envelope the
// internal launch runs 13 x 1500 x 5 = 97,500 rows through 64 -> 512 -> 256 ->
// 128 -> 3 (196,992 multiply-adds a row, 38.4 GFLOP) while reading 25 MB; the
// boundary launch runs 13,000 value rows (5.1 GFLOP). The backward does the
// same work twice over (input cotangents and weight gradients, 87 GFLOP).
// At the f32-accurate tensor-core rate (3xTF32, 164.9 TFLOP/s) that is
// 0.264 ms forward and 0.528 ms backward, far above the bytes' time. The
// j0_add mode adds two (13, 2, 1500, 512) f32 reads forward and two writes
// backward (160 MB each way, about 0.05 ms at 3.35 TB/s); the ctx_width
// mode runs its 1024 context columns through layer 0 for every J/H row (a
// further 102 GFLOP forward), which is why the path takes the j0_add mode.
//
// Design: mlp_prop.cuh's kernels without modulation (MOD = false): every
// product in 3xTF32 mma tiles, one thread holding a point's 5 rows. The
// widest row buffer is the 512-wide layer-0 output: 40 x 516 floats plus a
// 40 x 260 buffer for the other layers and a 52 KB weight ring, 173 KB, one
// block per SM. The training stash is 0.7 GB at the envelope, written once
// and read once: about 0.4 ms of bandwidth, against the 0.26 ms of products
// a recompute would cost on top of a second pass over the rows. The
// addends are nullable pointers, not a template axis, so the
// instantiations do not double; the context columns stream through a
// 128-column staging tile, so shared memory stays at the decoupled size.
#include "mlp_prop.cuh"

using namespace pct;

// (in pct's anonymous namespace, as mlp_prop.cuh's kernels: a second one at
// global scope makes nvcc's generated launch stubs ambiguous)
namespace pct {
namespace {

// Philox4x32-10 on n (counter, key) sets, for the known-answer check
__global__ void philox_kernel(const unsigned* in, unsigned* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned* c = in + 6 * i;
  const uint4 r = philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]), c[4], c[5]);
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

}  // namespace
}  // namespace pct

// v (n_cases, n_pts, L) and, with derivatives, jt/ht (n_cases, D, n_pts, L);
// ctx (n_cases, F1) = g W0[:, L:]^T + b0; layer i has weight w[i] given as
// (widths[i], widths[i+1]) row-major, i.e. nn.Linear's weight transposed (for
// layer 0 only its first L input columns, the local block), and bias b[i]
// (b[0] unused: ctx takes its place); widths = (L, F1, ..., O). Values go to
// rows [ov_row0, ov_row0 + n_pts) of ov (n_cases, ov_rows, O); J/H to oj/oh
// (n_cases, n_pts, O, D). Dropout: key (k0, k1) and, per layer, the unsigned
// keep threshold, the scale 1 / keep and whether it is on (all may be null:
// no dropout); case0 and row0 are added to the masks' case index and merged
// row (a launch on a share of a batch's cases or rows; 0 for the whole).
// stash_a / stash_z (null: no stash) receive the training
// stash, rows ((b * n_pts + pt) * C + comp) with C = 1 + 2D (1 value-only):
// stash_a holds every layer's input rows, stash_z every hidden layer's
// pre-activations, layer after layer. v_width: the width of the v rows;
// below widths[0] (ctx_width mode, derivatives only) the jt/ht rows carry
// widths[0] - v_width context columns after the local ones and w[0] is the
// full (widths[0], F1) layer-0 weight. j0_add / h0_add (n_cases, D, n_pts,
// F1), or null: added to the J/H rows' layer-0 pre-activations. wsplit
// (wsplit_floats, at least decoder_prop_forward_workspace's) receives the
// launch's weights split for the tensor cores. Returns the CUDA error code
// (0 = ok).
extern "C" int decoder_prop_forward(int d_dims, int act, int with_derivatives,
                                    const float* v, const float* jt, const float* ht,
                                    int n_cases, int n_pts, const float* ctx, int n_layers,
                                    const float* const* w, const float* const* b,
                                    const int* widths, float* ov, int ov_rows,
                                    int ov_row0, float* oj, float* oh, unsigned k0,
                                    unsigned k1, const unsigned* thresh, const float* scale,
                                    const int* on, int case0, int row0, float* stash_a,
                                    float* stash_z, int v_width, const float* j0_add,
                                    const float* h0_add,
                                    float* wsplit, long long wsplit_floats, void* stream) {
  return prop_forward<false>(d_dims, act, with_derivatives != 0, v, jt, ht, n_cases, n_pts,
                             ctx, nullptr, n_layers, w, b, widths, ov, ov_rows, ov_row0, oj,
                             oh, make_dropout(k0, k1, n_layers, thresh, scale, on, case0, row0),
                             stash_a, stash_z, v_width, j0_add, h0_add, wsplit, wsplit_floats,
                             static_cast<cudaStream_t>(stream));
}

// Floats of decoder_prop_forward's wsplit for one launch at these widths.
extern "C" long long decoder_prop_forward_workspace(int n_layers, const int* widths,
                                                    int v_width) {
  return prop_forward_workspace(n_layers, widths, v_width);
}

// Scratch floats decoder_prop_backward needs for one launch of `rows` stash
// rows over n_cases cases.
extern "C" long long decoder_prop_backward_workspace(int n_cases, long long rows, int n_layers,
                                                     const int* widths) {
  return prop_backward_workspace(n_cases, rows, n_layers, widths);
}

// Backward of one decoder_prop_forward launch (same inputs, dropout and
// stash). gv (n_cases, ov_rows, O) and, with derivatives, gj/gh (n_cases,
// n_pts, O, D) are the output cotangents; w_orig[i] is layer i's nn.Linear
// weight (widths[i+1] x ldw[i]) row-major (layer 0: its first L columns are
// read). gz_stash (rows x sum of widths[1:]) receives every layer's
// pre-activation cotangents. Writes dv (n_cases, n_pts, L) and, with
// derivatives, djt/dht (n_cases, D, n_pts, widths[0]); ADDS dW_i (widths[i] x
// widths[i+1], (in, out) layout) to dw[i], the value-row sums of GZ_i to db[i]
// for i >= 1, and the per-case value-row sums of GZ_0 to dctx (n_cases, F1).
// v_width as the forward's (dv is (n_cases, n_pts, v_width)); dja / dha
// (n_cases, D, n_pts, F1), or null, receive the J/H rows of GZ_0, the
// cotangents of the forward's j0_add / h0_add.
extern "C" int decoder_prop_backward(
    int d_dims, int act, int with_derivatives, const float* gv, int ov_rows, int ov_row0,
    const float* gj, const float* gh, int n_cases, int n_pts, int n_layers,
    const float* const* w_orig, const int* ldw, const int* widths, unsigned k0, unsigned k1,
    const unsigned* thresh, const float* scale, const int* on, int case0, int row0,
    const float* stash_a, const float* stash_z, float* gz_stash, float* dv, float* djt,
    float* dht, float* const* dw, float* const* db, float* dctx, float* scratch,
    long long scratch_floats, int v_width, float* dja, float* dha, void* stream) {
  return prop_backward<false>(d_dims, act, with_derivatives != 0, gv, ov_rows, ov_row0, gj, gh,
                              n_cases, n_pts, n_layers, w_orig, ldw, widths,
                              make_dropout(k0, k1, n_layers, thresh, scale, on, case0, row0),
                              nullptr, stash_a, stash_z, gz_stash, nullptr, dv, djt, dht, dw,
                              db, dctx, nullptr, scratch, scratch_floats, v_width, dja, dha,
                              static_cast<cudaStream_t>(stream));
}

// Scratch floats decoder_prop_weight_grad needs.
extern "C" long long decoder_prop_weight_grad_workspace(int rows, int K, int N) {
  return (long long)grad_scratch_floats(rows, K, N);
}

// out (K, N) += a^T g for a (rows, K) and g (rows, N), both row-major and
// contiguous: the engine's weight-gradient contraction (common.cuh's
// weight_grad) alone, as every backward launch runs it for each layer.
extern "C" int decoder_prop_weight_grad(const float* a, const float* g, int rows, int K, int N,
                                        float* scratch, long long scratch_floats, float* out,
                                        void* stream) {
  if (rows < 1 || K < 1 || N < 1 || (long long)grad_scratch_floats(rows, K, N) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  return (int)weight_grad<-1>(a, K, g, N, rows, K, N, scratch, out,
                              static_cast<cudaStream_t>(stream));
}

// Blocks per SM and shared bytes of the decoder's kernels at D and these
// widths (see prop_occupancy): out[6].
extern "C" int decoder_prop_occupancy(int d_dims, int n_layers, const int* widths, int v_width,
                                      int* out) {
  return prop_occupancy<false>(d_dims, n_layers, widths, v_width, true, out);
}

// Philox4x32-10 of n (c0, c1, c2, c3, k0, k1) sets in device memory.
extern "C" int decoder_prop_philox(const unsigned* in, unsigned* out, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  philox_kernel<<<(n + 127) / 128, 128, 0, s>>>(in, out, n);
  return (int)cudaGetLastError();
}
