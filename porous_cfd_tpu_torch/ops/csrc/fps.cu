// Farthest-point sampling: from point 0, repeatedly pick the point
// farthest from everything picked so far, for a batch of clouds.
//
// Replaces the TPU kernel porous_cfd_tpu/ops/fps_pallas.py:_fps_kernel
// (pallas_call at fps_pallas.py:76), and on CUDA tensors carries
// porous_cfd_tpu/models/neighbors.py:farthest_point_sampling.
//
// What bounds it on an H100: neither bytes nor operations but latency. Each
// of the n_samples - 1 steps depends on the previous pick: it lowers the
// running min-distance field by the distance to the last pick (3 N flops)
// and takes a block-wide argmax, so a step is a few hundred cycles of
// dependent shared-memory work and two barriers whatever N is.
//
// Design: one block per cloud, so all clouds of a batch run side by side (the
// TPU kernel put the batch on sublanes for the same reason). The cloud's
// coordinates and its min-distance field live in shared memory; each thread
// owns the points threadIdx.x + j * blockDim.x. A step: each thread updates
// its points and keeps its first largest value; warp shuffles and then one
// warp over the per-warp winners reduce (value, index) pairs, a larger value
// winning and equal values going to the lower index (the first maximum, as
// jnp.argmax and torch.argmax take it). The distance is formed in difference
// form, coordinate by coordinate, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into an FMA), which
// is the plain version's arithmetic, so the picks are equal, not just close.
// No TPU layout trick carries over: the TPU kernel's (D, B, N) transpose put
// points on lanes; here a point is a few consecutive floats.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// does (v, i) beat (best, best_i)? larger value, then lower index
__device__ __forceinline__ bool beats(float v, int i, float best, int best_i) {
  return v > best || (v == best && i < best_i);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ pos, int n, int n_samples,
               long long* __restrict__ out) {
  extern __shared__ float smem[];
  float* p = smem;               // n * D coordinates
  float* min_d2 = p + n * D;     // n running minima
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int picked;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* pb = pos + (size_t)b * n * D;
  for (int e = threadIdx.x; e < n * D; e += kThreads) p[e] = pb[e];
  for (int e = threadIdx.x; e < n; e += kThreads) min_d2[e] = FLT_MAX;
  long long* ob = out + (size_t)b * n_samples;
  if (threadIdx.x == 0) ob[0] = 0;
  int last = 0;
  __syncthreads();

  for (int s = 1; s < n_samples; ++s) {
    float c[D];
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = p[last * D + d];
    float best = -FLT_MAX;
    int best_i = INT_MAX;
    for (int j = threadIdx.x; j < n; j += kThreads) {  // ascending: strict > keeps the first
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float df = __fsub_rn(p[j * D + d], c[d]);
        acc = __fadd_rn(acc, __fmul_rn(df, df));
      }
      const float m = fminf(min_d2[j], acc);
      min_d2[j] = m;
      if (m > best) {
        best = m;
        best_i = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(kFullMask, best, off);
      const int i = __shfl_xor_sync(kFullMask, best_i, off);
      if (beats(v, i, best, best_i)) {
        best = v;
        best_i = i;
      }
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? red_v[lane] : -FLT_MAX;
      best_i = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(kFullMask, best, off);
        const int i = __shfl_xor_sync(kFullMask, best_i, off);
        if (beats(v, i, best, best_i)) {
          best = v;
          best_i = i;
        }
      }
      if (lane == 0) {
        picked = best_i;
        ob[s] = best_i;
      }
    }
    __syncthreads();
    last = picked;
  }
}

template <int D>
int launch(const float* pos, int n_clouds, int n, int n_samples, long long* out,
           cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)n * (D + 1);
  int dev = 0, most = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem + 2 * sizeof(float) * kWarps + sizeof(int) > (size_t)most)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(fps_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fps_kernel<D><<<n_clouds, kThreads, smem, s>>>(pos, n, n_samples, out);
  return (int)cudaGetLastError();
}

}  // namespace

// pos (n_clouds, n, d) f32, d in 1..3; out (n_clouds, n_samples) int64, the
// picks in order, out[:, 0] = 0. The cloud and its min-distance field must
// fit in shared memory (about 19,000 points in 2D). Returns the CUDA error
// code of the launch (0 = ok).
extern "C" int fps_forward(const float* pos, int n_clouds, int n, int d, int n_samples,
                           long long* out, void* stream) {
  if (n_clouds < 1 || n < 1 || n_samples < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(pos, n_clouds, n, n_samples, out, s);
    case 2: return launch<2>(pos, n_clouds, n, n_samples, out, s);
    case 3: return launch<3>(pos, n_clouds, n, n_samples, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
