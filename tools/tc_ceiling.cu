// The tensor cores' TF32 rate on the card through the two instructions the
// port's kernels use, and a check of wgmma's shared-memory descriptor
// layout. Built and run by tools/tc_ceiling.py.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NACC independent accumulators a warp, back-to-back products
template <int NACC>
__global__ void mma_loop(float* out, int iters) {
  unsigned a[4];
  for (int i = 0; i < 4; ++i) a[i] = to_tf32(1.0f + threadIdx.x * 1e-3f + i);
  const unsigned b0 = to_tf32(0.5f), b1 = to_tf32(0.25f);
  float acc[NACC][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < NACC; ++k) mma_tf32(acc[k], a, b0, b1);
  float s = 0.f;
  for (int k = 0; k < NACC; ++k)
    for (int q = 0; q < 4; ++q) s += acc[k][q];
  if (s == 123.f) out[0] = s;  // keeps the products
}

// K-major tile without swizzling: LBO along K, SBO along N (bytes)
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo, int sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_64x64(float (&d)[32], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x 64) = A (64 x 8, registers) Bt (64 x 8, K-major in shared memory:
// chunk (n, k / 4) at (n / 8) * sbo + (k / 4) * lbo + (n % 8) * 16 bytes)
__global__ void wgmma_check(const float* A, const float* Bt, float* D, int lbo, int sbo) {
  __shared__ __align__(128) float bs[64 * 8 * 2];
  const int tid = threadIdx.x;
  for (int e = tid; e < 64 * 8; e += 128) {
    const int n = e / 8, k = e % 8;
    bs[((n / 8) * sbo + (k / 4) * lbo + (n % 8) * 16) / 4 + k % 4] =
        __uint_as_float(to_tf32(Bt[n * 8 + k]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const unsigned a[4] = {to_tf32(A[(16 * w + g) * 8 + t]), to_tf32(A[(16 * w + g + 8) * 8 + t]),
                         to_tf32(A[(16 * w + g) * 8 + t + 4]),
                         to_tf32(A[(16 * w + g + 8) * 8 + t + 4])};
  float d[32] = {};
  wg_fence();
  wgmma_64x64(d, a, make_desc(bs, lbo, sbo));
  wg_commit();
  wg_wait0();
  for (int i = 0; i < 8; ++i)
    for (int q = 0; q < 4; ++q)
      D[(16 * w + g + 8 * (q >> 1)) * 64 + 8 * i + 2 * t + (q & 1)] = d[4 * i + q];
}

// warpgroups looping over four m64n64k8 products on two accumulators
__global__ void wgmma_loop(float* out, int iters) {
  __shared__ __align__(128) float bs[64 * 8];
  for (int e = threadIdx.x; e < 64 * 8; e += blockDim.x) bs[e] = 0.5f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const unsigned a[4] = {to_tf32(1.f), to_tf32(2.f), to_tf32(3.f), to_tf32(4.f)};
  float d0[32] = {}, d1[32] = {};
  const uint64_t desc = make_desc(bs, 128, 256);
  for (int it = 0; it < iters; ++it) {
    wg_fence();
    wgmma_64x64(d0, a, desc);
    wgmma_64x64(d1, a, desc);
    wgmma_64x64(d0, a, desc);
    wgmma_64x64(d1, a, desc);
    wg_commit();
    wg_wait0();
  }
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += d0[i] + d1[i];
  if (s == 123.f) out[0] = s;
}

static float timed(void (*launch)(float*, int, int, int), int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch(out, blocks, threads, iters);  // warm-up
  cudaEventRecord(a);
  launch(out, blocks, threads, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = -1.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}

static void launch_mma4(float* o, int b, int t, int i) { mma_loop<4><<<b, t>>>(o, i); }
static void launch_mma16(float* o, int b, int t, int i) { mma_loop<16><<<b, t>>>(o, i); }
static void launch_wgmma(float* o, int b, int t, int i) { wgmma_loop<<<b, t>>>(o, i); }

// ms of `blocks` blocks of `threads` threads, each warp (mma.sync, nacc 4 or
// 16) or warpgroup (wgmma, nacc 0) doing `iters` rounds
extern "C" float tc_time(int nacc, int blocks, int threads, int iters) {
  return timed(nacc == 0 ? launch_wgmma : nacc == 4 ? launch_mma4 : launch_mma16, blocks,
               threads, iters);
}

extern "C" int tc_wgmma_check(const float* A, const float* Bt, float* D, int lbo, int sbo) {
  float *dA, *dB, *dD;
  cudaMalloc(&dA, 64 * 8 * 4);
  cudaMalloc(&dB, 64 * 8 * 4);
  cudaMalloc(&dD, 64 * 64 * 4);
  cudaMemcpy(dA, A, 64 * 8 * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, Bt, 64 * 8 * 4, cudaMemcpyHostToDevice);
  wgmma_check<<<1, 128>>>(dA, dB, dD, lbo, sbo);
  const cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(D, dD, 64 * 64 * 4, cudaMemcpyDeviceToHost);
  cudaFree(dA);
  cudaFree(dB);
  cudaFree(dD);
  return (int)e;
}
