// Farthest-point sampling: from point 0, repeatedly pick the point
// farthest from everything picked so far, for a batch of clouds.
//
// Replaces the TPU kernel porous_cfd_tpu/ops/fps_pallas.py:_fps_kernel
// (pallas_call at fps_pallas.py:76), and on CUDA tensors carries
// porous_cfd_tpu/models/neighbors.py:farthest_point_sampling.
//
// What bounds it on an H100: neither bytes nor operations but latency. Each
// of the n_samples - 1 picks depends on the one before: it lowers every
// point's running min-distance by its distance to the last pick and takes
// the first argmax over the cloud. At the paths' 1,000 points that is about
// 5,000 flops a pick, a few dozen cycles of one SM; the pick's chain of
// reductions, barriers and shared-memory round trips sets the pace. The
// kernel this one replaced held the cloud and its minima in shared memory,
// one 512-thread block a cloud, and spent two barriers over 16 warps, a
// serial reduction by warp 0 and a broadcast through shared memory on every
// pick: 0.535 us a pick at N = 1000 and at N = 500 alike (NVIDIA H100 80GB
// HBM3, 700 W).
//
// Design A, one block a cloud (fps_kernel<D, P, false>), up to 8,192
// points. Thread t holds the P consecutive points tP .. tP + P - 1, their
// coordinates and running minima in registers (lower lanes and warps hold
// lower indices); a copy of the cloud in shared memory serves only to read
// the pick's coordinates, since registers cannot be indexed at run time. A
// pick: each lane lowers its minima and takes its first maximum by a tree
// over its points (a later point wins only when strictly larger); a block
// of more than one warp posts every lane's (bits, index) to shared memory
// (double-buffered by the pick's parity) and meets at one bar.sync; each
// lane then takes the first maximum of its own lane's posts across the
// warps, and the warp reduces the 32 results with two redux.sync: a max
// over the value's bits (the minima are >= 0 or FLT_MAX, so their bits
// order as unsigned; a padded point's -1 is posted as 0 behind every real
// point) and a min over the indices holding it. Every warp does that last
// step itself: no second barrier, no serial warp, no broadcast. A block has
// at most eight warps, so each lane reads at most eight posts; P grows to
// 32 instead. Warp 0's lane s % 32 keeps pick s, and the warp stores 32
// picks at a time.
//
// Design B, one thread-block cluster a cloud (fps_kernel<D, P, true>). CTA
// r of a cluster of C (16, a non-portable size) holds the contiguous slice
// [r T P, (r + 1) T P) as design A holds a cloud, one warp where 16 points
// a lane suffice, and reduces it as design A does. Warp 0's lanes l < C
// then send the CTA's (bits, index, coordinates) into slot [s & 1][r] of
// CTA l with st.async, which completes CTA l's mbarrier for that parity by
// its bytes; every CTA arms its own mbarrier with C slots' bytes and waits
// on it, and every warp takes the first maximum of the C slots (one
// redux.sync, the lowest rank holding it by a ballot) with the coordinates
// from that slot by a shuffle. No cluster-wide barrier a pick: a
// barrier.cluster arrive/wait pair in its place measured 2x slower (1.18
// against 0.53 us a pick at 8,192 2D points). A CTA can send pick s + 2
// into a buffer only after every CTA sent pick s + 1, which each does
// after reading pick s's slots, so two buffers suffice. The grid is B
// clusters, so a batch still runs side by side. A cluster launch is checked
// with cudaOccupancyMaxActiveClusters first and refused (kNoCluster) if no
// GPC can hold one.
//
// Crossover and limit (fps_cuda.fps_design chooses): design A up to 2,048
// points, design B past them: at 3,072 and 4,096 points B's 16 one-warp
// CTAs beat one block by 3-9%, at 2,048 they lose by 3-23% (one cloud,
// 2D and 3D; tools/time_engine.py --parts fps_sweep on an H100 80GB HBM3 at
// 700 W). The choice ignores the batch: 52 clouds of 4,096 points ran 4%
// faster as blocks, 13 such clouds 8% faster as clusters. Design B's limit is 16 CTAs of 256 threads of 32 points,
// 131,072 points in any D; past it the wrapper raises ValueError before
// any launch.
//
// Equal picks, not close ones: each squared distance is formed as the plain
// version forms it, in difference form, coordinate by coordinate, every
// subtraction, product and sum rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn: nothing is contracted into an FMA), from the f32 input as
// read, and every reduction takes the first maximum. One differing
// centroid would change every later level of a SetAbstraction chain.
//
// No TPU layout trick carries over: fps_pallas.py transposes the clouds to
// (D, B, N) so that points lie on the 128 lanes and the batch on sublanes,
// and reads the pick's coordinates by masked lane reductions. Here a point
// is a few floats in a thread's registers, the batch is the grid, and the
// pick's coordinates are one shared-memory load (design A) or travel with
// the CTA's winner in its slot (design B).
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;
constexpr int kNoCluster = -1;  // no GPC can hold one cluster of the launch

// threads a block may have: at most eight warps, so that every lane can read
// every warp's candidate of its own lane after one barrier
constexpr int kMaxThreads = 256;

// floats a point takes in the shared copy: one vector load reads it
template <int D>
constexpr int kStride = D == 3 ? 4 : D;

// a CTA's winner in a cluster: its minimum's bits, index and coordinates
// (the third in hi.x)
struct Slot {
  uint4 lo;
  uint4 hi;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// bytes into another CTA's shared memory that count towards that CTA's
// mbarrier transaction
__device__ __forceinline__ void store_async(unsigned remote, uint4 v, unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void store_async(unsigned remote, unsigned v, unsigned remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   remote),
               "r"(v), "r"(remote_bar)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// point i of a shared copy
template <int D>
__device__ __forceinline__ void load_point(const float* cloud, int i, float (&c)[D]) {
  if constexpr (D == 1) {
    c[0] = cloud[i];
  } else if constexpr (D == 2) {
    const float2 v = reinterpret_cast<const float2*>(cloud)[i];
    c[0] = v.x;
    c[1] = v.y;
  } else {
    const float4 v = reinterpret_cast<const float4*>(cloud)[i];
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
  }
}

// the warp's first maximum where lower lanes hold lower indices: the
// largest bits by one redux.sync, the lowest lane holding them by a ballot
__device__ __forceinline__ int lowest_lane_of_max(unsigned bits, unsigned& top) {
  top = __reduce_max_sync(kFull, bits);
  return __ffs(__ballot_sync(kFull, bits == top)) - 1;
}

template <int D, int P, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fps_kernel(const float* __restrict__ pos, int n, int n_samples, long long* __restrict__ out) {
  extern __shared__ float4 cloud_raw[];          // this block's points, kStride<D> floats each
  float* cloud = reinterpret_cast<float*>(cloud_raw);
  __shared__ uint2 lane_slot[2][kMaxThreads];   // each lane's best, by pick parity
  __shared__ __align__(16) Slot cta_slot[2][kMaxCluster];  // design B: each CTA's best
  __shared__ __align__(8) unsigned long long full[2];      // design B: their arrival

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int cid = kCluster ? cluster_id() : blockIdx.x;
  const int rank = kCluster ? cluster_rank() : 0;
  const int ctas = kCluster ? cluster_size() : 1;
  const int base = rank * threads * P;           // the block's slice of the cloud
  const int count = min(threads * P, n - base);  // its points (<= 0: none)
  // thread tid holds the P consecutive points first, first + 1, ...: lower
  // lanes, warps and CTAs hold lower indices
  const int first = base + tid * P;
  const float* pc = pos + (size_t)cid * n * D;

  for (int e = tid; e < count * D; e += threads)
    cloud[(e / D) * kStride<D> + e % D] = pc[(size_t)base * D + e];
  float x[P][D], m[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const bool real = first + j < n;
    m[j] = real ? FLT_MAX : -1.f;                 // a padded point never wins
#pragma unroll
    for (int d = 0; d < D; ++d) x[j][d] = real ? pc[(size_t)(first + j) * D + d] : 0.f;
  }
  float c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = pc[d];       // the first pick, point 0
  constexpr unsigned kSlotBytes = D == 3 ? 20u : 16u;
  if (kCluster && tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[b])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (kCluster) cluster_barrier();     // every CTA runs before any remote store

  long long* ob = out + (size_t)cid * n_samples;
  const bool writer = warp == 0 && rank == 0;
  int mine = 0;                                   // lane s % 32 of warp 0 keeps pick s
  for (int s = 1; s < n_samples; ++s) {
    const int buf = s & 1;
    // lower each minimum, then the lane's first maximum by a tree over its
    // points in ascending index (a later point wins only when larger)
    float v[P];
    int bj[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float df = __fsub_rn(x[j][0], c[0]);
      float acc = __fmul_rn(df, df);
#pragma unroll
      for (int d = 1; d < D; ++d) {
        df = __fsub_rn(x[j][d], c[d]);
        acc = __fadd_rn(acc, __fmul_rn(df, df));
      }
      m[j] = fminf(m[j], acc);
      v[j] = m[j];
      bj[j] = j;
    }
#pragma unroll
    for (int step = 1; step < P; step *= 2) {
#pragma unroll
      for (int j = 0; j + step < P; j += 2 * step) {
        const bool later = v[j + step] > v[j];
        v[j] = later ? v[j + step] : v[j];
        bj[j] = later ? bj[j + step] : bj[j];
      }
    }
    unsigned bits = __float_as_uint(fmaxf(v[0], 0.f)), top;
    int idx = first + bj[0];
    // the block's first maximum with one warp-wide reduction: every lane
    // posts its best, one barrier, each lane takes the first maximum of its
    // own lane's posts across the warps (lower warps hold lower indices),
    // then two redux.sync: the largest bits, the lowest index holding them
    if (warps > 1) {
      lane_slot[buf][tid] = make_uint2(bits, static_cast<unsigned>(idx));
      __syncthreads();
      const uint2 own = lane_slot[buf][lane];
      bits = own.x;
      idx = static_cast<int>(own.y);
#pragma unroll 4
      for (int w = 1; w < warps; ++w) {
        const uint2 o = lane_slot[buf][w * 32 + lane];
        if (o.x > bits) {
          bits = o.x;
          idx = static_cast<int>(o.y);
        }
      }
    }
    top = __reduce_max_sync(kFull, bits);
    idx = __reduce_min_sync(kFull, bits == top ? idx : INT_MAX);
    if constexpr (!kCluster) {
      load_point<D>(cloud, idx, c);
    } else {
      // each CTA's best into slot [s & 1][rank] of every CTA, counted by
      // that CTA's mbarrier; then every warp takes the first maximum of the
      // slots, lower ranks holding lower indices
      if (warp == 0 && lane < ctas) {
        float w[D];
        load_point<D>(cloud, idx - base, w);
        const unsigned bar = map_rank(smem_addr(&full[buf]), lane);
        float y = 0.f;
        if constexpr (D > 1) y = w[1];
        store_async(map_rank(smem_addr(&cta_slot[buf][rank].lo), lane),
                    make_uint4(top, static_cast<unsigned>(idx), __float_as_uint(w[0]),
                               __float_as_uint(y)),
                    bar);
        if constexpr (D == 3)
          store_async(map_rank(smem_addr(&cta_slot[buf][rank].hi), lane), __float_as_uint(w[2]),
                      bar);
      }
      if (tid == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                         smem_addr(&full[buf])),
                     "r"(ctas * kSlotBytes)
                     : "memory");
      bar_wait(smem_addr(&full[buf]), ((s - 1) >> 1) & 1);
      uint4 lo = make_uint4(0u, 0u, 0u, 0u);      // an absent slot: bits 0, above the others
      float z = 0.f;
      if (lane < ctas) {
        lo = cta_slot[buf][lane].lo;
        if constexpr (D == 3) z = __uint_as_float(cta_slot[buf][lane].hi.x);
      }
      const int from = lowest_lane_of_max(lo.x, top);
      idx = __shfl_sync(kFull, static_cast<int>(lo.y), from);
      const float w[3] = {__uint_as_float(lo.z), __uint_as_float(lo.w), z};
#pragma unroll
      for (int d = 0; d < D; ++d) c[d] = __shfl_sync(kFull, w[d], from);
    }

    if (writer) {
      if ((s & 31) == lane) mine = idx;
      if ((s & 31) == 31) ob[s - 31 + lane] = mine;
    }
  }
  const int tail = (n_samples - 1) & 31;          // picks not yet stored
  if (writer && tail != 31 && lane <= tail) ob[n_samples - 1 - tail + lane] = mine;
  if constexpr (kCluster) {                       // no CTA leaves while a store to it flies
    __syncwarp();
    cluster_barrier();
  }
}

template <int D, int P, bool kCluster>
int launch(const float* pos, int n_clouds, int n, int n_samples, int ctas, int threads,
           long long* out, cudaStream_t s) {
  auto kern = fps_kernel<D, P, kCluster>;
  if (threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      (kCluster ? ctas < 2 || ctas > kMaxCluster : ctas != 1) ||
      (long long)ctas * threads * P < n)
    return (int)cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(float)) * kStride<D> * threads * P;
  cudaError_t e = cudaSuccess;
  if (smem > 40 * 1024) {                        // past 48 KB with the static slots: opt in
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if constexpr (!kCluster) {
    kern<<<n_clouds, threads, smem, s>>>(pos, n, n_samples, out);
    return (int)cudaGetLastError();
  } else {
    if (ctas > 8) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_clouds * ctas);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return kNoCluster;
    e = cudaLaunchKernelEx(&cfg, kern, pos, n, n_samples, out);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
}

template <int D, bool kCluster>
int by_points(const float* pos, int n_clouds, int n, int n_samples, int ctas, int threads,
              int per_thread, long long* out, cudaStream_t s) {
  switch (per_thread) {
    case 1: return launch<D, 1, kCluster>(pos, n_clouds, n, n_samples, ctas, threads, out, s);
    case 2: return launch<D, 2, kCluster>(pos, n_clouds, n, n_samples, ctas, threads, out, s);
    case 4: return launch<D, 4, kCluster>(pos, n_clouds, n, n_samples, ctas, threads, out, s);
    case 8: return launch<D, 8, kCluster>(pos, n_clouds, n, n_samples, ctas, threads, out, s);
    case 16: return launch<D, 16, kCluster>(pos, n_clouds, n, n_samples, ctas, threads, out, s);
    case 32: return launch<D, 32, kCluster>(pos, n_clouds, n, n_samples, ctas, threads, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int by_design(const float* pos, int n_clouds, int n, int n_samples, int ctas, int threads,
              int per_thread, long long* out, cudaStream_t s) {
  return ctas == 1
             ? by_points<D, false>(pos, n_clouds, n, n_samples, ctas, threads, per_thread, out, s)
             : by_points<D, true>(pos, n_clouds, n, n_samples, ctas, threads, per_thread, out, s);
}

}  // namespace

// pos (n_clouds, n, d) f32, d in 1..3; out (n_clouds, n_samples) int64, the
// picks in order, out[:, 0] = 0. The design, as fps_cuda.fps_design gives
// it: ctas = 1 for design A (a block a cloud), 2..16 for design B (a
// cluster of that many CTAs a cloud); threads a block (a multiple of 32)
// and per_thread points a thread (1, 2, 4, 8, 16 or 32), with ctas * threads *
// per_thread >= n. Returns the CUDA error code of the launch (0 = ok), or
// -1 when no GPC can hold one cluster.
extern "C" int fps_forward(const float* pos, int n_clouds, int n, int d, int n_samples, int ctas,
                           int threads, int per_thread, long long* out, void* stream) {
  if (n_clouds < 1 || n < 1 || n_samples < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return by_design<1>(pos, n_clouds, n, n_samples, ctas, threads, per_thread, out, s);
    case 2: return by_design<2>(pos, n_clouds, n, n_samples, ctas, threads, per_thread, out, s);
    case 3: return by_design<3>(pos, n_clouds, n, n_samples, ctas, threads, per_thread, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
