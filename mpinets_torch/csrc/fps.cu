// Furthest-point sampling on Hopper (sm_90a), bound through a plain C
// interface (ctypes).
//
// Replaces: mpinets_tpu/kernels/pallas_ops.py::_fps_kernel and
// ::_fps_kernel_v2 (v2 computes the same function with a TPU output layout,
// so one kernel serves both `impl` values).
//
// Function: slot 0 is index 0; each next pick is the argmax of the running
// minimum squared distance to the picked set, the lowest index winning
// ties. Distances are f32 whatever the coordinate type (f32 or bf16). The
// picked coordinates are returned beside the indices.
//
// What bounds it on the H100: the npoint - 1 picks of a row are a chain,
// each needing the last pick's coordinates and each a row-wide argmax.
//  * At small B (the server's B=1, validation's B=3) one row's chain sets
//    the time: per pick, the distance pass over the row's points (12
//    CUDA-core instructions a point: 9 for the distance and the running
//    minimum, 3 for the running argmax), then the reduction to one winner
//    and the barrier between the two, whose latency does not shrink with N.
//  * At B=256 the rows fill the card, and the instructions per point and
//    pick bound it: the 9 uncontracted f32 operations per point (no FMA)
//    over the card's non-FMA f32 rate (132 SMs x 128 lanes x 1.98 GHz =
//    33.45e12 a second) give 0.22 ms at 6272 -> 512; the 12 instructions
//    a point, about 0.3 ms.
// The bytes (the cloud read once, the picks written once) are microseconds.
//
// Design (one launch; the plan by (B, N) is the caller's, ops.fps_plan):
//  * Points in registers. A row runs on `cluster` blocks of `threads`
//    threads, P points a thread (P = 8, 4, 2 or 1, a template parameter):
//    point i = g + k * (cluster * threads) for the thread's rank g in the
//    row, so a thread's points ascend with k. Each thread keeps x, y, z and
//    the running minimum md of its points in registers, so a pick reads no
//    shared memory for distances. Points past N hold md = -1, which never
//    wins.
//  * A warp argmax in two instructions. md >= 0 (fminf of sums of rounded
//    squares, starting from +inf, never gives -0), so its f32 bits order as
//    unsigned integers: __reduce_max_sync on the bits gives the warp's
//    largest value, __reduce_min_sync over (bits == max ? index : INT_MAX)
//    the lowest index holding it. Ties are broken on the index, never on
//    lane order: a thread's candidate is its lowest index of its largest
//    value (strict > in ascending k).
//  * One barrier per pick. Lane 0 of each warp writes the warp's (bits,
//    index) record into a slot array in shared memory, double-buffered by
//    the pick's parity, so a fast warp's next record never overwrites one a
//    slow warp still reads. After one __syncthreads every warp reads all
//    the records (warps x cluster <= 32: one a lane) and reduces them
//    itself with the same two instructions; the winner's coordinates come
//    from a copy of the row in shared memory (x[N], y[N], z[N] f32, 75 KB
//    at N=6272), read at the winning index: one load after the reduction,
//    where records carrying x, y, z would need the winning lane's load (or
//    selects in the distance loop) before the barrier and a shuffle after
//    it. The picked indices are kept in shared memory and written out, with
//    their coordinates, after the last pick: no global store is on the
//    chain.
//  * A cluster per row at small B (the plan takes cluster = 2 or 4 where
//    B x cluster fits the card's SMs; the kernel also takes 8, which was
//    slower than 4; a cluster's blocks hold 8 points a thread). The row's
//    distance work is split over the cluster's blocks. Lane r of each warp
//    sends the warp's record to rank r with st.async, which counts its
//    bytes on rank r's mbarrier for that parity; each block's thread 0 arms
//    its mbarrier with the bytes of all the row's records, and every thread
//    waits on its own block's mbarrier. So a pick costs one remote store
//    and one local wait, not a cluster barrier (barrier.cluster with
//    release/acquire cost more than the split saved). A record for pick
//    t + 2 cannot reach a slot still being read for pick t: it is sent
//    after its sender read pick t + 1's records, which every warp sends
//    only after reading pick t's. A cluster.sync() before the first pick makes
//    sure every block runs and has set its mbarriers before any record is
//    sent, and one after the last that none leaves while another still
//    works. Every block keeps the whole row's copy, so the winner's
//    coordinates are a local read.
//
// Rounding: nvcc contracts a*b+c into an FMA by default, which rounds the
// squared distance differently from the plain version and moves argmax
// picks at near-ties. The distance is therefore written with
// __fsub_rn/__fmul_rn/__fadd_rn, which are never contracted, summed left to
// right: (dx*dx + dy*dy) + dz*dz.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRecords = 32;  // warps x cluster ranks: one record a lane
constexpr int kMaxCluster = 8;

// Threads a block may have at P points a thread: P = 8 keeps 32 registers of
// point state, so its blocks stop at 800 threads (80 registers a thread).
__host__ __device__ constexpr int max_threads(int p) { return p == 8 ? 800 : 1024; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The warp's largest key and the lowest index holding it.
__device__ __forceinline__ uint2 warp_argmax(unsigned key, int i) {
  const unsigned m = __reduce_max_sync(kFull, key);
  const int w = __reduce_min_sync(kFull, key == m ? i : INT_MAX);
  return make_uint2(m, (unsigned)w);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The shared::cluster address of this block's shared address `a` in rank
// `rank`'s shared memory.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

// Spins until the phase of parity `parity` of the mbarrier at shared
// address `bar` completes.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}"
      :
      : "r"(bar), "r"(parity)
      : "memory");
}

// One block per row (kCluster = false), or a cluster of blocks per row,
// which exchange their records through distributed shared memory.
template <typename T, int P, bool kCluster>
__global__ void __launch_bounds__(max_threads(P))
    fps_kernel(const T* __restrict__ xyz, int n, int npoint, int* __restrict__ idx,
               float* __restrict__ coords) {
  // the row's copy x[n], y[n], z[n], then the picked indices
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + n;
  float* sz = smem + 2 * n;
  int* spick = reinterpret_cast<int*>(smem + 3 * n);
  __shared__ uint2 rec[2][kMaxRecords];
  __shared__ unsigned long long bar[2];  // kCluster: the records' mbarriers

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = kCluster ? (int)cluster.num_blocks() : 1;
  const int rank = kCluster ? (int)cluster.block_rank() : 0;
  const int row = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nrec = nwarps * csize;
  const int stride = csize * blockDim.x;
  const int g = rank * blockDim.x + tid;

  const T* src = xyz + (size_t)row * n * 3;
  for (int i = tid; i < n; i += blockDim.x) {
    sx[i] = to_f32(src[3 * i]);
    sy[i] = to_f32(src[3 * i + 1]);
    sz[i] = to_f32(src[3 * i + 2]);
  }
  // kCluster: lane r < csize sends the warp's record of pick parity b to
  // rank r's slot send[b], counted by rank r's mbarrier sbar[b]
  unsigned send[2] = {0, 0}, sbar[2] = {0, 0};
  if constexpr (kCluster) {
    if (tid == 0) {
      for (int b = 0; b < 2; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[b]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    for (int b = 0; b < 2; ++b) {
      send[b] = cluster_addr(smem_addr(&rec[b][rank * nwarps + warp]), lane % csize);
      sbar[b] = cluster_addr(smem_addr(&bar[b]), lane % csize);
    }
    cluster.sync();  // the copies are staged, the barriers set, every block runs
  } else {
    __syncthreads();
  }

  float px[P], py[P], pz[P], md[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = g + k * stride;
    const bool live = i < n;
    px[k] = live ? sx[i] : 0.f;
    py[k] = live ? sy[i] : 0.f;
    pz[k] = live ? sz[i] : 0.f;
    md[k] = live ? INFINITY : -1.f;
  }
  const bool writer = rank == 0 && tid == 0;
  if (writer) spick[0] = 0;
  float cx = sx[0], cy = sy[0], cz = sz[0];

  for (int it = 1; it < npoint; ++it) {
    float bv = -1.f;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      md[k] = fminf(md[k], sq_dist(px[k], py[k], pz[k], cx, cy, cz));
      if (md[k] > bv) {  // ascending k: strict > keeps the thread's lowest index
        bv = md[k];
        bk = k;
      }
    }
    const bool any = bv >= 0.f;  // false only for a thread with no point below N
    const uint2 w = warp_argmax(any ? __float_as_uint(bv) : 0u, any ? g + bk * stride : INT_MAX);
    const int par = it & 1;
    if constexpr (kCluster) {
      // this block's barrier expects nrec records of this pick; each
      // arrives with its byte count
      if (tid == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                         smem_addr(&bar[par])),
                     "r"(nrec * (int)sizeof(uint2))
                     : "memory");
      if (lane < csize)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];"
            ::"r"(par ? send[1] : send[0]), "r"(w.x), "r"(w.y), "r"(par ? sbar[1] : sbar[0])
            : "memory");
      wait_phase(smem_addr(&bar[par]), ((it - 1) >> 1) & 1);
    } else {
      if (lane == 0) rec[par][warp] = w;
      __syncthreads();
    }
    const uint2 r = lane < nrec ? rec[par][lane] : make_uint2(0u, (unsigned)INT_MAX);
    const int win = (int)warp_argmax(r.x, (int)r.y).y;
    cx = sx[win];
    cy = sy[win];
    cz = sz[win];
    if (writer) spick[it] = win;
  }

  if constexpr (kCluster)
    cluster.sync();  // no block leaves while a record may still reach it
  else
    __syncthreads();
  if (rank == 0) {
    int* out_idx = idx + (size_t)row * npoint;
    float* out_c = coords + (size_t)row * npoint * 3;
    for (int j = tid; j < npoint; j += blockDim.x) {
      const int i = spick[j];
      out_idx[j] = i;
      out_c[3 * j] = sx[i];
      out_c[3 * j + 1] = sy[i];
      out_c[3 * j + 2] = sz[i];
    }
  }
}

// The instantiation for a plan that plan_ok takes: a cluster's blocks hold
// 8 points a thread.
template <typename T>
const void* kernel_for(int p, int cluster) {
  if (cluster > 1) return reinterpret_cast<const void*>(&fps_kernel<T, 8, true>);
  switch (p) {
    case 1: return reinterpret_cast<const void*>(&fps_kernel<T, 1, false>);
    case 2: return reinterpret_cast<const void*>(&fps_kernel<T, 2, false>);
    case 4: return reinterpret_cast<const void*>(&fps_kernel<T, 4, false>);
    default: return reinterpret_cast<const void*>(&fps_kernel<T, 8, false>);
  }
}

const void* kernel_for(int bf16, int p, int cluster) {
  return bf16 ? kernel_for<__nv_bfloat16>(p, cluster) : kernel_for<float>(p, cluster);
}

// The plans the kernel takes. ops.fps_plan_ok is the same rule where the
// plan is chosen, in Python; tests/test_torch_cuda.py holds the two equal.
bool plan_ok(int n, int threads, int p, int cluster) {
  if (p != 1 && p != 2 && p != 4 && p != 8) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) return false;
  if (cluster > 1 && p != 8) return false;
  if (threads < 32 || threads % 32 || threads > max_threads(p)) return false;
  if ((threads / 32) * cluster > kMaxRecords) return false;
  return n >= 1 && (long long)threads * p * cluster >= n;
}

cudaLaunchConfig_t config(int b, int n, int npoint, int threads, int cluster, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)(3 * n + npoint) * sizeof(float);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

}  // namespace

extern "C" {

// xyz: [b, n, 3] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1).
// idx: [b, npoint] int32; coords: [b, npoint, 3] f32. The plan (threads a
// block, points a thread, blocks a row) is ops.fps_plan's. Returns a
// cudaError_t: cudaErrorInvalidValue for a plan or shape the kernel does
// not take.
int mpn_fps(const void* xyz, int bf16, int b, int n, int npoint, int threads, int p,
            int cluster, int* idx, float* coords, void* stream) {
  if (!plan_ok(n, threads, p, cluster) || b < 1 || npoint < 1 || npoint > n ||
      (long long)b * cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(bf16, p, cluster);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(b, n, npoint, threads, cluster, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&xyz, (void*)&n, (void*)&npoint, (void*)&idx, (void*)&coords};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What a plan gets on this device for n points and npoint picks: registers
// a thread, blocks of it that fit on one SM, and (cluster > 1) clusters of
// it that can run at once, 0 when the cluster cannot be scheduled. Returns
// a cudaError_t.
int mpn_fps_plan(int bf16, int n, int npoint, int threads, int p, int cluster, int* registers,
                 int* blocks_per_sm, int* max_clusters) {
  if (!plan_ok(n, threads, p, cluster) || npoint < 1 || npoint > n)
    return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(bf16, p, cluster);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(1, n, npoint, threads, cluster, nullptr, &attr);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  *registers = fa.numRegs;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads,
                                                    cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return (int)e;
  *max_clusters = 0;
  if (cluster > 1) e = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  return (int)e;
}

const char* mpn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
