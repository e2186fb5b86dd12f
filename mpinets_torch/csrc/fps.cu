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
// What bounds it on the H100: neither bytes nor FLOPs. The 19 MB a
// [256, 6272, 3] f32 cloud holds is read once (about 6 us of HBM time) and
// the ~7.4 GFLOP of distance work is ~0.1 ms of CUDA-core time, but the
// npoint-1 picks are a chain of dependent block-wide argmax reductions, so
// the kernel is bound by the latency of one iteration (a shared-memory
// read, a few FMAs per thread, two __syncthreads and two shuffle trees)
// times npoint.
//
// Design: one block per batch row, up to 1024 threads. The row's
// coordinates live in shared memory (75 KB at N=6272, above the 48 KB
// default, so the launcher opts in to more dynamic shared memory); the
// running min distances live in registers, kPerThread per thread. Each
// iteration is one register pass and a (value, index) argmax: warp shuffles,
// then one warp over the per-warp winners.
//
// Rounding: nvcc contracts a*b+c into an FMA by default, which rounds the
// squared distance differently from the plain version and moves argmax
// picks at near-ties. The distance is therefore written with
// __fsub_rn/__fmul_rn/__fadd_rn, which are never contracted, summed left to
// right: (dx*dx + dy*dy) + dz*dz.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPerThread = 8;  // points per thread: N <= 8192

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// (v, i) <- the better of (v, i) and (ov, oi): larger value, then lower index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const T* __restrict__ xyz, int n, int npoint, int* __restrict__ idx,
               float* __restrict__ coords) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + n;
  float* sz = smem + 2 * n;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_next;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  const T* src = xyz + (size_t)b * n * 3;
  for (int i = tid; i < n; i += nt) {
    sx[i] = to_f32(src[3 * i]);
    sy[i] = to_f32(src[3 * i + 1]);
    sz[i] = to_f32(src[3 * i + 2]);
  }
  float md[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) md[k] = INFINITY;
  int* out_idx = idx + (size_t)b * npoint;
  float* out_c = coords + (size_t)b * npoint * 3;
  __syncthreads();
  if (tid == 0) {
    out_idx[0] = 0;
    out_c[0] = sx[0];
    out_c[1] = sy[0];
    out_c[2] = sz[0];
  }

  int last = 0;
  for (int it = 1; it < npoint; ++it) {
    const float cx = sx[last], cy = sy[last], cz = sz[last];
    float best_v = -INFINITY;
    int best_i = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid + k * nt;  // ascending per thread: strict > keeps the lowest index
      if (i < n) {
        const float dx = __fsub_rn(sx[i], cx);
        const float dy = __fsub_rn(sy[i], cy);
        const float dz = __fsub_rn(sz[i], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        md[k] = fminf(md[k], d);
        if (md[k] > best_v) {
          best_v = md[k];
          best_i = i;
        }
      }
    }
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      red_v[warp] = best_v;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < nwarps ? red_v[lane] : -INFINITY;
      best_i = lane < nwarps ? red_i[lane] : 0x7fffffff;
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        s_next = best_i;
        out_idx[it] = best_i;
        out_c[3 * it] = sx[best_i];
        out_c[3 * it + 1] = sy[best_i];
        out_c[3 * it + 2] = sz[best_i];
      }
    }
    __syncthreads();
    last = s_next;
  }
}

template <typename T>
int launch(const void* xyz, int b, int n, int npoint, int* idx, float* coords,
           cudaStream_t stream) {
  const int threads = min(kMaxThreads, ((n + 31) / 32) * 32);
  if (n > threads * kPerThread || npoint < 1 || npoint > n) return (int)cudaErrorInvalidValue;
  const int smem = 3 * n * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fps_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fps_kernel<T><<<b, threads, smem, stream>>>(static_cast<const T*>(xyz), n, npoint, idx,
                                               coords);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz: [b, n, 3] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1).
// idx: [b, npoint] int32; coords: [b, npoint, 3] f32. Returns a cudaError_t.
int mpn_fps(const void* xyz, int bf16, int b, int n, int npoint, int* idx, float* coords,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(xyz, b, n, npoint, idx, coords, s)
              : launch<float>(xyz, b, n, npoint, idx, coords, s);
}

const char* mpn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
