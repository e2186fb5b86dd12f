// Fused PointNet++ set-abstraction stage on Hopper (sm_90a), bound through
// a plain C interface (ctypes): ball query, first-128 selection, gather,
// 3-layer shared MLP and max-pool in one kernel, for the exact and the
// fast (chunk-window) grouping.
//
// Replaces: mpinets_tpu/kernels/pallas_ops.py::_sa_kernel_v8 (exact,
// chunks = null) and ::_sa_kernel_f1 (fast, chunks = per-centroid window).
//
// Function, per (batch row b, centroid s):
//  * candidates are scanned in order -- every point by index (exact), or
//    the `window` chunks of 128 points in window-rank order, lanes in order
//    (fast) -- and the first 128 with dx*dx + dy*dy + dz*dz < r*r are kept.
//    The test is the literal form, left to right in f32 (the algebraic
//    |p|^2 form flips boundary points, pallas_ops.py:785-788). Under bf16
//    compute the fast kernel tests bf16-rounded point coordinates against
//    f32 centroids (pallas_ops.py:1241-1242,1068-1085).
//  * idx gets the kept indices with fill-with-first (0 when none).
//  * The raw rows [xyz, feat] of the kept points (not recentred), rounded to
//    the compute type, go through layer 1 with the recentring folded into
//    the bias, (raw . W1 + b1) - W1[:3]^T c in f32 (the v8 form,
//    pallas_ops.py:928-953), then ReLU, layers 2-3 with ReLU, and a max over
//    the slots below max(count, 1). With no neighbour, slot 0 is a zero
//    raw row (pallas_ops.py:1132-1183).
//
// What bounds it on the H100: operations. The MLP is 2.8e11 FLOP at SA0
// and 4.8e11 at SA1 for B=256 when every slot is filled; the kernel skips
// rows past each centroid's neighbour count, and its inputs are a few MB.
// This first version runs the products on the CUDA cores (67 TFLOP/s f32
// peak, against 989 TFLOP/s bf16 on the tensor cores), so it sits far above
// the bound; moving the products to wgmma is a later step.
//
// Design: one block of 8 warps per 8 centroids of one batch row. Selection
// is one warp per centroid: each step tests 32 candidates, __ballot_sync +
// __popc give every hit its slot in scan order (the order-preserving
// compaction the TPU kernel built from prefix matmuls and a binary search,
// pallas_ops.py:824-891), and the scan stops once 128 are found. The MLP
// then runs per centroid on blocks of 32 rows held in shared memory; each
// thread owns one output channel for 8 rows, reads weights through L1 and
// activations as float4 broadcasts, and folds layer 3 into a running
// max-pool, so no [rows, C3] activation is stored.
//
// Rounding: the in-ball distance is written with __fsub_rn/__fmul_rn/
// __fadd_rn, which nvcc never contracts into FMAs, so membership matches
// the plain version bit for bit. The MLP uses fmaf; its sums differ from
// the plain version's only in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNs = 128;      // neighbours kept per centroid
constexpr int kChunk = 128;   // points per chunk (the fast window's unit)
constexpr int kTs = 8;        // centroids per block: one warp each for selection
constexpr int kThreads = kTs * 32;
constexpr int kRows = 32;     // MLP row block
constexpr int kRpt = 8;       // rows per thread item
constexpr int kGroups = kRows / kRpt;

struct SaArgs {
  const float* xyz;     // [b, n, 3]
  const float* feat;    // [b, n, c]
  const float* cent;    // [b, s, 3]
  const int* chunks;    // [b, s, window] (fast) or null (exact)
  const float* w1;      // [kp, c1], compute-rounded, rows >= 3 + c are 0
  const float* w1xyz;   // [3, c1] f32: recentring bias weights
  const float* b1;      // [c1]
  const float* w2;      // [c1, c2], compute-rounded
  const float* b2;      // [c2]
  const float* w3;      // [c2, c3], compute-rounded
  const float* b3;      // [c3]
  float* out;           // [b, s, c3]
  int* idx;             // [b, s, kNs]
  int n, s, c, kp, c1, c2, c3, window, bf16;
  float r2;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));  // round to nearest even
}

__device__ __forceinline__ float dist2(float x, float y, float z, float cx, float cy,
                                       float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// One dense layer over a kRows-row block held in shared memory.
// kMode 0: layer 1, (acc + b) - bc, ReLU, round; 1: hidden, acc + b, ReLU,
// round; 2: last, acc + b, ReLU, running max of rows < row_limit into out
// (= pmax [kGroups][m]).
template <int kMode>
__device__ __forceinline__ void dense(const float* in, int kin, const float* __restrict__ w,
                                      const float* __restrict__ bias, const float* bc, int m,
                                      float* out, int row_limit, bool bf16) {
  for (int item = threadIdx.x; item < kGroups * m; item += kThreads) {
    const int j = item % m;
    const int grp = item / m;
    const float* a = in + grp * kRpt * kin;
    float acc[kRpt];
#pragma unroll
    for (int r = 0; r < kRpt; ++r) acc[r] = 0.f;
    for (int k = 0; k < kin; k += 4) {
      const float w0 = __ldg(w + (size_t)k * m + j);
      const float w1 = __ldg(w + (size_t)(k + 1) * m + j);
      const float w2 = __ldg(w + (size_t)(k + 2) * m + j);
      const float w3 = __ldg(w + (size_t)(k + 3) * m + j);
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(a + r * kin + k);
        acc[r] = fmaf(v.x, w0, acc[r]);
        acc[r] = fmaf(v.y, w1, acc[r]);
        acc[r] = fmaf(v.z, w2, acc[r]);
        acc[r] = fmaf(v.w, w3, acc[r]);
      }
    }
    const float bj = bias[j];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      float h = acc[r] + bj;
      if (kMode == 0) h = h - bc[j];
      h = fmaxf(h, 0.f);
      if (kMode < 2) {
        out[(grp * kRpt + r) * m + j] = bf16 ? round_bf16(h) : h;
      } else if (grp * kRpt + r < row_limit) {
        mx = fmaxf(mx, h);
      }
    }
    if (kMode == 2) out[grp * m + j] = fmaxf(out[grp * m + j], mx);
  }
}

__global__ void __launch_bounds__(kThreads) sa_kernel(SaArgs a) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // [kRows][kp]
  float* h1 = raw + kRows * a.kp;                 // [kRows][c1]
  float* h2 = h1 + kRows * a.c1;                  // [kRows][c2]
  float* bc = h2 + kRows * a.c2;                  // [c1]
  float* pmax = bc + a.c1;                        // [kGroups][c3]
  int* sel = reinterpret_cast<int*>(pmax + kGroups * a.c3);  // [kTs][kNs]
  int* cnt = sel + kTs * kNs;                     // [kTs]

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kTs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xyz = a.xyz + (size_t)b * a.n * 3;
  const float* feat = a.feat + (size_t)b * a.n * a.c;
  const bool bf16 = a.bf16 != 0;

  // ---- selection: warp w scans for centroid s0 + w --------------------------
  {
    const int s = s0 + warp;
    int count = 0;
    if (s < a.s) {
      const float* c = a.cent + ((size_t)b * a.s + s) * 3;
      const float cx = c[0], cy = c[1], cz = c[2];
      const bool fast = a.chunks != nullptr;
      const int nlist = fast ? a.window : (a.n + kChunk - 1) / kChunk;
      const int* list = fast ? a.chunks + ((size_t)b * a.s + s) * a.window : nullptr;
      const bool round_pts = fast && bf16;
      int* my_sel = sel + warp * kNs;
      // count is warp-uniform (it only grows by ballot popcounts), so are the exits
      for (int li = 0; li < nlist && count < kNs; ++li) {
        const int chunk = fast ? list[li] : li;
        for (int sub = 0; sub < kChunk / 32 && count < kNs; ++sub) {
          const int p = chunk * kChunk + sub * 32 + lane;
          bool in = false;
          if (p < a.n) {
            float x = xyz[3 * p], y = xyz[3 * p + 1], z = xyz[3 * p + 2];
            if (round_pts) {
              x = round_bf16(x);
              y = round_bf16(y);
              z = round_bf16(z);
            }
            in = dist2(x, y, z, cx, cy, cz) < a.r2;
          }
          const unsigned mask = __ballot_sync(0xffffffffu, in);
          if (in) {
            const int slot = count + __popc(mask & ((1u << lane) - 1u));
            if (slot < kNs) my_sel[slot] = p;
          }
          count += __popc(mask);
        }
      }
      __syncwarp();
      const int kept = min(count, kNs);
      const int first = count > 0 ? my_sel[0] : 0;
      int* out_idx = a.idx + ((size_t)b * a.s + s) * kNs;
      for (int k = lane; k < kNs; k += 32) out_idx[k] = k < kept ? my_sel[k] : first;
    }
    if (lane == 0) cnt[warp] = count;
  }
  __syncthreads();

  // ---- gather + MLP + max-pool, one centroid at a time ----------------------
  for (int g = 0; g < kTs; ++g) {
    const int s = s0 + g;
    if (s >= a.s) break;
    const int kept = min(cnt[g], kNs);
    const int nrows = max(kept, 1);
    const float* c = a.cent + ((size_t)b * a.s + s) * 3;
    const float cx = c[0], cy = c[1], cz = c[2];
    for (int j = tid; j < a.c1; j += kThreads) {
      bc[j] = a.w1xyz[j] * cx + a.w1xyz[a.c1 + j] * cy + a.w1xyz[2 * a.c1 + j] * cz;
    }
    for (int i = tid; i < kGroups * a.c3; i += kThreads) pmax[i] = -INFINITY;
    for (int r0 = 0; r0 < nrows; r0 += kRows) {
      for (int i = tid; i < kRows * a.kp; i += kThreads) {
        const int r = i / a.kp;
        const int k = i - r * a.kp;
        float v = 0.f;
        if (r0 + r < kept && k < 3 + a.c) {
          const int p = sel[g * kNs + r0 + r];
          v = k < 3 ? xyz[3 * p + k] : feat[(size_t)p * a.c + (k - 3)];
          if (bf16) v = round_bf16(v);
        }
        raw[i] = v;
      }
      __syncthreads();
      dense<0>(raw, a.kp, a.w1, a.b1, bc, a.c1, h1, 0, bf16);
      __syncthreads();
      dense<1>(h1, a.c1, a.w2, a.b2, nullptr, a.c2, h2, 0, bf16);
      __syncthreads();
      dense<2>(h2, a.c2, a.w3, a.b3, nullptr, a.c3, pmax, nrows - r0, bf16);
      __syncthreads();
    }
    float* out = a.out + ((size_t)b * a.s + s) * a.c3;
    for (int j = tid; j < a.c3; j += kThreads) {
      float m = pmax[j];
#pragma unroll
      for (int q = 1; q < kGroups; ++q) m = fmaxf(m, pmax[q * a.c3 + j]);
      out[j] = m;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shapes as in SaArgs. chunks == null selects the exact scan, else the fast
// window scan over `window` chunks per centroid. kp, c1 and c2 must be
// multiples of 4. Returns a cudaError_t.
int mpn_sa(const float* xyz, const float* feat, const float* cent, const int* chunks,
           int window, const float* w1, const float* w1xyz, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, int b, int n, int s, int c,
           int kp, int c1, int c2, int c3, float r2, int bf16, float* out, int* idx,
           void* stream) {
  if (kp % 4 || c1 % 4 || c2 % 4 || kp < 3 + c || b > 65535) return (int)cudaErrorInvalidValue;
  SaArgs a{xyz, feat, cent, chunks, w1, w1xyz, b1, w2, b2, w3, b3, out, idx,
           n, s, c, kp, c1, c2, c3, window, bf16, r2};
  const size_t floats = (size_t)kRows * (kp + c1 + c2) + c1 + (size_t)kGroups * c3;
  const size_t smem = floats * sizeof(float) + (kTs * kNs + kTs) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + kTs - 1) / kTs, b);
  sa_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* mpn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
