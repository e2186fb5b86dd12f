// PointNet++ set-abstraction stage on Hopper (sm_90a), bound through a plain
// C interface (ctypes): ball query, first-128 selection, gather, 3-layer
// shared MLP and max-pool. The exact grouping runs as two launches on the
// caller's stream, a ball-query kernel that writes the selection and an MLP
// kernel that reads it; the fast (chunk-window) grouping runs as one.
//
// Replaces: mpinets_tpu/kernels/pallas_ops.py::_sa_kernel_v8 (exact,
// chunks = null, in_cloud = 1; with its return_raw output when raw is not
// null), ::_sa_kernel_f1 (fast, chunks = per-centroid window), and
// ::_sa_kernel (v3) and ::_sa_kernel_v5 (exact, in_cloud = 0: centroids
// need not be cloud members; v5 with centroids_in_cloud=True is v8).
//
// Function, per (batch row b, centroid s):
//  * candidates are scanned in order -- every point by index (exact), or
//    the `window` chunks of 128 points in window-rank order, lanes in order
//    (fast) -- and the first 128 with dx*dx + dy*dy + dz*dz < r*r are kept.
//    The test is the literal form, left to right in f32 (the algebraic
//    |p|^2 form flips boundary points, pallas_ops.py:785-788). Under bf16
//    compute the fast kernel tests bf16-rounded point coordinates against
//    f32 centroids (pallas_ops.py:1241-1242,1068-1085).
//  * idx gets the kept indices with fill-with-first (0 when none); count
//    (exact path) the kept count, min(hits, 128).
//  * The raw rows [xyz, feat] of the kept points (not recentred), rounded to
//    the compute type, go through layer 1 with the recentring folded into
//    the bias, (raw . W1 + b1) - W1[:3]^T c in f32 (the v8 form,
//    pallas_ops.py:928-953), then ReLU, layers 2-3 with ReLU, and a max over
//    the slots below max(count, 1). With no neighbour, slot 0 is a zero
//    raw row (pallas_ops.py:1132-1183) when in_cloud = 1; when in_cloud = 0
//    slot 0's layer-1 pre-activation is point 0's row instead,
//    b1 + sum_ch pts0[ch] * W1[ch] - W1[:3]^T c in f32 with the unrounded W1
//    (the CUDA count==0 fallback, pallas_ops.py:430-442,661-682).
//  * raw (optional, [b, s, 128, 3 + c] f32): the gathered rows of the kept
//    points as read, neither recentred nor rounded, slot j the j-th kept
//    point in scan order; zero rows past the count (pallas_ops.py:920-926).
//    The train path's backward reads it instead of gathering again.
//
// sa_select_kernel<kCpw> (exact ball query, the scan of pallas_ops.py:
// 814-891). What bounds it on the H100: the distance tests, up to B*S*N of
// them (9 f32 operations each: 8.2e8 tests, 0.11 ms at 67 TFLOP/s at
// B=256, N=6272, S=512, where a centroid keeps about 3.6 points and so
// scans the whole cloud); the bytes (cloud, centroids, idx) are a few tens
// of MB. Design: one block of 8 warps per (batch row, tile of 8 * kCpw
// centroids) stages the row's cloud as x[N], y[N], z[N] f32 in shared
// memory (75 KB at N=6272, padded to whole chunks with NaN, which no test
// passes), so the scan reads no global memory; each warp scans for kCpw
// centroids at once, so each point read from shared memory is tested
// against kCpw centroids. Per step of 32 points, __ballot_sync gives each
// centroid its hit mask, and __popc of the mask below the lane gives every
// hit its slot in scan order (the order-preserving compaction the TPU
// kernel built from prefix matmuls and a binary search); hits below slot
// 128 go straight to idx. A warp stops after the chunk in which its last
// centroid reached 128. kCpw is 4 where the batch gives the card two
// blocks per SM at that tile, else 2 or 1, so a small batch (the server's
// B=1) still spreads over the SMs. Features are not staged: the MLP kernel
// gathers only the kept rows. The largest cloud staged is what fits in
// the block's shared memory; the wrapper refuses a larger one.
//
// The MLP kernels are templates over the raw block (kRaw), the off-cloud
// branch (kPoint0) and the grouping (kFast): on the exact path (kFast = 0)
// a warp reads its centroid's selection from idx and count; on the fast
// path it scans the window itself (select_warp, one warp per centroid,
// the same ballot compaction over the cloud in global memory). The raw
// block is a v8 output and so comes only with in_cloud = 1 on the exact
// path. mpn_sa picks one of eight instantiations.
//
// sa_kernel_mma (bf16): the MLP runs on the tensor cores, mma.sync
// m16n8k16 with bf16 operands and f32 accumulation, as the TPU kernel runs
// it on the MXU (pallas_ops.py:947-960). What bounds it on the H100: the
// MLP over the valid rows (about 61 rows per centroid at SA1, 2.3e11 FLOP
// at B=256; about 3.6 at SA0), latency-bound with one block of 8 warps per
// SM at SA1, and at SA0 the gather and the weights' copy per block of 8
// centroids. Design:
//  * One block of 8 warps per 8 centroids of one batch row; the block
//    copies the three layers' weights (bf16, W^T [n, k], zero-padded to
//    multiples of 16, made once per model by prepare_sa_weights) into shared
//    memory with cp.async while warp w reads (or scans for) the selection
//    of centroid w, and waits once.
//  * Rows go in tiles of 16 (the mma's m), up to max(count, 1) per
//    centroid: 1 tile at SA0 and about 4 at SA1, so no packing of rows
//    across centroids is needed. The block's tiles are dealt to its warps in
//    turn rather than each warp keeping its own centroid, so no warp waits
//    on the centroid with the most rows; each warp has its own tile buffers,
//    so there is no block barrier inside the MLP (the CUDA-core kernel pays
//    four per 32-row block).
//  * A operands (the gathered raw rows, then h1, then h2 over the raw rows'
//    buffer), weights and biases sit in shared memory, rows padded by 16
//    bytes so every ldmatrix row lands on its own banks. The gather keeps
//    8 loads in flight per lane. Each layer runs in passes of 32 output
//    columns (16 accumulators a thread); its epilogue works on the C
//    fragments in registers: bias, the layer-1 recentring term, ReLU, bf16
//    rounding into the next layer's A tile; after layer 3 the max over the
//    rows below max(count, 1) (two rows a thread, then shuffles over lanes
//    4, 8 and 16) goes into the centroid's max-pool by an integer atomicMax
//    (ReLU outputs are non-negative, whose bits order as ints).
//  * Shared memory: 210 KB at SA1 (one block per SM), 66 KB at SA0, where
//    __launch_bounds__(256, 3) (80 registers) keeps 3 blocks per SM. A
//    stage whose weights and tiles do not fit takes the CUDA-core kernel.
// Left for later: wgmma, whose 64-row tiles need rows packed across
// centroids (and would read each weight tile once per 64 rows, not per 16).
//
// sa_kernel (f32; and bf16 beyond the tensor-core kernel's shared memory):
// the MLP on the CUDA cores (67 TFLOP/s f32 peak), per centroid on blocks
// of 32 rows held in shared memory; each thread owns one output channel for
// 8 rows, reads weights through L1 and activations as float4 broadcasts,
// and folds layer 3 into a running max-pool, so no [rows, C3] activation is
// stored.
//
// Rounding: the in-ball distance is written with __fsub_rn/__fmul_rn/
// __fadd_rn, which nvcc never contracts into FMAs, so membership matches
// the plain version bit for bit. The MLP rounds where the plain version
// does (bf16 inputs, bf16 after layers 1-2) and sums in f32; its sums
// differ from the plain version's only in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kNs = 128;      // neighbours kept per centroid
constexpr int kChunk = 128;   // points per chunk (the fast window's unit)
constexpr int kTs = 8;        // centroids per block: one warp each for selection
constexpr int kThreads = kTs * 32;
constexpr int kRows = 32;     // CUDA-core MLP row block
constexpr int kRpt = 8;       // rows per thread item
constexpr int kGroups = kRows / kRpt;
constexpr int kTile = 16;     // tensor-core row tile (the mma's m)
constexpr int kPad = 8;       // bf16 padding of each shared row (16 bytes)
constexpr int kNc = 32;       // tensor-core output columns per pass
constexpr int kGather = 8;    // raw-row loads in flight per lane
constexpr int kSelWarps = 8;  // warps per ball-query block
constexpr int kSelThreads = kSelWarps * 32;

using bf16_t = __nv_bfloat16;

struct SelArgs {
  const float* xyz;   // [b, n, 3]
  const float* cent;  // [b, s, 3]
  int* idx;           // [b, s, kNs]
  int* count;         // [b, s]: min(hits, kNs)
  int n, s, np;       // np: n rounded up to whole chunks (the staged length)
  float r2;
};

struct SaArgs {
  const float* xyz;     // [b, n, 3]
  const float* feat;    // [b, n, c]
  const float* cent;    // [b, s, 3]
  const int* chunks;    // [b, s, window] (fast) or null (exact)
  const float* w1;      // [kp, c1], compute-rounded, rows >= 3 + c are 0
  const float* w1f;     // [3 + c, c1] f32, unrounded: rows 0-2 give the
                        // recentring bias, all rows the count==0 row
  const float* b1;      // [c1]
  const float* w2;      // [c1, c2], compute-rounded
  const float* b2;      // [c2]
  const float* w3;      // [c2, c3], compute-rounded
  const float* b3;      // [c3]
  const bf16_t* w1t;    // [n1p, k1p] bf16 W1^T, zero-padded (tensor-core kernel)
  const bf16_t* w2t;    // [n2p, n1p]
  const bf16_t* w3t;    // [n3p, n2p]
  float* out;           // [b, s, c3]
  int* idx;             // [b, s, kNs]: written (fast) or read (exact)
  const int* count;     // [b, s]: the kept counts (exact), or null (fast)
  float* raw;           // [b, s, kNs, 3 + c] (kRaw) or null
  int n, s, c, kp, c1, c2, c3, window, bf16;
  int k1p, n1p, n2p, n3p;  // 3 + c, c1, c2, c3 rounded up to 16
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

// ---------------------------------------------------------------------------
// Exact ball query
// ---------------------------------------------------------------------------

template <int kCpw>
__global__ void __launch_bounds__(kSelThreads, 2) sa_select_kernel(SelArgs a) {
  extern __shared__ float cloud[];  // x[np], y[np], z[np]
  float* sx = cloud;
  float* sy = cloud + a.np;
  float* sz = cloud + 2 * a.np;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xyz = a.xyz + (size_t)b * a.n * 3;
#pragma unroll 4
  for (int p = tid; p < a.n; p += kSelThreads) {
    sx[p] = __ldg(xyz + 3 * p);
    sy[p] = __ldg(xyz + 3 * p + 1);
    sz[p] = __ldg(xyz + 3 * p + 2);
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int p = a.n + tid; p < a.np; p += kSelThreads) sx[p] = sy[p] = sz[p] = nan;

  // this warp's centroids; one past S gets NaN (never a hit) and a full count
  const int s0 = (blockIdx.x * kSelWarps + warp) * kCpw;
  float cx[kCpw], cy[kCpw], cz[kCpw];
  int cnt[kCpw], first[kCpw];
#pragma unroll
  for (int g = 0; g < kCpw; ++g) {
    cx[g] = cy[g] = cz[g] = nan;
    cnt[g] = kNs;
    first[g] = 0;
    if (s0 + g < a.s) {
      const float* c = a.cent + ((size_t)b * a.s + s0 + g) * 3;
      cx[g] = c[0];
      cy[g] = c[1];
      cz[g] = c[2];
      cnt[g] = 0;
    }
  }
  __syncthreads();

  int* rows = a.idx + ((size_t)b * a.s + s0) * kNs;  // centroid s0 + g: rows + g * kNs
  const unsigned below = (1u << lane) - 1u;
  // the counts and masks are warp-uniform, so are the branches on them
  for (int c = 0; c < a.np / kChunk; ++c) {
    bool done = true;
#pragma unroll
    for (int g = 0; g < kCpw; ++g) done = done && cnt[g] >= kNs;
    if (done) break;
#pragma unroll
    for (int k = 0; k < kChunk / 32; ++k) {
      const int p = c * kChunk + 32 * k + lane;
      const float x = sx[p], y = sy[p], z = sz[p];
#pragma unroll
      for (int g = 0; g < kCpw; ++g) {
        const bool in = dist2(x, y, z, cx[g], cy[g], cz[g]) < a.r2;
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (m) {
          if (cnt[g] == 0) first[g] = p - lane + __ffs(m) - 1;
          const int slot = cnt[g] + __popc(m & below);
          if (in && slot < kNs) rows[g * kNs + slot] = p;
          cnt[g] += __popc(m);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kCpw; ++g) {
    if (s0 + g >= a.s) break;
    const int kept = min(cnt[g], kNs);
    for (int k = kept + lane; k < kNs; k += 32) rows[g * kNs + k] = first[g];
    if (lane == 0) a.count[(size_t)b * a.s + s0 + g] = kept;
  }
}

// Exact path: the selection of centroid (b, s) that sa_select_kernel wrote,
// its kept indices into my_sel. Returns the kept count.
__device__ __forceinline__ int load_selection(const SaArgs& a, int b, int s, int lane,
                                              int* my_sel) {
  const size_t row = (size_t)b * a.s + s;
  const int kept = a.count[row];
  for (int k = lane; k < kept; k += 32) my_sel[k] = a.idx[row * kNs + k];
  __syncwarp();
  return kept;
}

// Fast path: warp-wide scan of centroid (b, s)'s window. The first kNs hits
// in scan order go to my_sel, idx gets them with fill-with-first. Returns
// the hit count.
__device__ __forceinline__ int select_warp(const SaArgs& a, const float* xyz, int b, int s,
                                           bool bf16, int lane, int* my_sel) {
  int count = 0;
  const float* c = a.cent + ((size_t)b * a.s + s) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const int* list = a.chunks + ((size_t)b * a.s + s) * a.window;
  // count is warp-uniform (it only grows by ballot popcounts), so are the exits
  for (int li = 0; li < a.window && count < kNs; ++li) {
    const int chunk = list[li];
    for (int sub = 0; sub < kChunk / 32 && count < kNs; ++sub) {
      const int p = chunk * kChunk + sub * 32 + lane;
      bool in = false;
      if (p < a.n) {
        float x = xyz[3 * p], y = xyz[3 * p + 1], z = xyz[3 * p + 2];
        if (bf16) {
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
  return count;
}

// ---------------------------------------------------------------------------
// CUDA-core MLP
// ---------------------------------------------------------------------------

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

// kRaw: write the raw block; kPoint0: a centroid without neighbours takes
// point 0's layer-1 row (centroids off the cloud), else a zero raw row;
// kFast: scan the window, else read the exact selection.
template <bool kRaw, bool kPoint0, bool kFast>
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

  // ---- selection of centroid s0 + w, by warp w -------------------------------
  {
    const int s = s0 + warp;
    int count = 0;
    if (s < a.s) {
      count = kFast ? select_warp(a, xyz, b, s, bf16, lane, sel + warp * kNs)
                    : load_selection(a, b, s, lane, sel + warp * kNs);
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
      bc[j] = a.w1f[j] * cx + a.w1f[a.c1 + j] * cy + a.w1f[2 * a.c1 + j] * cz;
    }
    for (int i = tid; i < kGroups * a.c3; i += kThreads) pmax[i] = -INFINITY;
    if constexpr (kRaw) {
      // all 128 slots, coalesced: kept rows as read, zero rows after them
      const int p = 3 + a.c;
      float* raw_out = a.raw + ((size_t)b * a.s + s) * kNs * p;
      for (int i = tid; i < kNs * p; i += kThreads) {
        const int r = i / p;
        const int k = i - r * p;
        float v = 0.f;
        if (r < kept) {
          const int q = sel[g * kNs + r];
          v = k < 3 ? xyz[3 * q + k] : feat[(size_t)q * a.c + (k - 3)];
        }
        raw_out[i] = v;
      }
    }
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
      if (kPoint0 && cnt[g] == 0) {  // block-uniform; then nrows == 1, row 0 only
        for (int j = tid; j < a.c1; j += kThreads) {
          float h = a.b1[j];
          for (int k = 0; k < 3 + a.c; ++k) {
            h += (k < 3 ? xyz[k] : feat[k - 3]) * a.w1f[(size_t)k * a.c1 + j];
          }
          h = fmaxf(h - bc[j], 0.f);
          h1[j] = bf16 ? round_bf16(h) : h;
        }
        __syncthreads();
      }
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

// ---------------------------------------------------------------------------
// Tensor-core MLP (bf16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory (addr: a shared-space byte
// address); lane l gives the address of row l % 8 of matrix l / 8 and gets,
// of each matrix, row l / 4, columns 2 * (l % 4) + {0, 1}.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators (the PTX of CUTLASS's
// cute/arch/mma_sm80.hpp, SM80_16x8x16_F32BF16BF16F32_TN).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A [rows, cols] bf16 matrix (cols a multiple of 8) from global memory into
// shared rows of cols + kPad, 16 bytes per cp.async, by the whole block.
__device__ __forceinline__ void stage_async(bf16_t* dst, const bf16_t* src, int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int q = i - r * per_row;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst + r * (cols + kPad) + q * 8)),
                 "l"(src + (size_t)r * cols + q * 8)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower column
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One dense layer of the tensor-core MLP on one warp's 16-row tile:
// A [16, k] bf16 (row stride lda), W^T [n, k] bf16 (row stride k + kPad)
// and the bias [n] f32 (zero past nreal, the layer's real output width), all
// in shared memory, k and n multiples of 16. Passes of kNc output columns;
// lane holds the m16n8 C fragment of each 8-column tile: rows lane/4 and
// lane/4 + 8, columns 2*(lane%4) + {0, 1}.
// kMode 0: layer 1, (acc + b) - bc, ReLU, bf16 into out (row stride ldo);
// 1: hidden, acc + b, ReLU, bf16 into out; 2: last, acc + b, ReLU, max over
// the rows below row_limit into pmax (bits of non-negative floats).
template <int kMode>
__device__ __forceinline__ void mma_layer(const bf16_t* A, int lda, const bf16_t* W, int k,
                                          int n, const float* bias, int nreal,
                                          const float* bc, bf16_t* out, int ldo, int* pmax,
                                          int row_limit, int lane) {
  const int row = lane >> 2;
  const int q = lane & 3;
  const int ldw = k + kPad;
  // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const uint32_t a_addr = smem_u32(A + (lane & 15) * lda + (lane >> 4) * 8);
  // W^T: matrices (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15),
  // i.e. b0 and b1 of two 8-column tiles
  const uint32_t w_addr =
      smem_u32(W + ((lane >> 4) * 8 + (lane & 7)) * ldw + ((lane >> 3) & 1) * 8);
  for (int n0 = 0; n0 < n; n0 += kNc) {
    float acc[kNc / 8][4];
#pragma unroll
    for (int t = 0; t < kNc / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    for (int k0 = 0; k0 < k; k0 += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, a_addr + 2 * k0);
#pragma unroll
      for (int p = 0; p < kNc / 16; ++p) {
        if (n0 + 16 * p < n) {  // warp-uniform
          uint32_t bf[4];
          ldmatrix_x4(bf, w_addr + 2 * ((n0 + 16 * p) * ldw + k0));
          mma_bf16(acc[2 * p], af, bf[0], bf[1]);
          mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kNc / 8; ++t) {
      const int col = n0 + 8 * t + 2 * q;
      if (n0 + 8 * t < n) {
        const float bias0 = bias[col], bias1 = bias[col + 1];
        float v00 = acc[t][0] + bias0, v01 = acc[t][1] + bias1;  // row
        float v10 = acc[t][2] + bias0, v11 = acc[t][3] + bias1;  // row + 8
        if constexpr (kMode == 0) {
          const float bc0 = bc[col], bc1 = bc[col + 1];
          v00 = v00 - bc0;
          v01 = v01 - bc1;
          v10 = v10 - bc0;
          v11 = v11 - bc1;
        }
        v00 = fmaxf(v00, 0.f);
        v01 = fmaxf(v01, 0.f);
        v10 = fmaxf(v10, 0.f);
        v11 = fmaxf(v11, 0.f);
        if constexpr (kMode < 2) {
          *reinterpret_cast<uint32_t*>(out + row * ldo + col) = pack_bf16(v00, v01);
          *reinterpret_cast<uint32_t*>(out + (row + 8) * ldo + col) = pack_bf16(v10, v11);
        } else {
          // rows past the count are zero raw rows: 0, the ReLU max's identity
          float m0 = row < row_limit ? v00 : 0.f;
          float m1 = row < row_limit ? v01 : 0.f;
          if (row + 8 < row_limit) {
            m0 = fmaxf(m0, v10);
            m1 = fmaxf(m1, v11);
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
          }
          if (row == 0) {
            if (col < nreal) atomicMax(pmax + col, __float_as_int(m0));
            if (col + 1 < nreal) atomicMax(pmax + col + 1, __float_as_int(m1));
          }
        }
      }
    }
  }
}

template <bool kRaw, bool kPoint0, bool kFast>
__global__ void __launch_bounds__(kThreads, 3) sa_kernel_mma(SaArgs a) {
  extern __shared__ float4 smem4[];
  const int lda = max(a.k1p, a.n2p) + kPad;  // tile buffer A: raw rows, then h2
  const int ldb = a.n1p + kPad;              // tile buffer B: h1
  bf16_t* w1s = reinterpret_cast<bf16_t*>(smem4);   // [n1p][k1p + kPad]
  bf16_t* w2s = w1s + a.n1p * (a.k1p + kPad);       // [n2p][n1p + kPad]
  bf16_t* w3s = w2s + a.n2p * (a.n1p + kPad);       // [n3p][n2p + kPad]
  bf16_t* tiles = w3s + a.n3p * (a.n2p + kPad);     // [kTs][kTile][lda + ldb]
  float* bc = reinterpret_cast<float*>(tiles + kTs * kTile * (lda + ldb));  // [kTs][n1p]
  float* bias = bc + kTs * a.n1p;  // b1, b2, b3 zero-padded: [n1p + n2p + n3p]
  int* pmax = reinterpret_cast<int*>(bias + a.n1p + a.n2p + a.n3p);  // [kTs][c3]
  int* sel = pmax + kTs * a.c3;                          // [kTs][kNs]
  int* cnt = sel + kTs * kNs;                            // [kTs]; -1: no centroid

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kTs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xyz = a.xyz + (size_t)b * a.n * 3;
  const float* feat = a.feat + (size_t)b * a.n * a.c;

  stage_async(w1s, a.w1t, a.n1p, a.k1p);
  stage_async(w2s, a.w2t, a.n2p, a.n1p);
  stage_async(w3s, a.w3t, a.n3p, a.n2p);
  for (int j = tid; j < a.n1p + a.n2p + a.n3p; j += kThreads) {
    const int j2 = j - a.n1p, j3 = j2 - a.n2p;
    bias[j] = j2 < 0 ? (j < a.c1 ? a.b1[j] : 0.f)
              : j3 < 0 ? (j2 < a.c2 ? a.b2[j2] : 0.f) : (j3 < a.c3 ? a.b3[j3] : 0.f);
  }

  // ---- warp w: selection, raw block, recentring bias of centroid s0 + w ----
  {
    const int s = s0 + warp;
    int count = -1;
    if (s < a.s) {
      int* my_sel = sel + warp * kNs;
      count = kFast ? select_warp(a, xyz, b, s, true, lane, my_sel)
                    : load_selection(a, b, s, lane, my_sel);
      if constexpr (kRaw) {  // all 128 slots, as the CUDA-core kernel writes them
        const int p = 3 + a.c;
        const int kept = min(count, kNs);
        float* raw_out = a.raw + ((size_t)b * a.s + s) * kNs * p;
        for (int i = lane; i < kNs * p; i += 32) {
          const int r = i / p;
          const int k = i - r * p;
          float v = 0.f;
          if (r < kept) {
            const int q = my_sel[r];
            v = k < 3 ? xyz[3 * q + k] : feat[(size_t)q * a.c + (k - 3)];
          }
          raw_out[i] = v;
        }
      }
      const float* c = a.cent + ((size_t)b * a.s + s) * 3;
      const float cx = c[0], cy = c[1], cz = c[2];
      for (int j = lane; j < a.n1p; j += 32) {
        bc[warp * a.n1p + j] =
            j < a.c1 ? a.w1f[j] * cx + a.w1f[a.c1 + j] * cy + a.w1f[2 * a.c1 + j] * cz : 0.f;
      }
      for (int j = lane; j < a.c3; j += 32) pmax[warp * a.c3 + j] = 0;  // +0.f
    }
    if (lane == 0) cnt[warp] = count;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- the block's 16-row tiles, dealt to the warps in turn ----------------
  bf16_t* buf_a = tiles + warp * kTile * (lda + ldb);
  bf16_t* buf_b = buf_a + kTile * lda;
  const int kin = 3 + a.c;
  for (int i = warp;; i += kTs) {
    int g = 0, base = 0, nrows = 0;
    for (; g < kTs; ++g) {
      nrows = cnt[g] < 0 ? 0 : max(min(cnt[g], kNs), 1);
      const int ntiles = (nrows + kTile - 1) / kTile;
      if (i < base + ntiles) break;
      base += ntiles;
    }
    if (g == kTs) break;
    const int r0 = (i - base) * kTile;
    const int kept = min(cnt[g], kNs);
    const int* gsel = sel + g * kNs;
    // raw rows r0 .. r0 + 15 in bf16, zero past the count and past 3 + c;
    // kGather loads issued before their stores, so their latencies overlap.
    // Lane steps through the [16, k1p] tile 32 elements at a time.
    const int dr = 32 / a.k1p, dk = 32 - dr * a.k1p;
    const auto step = [&](int& r, int& k) {
      r += dr;
      k += dk;
      if (k >= a.k1p) {
        k -= a.k1p;
        ++r;
      }
    };
    for (int r = lane / a.k1p, k = lane % a.k1p; r < kTile;) {
      float v[kGather];
      const int r_start = r, k_start = k;
#pragma unroll
      for (int u = 0; u < kGather; ++u, step(r, k)) {
        v[u] = 0.f;
        if (r < kTile && r0 + r < kept && k < kin) {
          const int p = gsel[r0 + r];
          v[u] = k < 3 ? xyz[3 * p + k] : feat[(size_t)p * a.c + (k - 3)];
        }
      }
      r = r_start;
      k = k_start;
#pragma unroll
      for (int u = 0; u < kGather; ++u, step(r, k)) {
        if (r < kTile) buf_a[r * lda + k] = __float2bfloat16_rn(v[u]);
      }
    }
    __syncwarp();
    mma_layer<0>(buf_a, lda, w1s, a.k1p, a.n1p, bias, a.c1, bc + g * a.n1p, buf_b, ldb,
                 nullptr, 0, lane);
    if (kPoint0 && cnt[g] == 0) {  // warp-uniform; then nrows == 1, row 0 only
      __syncwarp();
      for (int j = lane; j < a.c1; j += 32) {
        float h = a.b1[j];
        for (int k = 0; k < kin; ++k) {
          h += (k < 3 ? xyz[k] : feat[k - 3]) * a.w1f[(size_t)k * a.c1 + j];
        }
        buf_b[j] = __float2bfloat16_rn(fmaxf(h - bc[g * a.n1p + j], 0.f));
      }
    }
    __syncwarp();
    mma_layer<1>(buf_b, ldb, w2s, a.n1p, a.n2p, bias + a.n1p, a.c2, nullptr, buf_a, lda,
                 nullptr, 0, lane);
    __syncwarp();
    mma_layer<2>(buf_a, lda, w3s, a.n2p, a.n3p, bias + a.n1p + a.n2p, a.c3, nullptr, nullptr, 0,
                 pmax + g * a.c3, nrows - r0, lane);
    __syncwarp();
  }
  __syncthreads();
  float* out = a.out + ((size_t)b * a.s + s0) * a.c3;
  for (int i = tid; i < kTs * a.c3; i += kThreads) {
    if (s0 + i / a.c3 < a.s) out[i] = __int_as_float(pmax[i]);
  }
}

// ---------------------------------------------------------------------------
// Launch plans
// ---------------------------------------------------------------------------

int round16(int x) { return (x + 15) / 16 * 16; }

cudaError_t device_attribute(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaDeviceGetAttribute(value, attr, dev) : e;
}

struct Plan {
  void (*kernel)(SaArgs);
  size_t smem;
  int mma;  // 1: the tensor-core kernel
};

template <bool kRaw, bool kPoint0, bool kFast>
void pick(int mma, Plan* p) {
  p->kernel = mma ? sa_kernel_mma<kRaw, kPoint0, kFast> : sa_kernel<kRaw, kPoint0, kFast>;
}

// The MLP kernel for these widths and options and its dynamic shared
// memory. bf16 takes the tensor-core kernel when it fits the device's shared
// memory, else the CUDA-core kernel.
cudaError_t plan(int c, int kp, int c1, int c2, int c3, int bf16, int in_cloud, int raw,
                 int fast, Plan* p) {
  const int k1p = round16(3 + c), n1p = round16(c1), n2p = round16(c2), n3p = round16(c3);
  const size_t mma_smem =
      2 * ((size_t)n1p * (k1p + kPad) + (size_t)n2p * (n1p + kPad) + (size_t)n3p * (n2p + kPad) +
           (size_t)kTs * kTile * (std::max(k1p, n2p) + n1p + 2 * kPad)) +
      4 * ((size_t)kTs * (n1p + c3 + kNs) + kTs + n1p + n2p + n3p);
  int optin = 0;
  cudaError_t e = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (e != cudaSuccess) return e;
  p->mma = bf16 && mma_smem <= (size_t)optin;
  if (fast) {
    pick<false, false, true>(p->mma, p);
  } else if (raw) {
    pick<true, false, false>(p->mma, p);
  } else if (in_cloud) {
    pick<false, false, false>(p->mma, p);
  } else {
    pick<false, true, false>(p->mma, p);
  }
  p->smem = p->mma ? mma_smem
                   : ((size_t)kRows * (kp + c1 + c2) + c1 + (size_t)kGroups * c3) * sizeof(float) +
                         (kTs * kNs + kTs) * sizeof(int);
  return cudaFuncSetAttribute(p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

struct SelPlan {
  void (*kernel)(SelArgs);
  size_t smem;
  int cpw;    // centroids per warp
  int tile;   // centroids per block
};

// The ball-query launch for b rows of n points and s centroids: the largest
// kCpw whose tiles give at least two blocks per SM, and the staged cloud's
// shared memory (cudaErrorInvalidValue where it does not fit a block).
cudaError_t select_plan(int b, int n, int s, SelPlan* p) {
  int sms = 0, optin = 0;
  cudaError_t e = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (e == cudaSuccess) e = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (e != cudaSuccess) return e;
  p->cpw = 1;
  for (int cpw = 4; cpw > 1; cpw /= 2) {
    if ((long)b * ((s + kSelWarps * cpw - 1) / (kSelWarps * cpw)) >= 2L * sms) {
      p->cpw = cpw;
      break;
    }
  }
  p->kernel = p->cpw == 4 ? sa_select_kernel<4> : p->cpw == 2 ? sa_select_kernel<2>
                                                              : sa_select_kernel<1>;
  p->tile = kSelWarps * p->cpw;
  p->smem = 3 * sizeof(float) * (size_t)((n + kChunk - 1) / kChunk * kChunk);
  if (p->smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

cudaError_t launch_select(const float* xyz, const float* cent, int b, int n, int s, float r2,
                          int* idx, int* count, cudaStream_t stream) {
  SelPlan p;
  cudaError_t e = select_plan(b, n, s, &p);
  if (e != cudaSuccess) return e;
  SelArgs a{xyz, cent, idx, count, n, s, (int)(p.smem / (3 * sizeof(float))), r2};
  p.kernel<<<dim3((s + p.tile - 1) / p.tile, b), kSelThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The exact ball query alone: idx [b, s, 128] (fill-with-first, 0 when
// none) and count [b, s] (min(hits, 128)) of centroids cent [b, s, 3] in
// the cloud xyz [b, n, 3], hits by dx*dx + dy*dy + dz*dz < r2 in f32.
// Returns a cudaError_t (cudaErrorInvalidValue for a cloud whose staged
// copy does not fit in a block's shared memory).
int mpn_sa_select(const float* xyz, const float* cent, int b, int n, int s, float r2, int* idx,
                  int* count, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || s < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_select(xyz, cent, b, n, s, r2, idx, count,
                            static_cast<cudaStream_t>(stream));
}

// Shapes as in SaArgs. chunks == null selects the exact grouping: with
// select = 1 the ball-query kernel first writes idx and count (scratch
// [b, s] int32), with select = 0 they are given; then the MLP kernel reads
// them. Else the fast window scan over `window` chunks per centroid writes
// idx in the MLP kernel (count and select unused). in_cloud = 0 gives a
// centroid without neighbours point 0's layer-1 row; raw == null writes no
// raw block, and a raw block needs in_cloud = 1 and the exact grouping.
// kp, c1 and c2 must be multiples of 4. w1t, w2t, w3t: the bf16 W^T copies,
// zero-padded to multiples of 16 (needed for bf16, null for f32). Both
// launches go on `stream`. Returns a cudaError_t.
int mpn_sa(const float* xyz, const float* feat, const float* cent, const int* chunks,
           int window, const float* w1, const float* w1f, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, const bf16_t* w1t,
           const bf16_t* w2t, const bf16_t* w3t, int b, int n, int s, int c, int kp, int c1,
           int c2, int c3, float r2, int bf16, int in_cloud, float* out, int* idx, int* count,
           float* raw, int select, void* stream) {
  const int fast = chunks != nullptr;
  if (kp % 4 || c1 % 4 || c2 % 4 || kp < 3 + c || b < 1 || b > 65535 || s < 1 ||
      (raw && !in_cloud) || (fast && (raw || !in_cloud)) || (!fast && !count) ||
      (bf16 && !(w1t && w2t && w3t)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan(c, kp, c1, c2, c3, bf16, in_cloud, raw != nullptr, fast, &p);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fast && select) {
    e = launch_select(xyz, cent, b, n, s, r2, idx, count, st);
    if (e != cudaSuccess) return (int)e;
  }
  SaArgs a{xyz, feat, cent, chunks, w1, w1f, b1, w2, b2, w3, b3, w1t, w2t, w3t, out, idx,
           fast ? nullptr : count, raw, n, s, c, kp, c1, c2, c3, window, bf16,
           round16(3 + c), round16(c1), round16(c2), round16(c3), r2};
  p.kernel<<<dim3((s + kTs - 1) / kTs, b), kThreads, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The MLP launch mpn_sa makes for these widths and options: *mma 1 for the
// tensor-core kernel, its dynamic shared memory in bytes and the blocks of
// it that fit on one SM. Returns a cudaError_t.
int mpn_sa_plan(int c, int kp, int c1, int c2, int c3, int bf16, int in_cloud, int raw, int fast,
                int* mma, int* smem, int* blocks_per_sm) {
  Plan p;
  cudaError_t e = plan(c, kp, c1, c2, c3, bf16, in_cloud, raw, fast, &p);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, p.kernel, kThreads, p.smem);
  }
  *mma = p.mma;
  *smem = (int)p.smem;
  return (int)e;
}

// The ball-query launch for b rows, n points and s centroids: centroids per
// warp, the staged cloud's shared memory in bytes and the blocks that fit
// on one SM. Returns a cudaError_t.
int mpn_sa_select_plan(int b, int n, int s, int* cpw, int* smem, int* blocks_per_sm) {
  SelPlan p;
  cudaError_t e = select_plan(b, n, s, &p);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, p.kernel, kSelThreads,
                                                      p.smem);
  }
  *cpw = p.cpw;
  *smem = (int)p.smem;
  return (int)e;
}

const char* mpn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
