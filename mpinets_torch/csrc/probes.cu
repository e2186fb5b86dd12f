// The TPU on-chip probes under scripts/ on Hopper (sm_90a), bound through a
// plain C interface (ctypes). Four kernels:
//
// probe_scan_kernel<kMode> replaces scripts/onchip_r3b.py::_abl_kernel,
// scripts/onchip_r3d.py::_abl_kernel and scripts/onchip_r3c.py::_abl2_kernel:
// the SA0 ball-query scan (pallas_ops.py::_sa_kernel_v5) cut off after one
// of its stages, with a cheap per-lane reduction written out so that nothing
// is dead code. Point i = 128 c + l is lane l of chunk c; hit(s, i) is
// dx*dx + dy*dy + dz*dz < r2 in f32, left to right; lo_c / hi_c are the
// hits of centroid s before / through chunk c. out[b, s, l] is, by mode:
//   kHits        (r3b stop 1)          sum_c hit(s, 128c + l)
//   kCount       (r3b stop 2, r3c)     sum_c (lo_c + hits at lanes <= l of chunk c)
//   kCountNoScan (r3c without scan)    sum_c (hits of chunk c + hits at lanes <= l)
//   kSlot        (r3b/r3d stop 3)      sum_c pos_c(l): 0 for l < lo_c, 127 for
//                                      l >= hi_c, else the lane of the
//                                      (l - lo_c)-th hit of chunk c
//   kGather      (r3b stop 4, 5)       P(n_l(s)) for l < count(s), else 0
//   kTileSum     (r3d stop 4)          sum over the 32-centroid tile of s of
//                                      kGather's value
// where n_l(s) is the l-th hit in index order and P(i) = ((x + y) + z) + feat.
//
// What bounds it on the H100: the distance tests, B*S*N of them (8.2e8 at
// B=256, N=6272, S=512). Each is 8 uncontracted f32 operations and a
// compare, 9 issue slots and no FMA, so the floor is 9 B S N over the card's
// non-FMA f32 rate (132 SMs x 128 lanes x 1.98 GHz = 33.45e12 a second):
// 0.221 ms. The bytes (cloud, centroids, [B, S, 128] out) are 93 MB, 0.028 ms.
//
// Design: one block of 8 warps per (batch row, tile of 32 centroids); the
// block stages the planes the scan reads, x[N], y[N], z[N], in shared memory
// (75 KB at N=6272: three blocks a SM), so the scan reads no global memory;
// feat, which only kGather and kTileSum read and only at a hit, is read from
// global memory there. Each warp scans for 4 centroids at once; per chunk a
// lane reads its 4 neighbouring points 128 c + 4 lane + j (j < 4) as one
// float4 a plane and tests each against the 4 centroids: 16 tests for 3
// shared loads. Everything after a test is per hit, or per chunk and the same
// for the whole warp:
//  - kHits, kCount, kCountNoScan: one sign-bit add a test (diff_bits). The
//    lane keeps H[g][j], its hits at point 4 lane + j over the chunks; kCount
//    also adds the lane's sum over j of H to T[g] before each chunk, so that
//    T summed over the warp is sum_c lo_c. At the end, per centroid, one
//    warp prefix over lanes (__shfl_up_sync): sum_c (hits at lanes <= l of
//    chunk c) is the inclusive prefix of H over the 128 lanes; kCount adds
//    sum_c lo_c (__reduce_add_sync), kCountNoScan sum_c tot_c (the warp's
//    sum of H).
//  - kSlot, kGather, kTileSum: one funnel shift a test (the sign of
//    d2 - r2 into bit j of centroid g's 4-bit mask) and one __any_sync a
//    chunk. Only at a chunk with hits (a warp-uniform branch) does the warp
//    walk, per centroid, the lanes that hold hits (__ballot_sync, then
//    __shfl_sync of each one's 4-bit mask) in index order, and the lanes
//    that own slots lo .. hi - 1 take the hit's lane in the chunk (kSlot)
//    or P (kGather). kSlot needs no work at empty chunks: slot l < count(s)
//    gets 127 for each chunk before its hit's chunk c and 0 after it, so its
//    sum is 127 c + the hit's lane; a slot l >= count(s) gets 127 at every
//    chunk, 127 nc. Once every centroid of the warp has 128 hits, every
//    later chunk adds 0 (l < lo_c) and fills no slot, so the warp stops
//    scanning, as sa_select_kernel does.
// So a test issues 10 instructions: the 8 of the distance, the subtraction
// and the add or shift (a compare and a select would make 11-12), and a
// chunk of 16 tests 3 shared loads and a few more.
// The sums of kHits, kCount, kCountNoScan and kSlot are integers below 2^24
// (at most nc N = 2,918,528 at the largest cloud the kernel takes, 19,328
// points in 151 chunks, where x, y, z fill 227 KB), so integer accumulators
// converted once at the end equal the plain version's sums.
// kTileSum is a block reduction in the plain version's order: each warp sums
// its 4 centroids, then 128 threads sum the 8 warps in order.
//
// probe_micro_kernel<kOp> / probe_roll_kernel / probe_prefix_kernel replace
// scripts/onchip_r3d.py::_micro_kernel: one op repeated `reps` times over
// every row of each `rb`-row block of a [rows, 128] f32 array, rows 0..7 of
// each block written out ([8 rows / rb, 128]). The whole block is computed
// and the store is guarded at run time, so no row's work is dead code.
//   gather       sum_{r < reps} a[row, (idx[row, l] + r) mod 128] (rows staged in shared)
//   vadd         v <- v * 1.0000001 + 1, reps times (never contracted into an FMA)
//   roll_narrow  the column a[:, 0] shifted down one row (mod rb) and 1 added,
//                reps times, in shared memory; the value goes in every lane
//   roll_wide    the same for every lane, in groups of kRollLanes lanes
//   bd_matmul    the exclusive prefix sum of bf16(a) down each 49-row group
//                (the TPU's block-diagonal prefix matmul), added to an f32
//                accumulator reps times; a thread per lane and group keeps
//                the group's 49 values and 49 accumulators in registers, and
//                writes their sum per group (sums [rows / 49, 128]) so that
//                every row's work is kept, as the TPU's full matmul does it.
// Bounds: bytes for one pass (12.8 MB in and out at 25,088 x 128), a few
// microseconds; reps adds per element at 67 TFLOP/s.
//
// probe_wide_kernel replaces scripts/onchip_r4a.py::_wide_kernel:
// out[b, p, k] = sum_{c < nc} tab[b, nc p + c, idx[b, nc p + c, k]], a gather
// with an index wider than its 128-lane table. Bound by bytes: the index
// (470 MB at B=256, [224, 2048] int32 a row) is read once; the table rows of
// one part sit in shared memory and each thread reads 4 indices as one int4.
//
// probe_scratch_kernel replaces scripts/onchip_r4a.py::_scratch_kernel,
// which asks whether scratch memory persists across sequential grid steps:
// one block steps through `steps` steps itself, writes its shared scratch
// (iota over lanes) at step 0 only and writes scratch + j at step j. On a GPU
// that holds within a block, never across blocks.
//
// Rounding: the distance is written with __fsub_rn/__fmul_rn/__fadd_rn, as in
// sa.cu, so membership matches the plain version bit for bit; sums are in
// the plain versions' order unless stated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;       // points per chunk, lanes per row
constexpr int kTile = 32;         // centroids per block (the TPU's tile_s)
constexpr int kWarps = 8;
constexpr int kCpw = kTile / kWarps;  // centroids scanned together by one warp
constexpr int kLanePts = kChunk / 32; // neighbouring points of a chunk a lane tests
constexpr int kScanThreads = kWarps * 32;
constexpr int kMaxScanPoints = 19328; // 151 chunks: x, y, z f32 in 227 KB
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOutRows = 8;       // rows written per micro block
constexpr int kRowsPerBlock = 16; // rows per block of the elementwise micro ops
constexpr int kRollLanes = 4;     // lanes per block of roll_wide
constexpr int kGroup = 49;        // rows per prefix group of bd_matmul
constexpr int kScratchRows = 8;

enum ScanMode { kHits = 0, kCount, kCountNoScan, kSlot, kGather, kTileSum, kScanModes };
enum MicroOp { kGatherOp = 0, kRollNarrow, kRollWide, kVadd, kBdMatmul, kMicroOps };

struct ScanArgs {
  const float* xyz;   // [b, n, 3]
  const float* feat;  // [b, n]
  const float* cent;  // [b, s, 3]
  float* out;         // [b, s, 128]
  int n, s;
  float r2;
};

__device__ __forceinline__ float dist2(float x, float y, float z, float cx, float cy,
                                       float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Position of the k-th set bit (from 0) of the 4-bit mask m, for k < popc(m).
__device__ __forceinline__ int nth_bit4(unsigned m, int k) {
  const int low = __popc(m & 3u);
  int pos = 0;
  if (k >= low) {
    k -= low;
    m >>= 2;
    pos = 2;
  }
  return pos + (k >= (int)(m & 1u) ? 1 : 0);
}

// The lane's points 128 c + 4 lane + j of chunk c (one float4 a plane)
// against the warp's centroids: test(g, j, d2) with each squared distance,
// j from 3 down to 0.
template <typename Test>
__device__ __forceinline__ void test_chunk(const float* cloud, int n, int c, int lane,
                                           const float (&cx)[kCpw], const float (&cy)[kCpw],
                                           const float (&cz)[kCpw], Test&& test) {
  const int p = (c * kChunk) / kLanePts + lane;
  const float4 x4 = reinterpret_cast<const float4*>(cloud)[p];
  const float4 y4 = reinterpret_cast<const float4*>(cloud + n)[p];
  const float4 z4 = reinterpret_cast<const float4*>(cloud + 2 * n)[p];
  const float xs[kLanePts] = {x4.x, x4.y, x4.z, x4.w};
  const float ys[kLanePts] = {y4.x, y4.y, y4.z, y4.w};
  const float zs[kLanePts] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
  for (int j = kLanePts - 1; j >= 0; --j) {
#pragma unroll
    for (int g = 0; g < kCpw; ++g) {
      test(g, j, dist2(xs[j], ys[j], zs[j], cx[g], cy[g], cz[g]));
    }
  }
}

// The bits of d2 - r2 rounded: the top bit is 1 exactly when d2 < r2 (a
// difference of two floats is 0 only when they are equal, rounding keeps
// its sign, and NaN comes out positive). The test is then one sign-bit add
// (LEA.HI) or one funnel shift (SHF) instead of a compare and a select.
__device__ __forceinline__ unsigned diff_bits(float d2, float r2) {
  return __float_as_uint(__fsub_rn(d2, r2));
}

template <int kMode>
__global__ void __launch_bounds__(kScanThreads, 3) probe_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) float cloud[];  // x[n], y[n], z[n]
  const int n = a.n;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xyz = a.xyz + (size_t)b * n * 3;
  for (int i = tid; i < n; i += kScanThreads) {
    cloud[i] = xyz[3 * i];
    cloud[n + i] = xyz[3 * i + 1];
    cloud[2 * n + i] = xyz[3 * i + 2];
  }
  const int s0 = blockIdx.x * kTile + warp * kCpw;  // this warp's first centroid
  float cx[kCpw], cy[kCpw], cz[kCpw];
#pragma unroll
  for (int g = 0; g < kCpw; ++g) {
    const float* c = a.cent + ((size_t)b * a.s + s0 + g) * 3;
    cx[g] = c[0];
    cy[g] = c[1];
    cz[g] = c[2];
  }
  __syncthreads();

  const int nc = n / kChunk;
  float v[kCpw][kLanePts];  // out[b, s0 + g, 4 lane + j]
  if constexpr (kMode <= kCountNoScan) {
    // H: the lane's hits at point 4 lane + j of a chunk, over the chunks;
    // kCount: T, the sum over chunks of the lane's H before the chunk, whose
    // sum over the warp is sum_c lo_c
    unsigned hh[kCpw][kLanePts] = {};
    unsigned tt[kCpw] = {};
    for (int c = 0; c < nc; ++c) {
      if constexpr (kMode == kCount) {
#pragma unroll
        for (int g = 0; g < kCpw; ++g) tt[g] += (hh[g][0] + hh[g][1]) + (hh[g][2] + hh[g][3]);
      }
      test_chunk(cloud, n, c, lane, cx, cy, cz,
                 [&](int g, int j, float d2) { hh[g][j] += diff_bits(d2, a.r2) >> 31; });
    }
#pragma unroll
    for (int g = 0; g < kCpw; ++g) {
      int h[kLanePts];
#pragma unroll
      for (int j = 0; j < kLanePts; ++j) h[j] = (int)hh[g][j];
      if constexpr (kMode == kHits) {
#pragma unroll
        for (int j = 0; j < kLanePts; ++j) v[g][j] = (float)h[j];
      } else {
        // inclusive prefix of H over lanes 0 .. 4 lane + j: the lane's own,
        // then over the warp
#pragma unroll
        for (int j = 1; j < kLanePts; ++j) h[j] += h[j - 1];
        int incl = h[kLanePts - 1];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += t;
        }
        int base = incl - h[kLanePts - 1];
        if constexpr (kMode == kCount) {  // + sum_c lo_c
          base += (int)__reduce_add_sync(kFull, tt[g]);
        } else {  // + sum_c tot_c
          base += __shfl_sync(kFull, incl, 31);
        }
#pragma unroll
        for (int j = 0; j < kLanePts; ++j) v[g][j] = (float)(base + h[j]);
      }
    }
  } else {
    int lo[kCpw];  // warp-uniform: hits so far, exact until it reaches 128
#pragma unroll
    for (int g = 0; g < kCpw; ++g) {
      lo[g] = 0;
#pragma unroll
      for (int j = 0; j < kLanePts; ++j) v[g][j] = kMode == kSlot ? (float)(127 * nc) : 0.f;
    }
    for (int c = 0; c < nc; ++c) {
      unsigned mine[kCpw] = {};  // bit j: point 4 lane + j is in centroid g's ball
      test_chunk(cloud, n, c, lane, cx, cy, cz, [&](int g, int j, float d2) {
        mine[g] = __funnelshift_l(diff_bits(d2, a.r2), mine[g], 1);  // j = 3, 2, 1, 0
      });
      if (!__any_sync(kFull, ((mine[0] | mine[1]) | (mine[2] | mine[3])) != 0u)) continue;
      bool done = true;
#pragma unroll
      for (int g = 0; g < kCpw; ++g) {
        unsigned who = __ballot_sync(kFull, mine[g] != 0u);  // lanes with a hit, in order
        int r = lo[g];
        while (who != 0u && r < kChunk) {
          const int t = __ffs(who) - 1;
          who &= who - 1u;
          const unsigned m = __shfl_sync(kFull, mine[g], t);
          const int hits = __popc(m);
#pragma unroll
          for (int j = 0; j < kLanePts; ++j) {  // slots r .. r + hits - 1 are lane t's hits
            const int k = kLanePts * lane + j - r;
            if (k >= 0 && k < hits) {
              const int l = kLanePts * t + nth_bit4(m, k);  // the hit's lane in chunk c
              if constexpr (kMode == kSlot) {
                v[g][j] = (float)(127 * c + l);
              } else {
                const int q = c * kChunk + l;  // feat is read at the hit only
                v[g][j] = ((cloud[q] + cloud[n + q]) + cloud[2 * n + q]) +
                          __ldg(a.feat + (size_t)b * n + q);
              }
            }
          }
          r += hits;
        }
        lo[g] = r;
        done = done && r >= kChunk;
      }
      if (done) break;  // no later chunk changes a slot
    }
  }

  if constexpr (kMode == kTileSum) {
    __syncthreads();  // every warp is done with the cloud: reuse it
    float* red = cloud;  // [kWarps][kChunk]
#pragma unroll
    for (int j = 0; j < kLanePts; ++j) {
      float t = v[0][j];
#pragma unroll
      for (int g = 1; g < kCpw; ++g) t += v[g][j];
      red[warp * kChunk + kLanePts * lane + j] = t;
    }
    __syncthreads();
    if (tid < kChunk) {
      float t = red[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += red[w * kChunk + tid];
      float* out = a.out + ((size_t)b * a.s + blockIdx.x * kTile) * kChunk;
      for (int r = 0; r < kTile; ++r) out[r * kChunk + tid] = t;
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < kCpw; ++g) {
    float4* out = reinterpret_cast<float4*>(a.out + ((size_t)b * a.s + s0 + g) * kChunk);
    out[lane] = make_float4(v[g][0], v[g][1], v[g][2], v[g][3]);
  }
}

// gather and vadd: kRowsPerBlock rows a block, one thread per lane.
template <int kOp>
__global__ void __launch_bounds__(kChunk) probe_micro_kernel(const float* __restrict__ a,
                                                            const int* __restrict__ idx,
                                                            int rows, int rb, int reps,
                                                            float* __restrict__ out) {
  __shared__ float srow[kRowsPerBlock][kChunk];
  const int l = threadIdx.x;
  const int r0 = blockIdx.x * kRowsPerBlock;
  if (kOp == kGatherOp) {
    for (int i = 0; i < kRowsPerBlock && r0 + i < rows; ++i) {
      srow[i][l] = a[(size_t)(r0 + i) * kChunk + l];
    }
    __syncthreads();
  }
  for (int i = 0; i < kRowsPerBlock && r0 + i < rows; ++i) {
    const int row = r0 + i;
    float v;
    if (kOp == kGatherOp) {
      int cur = idx[(size_t)row * kChunk + l];
      v = 0.f;
      for (int r = 0; r < reps; ++r) {
        v = __fadd_rn(v, srow[i][cur]);
        cur = (cur + 1) & (kChunk - 1);
      }
    } else {  // kVadd
      v = a[(size_t)row * kChunk + l];
      for (int r = 0; r < reps; ++r) v = __fadd_rn(__fmul_rn(v, 1.0000001f), 1.f);
    }
    const int in_blk = row % rb;
    if (in_blk < kOutRows) out[((size_t)(row / rb) * kOutRows + in_blk) * kChunk + l] = v;
  }
}

// roll_narrow (width 1: lane 0 only, written to every lane) and roll_wide
// (kRollLanes lanes a block): the block's rb x width slab in shared memory,
// double-buffered, shifted down one row (mod rb) with 1 added, reps times.
__global__ void __launch_bounds__(256) probe_roll_kernel(const float* __restrict__ a, int rb,
                                                         int reps, int width,
                                                         float* __restrict__ out) {
  extern __shared__ float slab[];
  float* cur = slab;
  float* nxt = slab + rb * width;
  const int blk = blockIdx.x;
  const int lane0 = blockIdx.y * width;
  const int size = rb * width;
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    cur[e] = a[((size_t)blk * rb + e / width) * kChunk + lane0 + e % width];
  }
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    for (int e = threadIdx.x; e < size; e += blockDim.x) {
      const int i = e / width, w = e % width;
      nxt[e] = __fadd_rn(cur[((i + rb - 1) % rb) * width + w], 1.f);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int e = threadIdx.x; e < kOutRows * kChunk; e += blockDim.x) {
    const int i = e / kChunk, l = e % kChunk;
    float* o = out + ((size_t)blk * kOutRows + i) * kChunk;
    if (width == 1) {
      o[l] = cur[i];
    } else if (l < width) {
      o[lane0 + l] = cur[i * width + l];
    }
  }
}

// bd_matmul: one thread per (lane, 49-row group); the group's values in
// registers. Each rep adds the exclusive prefix of v down the group to acc,
// then makes v depend on acc (v <- bf16(acc * 0 + v), as the TPU body does)
// so no rep can be hoisted. The TPU body computes every row's result; here
// every row's is observable too: sums[group, l] = sum_j (acc[j] + v[j]) in
// row order, so all 49 + 49 values stay live (rows 0..7 alone would let the
// compiler drop the rest of the group).
__global__ void __launch_bounds__(kChunk) probe_prefix_kernel(const float* __restrict__ a,
                                                              int rb, int reps,
                                                              float* __restrict__ out,
                                                              float* __restrict__ sums) {
  const int l = threadIdx.x;
  const int groups = rb / kGroup;
  const int blk = blockIdx.x / groups;
  const int grp = blockIdx.x % groups;
  const float* src = a + ((size_t)blk * rb + grp * kGroup) * kChunk + l;
  float v[kGroup], acc[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    v[j] = __bfloat162float(__float2bfloat16_rn(src[(size_t)j * kChunk]));
    acc[j] = 0.f;
  }
  for (int r = 0; r < reps; ++r) {
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      acc[j] = __fadd_rn(acc[j], run);
      run = __fadd_rn(run, v[j]);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      v[j] = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(acc[j], 0.f), v[j])));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) sum = __fadd_rn(__fadd_rn(sum, acc[j]), v[j]);
  sums[(size_t)blockIdx.x * kChunk + l] = sum;
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < kOutRows; ++j) out[((size_t)blk * kOutRows + j) * kChunk + l] = acc[j];
  }
}

// One block per (part p, batch row b); part p's nc table rows in shared
// memory; each thread sums 4 columns k, reading their indices as one int4.
__global__ void __launch_bounds__(512) probe_wide_kernel(const float* __restrict__ tab,
                                                          const int* __restrict__ idx, int nc,
                                                          int parts, int width,
                                                          float* __restrict__ out) {
  extern __shared__ float stab[];
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t row0 = (size_t)b * parts * nc + (size_t)p * nc;
  for (int e = threadIdx.x; e < nc * kChunk; e += blockDim.x) stab[e] = tab[row0 * kChunk + e];
  __syncthreads();
  const int k = 4 * threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int4* ip = reinterpret_cast<const int4*>(idx + row0 * width + k);
  for (int c = 0; c < nc; ++c) {
    const int4 i4 = ip[(size_t)c * (width / 4)];
    const float* t = stab + c * kChunk;
    acc.x = __fadd_rn(acc.x, t[i4.x]);
    acc.y = __fadd_rn(acc.y, t[i4.y]);
    acc.z = __fadd_rn(acc.z, t[i4.z]);
    acc.w = __fadd_rn(acc.w, t[i4.w]);
  }
  *reinterpret_cast<float4*>(out + ((size_t)b * parts + p) * width + k) = acc;
}

__global__ void __launch_bounds__(kScratchRows * kChunk) probe_scratch_kernel(int steps,
                                                                              float* out) {
  __shared__ float scr[kScratchRows * kChunk];
  const int t = threadIdx.x;
  for (int j = 0; j < steps; ++j) {
    if (j == 0) scr[t] = (float)(t % kChunk);
    __syncthreads();
    out[j * kScratchRows * kChunk + t] = scr[t] + (float)j;
    __syncthreads();
  }
}

template <typename K>
cudaError_t smem_optin(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The scan kernel of a mode and its dynamic shared memory at n points (the
// staged planes; kTileSum reuses them for its 8 x 128 reduction), opted in
// and with shared memory preferred over L1.
cudaError_t scan_setup(int n, int mode, void (**kernel)(ScanArgs), size_t* smem) {
  static void (*const kernels[kScanModes])(ScanArgs) = {
      probe_scan_kernel<kHits>, probe_scan_kernel<kCount>, probe_scan_kernel<kCountNoScan>,
      probe_scan_kernel<kSlot>, probe_scan_kernel<kGather>, probe_scan_kernel<kTileSum>};
  if (n < kChunk || n % kChunk || n > kMaxScanPoints || mode < 0 || mode >= kScanModes)
    return cudaErrorInvalidValue;
  *kernel = kernels[mode];
  *smem = sizeof(float) * 3 * (size_t)n;
  if (mode == kTileSum && *smem < sizeof(float) * kWarps * kChunk)
    *smem = sizeof(float) * kWarps * kChunk;
  cudaError_t e = smem_optin(*kernel, *smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// xyz [b, n, 3], feat [b, n], cent [b, s, 3] f32; out [b, s, 128] f32.
// n a multiple of 128 up to 19,328, s of 32; mode a ScanMode. Returns a
// cudaError_t.
int mpn_probe_scan(const float* xyz, const float* feat, const float* cent, int b, int n, int s,
                   float r2, int mode, float* out, void* stream) {
  if (s < kTile || s % kTile || b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  void (*kernel)(ScanArgs);
  size_t smem;
  cudaError_t e = scan_setup(n, mode, &kernel, &smem);
  if (e != cudaSuccess) return (int)e;
  ScanArgs a{xyz, feat, cent, out, n, s, r2};
  kernel<<<dim3(s / kTile, b), kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The scan launch of a mode at n points: its dynamic shared memory in bytes
// and the blocks that fit on one SM. Returns a cudaError_t.
int mpn_probe_scan_plan(int n, int mode, int* smem_bytes, int* blocks_per_sm) {
  void (*kernel)(ScanArgs);
  size_t smem;
  cudaError_t e = scan_setup(n, mode, &kernel, &smem);
  if (e != cudaSuccess) return (int)e;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kScanThreads,
                                                            smem);
}

// a [rows, 128] f32, idx [rows, 128] int32 in [0, 128) (gather only; may be
// null otherwise); out [8 rows / rb, 128] f32; sums [rows / 49, 128] f32
// (bd_matmul only; may be null otherwise). rows a multiple of rb, rb >= 8;
// bd_matmul needs rb a multiple of 49. op a MicroOp. Returns a cudaError_t.
int mpn_probe_micro(const float* a, const int* idx, int rows, int rb, int op, int reps,
                    float* out, float* sums, void* stream) {
  if (rb < kOutRows || rows < rb || rows % rb || reps < 0 || op < 0 || op >= kMicroOps ||
      (op == kGatherOp && !idx) || (op == kBdMatmul && (rb % kGroup || !sums)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = rows / rb;
  cudaError_t e = cudaSuccess;
  if (op == kGatherOp || op == kVadd) {
    const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (op == kGatherOp) {
      probe_micro_kernel<kGatherOp><<<grid, kChunk, 0, st>>>(a, idx, rows, rb, reps, out);
    } else {
      probe_micro_kernel<kVadd><<<grid, kChunk, 0, st>>>(a, idx, rows, rb, reps, out);
    }
  } else if (op == kBdMatmul) {
    probe_prefix_kernel<<<nblk * (rb / kGroup), kChunk, 0, st>>>(a, rb, reps, out, sums);
  } else {
    const int width = op == kRollNarrow ? 1 : kRollLanes;
    const size_t smem = 2 * sizeof(float) * (size_t)rb * width;
    e = smem_optin(probe_roll_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    probe_roll_kernel<<<dim3(nblk, op == kRollNarrow ? 1 : kChunk / kRollLanes), 256, smem, st>>>(
        a, rb, reps, width, out);
  }
  return (int)cudaGetLastError();
}

// tab [b, parts * nc, 128] f32, idx [b, parts * nc, width] int32 in
// [0, 128), out [b, parts, width] f32; width a multiple of 4, at most 2048;
// idx and out 16-byte aligned (read and written 4 at a time).
// Returns a cudaError_t.
int mpn_probe_wide(const float* tab, const int* idx, int b, int parts, int nc, int width,
                   float* out, void* stream) {
  if (b < 1 || b > 65535 || parts < 1 || nc < 1 || width < 4 || width % 4 || width > 2048 ||
      (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)nc * kChunk;
  cudaError_t e = smem_optin(probe_wide_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  probe_wide_kernel<<<dim3(parts, b), width / 4, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, idx, nc, parts, width, out);
  return (int)cudaGetLastError();
}

// out [steps, 8, 128] f32. Returns a cudaError_t.
int mpn_probe_scratch(int steps, float* out, void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  probe_scratch_kernel<<<1, kScratchRows * kChunk, 0, static_cast<cudaStream_t>(stream)>>>(steps,
                                                                                          out);
  return (int)cudaGetLastError();
}

const char* mpn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
