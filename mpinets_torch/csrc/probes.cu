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
//   gather       sum_{r < reps} a[row, (idx[row, l] + r) mod 128]
//   vadd         v <- v * 1.0000001 + 1, reps times (never contracted into an FMA)
//   roll_narrow  the column a[:, 0] shifted down one row (mod rb) and 1 added,
//                reps times; the value goes in every lane
//   roll_wide    the same for every lane
//   bd_matmul    the exclusive prefix sum of bf16(a) down each 49-row group
//                (the TPU's block-diagonal prefix matmul), added to an f32
//                accumulator reps times; a thread per lane and group keeps
//                the group's 49 values and 49 accumulators in registers, and
//                writes their sum per group (sums [rows / 49, 128]) so that
//                every row's work is kept, as the TPU's full matmul does it.
// Every add and multiply is __fadd_rn / __fmul_rn, so the bounds count them
// at the card's non-FMA f32 rate (33.45e12 a second, below).
//
// probe_roll_kernel<kC, kRagged, kRing>: the roll in registers. A ring (one
// lane column of one block) is held by 32 x warps threads, thread u holding
// rows kC u + j (j < kC) in registers: kC = 49 and one warp at the session's
// rb = 1,568 = 32 x 49. A rep is one __shfl_sync that brings in the previous
// thread's last row (thread 0 takes the ring's last row, so the wrap from row
// rb - 1 stays inside the warp) and kC __fadd_rn(., 1) written from the last
// slot down, so the adds do the shift and no value is moved. Every row's
// value flows into the shuffle kC reps later, so no row is dead code.
// roll_wide: a block of 16 warps holds 16 lanes of one block of rows (64-byte
// row segments: 128 blocks at the session's shape, one wave); it reads its
// slab as float4s, eight a thread in flight, and stages it in shared memory
// column by column at a pitch of 2 mod 8 floats, so the staging stores and
// the column reads (stride kC = 49, odd) are conflict-free; nothing divides
// inside the loop. roll_narrow: one warp a block holds lane 0's column, each
// thread reading its rows straight from device memory. Other rb: kC is the
// smallest of 2, 4, 8, 16, 32, 49, 64 with 32 kC >= rb, the last thread
// holding the rest (kRagged: it sends its row `last - 1`, picked by a chain
// of selects, and its tail is never read); past 2,048 rows, kC = 64 and a
// ring spans up to 16 warps of one column (kRing), the warps passing their
// last rows through shared memory with one barrier a rep.
// Bound: bytes (the slab read once; at rb = 1,568 the 3.2e6 adds a rep take
// 0.1 us at the non-FMA rate). What it costs on the card: the slab's read
// and a rep loop at the FADD issue rate, one after the other in each block.
//
// probe_micro_kernel<kVadd>: each thread runs 16 independent chains (four
// consecutive float4s of one row, all loaded before the first rep) and
// computes its store guard once. Bound: bytes at 8 reps, the 2 reps
// operations an element at 32.
// probe_micro_kernel<kGatherOp>: a block stages 64 rows, each followed by its
// first 32 values again so that a window of 32 never wraps, and sorts its
// 8,192 outputs by the bank of their start (idx mod 32: a row is 160 floats,
// 0 mod 32) with a counting sort in shared memory, paid once and not a rep.
// Lane b of every warp then takes bank b's outputs, so at rep r lane b reads
// bank (b + r) mod 32 and every warp's read is one wavefront; a lane whose
// bank has run out reads a dummy window on its own bank. A warp runs four
// outputs a lane at once; each sum is v = 0; v += a[row, (idx + r) mod 128]
// for r = 0 .. reps - 1, in that order. Three blocks a SM, one wave at the
// session's shape. Bound: the reps x rows x 128 shared reads at 32 words a
// clock a SM (8.36e12 a second) at 32 reps, the 25.7 MB read at 8.
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
constexpr int kVaddThreads = 256;
constexpr int kVaddVecs = 4;      // float4s a thread of vadd: 16 independent chains
constexpr float kVaddScale = 1.0000001f;
constexpr int kGatherRows = 64;   // rows a block of gather
constexpr int kGatherThreads = 512;
constexpr int kGatherPitch = 160; // floats a staged row: its 128 values, then its first 32 again
constexpr int kGatherChains = 4;  // outputs a lane runs at once
// the sorted outputs: bank b's at 2b + 64 m + g (g < its count), so lane b's
// g-th entry lies in bank b + g / 2 (mod 32): 8,192 entries and the padding
constexpr int kGatherList = kGatherRows * kChunk + 32 * 2 * 32 + 32 * 64;
constexpr int kRollCols = 16;     // lane columns a block of roll_wide, one ring each
constexpr int kRollMaxRows = 64;  // rows a thread of a ring holds at most
constexpr int kRollMaxWarps = 16; // warps a ring spans at most
constexpr int kRollThreads = 512;
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

struct MicroArgs {
  const float* a;   // [rows, 128]
  const int* idx;   // [rows, 128] in [0, 128) (gather)
  float* out;       // [8 rows / rb, 128]
  int rows, rb, reps;
  int vec;          // a and idx 16-byte aligned: read as float4 / int4
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ int4 load4(const int* p, bool vec) {
  return vec ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(p[0], p[1], p[2], p[3]);
}

// A warp's kK outputs a lane of gather (see the note at the top): lane b
// reads bank (b + r) mod 32 at rep r in each of its kK windows.
template <int kK>
__device__ __forceinline__ void gather_outputs(const float* srow, const uint16_t* list,
                                               const int* outrow, int base, int cnt, int g0,
                                               int step, int lane, const MicroArgs& p) {
  const float* rowp[kK];
  int s[kK], col[kK], orow[kK];
  float acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int g = g0 + k * step;
    // entry: out row? << 15 | row << 9 | lane column << 2 | idx >> 5, and
    // idx mod 32 = lane; a lane past its bank's outputs reads row 0 from
    // `lane`, writing nothing
    const unsigned e = g < cnt ? list[base + g] : 0u;
    const int row = (e >> 9) & (kGatherRows - 1);
    rowp[k] = srow + row * kGatherPitch;
    s[k] = (int)((e & 3u) << 5) | lane;
    col[k] = (e >> 2) & (kChunk - 1);
    orow[k] = e >> 15 ? outrow[row] : -1;
    acc[k] = 0.f;
  }
  for (int c = 0; c < p.reps; c += 32) {  // reps c .. c + 31 read values s + c .. s + c + 31
    const float* w[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) w[k] = rowp[k] + ((s[k] + c) & (kChunk - 1));
    if (p.reps - c >= 32) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
#pragma unroll
        for (int k = 0; k < kK; ++k) acc[k] = __fadd_rn(acc[k], w[k][r]);
      }
    } else {
      for (int r = 0; r < p.reps - c; ++r) {
#pragma unroll
        for (int k = 0; k < kK; ++k) acc[k] = __fadd_rn(acc[k], w[k][r]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (orow[k] >= 0) p.out[(size_t)orow[k] * kChunk + col[k]] = acc[k];
  }
}

// gather (kGatherOp) and vadd (kVadd); see the note at the top.
template <int kOp>
__global__ void __launch_bounds__(kOp == kGatherOp ? kGatherThreads : kVaddThreads,
                                  kOp == kGatherOp ? 3 : 1)
    probe_micro_kernel(MicroArgs p) {
  const int tid = threadIdx.x;
  if constexpr (kOp == kVadd) {
    const int q0 = (blockIdx.x * kVaddThreads + tid) * kVaddVecs;  // its first float4
    if (q0 >= p.rows * (kChunk / 4)) return;
    const int row = q0 / (kChunk / 4);  // the thread's float4s lie in one row
    float4 v[kVaddVecs];
#pragma unroll
    for (int k = 0; k < kVaddVecs; ++k) v[k] = load4(p.a + 4 * (size_t)(q0 + k), p.vec);
    const int in_blk = row % p.rb;
#pragma unroll 2
    for (int r = 0; r < p.reps; ++r) {
#pragma unroll
      for (int k = 0; k < kVaddVecs; ++k) {
        v[k].x = __fadd_rn(__fmul_rn(v[k].x, kVaddScale), 1.f);
        v[k].y = __fadd_rn(__fmul_rn(v[k].y, kVaddScale), 1.f);
        v[k].z = __fadd_rn(__fmul_rn(v[k].z, kVaddScale), 1.f);
        v[k].w = __fadd_rn(__fmul_rn(v[k].w, kVaddScale), 1.f);
      }
    }
    if (in_blk < kOutRows) {
      float4* o = reinterpret_cast<float4*>(
          p.out + ((size_t)(row / p.rb) * kOutRows + in_blk) * kChunk + 4 * (q0 % (kChunk / 4)));
#pragma unroll
      for (int k = 0; k < kVaddVecs; ++k) o[k] = v[k];
    }
  } else {
    extern __shared__ __align__(16) float smem[];
    float* srow = smem;                                                   // [64][160]
    uint16_t* list = reinterpret_cast<uint16_t*>(srow + kGatherRows * kGatherPitch);
    int* count = reinterpret_cast<int*>(list + kGatherList);              // [32] outputs a bank
    int* start = count + 32;                                              // [32]
    int* outrow = start + 32;                                             // [64] out row or -1
    int* groups = outrow + kGatherRows;
    const int lane = tid & 31, warp = tid >> 5;
    const int r0 = blockIdx.x * kGatherRows;
    const int nr = min(kGatherRows, p.rows - r0);
    if (tid < kGatherRows) {
      if (tid < 32) count[tid] = 0;
      const int row = r0 + tid, ib = row % p.rb;
      outrow[tid] = tid < nr && ib < kOutRows ? (row / p.rb) * kOutRows + ib : -1;
    }
    // the indices first, four int4s a thread, so that they arrive ahead of
    // the rows and the sort runs while the rows stream in
    constexpr int kPer = kGatherRows * kChunk / 4 / kGatherThreads;
    const int n4 = nr * (kChunk / 4);
    int4 i4[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = tid + k * kGatherThreads;
      i4[k] = q < n4 ? load4(p.idx + ((size_t)r0 * kChunk + 4 * q), p.vec) : int4{};
    }
    // the rows, each followed by its first 32 values, straight to shared memory
    for (int q = tid; q < n4; q += kGatherThreads) {
      const int row = q / (kChunk / 4), c4 = q % (kChunk / 4);
      float* dst = srow + row * kGatherPitch + 4 * c4;
      const float* src = p.a + ((size_t)r0 * kChunk + 4 * q);
      if (p.vec) {
        cp_async16(dst, src);
        if (c4 < 32 / 4) cp_async16(dst + kChunk, src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cp_async4(dst + i, src + i);
          if (c4 < 32 / 4) cp_async4(dst + kChunk + i, src + i);
        }
      }
    }
    // the indices kept as bytes; each output's rank in its bank's bin, two to
    // a register
    unsigned keys[kPer], ranks[kPer][2];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      keys[k] = (unsigned)i4[k].x | (unsigned)i4[k].y << 8 | (unsigned)i4[k].z << 16 |
                (unsigned)i4[k].w << 24;
    }
    __syncthreads();  // count is zeroed
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (tid + k * kGatherThreads < n4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned lo = atomicAdd(&count[(keys[k] >> (16 * h)) & 31], 1);
          const unsigned hi = atomicAdd(&count[(keys[k] >> (16 * h + 8)) & 31], 1);
          ranks[k][h] = lo | hi << 16;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // bank b's bin: a region of a multiple of 64 entries, its entries from
      // 2b on; and the most outputs of a bank
      const int c = count[lane];
      const int size = (2 * lane + c + 63) & ~63;
      int incl = size;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      start[lane] = incl - size + 2 * lane;
      const int most = __reduce_max_sync(kFull, c);
      if (lane == 0) *groups = most;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = tid + k * kGatherThreads;
      if (q < n4) {
        const int row = q / (kChunk / 4), col = 4 * (q % (kChunk / 4));
        const unsigned flag = outrow[row] >= 0 ? 1u << 15 : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned v = (keys[k] >> (8 * e)) & 0xffu;
          list[start[v & 31] + ((ranks[k][e >> 1] >> (16 * (e & 1))) & 0xffffu)] =
              (uint16_t)(flag | row << 9 | (col + e) << 2 | v >> 5);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // warp w runs groups w, w + 16, ...: group g is the g-th output of every bank
    constexpr int kWarpsG = kGatherThreads / 32;
    const int ng = *groups, cnt = count[lane], base = start[lane];
    int g0 = warp;
    for (; g0 + (kGatherChains - 1) * kWarpsG < ng; g0 += kGatherChains * kWarpsG)
      gather_outputs<kGatherChains>(srow, list, outrow, base, cnt, g0, kWarpsG, lane, p);
    for (; g0 < ng; g0 += kWarpsG)
      gather_outputs<1>(srow, list, outrow, base, cnt, g0, kWarpsG, lane, p);
  }
}

struct RollArgs {
  const float* a;  // [rows, 128]
  float* out;      // [8 rows / rb, 128]
  int rb, reps;
  int warps;       // warps a ring
  int used;        // threads of a ring that hold rows: ceil(rb / kC)
  int last;        // rows of thread used - 1 (kC unless ragged)
  int pitch;       // floats between two staged columns: >= rb, 2 mod 8
  int narrow;      // roll_narrow: lane 0's column, written to every lane
  int vec;         // a 16-byte aligned: the slab read as float4s
};

// reps rolls of a ring, thread u holding its rows kC u + j in v: the
// previous thread's last row comes in by one shuffle (kRing: lane 0 takes
// the previous warp's through xch, one barrier a rep), and kC adds shift
// the registers down one slot.
template <int kC, bool kRagged, bool kRing>
__device__ __forceinline__ void roll_reps(float (&v)[kC], const RollArgs& p, int u, float* xch) {
  const int lane = u & 31, w = u >> 5;
  // the thread whose last row comes in: u - 1, or the ring's last thread
  const int src_lane = lane ? lane - 1 : (kRing ? 31 : p.used - 1);
  const int send_slot = kRagged && u == p.used - 1 ? p.last - 1 : kC - 1;
  for (int r = 0; r < p.reps; ++r) {
    float send = v[kC - 1];
    if constexpr (kRagged) {
#pragma unroll
      for (int j = 0; j < kC - 1; ++j) send = j == send_slot ? v[j] : send;
    }
    float got = __shfl_sync(kFull, send, src_lane);
    if constexpr (kRing) {
      float* x = xch + (r & 1) * p.warps;
      if (u == p.used - 1) {
        x[0] = send;
      } else if (lane == 31 && u < p.used) {
        x[w + 1] = send;
      }
      __syncthreads();
      if (lane == 0) got = x[w];
    }
#pragma unroll
    for (int j = kC - 1; j > 0; --j) v[j] = __fadd_rn(v[j - 1], 1.f);
    v[0] = __fadd_rn(got, 1.f);
  }
}

// roll_wide and roll_narrow in registers; see the note at the top.
template <int kC, bool kRagged, bool kRing>
__global__ void __launch_bounds__(kRollThreads) probe_roll_kernel(RollArgs p) {
  // roll_wide: [kRollCols][pitch] staged columns; else [8] rows out, then
  // kRing: [2][warps]
  extern __shared__ __align__(16) float stage[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int first = kC * (tid % (32 * p.warps));  // thread u holds rows first + j; past rb, 0
  float v[kC];
  if (!p.narrow && p.warps == 1) {
    // roll_wide, one warp a ring: block i holds lanes 16 (i mod 8) .. + 15 of
    // block i / 8 of rows. The slab, 64 bytes a row, is read as float4s,
    // eight a thread in flight, and written into columns.
    constexpr int kRow4 = kRollCols / 4, kBatch = 8;
    const int c = tid / 32, groups = kChunk / kRollCols;
    const int blk = blockIdx.x / groups, col0 = blockIdx.x % groups * kRollCols;
    const float* src = p.a + (size_t)blk * p.rb * kChunk + col0;
    const int n4 = p.rb * kRow4;
    for (int q0 = tid; q0 < n4; q0 += kBatch * nthreads) {
      float4 x[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int q = q0 + k * nthreads;
        if (q < n4) x[k] = load4(src + (size_t)(q / kRow4) * kChunk + 4 * (q % kRow4), p.vec);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int q = q0 + k * nthreads;
        if (q < n4) {
          float* dst = stage + 4 * (q % kRow4) * p.pitch + q / kRow4;
          dst[0] = x[k].x;
          dst[p.pitch] = x[k].y;
          dst[2 * p.pitch] = x[k].z;
          dst[3 * p.pitch] = x[k].w;
        }
      }
    }
    __syncthreads();
    const float* col = stage + c * p.pitch;
#pragma unroll
    for (int j = 0; j < kC; ++j) v[j] = first + j < p.rb ? col[first + j] : 0.f;
    roll_reps<kC, kRagged, false>(v, p, tid & 31, nullptr);
    float* out = p.out + (size_t)blk * kOutRows * kChunk + col0 + c;
#pragma unroll
    for (int j = 0; j < (kC < kOutRows ? kC : kOutRows); ++j) {
      if (first + j < kOutRows) out[(first + j) * kChunk] = v[j];
    }
    return;
  }
  // one column a block (roll_narrow, and rings over several warps): each
  // thread reads its rows
  const int col0 = p.narrow ? 0 : blockIdx.y;
  const float* src = p.a + (size_t)blockIdx.x * p.rb * kChunk + col0;
#pragma unroll
  for (int j = 0; j < kC; ++j) v[j] = first + j < p.rb ? src[(size_t)(first + j) * kChunk] : 0.f;
  roll_reps<kC, kRagged, kRing>(v, p, tid, stage + kOutRows);
#pragma unroll
  for (int j = 0; j < (kC < kOutRows ? kC : kOutRows); ++j) {
    if (first + j < kOutRows) stage[first + j] = v[j];
  }
  __syncthreads();
  float* out = p.out + (size_t)blockIdx.x * kOutRows * kChunk;
  if (p.narrow) {
    for (int e = tid; e < kOutRows * kChunk; e += nthreads) out[e] = stage[e / kChunk];
  } else {
    for (int e = tid; e < kOutRows; e += nthreads) out[e * kChunk + col0] = stage[e];
  }
}

// bd_matmul: one thread per (lane, 49-row group), 128 threads a block, the
// group's bf16 values and f32 accumulators in registers (98 floats: with
// __launch_bounds__(128, 4) at most 128 registers, four blocks a SM, so the
// 512 blocks of the session's shape fill the card in one wave with 3.9 warps
// a scheduler). A rep is the exclusive prefix of v added to acc, 49 + 48
// __fadd_rn, and one __fmul_rn: each rep's running sum starts at
// |acc[1]| * 0, not at 0. For finite acc that is +0, the plain version's
// start (the fabsf, an operand modifier of the FMUL, keeps it +0 where
// acc[1] < 0; a -0 start would give the same bits, as no accumulator is
// ever -0), and it ties each rep's prefix to the previous rep's
// accumulators, so the compiler can neither hoist the prefix out of the
// loop nor merge reps: IEEE forbids folding x * 0 and reassociating the
// adds, and the build has no --use_fast_math.
// The TPU body ties v to acc[:, :1] instead, one dependency a row; here it
// is one a (group, lane), and v is converted to bf16 once, at the load (a
// tie a row, v = bf16(acc * 0 + v), would issue a multiply, an add and two
// conversions an element a rep beside the two counted adds). Both ties are
// identities on finite values; a non-finite acc[1] (row 0's value summed
// over the reps) reaches every row of the group from the next rep on.
// acc[1] is final two steps into a rep (acc[0] only ever adds the start,
// so it would be a constant the compiler could fold), so the next rep's
// chain of ~50 dependent adds can start while this one runs: with the rep
// loop unrolled 4 times the compiler interleaves the reps' chains, which
// the in-order issue of a warp needs to keep the FADD pipe full. A chain is
// never split, as that would change the order of the adds. Every row's
// result stays observable: sums[group, l] = sum_j (acc[j] + v[j]) in row
// order, so all 49 + 49 values stay live (rows 0..7 alone would let the
// compiler drop the rest of the group).
// The tensor cores lose here: the block-diagonal product is 49 x 64 x 128 x 2
// FLOP a group a rep with the depth padded to 64 (64 rows padded: 64 x 64 x
// 128 x 2), 411 (537) MFLOP a rep over 512 groups, 0.42 (0.54) us at 989
// TFLOP/s bf16, against 0.19 us for the two adds an element at the non-FMA
// f32 rate; and an MMA's summation order is not the plain version's.
__global__ void __launch_bounds__(kChunk, 4) probe_prefix_kernel(const float* __restrict__ a,
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
#pragma unroll 4
  for (int r = 0; r < reps; ++r) {
    float run = __fmul_rn(fabsf(acc[1]), 0.f);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      acc[j] = __fadd_rn(acc[j], run);
      run = __fadd_rn(run, v[j]);
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

// The launch floor: an empty kernel of one warp, timed in the probes' loop
// as the least time any launch takes there. A yardstick like a library
// call's time; it replaces no TPU kernel and no main path calls it.
__global__ void probe_empty_kernel() {}

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

using RollKernel = void (*)(RollArgs);
using MicroKernel = void (*)(MicroArgs);
constexpr int kRollSizes = 7;
constexpr int kRollRowsPerThread[kRollSizes] = {2, 4, 8, 16, 32, 49, kRollMaxRows};

// The launch of a micro op at rb rows a block (rows: the grid): its kernel,
// grid, threads, dynamic shared memory (opted in, shared memory preferred
// over L1), and for the roll its rows a thread, raggedness and warps a ring.
struct MicroLaunch {
  const void* fn;
  RollKernel roll;
  MicroKernel micro;
  dim3 grid;
  int threads;
  size_t smem;
  RollArgs ra;
  int rows_per_thread, ragged;  // the roll's kC and kRagged
};

cudaError_t micro_setup(int rows, int rb, int op, MicroLaunch* m) {
  static const RollKernel roll[kRollSizes][2] = {
      {probe_roll_kernel<2, false, false>, probe_roll_kernel<2, true, false>},
      {probe_roll_kernel<4, false, false>, probe_roll_kernel<4, true, false>},
      {probe_roll_kernel<8, false, false>, probe_roll_kernel<8, true, false>},
      {probe_roll_kernel<16, false, false>, probe_roll_kernel<16, true, false>},
      {probe_roll_kernel<32, false, false>, probe_roll_kernel<32, true, false>},
      {probe_roll_kernel<49, false, false>, probe_roll_kernel<49, true, false>},
      {probe_roll_kernel<kRollMaxRows, false, false>, probe_roll_kernel<kRollMaxRows, true, false>}};
  static const RollKernel roll_ring[2] = {probe_roll_kernel<kRollMaxRows, false, true>,
                                          probe_roll_kernel<kRollMaxRows, true, true>};
  *m = MicroLaunch{};
  const int nblk = rows / rb;
  if (op == kGatherOp || op == kVadd) {
    const bool gather = op == kGatherOp;
    m->micro = gather ? probe_micro_kernel<kGatherOp> : probe_micro_kernel<kVadd>;
    m->threads = gather ? kGatherThreads : kVaddThreads;
    const int per_block = gather ? kGatherRows : kVaddThreads * kVaddVecs / (kChunk / 4);
    m->grid = dim3((rows + per_block - 1) / per_block);
    m->smem = gather ? sizeof(float) * kGatherRows * kGatherPitch + sizeof(uint16_t) * kGatherList +
                           sizeof(int) * (32 + 32 + kGatherRows + 1)
                     : 0;
    m->fn = (const void*)m->micro;
  } else if (op == kBdMatmul) {
    m->fn = (const void*)probe_prefix_kernel;
    m->grid = dim3(nblk * (rb / kGroup));
    m->threads = kChunk;
    return cudaSuccess;
  } else {
    // one warp a ring up to 32 x 64 rows, else 64 rows a thread over up to 16 warps
    const int warps = (rb + 32 * kRollMaxRows - 1) / (32 * kRollMaxRows);
    if (warps > kRollMaxWarps) return cudaErrorInvalidValue;
    int ci = kRollSizes - 1;
    if (warps == 1) {
      ci = 0;
      while (32 * kRollRowsPerThread[ci] < rb) ++ci;
    }
    const int kc = kRollRowsPerThread[ci];
    RollArgs& ra = m->ra;
    ra.rb = rb;
    ra.warps = warps;
    ra.used = (rb + kc - 1) / kc;
    ra.last = rb - (ra.used - 1) * kc;
    ra.narrow = op == kRollNarrow;
    const bool ragged = ra.last != kc;
    m->rows_per_thread = kc;
    m->ragged = ragged;
    const int cols = ra.narrow || warps > 1 ? 1 : kRollCols;
    ra.pitch = (rb + 5) / 8 * 8 + 2;  // 2 mod 8: a warp's staging stores hit 32 banks
    m->roll = warps > 1 ? roll_ring[ragged] : roll[ci][ragged];
    m->fn = (const void*)m->roll;
    m->threads = 32 * warps * cols;
    if (cols == kRollCols) {
      m->grid = dim3(nblk * (kChunk / kRollCols));
      m->smem = sizeof(float) * kRollCols * (size_t)ra.pitch;
    } else {
      m->grid = dim3(nblk, ra.narrow ? 1 : kChunk);
      m->smem = sizeof(float) * (kOutRows + (warps > 1 ? 2 * warps : 0));
    }
  }
  cudaError_t e = cudaFuncSetAttribute(m->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)m->smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(m->fn, cudaFuncAttributePreferredSharedMemoryCarveout,
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
// (bd_matmul only; may be null otherwise). rows a multiple of rb, rb >= 8
// (roll: up to 32,768); bd_matmul needs rb a multiple of 49. op a MicroOp.
// Returns a cudaError_t.
int mpn_probe_micro(const float* a, const int* idx, int rows, int rb, int op, int reps,
                    float* out, float* sums, void* stream) {
  if (rb < kOutRows || rows < rb || rows % rb || reps < 0 || op < 0 || op >= kMicroOps ||
      (op == kGatherOp && !idx) || (op == kBdMatmul && (rb % kGroup || !sums)))
    return (int)cudaErrorInvalidValue;
  MicroLaunch m;
  cudaError_t e = micro_setup(rows, rb, op, &m);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = (reinterpret_cast<uintptr_t>(a) |
                   (op == kGatherOp ? reinterpret_cast<uintptr_t>(idx) : 0)) % 16 == 0;
  if (op == kBdMatmul) {
    probe_prefix_kernel<<<m.grid, m.threads, 0, st>>>(a, rb, reps, out, sums);
  } else if (m.micro) {
    m.micro<<<m.grid, m.threads, m.smem, st>>>(MicroArgs{a, idx, out, rows, rb, reps, vec});
  } else {
    m.ra.a = a;
    m.ra.out = out;
    m.ra.reps = reps;
    m.ra.vec = vec;
    m.roll<<<m.grid, m.threads, m.smem, st>>>(m.ra);
  }
  return (int)cudaGetLastError();
}

// The launch of op at rb rows a block: info[0..5] = threads a block, dynamic
// shared memory in bytes, blocks that fit on one SM, and for the roll its rows
// a thread, whether the ring's last thread is ragged (1) and its warps a ring
// (0 for the other ops). Returns a cudaError_t.
int mpn_probe_micro_plan(int rb, int op, int* info) {
  if (rb < kOutRows || op < 0 || op >= kMicroOps || (op == kBdMatmul && rb % kGroup))
    return (int)cudaErrorInvalidValue;
  MicroLaunch m;
  cudaError_t e = micro_setup(rb, rb, op, &m);
  if (e != cudaSuccess) return (int)e;
  info[0] = m.threads;
  info[1] = (int)m.smem;
  info[3] = m.rows_per_thread;
  info[4] = m.ragged;
  info[5] = m.roll ? m.ra.warps : 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(info + 2, m.fn, m.threads, m.smem);
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

// The empty kernel, <<<1, 32>>>. Returns a cudaError_t.
int mpn_probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* mpn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
