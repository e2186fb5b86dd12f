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
// them (9 uncontracted f32 operations each, no FMA: 8.2e8 tests, 0.22 ms at
// the card's 33.45e12 non-FMA f32 operations a second (132 SMs x 128 lanes x
// 1.98 GHz) at B=256, N=6272, S=512, where a centroid keeps about 3.6 points and so
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
// a warp reads its centroids' selections from idx and count; on the fast
// path it scans their windows itself (the same ballot compaction over the
// cloud in global memory). The raw block is a v8 output and so comes only
// with in_cloud = 1 on the exact path. mpn_sa picks one of eight
// instantiations.
//
// sa_kernel_mma (bf16): the MLP runs on the tensor cores, mma.sync
// m16n8k16 with bf16 operands and f32 accumulation, as the TPU kernel runs
// it on the MXU (pallas_ops.py:947-960). What bounds it on the H100: the
// MLP over the valid rows (about 61 rows per centroid at SA1, 2.3e11 FLOP
// at B=256; about 3.6 at SA0), latency-bound with one block of 8 warps per
// SM at SA1; at SA0 each block's fixed cost (the weights' copy, the
// selection's dependent loads) over few rows. Design:
//  * One block of 8 warps per cpb centroids of one batch row (cpb 8, 16 or
//    32, the launch plan's; grid (ceil(s / cpb), b)). The block copies the
//    three layers' weights (bf16, W^T [n, k], zero-padded to multiples of
//    16, made once per model by prepare_sa_weights) into shared memory with
//    cp.async while warp w reads (or scans for) the selections of its
//    cpb / 8 centroids, and waits once. On the exact path a warp issues all
//    its centroids' count loads, then all their idx loads; on the fast path
//    it scans their windows together rank by rank, every point load of a
//    rank issued before the first ballot (W dependent trips a warp, not 16
//    a centroid at W = 4), each centroid's ballots in its own scan order.
//  * Rows are packed across the block's centroids: centroid g owns
//    max(min(count, 128), 1) rows from the exclusive prefix of those counts
//    (one warp scan, lane g holding g's offset), and 16-row tiles (the
//    mma's m) run over the concatenation, dealt to the warps in turn. SA0
//    keeps about 4-13 rows a centroid, so a tile holds several centroids
//    where each had a tile of its own before, and a block of 32 centroids
//    is one to three tiles a warp. A tile's rows find their centroids at
//    once: the first is popc(ballot(off <= t0)) - 1, and a row's is the
//    first plus the centroids whose rows start after t0 and by it (an
//    OR-reduced 16-bit mask of starts); the warp keeps them in a map with
//    each row's cloud point (-1: a zero raw row), -1 past the block's rows.
//    Each warp has its own tile buffers, so there is no block barrier inside
//    the MLP.
//  * A operands (the gathered raw rows, then h1, then h2 over the raw rows'
//    buffer), weights and biases sit in shared memory, rows padded by 16
//    bytes so every ldmatrix row lands on its own banks. The gather keeps
//    8 loads in flight per lane. Each layer runs in passes of 32 output
//    columns (16 accumulators a thread); its epilogue works on the C
//    fragments in registers: bias, the layer-1 recentring term of the row's
//    own centroid (W1[:3]^T c from W1's rows 0-2 in shared memory), ReLU,
//    bf16 rounding into the next layer's A tile. kPoint0 overwrites the one
//    row of each centroid with count 0 by point 0's layer-1 row. After layer
//    3 the max-pool is segmented by centroid, by a layer-3 instantiation
//    chosen per tile: a tile whose 16 rows are one centroid's takes the max
//    over them by shuffles over lanes 4, 8 and 16 and one atomicMax a
//    column; a mixed tile takes a segmented suffix max by shuffles within
//    each 8-row half, and each centroid's first row in a half takes one
//    shared atomicMax a column (one atomic a row instead, serialised 8 ways
//    on a shared address, cost SA1 10-27% on an H100). ReLU outputs are
//    non-negative, whose bits order as ints; rows past the block's never
//    enter a max. An mma row depends on its own A row alone, in the same k
//    order in any tile, so the features are bit-equal whatever cpb is.
//  * Shared memory at SA0: 66 KB at cpb 8, 72 KB at 16, 84 KB at 32; at SA1
//    209 KB at 8, 221 KB at 16 (32 does not fit): __launch_bounds__(256, 2)
//    keeps two blocks per SM at SA0, one at SA1. A stage whose weights and
//    tiles do not fit at cpb 8 takes the CUDA-core kernel.
// Left for later: the window choice inside the kernel, a persistent loop
// that stages the weights once per SM, and wgmma, whose 64-row tiles the
// packed rows now make possible.
//
// sa_kernel<kTr> (f32; and bf16 beyond the tensor-core kernel's shared
// memory): the MLP on the CUDA cores in f32 FFMA (67 TFLOP/s peak; no TF32,
// as the reference's f32 path runs at Precision.HIGHEST). What bounds it on
// the H100: the MLP's FLOP over the valid rows (SA1: about 61 rows a
// centroid, 115 kFLOP a row, 2.9e10 FLOP and 0.43 ms at B=32; SA0: about
// 13.8 rows, 16.6 kFLOP a row). Design:
//  * Rows are packed across the block's cpb centroids (8, 16 or 32, the
//    plan's) as in sa_kernel_mma: centroid g owns max(min(count, 128), 1)
//    rows from the exclusive prefix of those counts, and tiles of 128 rows
//    run over the concatenation, so no centroid is padded. Each warp reads
//    (or scans for) the selections of cpb / 8 centroids.
//  * A layer is a register-tiled FFMA product: each thread owns kTr rows by
//    8 columns of a pass of 256 * kTr * 8 / rows output columns: 4 x 8 where
//    every layer is at most 64 wide (SA0: one pass of 64), else 8 x 8 (SA1:
//    passes of 128). Activations sit in shared memory transposed,
//    [k][rows], so a thread's rows are kTr / 4 LDS.128; a weight slice sits
//    as [k][columns], so its 8 columns are two (the runs col0 and np / 2 +
//    col0, so 8 lanes read 128 contiguous bytes). A warp spans every column
//    group of the pass and 32 / (np / 8) row groups. 8 x 8 is 4 shared loads
//    a 64 FFMA, against 12 a 32 in the kernel this one replaced. Each
//    output's sum runs in ascending k from 0, then the bias: the plain
//    version's differs only in order.
//  * The weights stream through shared memory in slices of 8 * kTr k rows
//    by one pass's columns, double-buffered with cp.async: the next slice,
//    across the layers and on to the next tile's first, is in flight while
//    one computes, behind one barrier a slice. The three layers at SA1 (231
//    KB in f32) do not fit beside the tiles.
//  * The epilogue stays in registers: bias, the layer-1 recentring term
//    W1[:3]^T c of each row's own centroid, point 0's layer-1 row for a
//    centroid without neighbours under kPoint0 (made once a block), ReLU and
//    the bf16 rounding where the compute type is bf16. h1 and h2 stay in
//    shared memory for the tile (h2 over the raw rows); layer 3 is never
//    stored: a warp whose rows are all one centroid's takes their max by
//    shuffles and one shared atomicMax a column, else each thread one a run
//    of rows of one centroid (the ReLU outputs are non-negative, whose bits
//    order as ints).
//  * Shared memory at SA0: 91 KB at cpb 8 to 109 KB at 32, two blocks a SM
//    under __launch_bounds__(256, 2); at SA1: 213 KB at 8, 225 KB at 16 (32
//    does not fit), one block a SM, so the 8 x 8 instantiations take up to
//    255 registers. Wider layers take 32-row tiles of 4 x 8; a stage whose
//    tiles do not fit even then is refused.
//  * What holds it at about a third of the f32 peak on an H100: the FFMA
//    issue of 8 (SA1) or 16 (SA0) warps a SM. With every shared load of the
//    k loop replaced by registers, SA1 at B=32 took 0.87x as long, so the
//    loads are not what bounds it; then the epilogues (about 15% at SA1,
//    25% at SA0) and the barriers a slice.
// A row's features depend on its own gathered row alone, summed in the same
// order in any tile, so they are bit-equal whatever cpb is.
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
constexpr int kMinCpb = 8;    // MLP kernels: centroids per block, at least (one a warp)
constexpr int kWarps = 8;     // warps per MLP block (both kernels)
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCpw = 4;    // MLP kernels: centroids per warp, at most (cpb 32)
constexpr int kTc = 8;        // CUDA-core MLP: output columns a thread owns (two runs of 4)
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
  int cpb;                 // centroids per block: 8, 16 or 32
  int rows;                // CUDA-core kernel: rows per tile (32 or 128)
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));  // round to nearest even
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Exact path: the selections that sa_select_kernel wrote for the warp's
// centroids s .. s + cpw - 1, every count loaded, then every kept index,
// before the first store, so the loads' latencies overlap. Centroid g's kept indices
// go to sel + g * kNs, its kept count to cnt[g] (-1 past S).
__device__ __forceinline__ void load_selections(const SaArgs& a, int b, int s, int cpw, int lane,
                                                int* sel, int* cnt) {
  const size_t row0 = (size_t)b * a.s + s;
  const int mine = lane < cpw && s + lane < a.s ? a.count[row0 + lane] : -1;
  int kept[kMaxCpw];
  int v[kMaxCpw][kNs / 32];
#pragma unroll
  for (int g = 0; g < kMaxCpw; ++g) {
    kept[g] = __shfl_sync(0xffffffffu, mine, g);
#pragma unroll
    for (int j = 0; j < kNs / 32; ++j) {
      v[g][j] = 0;
      if (g < cpw && lane + 32 * j < kept[g]) v[g][j] = a.idx[(row0 + g) * kNs + lane + 32 * j];
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxCpw; ++g) {
    if (g >= cpw) break;
#pragma unroll
    for (int j = 0; j < kNs / 32; ++j) {
      if (lane + 32 * j < kept[g]) sel[g * kNs + lane + 32 * j] = v[g][j];
    }
    if (lane == 0) cnt[g] = kept[g];
  }
  __syncwarp();
}

// Fast path: the window scans of the warp's centroids s .. s + cpw - 1
// together, rank by rank. For window rank li, every point load of that
// rank (4 a lane for each centroid still short of kNs hits) is issued
// before the first ballot, so the warp waits once a rank, not once a 32
// points. Each centroid's ballots run in its own scan order (rank, then
// lane) and stop after the 32 points in which it reached kNs, so its hits,
// its idx (fill with the first) and its count are those of a scan of that
// centroid alone. bf16: test bf16-rounded point coordinates. Hits go to
// sel + g * kNs, counts to cnt[g] (-1 past S).
__device__ __forceinline__ void scan_windows(const SaArgs& a, const float* xyz, int b, int s,
                                             int cpw, bool bf16, int lane, int* sel, int* cnt) {
  constexpr int kSub = kChunk / 32;
  const size_t row0 = (size_t)b * a.s + s;
  const float nan = __int_as_float(0x7fc00000);
  float cx[kMaxCpw], cy[kMaxCpw], cz[kMaxCpw];
  int count[kMaxCpw];  // warp-uniform: it only grows by ballot popcounts
#pragma unroll
  for (int g = 0; g < kMaxCpw; ++g) {
    cx[g] = cy[g] = cz[g] = 0.f;
    count[g] = kNs;  // no centroid: nothing to scan
    if (g < cpw && s + g < a.s) {
      const float* c = a.cent + (row0 + g) * 3;
      cx[g] = c[0];
      cy[g] = c[1];
      cz[g] = c[2];
      count[g] = 0;
    }
  }
  const unsigned below = (1u << lane) - 1u;
  for (int l0 = 0; l0 < a.window; l0 += 32) {
    int entry[kMaxCpw];  // lane l: window rank l0 + l of centroid g
#pragma unroll
    for (int g = 0; g < kMaxCpw; ++g) {
      entry[g] = 0;
      if (count[g] < kNs && l0 + lane < a.window) {
        entry[g] = a.chunks[(row0 + g) * a.window + l0 + lane];
      }
    }
    for (int li = l0; li < min(l0 + 32, a.window); ++li) {
      bool live = false;
#pragma unroll
      for (int g = 0; g < kMaxCpw; ++g) live = live || count[g] < kNs;
      if (!live) break;
      float x[kMaxCpw][kSub], y[kMaxCpw][kSub], z[kMaxCpw][kSub];
#pragma unroll
      for (int g = 0; g < kMaxCpw; ++g) {
        const int chunk = __shfl_sync(0xffffffffu, entry[g], li - l0);
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
          const int p = chunk * kChunk + sub * 32 + lane;
          x[g][sub] = y[g][sub] = z[g][sub] = nan;  // no test passes
          if (count[g] < kNs && p < a.n) {
            x[g][sub] = xyz[3 * p];
            y[g][sub] = xyz[3 * p + 1];
            z[g][sub] = xyz[3 * p + 2];
            if (bf16) {
              x[g][sub] = round_bf16(x[g][sub]);
              y[g][sub] = round_bf16(y[g][sub]);
              z[g][sub] = round_bf16(z[g][sub]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxCpw; ++g) {
        const int chunk = __shfl_sync(0xffffffffu, entry[g], li - l0);
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
          if (count[g] < kNs) {
            const int p = chunk * kChunk + sub * 32 + lane;
            const bool in = dist2(x[g][sub], y[g][sub], z[g][sub], cx[g], cy[g], cz[g]) < a.r2;
            const unsigned mask = __ballot_sync(0xffffffffu, in);
            if (in) {
              const int slot = count[g] + __popc(mask & below);
              if (slot < kNs) sel[g * kNs + slot] = p;
            }
            count[g] += __popc(mask);
          }
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int g = 0; g < kMaxCpw; ++g) {
    if (g >= cpw) break;
    if (s + g < a.s) {
      const int kept = min(count[g], kNs);
      const int first = count[g] > 0 ? sel[g * kNs] : 0;
      int* out_idx = a.idx + (row0 + g) * kNs;
      for (int k = lane; k < kNs; k += 32) out_idx[k] = k < kept ? sel[g * kNs + k] : first;
    }
    if (lane == 0) cnt[g] = s + g < a.s ? count[g] : -1;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// CUDA-core MLP (f32; bf16 beyond the tensor-core kernel's shared memory)
// ---------------------------------------------------------------------------

// The layout of a row tile of `rows` rows (32 or 128) when each thread
// owns tr rows (4 or 8) by kTc columns: the block's 256 threads are rows / tr
// row groups by 256 * tr / rows column groups, so one pass of a layer covers
// pass_cols(rows, tr) output columns; a weight slice is slice_rows(rows, tr)
// k rows of a pass (64 KB double-buffered at 128 rows of 8, 16 KB at 4).
__host__ __device__ constexpr int pass_cols(int rows, int tr) {
  return kThreads * tr * kTc / rows;
}
__host__ __device__ constexpr int slice_rows(int rows, int tr) {
  return rows >= 128 ? 8 * tr : 4 * tr;
}

// Dynamic shared memory of sa_kernel<tr> for kin = 3 + c inputs, these
// widths, row tiles of `rows` and cpb centroids per block, in the kernel's
// order.
size_t cc_smem_bytes(int kin, int c1, int c2, int c3, int rows, int tr, int cpb) {
  const size_t lda = rows + 4;
  const size_t floats = (size_t)(std::max(kin, c2) + c1) * lda +
                        2 * (size_t)slice_rows(rows, tr) * pass_cols(rows, tr) +
                        (size_t)(c1 + c2 + c3) + 4 * (size_t)c1 + 3 * (size_t)cpb;
  const size_t ints = (size_t)cpb * (c3 + kNs + 2) + 1 + 2 * (size_t)rows;
  return 4 * (floats + ints);
}

// v[l] by a select, not an indexed load: a runtime index would put the
// array in local memory.
template <typename T>
__device__ __forceinline__ T pick3(const T (&v)[3], int l) {
  return l == 0 ? v[0] : l == 1 ? v[1] : v[2];
}

// One streamed weight slice: layer (0-2), output pass and first k row.
struct Slice {
  int layer, pass, k0;
};

// The MLP's three layers as the CUDA-core kernel streams them: layer l reads
// kin_l rows of W_l [kin_l, n_l] in passes of np columns and slices of ks
// rows, pass by pass.
struct CcLayers {
  const float* w[3];
  int kin[3], n[3], slices[3];  // slices: passes x k slices
  int ksl[3];                   // k slices per pass
  int ks;                       // k rows per slice
  __device__ CcLayers(const SaArgs& a, int np, int ks_) : ks(ks_) {
    w[0] = a.w1;
    w[1] = a.w2;
    w[2] = a.w3;
    kin[0] = 3 + a.c;
    kin[1] = n[0] = a.c1;
    kin[2] = n[1] = a.c2;
    n[2] = a.c3;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      ksl[l] = (kin[l] + ks - 1) / ks;
      slices[l] = (n[l] + np - 1) / np * ksl[l];
    }
  }
  __device__ Slice at(int j) const {
    int l = 0;
    if (j >= slices[0]) {
      j -= slices[0];
      l = 1;
      if (j >= slices[1]) {
        j -= slices[1];
        l = 2;
      }
    }
    const int k = pick3(ksl, l);
    return {l, j / k, (j % k) * ks};
  }
};

// Slice sc of the weights into dst [ks][np] (columns past n and rows past
// kin are left as they are: no output the kernel keeps reads them), with
// cp.async by the whole block; the caller commits the group.
__device__ __forceinline__ void load_slice(float* dst, const CcLayers& L, Slice sc, int np) {
  const int l = sc.layer, n = pick3(L.n, l);
  const int c0 = sc.pass * np;
  const int cols = min(np, n - c0);
  const int kn = min(L.ks, pick3(L.kin, l) - sc.k0);
  const float* src = pick3(L.w, l) + (size_t)sc.k0 * n + c0;
  if ((n & 3) == 0) {  // 16-byte copies: rows and columns stay aligned
    const int per = cols >> 2;
    for (int i = threadIdx.x; i < kn * per; i += kThreads) {
      const int r = i / per, q = i - r * per;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + r * np + 4 * q)),
                   "l"(src + (size_t)r * n + 4 * q)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < kn * cols; i += kThreads) {
      const int r = i / cols, q = i - r * cols;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + r * np + q)),
                   "l"(src + (size_t)r * n + q)
                   : "memory");
    }
  }
}

// kTr: output rows a thread owns (4 or 8); kRaw: write the raw block;
// kPoint0: a centroid without neighbours takes point 0's layer-1 row
// (centroids off the cloud), else a zero raw row; kFast: scan the window,
// else read the exact selection.
template <int kTr, bool kRaw, bool kPoint0, bool kFast>
__global__ void __launch_bounds__(kThreads, kTr == 8 ? 1 : 2) sa_kernel(SaArgs a) {
  extern __shared__ float4 smem4[];
  const int rows = a.rows;
  const int np = pass_cols(rows, kTr);
  const int ks = slice_rows(rows, kTr);
  const int half = np >> 1;
  const int lda = rows + 4;
  const int kin = 3 + a.c;
  const int cpb = a.cpb;
  float* buf_a = reinterpret_cast<float*>(smem4);     // [max(kin, c2)][lda]: raw^T, then h2^T
  float* buf_b = buf_a + max(kin, a.c2) * lda;         // [c1][lda]: h1^T
  float* wbuf = buf_b + a.c1 * lda;                    // [2][ks][np]: weight slices
  float* bias = wbuf + 2 * ks * np;                    // b1, b2, b3
  float* w1c = bias + a.c1 + a.c2 + a.c3;              // [3][c1]: W1 rows 0-2, f32
  float* h0 = w1c + 3 * a.c1;                          // [c1]: point 0's layer-1 row
  float* cent = h0 + a.c1;                             // [cpb][3]
  int* pmax = reinterpret_cast<int*>(cent + 3 * cpb);  // [cpb][c3]: bits of the max-pool
  int* sel = pmax + cpb * a.c3;                        // [cpb][kNs]
  int* cnt = sel + cpb * kNs;                          // [cpb]; -1: no centroid
  int* off = cnt + cpb;                                // [cpb + 1]: row offsets, then total
  int* gmap = off + cpb + 1;                           // [rows]: tile row -> centroid, -1 past
  int* pmap = gmap + rows;                             // [rows]: -> cloud point, -1 zero row

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * cpb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xyz = a.xyz + (size_t)b * a.n * 3;
  const float* feat = a.feat + (size_t)b * a.n * a.c;
  const bool bf16 = a.bf16 != 0;
  const CcLayers L(a, np, ks);
  const int per_tile = L.slices[0] + L.slices[1] + L.slices[2];
  // the weights are double-buffered: slice i (of the block's sequence, tile
  // after tile) goes to buffer i % 2, issued while slice i - 1 computes
  const auto issue = [&](int i, int tiles) {
    if (i < tiles * per_tile) {
      load_slice(wbuf + (i & 1) * ks * np, L, L.at(i % per_tile), np);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int j = tid; j < a.c1 + a.c2 + a.c3; j += kThreads) {
    const int j2 = j - a.c1, j3 = j2 - a.c2;
    bias[j] = j2 < 0 ? a.b1[j] : j3 < 0 ? a.b2[j2] : a.b3[j3];
  }
  for (int i = tid; i < 3 * a.c1; i += kThreads) w1c[i] = a.w1f[i];
  if constexpr (kPoint0) {
    for (int j = tid; j < a.c1; j += kThreads) {
      float h = a.b1[j];
      for (int k = 0; k < kin; ++k) {
        h += (k < 3 ? xyz[k] : feat[k - 3]) * a.w1f[(size_t)k * a.c1 + j];
      }
      h0[j] = h;
    }
  }
  for (int i = tid; i < 3 * cpb; i += kThreads) {
    cent[i] = s0 + i / 3 < a.s ? a.cent[((size_t)b * a.s + s0) * 3 + i] : 0.f;
  }
  for (int i = tid; i < cpb * a.c3; i += kThreads) pmax[i] = 0;  // +0.f

  // ---- warp w: selection and raw block of centroids s0 + w * cpw + g ------
  {
    const int cpw = cpb / kWarps;
    const int g0 = warp * cpw;
    if constexpr (kFast) {
      scan_windows(a, xyz, b, s0 + g0, cpw, bf16, lane, sel + g0 * kNs, cnt + g0);
    } else {
      load_selections(a, b, s0 + g0, cpw, lane, sel + g0 * kNs, cnt + g0);
    }
    if constexpr (kRaw) {  // all 128 slots: kept rows as read, zero rows after them
      for (int g = g0; g < g0 + cpw && s0 + g < a.s; ++g) {
        const int kept = min(cnt[g], kNs);
        float* raw_out = a.raw + ((size_t)b * a.s + s0 + g) * kNs * kin;
        for (int i = lane; i < kNs * kin; i += 32) {
          const int r = i / kin;
          const int k = i - r * kin;
          float v = 0.f;
          if (r < kept) {
            const int q = sel[g * kNs + r];
            v = k < 3 ? xyz[3 * q + k] : feat[(size_t)q * a.c + (k - 3)];
          }
          raw_out[i] = v;
        }
      }
    }
  }
  __syncthreads();
  // ---- the block's rows, packed: centroid g owns max(min(count, kNs), 1)
  // rows from off[g]
  if (warp == 0) {
    const int nrows = lane < cpb && cnt[lane] >= 0 ? max(min(cnt[lane], kNs), 1) : 0;
    int incl = nrows;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < cpb) off[lane] = incl - nrows;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0) off[cpb] = total;
  }
  __syncthreads();
  const int total = off[cpb];
  const int tiles = (total + rows - 1) / rows;

  // Tile rows t0 .. t0 + rows - 1: their centroids and points, then their raw
  // rows [xyz, feat] (compute-rounded; zero past a centroid's count and past
  // the block's rows) into buf_a transposed, kGather loads in flight a thread.
  const auto gather = [&](int t0) {
    for (int r = tid; r < rows; r += kThreads) {
      const int row = t0 + r;
      int g = -1, p = -1;
      if (row < total) {
        g = 0;
        for (int q = 1; q < cpb; ++q) g += off[q] <= row;
        const int j = row - off[g];
        if (j < min(cnt[g], kNs)) p = sel[g * kNs + j];
      }
      gmap[r] = g;
      pmap[r] = p;
    }
    __syncthreads();
    for (int i0 = tid; i0 < rows * kin; i0 += kThreads * kGather) {
      float v[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = 0.f;
        if (i < rows * kin) {
          const int r = i / kin, k = i - r * kin;
          const int p = pmap[r];
          if (p >= 0) v[u] = k < 3 ? xyz[3 * p + k] : feat[(size_t)p * a.c + (k - 3)];
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * kThreads;
        if (i < rows * kin) {
          const int r = i / kin, k = i - r * kin;
          buf_a[k * lda + r] = bf16 ? round_bf16(v[u]) : v[u];
        }
      }
    }
  };

  // this thread's output tile of each pass: rows row0 .. row0 + kTr - 1,
  // columns col0 .. col0 + 3 and half + col0 .. half + col0 + 3 of the pass.
  // A warp is 32 / cg row groups by all cg = np / 8 column groups (cg 8 to
  // 32), so its activation loads are 32 / cg addresses (broadcast) and its
  // weight loads cg * 16 contiguous bytes each
  const int cg = min(np >> 3, 32);
  const int row0 = (warp * (32 / cg) + lane / cg) * kTr;
  const int col0 = (lane % cg) * 4;

  issue(0, tiles);
  gather(0);
  float acc[kTr][kTc];
  for (int t = 0; t < tiles; ++t) {
    for (int j = 0; j < per_tile; ++j) {
      const int i = t * per_tile + j;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // slice i is in; every thread is past slice i - 1
      issue(i + 1, tiles);
      const Slice sc = L.at(j);
      const int l = sc.layer;
      if (sc.k0 == 0) {
#pragma unroll
        for (int r = 0; r < kTr; ++r) {
#pragma unroll
          for (int c = 0; c < kTc; ++c) acc[r][c] = 0.f;
        }
      }
      const float* A = (l == 1 ? buf_b : buf_a) + row0;
      const float* W = wbuf + (i & 1) * ks * np + col0;
      const int kin_l = pick3(L.kin, l);
      const int kn = min(ks, kin_l - sc.k0);
      A += sc.k0 * lda;
#pragma unroll 8
      for (int k = 0; k < kn; ++k) {  // ascending k, as every column's sum runs
        float ar[kTr];
#pragma unroll
        for (int r = 0; r < kTr; r += 4) {
          const float4 av = *reinterpret_cast<const float4*>(A + k * lda + r);
          ar[r] = av.x;
          ar[r + 1] = av.y;
          ar[r + 2] = av.z;
          ar[r + 3] = av.w;
        }
        const float4 wl = *reinterpret_cast<const float4*>(W + k * np);
        const float4 wh = *reinterpret_cast<const float4*>(W + k * np + half);
        const float wc[kTc] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
        for (int r = 0; r < kTr; ++r) {
#pragma unroll
          for (int c = 0; c < kTc; ++c) acc[r][c] = fmaf(ar[r], wc[c], acc[r][c]);
        }
      }
      if (sc.k0 + kn < kin_l) continue;
      // ---- epilogue of the pass, in registers ------------------------------
      int gr[kTr];  // the rows' centroids, -1 past the block's rows
#pragma unroll
      for (int r = 0; r < kTr; ++r) gr[r] = gmap[row0 + r];
      const int n = pick3(L.n, l);
      const float* bl = bias + (l == 0 ? 0 : l == 1 ? a.c1 : a.c1 + a.c2);
      if (l == 0) {  // bias, the recentring term of each row's own centroid, ReLU
        float cx[kTr], cy[kTr], cz[kTr];
        bool zero[kTr];  // kPoint0: the row of a centroid without neighbours
#pragma unroll
        for (int r = 0; r < kTr; ++r) {
          const int g = max(gr[r], 0);
          const bool live = gr[r] >= 0;
          cx[r] = live ? cent[3 * g] : 0.f;
          cy[r] = live ? cent[3 * g + 1] : 0.f;
          cz[r] = live ? cent[3 * g + 2] : 0.f;
          zero[r] = kPoint0 && live && cnt[g] == 0;
        }
#pragma unroll
        for (int c = 0; c < kTc; ++c) {
          const int col = sc.pass * np + col0 + (c & 3) + (c >> 2) * half;
          if (col >= n) continue;
          const float bj = bl[col], h0j = kPoint0 ? h0[col] : 0.f;
          const float wx = w1c[col], wy = w1c[a.c1 + col], wz = w1c[2 * a.c1 + col];
          float v[kTr];
#pragma unroll
          for (int r = 0; r < kTr; ++r) {
            const float bc = wx * cx[r] + wy * cy[r] + wz * cz[r];
            v[r] = fmaxf((zero[r] ? h0j : acc[r][c] + bj) - bc, 0.f);
            if (bf16) v[r] = round_bf16(v[r]);
          }
          float* out = buf_b + col * lda + row0;
#pragma unroll
          for (int r = 0; r < kTr; r += 4) {
            *reinterpret_cast<float4*>(out + r) = make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
          }
        }
      } else if (l == 1) {  // bias, ReLU
#pragma unroll
        for (int c = 0; c < kTc; ++c) {
          const int col = sc.pass * np + col0 + (c & 3) + (c >> 2) * half;
          if (col >= n) continue;
          const float bj = bl[col];
          float v[kTr];
#pragma unroll
          for (int r = 0; r < kTr; ++r) {
            v[r] = fmaxf(acc[r][c] + bj, 0.f);
            if (bf16) v[r] = round_bf16(v[r]);
          }
          float* out = buf_a + col * lda + row0;
#pragma unroll
          for (int r = 0; r < kTr; r += 4) {
            *reinterpret_cast<float4*>(out + r) = make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
          }
        }
      } else {  // bias, ReLU, and the max-pool segmented by centroid
        // the warp's rows (32 / cg row groups, contiguous) all one centroid's:
        // a max over them by shuffles and one atomic a column; else one
        // atomic a run of rows of one centroid in each thread's rows
        const int wrow = warp * (32 / cg) * kTr;
        const int wg = gmap[wrow];
        const bool whole = wg >= 0 && wg == gmap[wrow + (32 / cg) * kTr - 1];
#pragma unroll
        for (int c = 0; c < kTc; ++c) {
          const int col = sc.pass * np + col0 + (c & 3) + (c >> 2) * half;
          const float bj = col < n ? bl[col] : 0.f;
          float v[kTr];
#pragma unroll
          for (int r = 0; r < kTr; ++r) v[r] = fmaxf(acc[r][c] + bj, 0.f);
          if (whole) {  // warp-uniform
            float m = v[0];
#pragma unroll
            for (int r = 1; r < kTr; ++r) m = fmaxf(m, v[r]);
            for (int o = cg; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
            if (lane < cg && col < n) atomicMax(pmax + wg * a.c3 + col, __float_as_int(m));
            continue;
          }
          if (col >= n) continue;
          int g = gr[0];
          float m = v[0];
#pragma unroll
          for (int r = 1; r < kTr; ++r) {
            if (gr[r] == g) {
              m = fmaxf(m, v[r]);
            } else {
              if (g >= 0) atomicMax(pmax + g * a.c3 + col, __float_as_int(m));
              g = gr[r];
              m = v[r];
            }
          }
          if (g >= 0) atomicMax(pmax + g * a.c3 + col, __float_as_int(m));
        }
      }
    }
    if (t + 1 < tiles) {
      __syncthreads();  // every thread is past the tile's layer 3
      gather((t + 1) * rows);
    }
  }
  __syncthreads();
  float* out = a.out + ((size_t)b * a.s + s0) * a.c3;
  for (int i = tid; i < cpb * a.c3; i += kThreads) {
    if (s0 + i / a.c3 < a.s) out[i] = __int_as_float(pmax[i]);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core MLP (bf16)
// ---------------------------------------------------------------------------

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

// What a lane's two C-fragment rows of a tile (lo = lane / 4 and hi = lo +
// 8) take in the epilogues: their centroids within the block (-1: a row
// past the block's packed rows), the centroid of all 16 rows (-1: more than
// one, or rows past the block's), the coordinates of the rows' centroids,
// and the segments of the max-pool: join_lo[i] 1 where row lo + 2^i is in
// lo's 8-row half and lo's centroid, else 0 (join_hi the same for hi), as
// floats, so the suffix max masks by a product and takes no predicate;
// head_lo (head_hi) where lo (hi) is its centroid's first row in its half.
struct TileRows {
  int g_lo, g_hi, g_all;
  bool head_lo, head_hi;
  float join_lo[3], join_hi[3];
  float lo[3], hi[3];
};

// The layer-1 recentring term W1[:3]^T c of output column j, from w1c, the
// f32 rows 0-2 of W1 in shared memory ([3][ldc], zero past c1).
__device__ __forceinline__ float recentre(const float* w1c, int ldc, int j, float cx, float cy,
                                          float cz) {
  return w1c[j] * cx + w1c[ldc + j] * cy + w1c[2 * ldc + j] * cz;
}

// One dense layer of the tensor-core MLP on one warp's 16-row tile:
// A [16, k] bf16 (row stride lda), W^T [n, k] bf16 (row stride k + kPad)
// and the bias [n] f32 (zero past nreal, the layer's real output width), all
// in shared memory, k and n multiples of 16. Passes of kNc output columns;
// lane holds the m16n8 C fragment of each 8-column tile: rows lane/4 and
// lane/4 + 8, columns 2*(lane%4) + {0, 1}.
// kMode 0: layer 1, (acc + b) - W1[:3]^T c of the row's centroid (w1c, ldc),
// ReLU, bf16 into out (row stride ldo); 1: hidden, acc + b, ReLU, bf16 into
// out; 2 and 3: last, acc + b, ReLU, max of each row into its centroid's
// row of pmax ([cpb][nreal], bits of non-negative floats). 2: all 16 rows
// are centroid g_all's: a max over them by shuffles and one atomicMax a
// column. 3: rows of several centroids: a segmented suffix max over each
// 8-row half (shuffles 1, 2 and 4 rows down, within the row's centroid)
// and one atomicMax a column for each centroid's first row in each half;
// rows past the block's never enter a max.
template <int kMode>
__device__ __forceinline__ void mma_layer(const bf16_t* A, int lda, const bf16_t* W, int k,
                                          int n, const float* bias, int nreal,
                                          const float* w1c, int ldc, const TileRows& tr,
                                          bf16_t* out, int ldo, int* pmax, int lane) {
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
          v00 = v00 - recentre(w1c, ldc, col, tr.lo[0], tr.lo[1], tr.lo[2]);
          v01 = v01 - recentre(w1c, ldc, col + 1, tr.lo[0], tr.lo[1], tr.lo[2]);
          v10 = v10 - recentre(w1c, ldc, col, tr.hi[0], tr.hi[1], tr.hi[2]);
          v11 = v11 - recentre(w1c, ldc, col + 1, tr.hi[0], tr.hi[1], tr.hi[2]);
        }
        v00 = fmaxf(v00, 0.f);
        v01 = fmaxf(v01, 0.f);
        v10 = fmaxf(v10, 0.f);
        v11 = fmaxf(v11, 0.f);
        if constexpr (kMode < 2) {
          *reinterpret_cast<uint32_t*>(out + row * ldo + col) = pack_bf16(v00, v01);
          *reinterpret_cast<uint32_t*>(out + (row + 8) * ldo + col) = pack_bf16(v10, v11);
        } else if (kMode == 2) {  // all 16 rows are one centroid's
          float m0 = fmaxf(v00, v10), m1 = fmaxf(v01, v11);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
          }
          int* pm = pmax + tr.g_all * nreal;
          if (row == 0) {
            if (col < nreal) atomicMax(pm + col, __float_as_int(m0));
            if (col + 1 < nreal) atomicMax(pm + col + 1, __float_as_int(m1));
          }
        } else {  // rows of several centroids: segmented by centroid
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            // lanes 4 * 2^i apart: rows 2^i apart; every value is >= 0, so
            // a row of another centroid, times 0, changes no max
            const int o = 4 << i;
            v00 = fmaxf(v00, tr.join_lo[i] * __shfl_down_sync(0xffffffffu, v00, o));
            v01 = fmaxf(v01, tr.join_lo[i] * __shfl_down_sync(0xffffffffu, v01, o));
            v10 = fmaxf(v10, tr.join_hi[i] * __shfl_down_sync(0xffffffffu, v10, o));
            v11 = fmaxf(v11, tr.join_hi[i] * __shfl_down_sync(0xffffffffu, v11, o));
          }
          if (tr.head_lo) {
            int* pm = pmax + tr.g_lo * nreal;
            if (col < nreal) atomicMax(pm + col, __float_as_int(v00));
            if (col + 1 < nreal) atomicMax(pm + col + 1, __float_as_int(v01));
          }
          if (tr.head_hi) {
            int* pm = pmax + tr.g_hi * nreal;
            if (col < nreal) atomicMax(pm + col, __float_as_int(v10));
            if (col + 1 < nreal) atomicMax(pm + col + 1, __float_as_int(v11));
          }
        }
      }
    }
  }
}

// Dynamic shared memory of sa_kernel_mma at these padded widths and cpb
// centroids per block, in the order the kernel lays it out.
size_t mma_smem_bytes(int k1p, int n1p, int n2p, int n3p, int c3, int cpb) {
  const size_t bf16s = (size_t)n1p * (k1p + kPad) + (size_t)n2p * (n1p + kPad) +
                       (size_t)n3p * (n2p + kPad) +
                       (size_t)kWarps * kTile * (std::max(k1p, n2p) + n1p + 2 * kPad);
  const size_t words = (size_t)(n1p + n2p + n3p) + 3 * n1p + 3 * cpb +
                       (size_t)cpb * (c3 + kNs + 1) + kWarps * 2 * kTile;
  return 2 * bf16s + 4 * words;
}

template <bool kRaw, bool kPoint0, bool kFast>
__global__ void __launch_bounds__(kThreads, 2) sa_kernel_mma(SaArgs a) {
  extern __shared__ float4 smem4[];
  const int cpb = a.cpb;
  const int cpw = cpb / kWarps;              // centroids a warp selects for
  const int lda = max(a.k1p, a.n2p) + kPad;  // tile buffer A: raw rows, then h2
  const int ldb = a.n1p + kPad;              // tile buffer B: h1
  bf16_t* w1s = reinterpret_cast<bf16_t*>(smem4);   // [n1p][k1p + kPad]
  bf16_t* w2s = w1s + a.n1p * (a.k1p + kPad);       // [n2p][n1p + kPad]
  bf16_t* w3s = w2s + a.n2p * (a.n1p + kPad);       // [n3p][n2p + kPad]
  bf16_t* tiles = w3s + a.n3p * (a.n2p + kPad);     // [kWarps][kTile][lda + ldb]
  float* bias = reinterpret_cast<float*>(tiles + kWarps * kTile * (lda + ldb));
  // bias: b1, b2, b3 zero-padded [n1p + n2p + n3p]; w1c: W1 rows 0-2 [3][n1p]
  float* w1c = bias + a.n1p + a.n2p + a.n3p;
  float* cent = w1c + 3 * a.n1p;                         // [cpb][3]
  int* pmax = reinterpret_cast<int*>(cent + 3 * cpb);    // [cpb][c3]
  int* sel = pmax + cpb * a.c3;                          // [cpb][kNs]
  int* cnt = sel + cpb * kNs;                            // [cpb]; -1: no centroid
  int* tmap = cnt + cpb;                                 // [kWarps][2][kTile]

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * cpb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xyz = a.xyz + (size_t)b * a.n * 3;
  const float* feat = a.feat + (size_t)b * a.n * a.c;
  const int kin = 3 + a.c;

  stage_async(w1s, a.w1t, a.n1p, a.k1p);
  stage_async(w2s, a.w2t, a.n2p, a.n1p);
  stage_async(w3s, a.w3t, a.n3p, a.n2p);
  for (int j = tid; j < a.n1p + a.n2p + a.n3p; j += kThreads) {
    const int j2 = j - a.n1p, j3 = j2 - a.n2p;
    bias[j] = j2 < 0 ? (j < a.c1 ? a.b1[j] : 0.f)
              : j3 < 0 ? (j2 < a.c2 ? a.b2[j2] : 0.f) : (j3 < a.c3 ? a.b3[j3] : 0.f);
  }
  for (int i = tid; i < 3 * a.n1p; i += kThreads) {
    const int ch = i / a.n1p, j = i - ch * a.n1p;
    w1c[i] = j < a.c1 ? a.w1f[ch * a.c1 + j] : 0.f;
  }
  for (int i = tid; i < 3 * cpb; i += kThreads) {
    cent[i] = s0 + i / 3 < a.s ? a.cent[((size_t)b * a.s + s0) * 3 + i] : 0.f;
  }
  for (int i = tid; i < cpb * a.c3; i += kThreads) pmax[i] = 0;  // +0.f

  // ---- warp w: selection and raw block of centroids s0 + w * cpw + g ------
  {
    const int g0 = warp * cpw;
    if constexpr (kFast) {
      scan_windows(a, xyz, b, s0 + g0, cpw, true, lane, sel + g0 * kNs, cnt + g0);
    } else {
      load_selections(a, b, s0 + g0, cpw, lane, sel + g0 * kNs, cnt + g0);
    }
    if constexpr (kRaw) {  // all 128 slots, as the CUDA-core kernel writes them
      for (int g = g0; g < g0 + cpw && s0 + g < a.s; ++g) {
        const int kept = min(cnt[g], kNs);
        float* raw_out = a.raw + ((size_t)b * a.s + s0 + g) * kNs * kin;
        for (int i = lane; i < kNs * kin; i += 32) {
          const int r = i / kin;
          const int k = i - r * kin;
          float v = 0.f;
          if (r < kept) {
            const int q = sel[g * kNs + r];
            v = k < 3 ? xyz[3 * q + k] : feat[(size_t)q * a.c + (k - 3)];
          }
          raw_out[i] = v;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- the block's rows, packed: centroid g owns max(min(count, kNs), 1)
  // rows from off (held by lane g), in 16-row tiles dealt to the warps in turn
  const int nrows = lane < cpb && cnt[lane] >= 0 ? max(min(cnt[lane], kNs), 1) : 0;
  int incl = nrows;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int off = incl - nrows;
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int* map_g = tmap + warp * 2 * kTile;  // tile row -> centroid, -1 past the rows
  int* map_p = map_g + kTile;            // tile row -> cloud point, -1: a zero raw row
  bf16_t* buf_a = tiles + warp * kTile * (lda + ldb);
  bf16_t* buf_b = buf_a + kTile * lda;
  for (int t0 = warp * kTile; t0 < total; t0 += kWarps * kTile) {
    {  // lane j < 16: row t0 + j, whose centroid is the tile's first (the
       // last whose rows start at or before t0) plus those starting after t0
      const int first = __popc(__ballot_sync(0xffffffffu, off <= t0)) - 1;
      unsigned starts = nrows > 0 && off > t0 && off < t0 + kTile ? 1u << (off - t0) : 0u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) starts |= __shfl_xor_sync(0xffffffffu, starts, o);
      const int row = t0 + lane;
      const int g = min(first + __popc(starts & ((2u << (lane & 15)) - 1u)), 31);
      const int r = row - __shfl_sync(0xffffffffu, off, g);
      if (lane < kTile) {
        const bool live = row < total;
        map_g[lane] = live ? g : -1;
        map_p[lane] = live && r < min(cnt[g], kNs) ? sel[g * kNs + r] : -1;
      }
    }
    __syncwarp();
    TileRows tr;
    const int lo = lane >> 2, hi = lo + 8;
    tr.g_lo = map_g[lo];
    tr.g_hi = map_g[hi];
    tr.g_all = map_g[0] == map_g[kTile - 1] ? map_g[0] : -1;
    tr.head_lo = tr.g_lo >= 0 && (lo == 0 || map_g[lo - 1] != tr.g_lo);
    tr.head_hi = tr.g_hi >= 0 && (hi == 8 || map_g[hi - 1] != tr.g_hi);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int d = 1 << i;
      tr.join_lo[i] = lo + d < 8 && tr.g_lo >= 0 && map_g[lo + d] == tr.g_lo ? 1.f : 0.f;
      tr.join_hi[i] = hi + d < kTile && tr.g_hi >= 0 && map_g[hi + d] == tr.g_hi ? 1.f : 0.f;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      tr.lo[d] = tr.g_lo >= 0 ? cent[3 * tr.g_lo + d] : 0.f;
      tr.hi[d] = tr.g_hi >= 0 ? cent[3 * tr.g_hi + d] : 0.f;
    }
    // raw rows in bf16, zero past each centroid's count and past 3 + c;
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
        if (r < kTile && k < kin) {
          const int p = map_p[r];
          if (p >= 0) v[u] = k < 3 ? xyz[3 * p + k] : feat[(size_t)p * a.c + (k - 3)];
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
    mma_layer<0>(buf_a, lda, w1s, a.k1p, a.n1p, bias, a.c1, w1c, a.n1p, tr, buf_b, ldb,
                 nullptr, lane);
    if constexpr (kPoint0) {  // a centroid without neighbours: point 0's row
      const unsigned zero = __ballot_sync(
          0xffffffffu, lane < kTile && map_g[lane & 15] >= 0 && cnt[map_g[lane & 15]] == 0);
      if (zero) {  // warp-uniform; each such row is its centroid's only one
        __syncwarp();
        for (int col = lane; col < a.c1; col += 32) {
          float h = a.b1[col];
          for (int k = 0; k < kin; ++k) {
            h += (k < 3 ? xyz[k] : feat[k - 3]) * a.w1f[(size_t)k * a.c1 + col];
          }
          for (unsigned m = zero; m; m &= m - 1) {
            const int j = __ffs(m) - 1;
            const float* c = cent + 3 * map_g[j];
            const float bc = recentre(w1c, a.n1p, col, c[0], c[1], c[2]);
            buf_b[j * ldb + col] = __float2bfloat16_rn(fmaxf(h - bc, 0.f));
          }
        }
      }
    }
    __syncwarp();
    mma_layer<1>(buf_b, ldb, w2s, a.n1p, a.n2p, bias + a.n1p, a.c2, nullptr, 0, tr, buf_a, lda,
                 nullptr, lane);
    __syncwarp();
    if (tr.g_all >= 0) {  // warp-uniform
      mma_layer<2>(buf_a, lda, w3s, a.n2p, a.n3p, bias + a.n1p + a.n2p, a.c3, nullptr, 0, tr,
                   nullptr, 0, pmax, lane);
    } else {
      mma_layer<3>(buf_a, lda, w3s, a.n2p, a.n3p, bias + a.n1p + a.n2p, a.c3, nullptr, 0, tr,
                   nullptr, 0, pmax, lane);
    }
    __syncwarp();
  }
  __syncthreads();
  float* out = a.out + ((size_t)b * a.s + s0) * a.c3;
  for (int i = tid; i < cpb * a.c3; i += kThreads) {
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
  int mma;   // 1: the tensor-core kernel
  int cpb;   // centroids per block
  int rows;  // rows per tile: 16 (tensor-core), 32 or 128 (CUDA-core)
  int tr;    // CUDA-core kernel: output rows a thread owns, 4 or 8
};

template <bool kRaw, bool kPoint0, bool kFast>
void pick(Plan* p) {
  p->kernel = p->mma        ? sa_kernel_mma<kRaw, kPoint0, kFast>
              : p->tr == 8 ? sa_kernel<8, kRaw, kPoint0, kFast>
                           : sa_kernel<4, kRaw, kPoint0, kFast>;
}

// The CUDA-core kernel's tile at these widths, the first that fits in
// shared memory at 8 centroids a block: where every layer is at most 64
// wide, 128 rows of 4 a thread (one pass of 64 columns a layer), else 128
// rows of 8 a thread (passes of 128 columns: 4 shared loads a 64 FFMA); then
// 32 rows of 4 a thread (passes of 256). -> false where neither fits.
bool cc_tile(int kin, int c1, int c2, int c3, size_t optin, Plan* p) {
  const bool wide = std::max({c1, c2, c3}) > 64;
  const int tiles[][2] = {{128, wide ? 8 : 4}, {32, 4}};
  for (const auto& t : tiles) {
    if (cc_smem_bytes(kin, c1, c2, c3, t[0], t[1], kMinCpb) <= optin) {
      p->rows = t[0];
      p->tr = t[1];
      return true;
    }
  }
  return false;
}

// The MLP launch for b rows of s centroids at these widths and options: the
// kernel, its dynamic shared memory, its centroids per block and its tile.
// bf16 takes the tensor-core kernel when it fits the device's shared memory
// at 8 centroids a block, else the CUDA-core kernel; f32 takes the CUDA-core
// kernel. Both take the largest of 32, 16 and 8 centroids a block whose
// shared memory fits and whose grid still fills the card once (b * ceil(s /
// cpb) blocks at least the blocks per SM at that size times the SMs), else
// 8. The CUDA-core kernel asks more: a grid of at least two blocks a SM as
// well as a full wave (its blocks are long: at SA1 B=32, one block a SM, 256
// blocks of 16 centroids took 5% longer than 512 of 8 on an H100; at SA0
// B=32, two a SM, 512 of 32 took 9% less than 1024 of 16), and as many
// blocks a SM as at 8. cpb_req (8, 16 or 32; 0: the rule's choice) sets it
// instead; cudaErrorInvalidValue where the kernel does not take it, or where
// no tile of the CUDA-core kernel fits.
cudaError_t plan(int b, int s, int c, int c1, int c2, int c3, int bf16, int in_cloud, int raw,
                 int fast, int cpb_req, Plan* p) {
  const int k1p = round16(3 + c), n1p = round16(c1), n2p = round16(c2), n3p = round16(c3);
  if (cpb_req != 0 && cpb_req != 8 && cpb_req != 16 && cpb_req != 32) {
    return cudaErrorInvalidValue;
  }
  int optin = 0, sms = 0;
  cudaError_t e = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (e == cudaSuccess) e = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (e != cudaSuccess) return e;
  p->mma = bf16 && mma_smem_bytes(k1p, n1p, n2p, n3p, c3, kMinCpb) <= (size_t)optin;
  p->rows = kTile;
  p->tr = 0;
  if (!p->mma && !cc_tile(3 + c, c1, c2, c3, optin, p)) return cudaErrorInvalidValue;
  if (fast) {
    pick<false, false, true>(p);
  } else if (raw) {
    pick<true, false, false>(p);
  } else if (in_cloud) {
    pick<false, false, false>(p);
  } else {
    pick<false, true, false>(p);
  }
  const auto smem_at = [&](int cpb) {
    return p->mma ? mma_smem_bytes(k1p, n1p, n2p, n3p, c3, cpb)
                  : cc_smem_bytes(3 + c, c1, c2, c3, p->rows, p->tr, cpb);
  };
  int per_sm_min = 0;  // the CUDA-core kernel's blocks a SM at cpb 8
  if (!p->mma && cpb_req == 0) {
    const size_t smem = smem_at(kMinCpb);
    e = cudaFuncSetAttribute(p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_min, p->kernel, kThreads, smem);
    }
    if (e != cudaSuccess) return e;
  }
  for (int cpb = 32; cpb >= kMinCpb; cpb /= 2) {
    if (cpb_req != 0 && cpb != cpb_req) continue;
    const size_t smem = smem_at(cpb);
    if (smem > (size_t)optin) {
      if (cpb_req != 0) return cudaErrorInvalidValue;
      continue;
    }
    const long blocks = (long)b * ((s + cpb - 1) / cpb);
    // a grid below one block a SM never fills the card; at 8 blocks a SM
    // (2048 threads) and above it always does, without asking
    if (cpb_req == 0 && cpb != kMinCpb && blocks < sms) continue;
    e = cudaFuncSetAttribute(p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (cpb_req == 0 && cpb != kMinCpb && (blocks < 8L * sms || !p->mma)) {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->kernel, kThreads, smem);
      if (e != cudaSuccess) return e;
      const long need = p->mma ? per_sm : std::max(per_sm, 2);
      if (blocks < need * sms || per_sm < per_sm_min) continue;
    }
    p->cpb = cpb;
    p->smem = smem;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;  // not reached: cpb = 8 fits (mma, or the tile)
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
// zero-padded to multiples of 16 (needed for bf16, null for f32). cpb:
// the MLP kernel's centroids per block, 0 for the plan's choice, else 8, 16
// or 32; another value, or one that does not fit, is refused. Both
// launches go on `stream`. Returns a cudaError_t.
int mpn_sa(const float* xyz, const float* feat, const float* cent, const int* chunks,
           int window, const float* w1, const float* w1f, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, const bf16_t* w1t,
           const bf16_t* w2t, const bf16_t* w3t, int b, int n, int s, int c, int kp, int c1,
           int c2, int c3, float r2, int bf16, int in_cloud, float* out, int* idx, int* count,
           float* raw, int select, int cpb, void* stream) {
  const int fast = chunks != nullptr;
  if (kp % 4 || c1 % 4 || c2 % 4 || kp < 3 + c || b < 1 || b > 65535 || s < 1 ||
      (raw && !in_cloud) || (fast && (raw || !in_cloud)) || (!fast && !count) ||
      (bf16 && !(w1t && w2t && w3t)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan(b, s, c, c1, c2, c3, bf16, in_cloud, raw != nullptr, fast, cpb, &p);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fast && select) {
    e = launch_select(xyz, cent, b, n, s, r2, idx, count, st);
    if (e != cudaSuccess) return (int)e;
  }
  SaArgs a{xyz, feat, cent, chunks, w1, w1f, b1, w2, b2, w3, b3, w1t, w2t, w3t, out, idx,
           fast ? nullptr : count, raw, n, s, c, kp, c1, c2, c3, window, bf16,
           round16(3 + c), round16(c1), round16(c2), round16(c3), r2, p.cpb, p.rows};
  p.kernel<<<dim3((s + p.cpb - 1) / p.cpb, b), kThreads, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The MLP launch mpn_sa makes for b rows of s centroids at these widths and
// options, with cpb as mpn_sa takes it: *mma 1 for the tensor-core kernel,
// its dynamic shared memory in bytes, the blocks of it that fit on one SM,
// its centroids per block, its rows per tile and (CUDA-core kernel) the
// output rows a thread owns, 4 or 8 (0 on the tensor cores). Returns a
// cudaError_t.
int mpn_sa_plan(int b, int s, int c, int c1, int c2, int c3, int bf16, int in_cloud, int raw,
                int fast, int cpb, int* mma, int* smem, int* blocks_per_sm, int* cpb_out,
                int* rows_out, int* tr_out) {
  Plan p{};
  cudaError_t e = plan(b, s, c, c1, c2, c3, bf16, in_cloud, raw, fast, cpb, &p);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, p.kernel, kThreads, p.smem);
  }
  *mma = p.mma;
  *smem = (int)p.smem;
  *cpb_out = p.cpb;
  *rows_out = p.rows;
  *tr_out = p.tr;
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
