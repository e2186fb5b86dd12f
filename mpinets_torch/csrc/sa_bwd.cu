// Backward of an exact in-cloud bf16 PointNet++ set-abstraction stage on
// Hopper (sm_90a), bound through a plain C interface (ctypes): the train
// step's SAStageTrain.backward for sa_impl "v8" under bf16 compute.
//
// Replaces no TPU kernel: the JAX package's backward is plain XLA over the
// saved raw block (mpinets_tpu/model/fused_train.py:81-97,128-164), and the
// port repeated it in plain torch over all 128 slots of every centroid,
// about 28% of which are real neighbours. This kernel runs the same
// function over the valid rows only; the slots past a centroid's count
// never reach the tensor cores and never land in device memory.
//
// Function, per (batch row b, centroid s), from the raw block [b, s, 128,
// 3 + c] f32 the forward saved (rows past the count zero), the selection
// idx [b, s, 128] (valid slots: slot 0 and every slot whose index differs
// from slot 0's, a prefix of count rows), the centroid, the stage's bf16
// weights and f32 biases, and the cotangent g [b, s, c3] f32:
//  * the forward recomputed in the MLP kernel's arithmetic (sa.cu): the raw
//    row rounded to bf16, layer 1 with the recentring folded into its bias,
//    (raw . W1 + b1) - W1[:3]^T c in f32, ReLU, bf16; layer 2 the same
//    without the centroid term; layer 3's z = ReLU(h2 . W3 + b3) in f32;
//  * per (centroid, channel) the max of z over the valid rows and the rows
//    that tie with it; where the max is > 0 each tied row takes g / ties
//    (what amax's backward gives), the others 0: dz3;
//  * dz2 = (dz3 W3^T) [u2 > 0], dz1 = (dz2 W2^T) [u1 > 0] with bf16
//    operands (dz rounded, the rounded weights) and f32 sums; with gf,
//    dx = dz1 W1^T, each slot's feature columns rounded to bf16 and summed
//    into gf[b, idx] in f32 by atomics (fused_train.py:146-164);
//  * dW_l = A_l^T bf16(dz_l) over every valid row, A_1 the recentred row
//    bf16(raw - c) (the replay's layer-1 input), A_2 = h1, A_3 = h2; db_l
//    the f32 column sums of dz_l. Both sums are taken in a fixed order.
//
// What bounds it on the H100: over the valid rows (on a B=64 training batch
// 505k at SA1, about 61 a centroid, and 457k at SA0, about 14) the forward
// recomputed, the input cotangents and the weight cotangents, 1.7e11 FLOP
// at SA1: 0.177 ms at 989 TFLOP/s, 0.023 ms at SA0; the valid raw rows (135
// MB at SA1) and idx are read in less.
//
// Design: three launches on the caller's stream.
//  * sa_bwd_rows_kernel: persistent, one block a SM of two warpgroups, each
//    walking its own work items (batch row, cpb centroids: 8 where a layer
//    is wider than 64, else 32) as the forward's wgmma kernel does. The
//    block stages W1^T, W2^T, W3^T (bf16, zero-padded to the products' 128
//    or 256 columns) in wgmma's canonical K-major layout once. An item's
//    counts come from idx by the fill rule; its valid rows are packed
//    centroid after centroid into 64-row tiles (wgmma's m). Pass 1 runs
//    the forward over the item's tiles and merges (max, ties) per
//    (centroid, channel) into shared memory: a butterfly over the warp's
//    row groups, then a 64-bit compare-and-swap (max bits, count). Pass 2
//    runs the forward again, bit for bit (the epilogues use explicit
//    round-to-nearest intrinsics, so both passes compute the same z), and
//    the backward chain: every product is a m64n128k16 wgmma with f32
//    accumulators; h1, h2, dz3, dz2, dz1 stay in registers as the next
//    product's A fragments (the C fragment of 8-column groups 2j, 2j + 1
//    is the A fragment of k step j), and the transposed weights are the
//    same shared copies read as MN-major operands (descriptor strides
//    swapped, the transpose bit set). The ReLU masks wait as bits in shared
//    memory. Each tile writes A_l and bf16(dz_l) to device scratch, in the
//    canonical layout (a warp's 16-byte row quads make 128 contiguous
//    bytes), adds the column sums of dz_l (a butterfly over the warp's row
//    groups) to the warp's row of shared sums, and adds dx's feature
//    columns to gf two at a time (paired f32 atomics).
//  * sa_bwd_dw_kernel: dW_l^T = dz_l^T A_l over every tile, K the rows: per
//    (layer, split of the items) one block, tiles double-buffered into
//    shared memory by cp.async, both operands the MN-major views of the
//    scratch tiles; f32 partials a split.
//  * sa_bwd_reduce_kernel: the partials of dW and of db summed in a fixed
//    order, dW written Dense [in, out].
// All three layers' f32 weight cotangents (231 KB at SA1) do not fit a
// block beside the weights, so they are not kept per block across tiles:
// the scratch holds each row's bf16 operands (sized for B * S * 128 rows,
// what a selection can hold: the host never reads the row count) and the
// second kernel reduces over rows with K as long as a split's tiles.
//
// On an H100 at B=64 (a training batch; 255 registers, 8-12 bytes of
// per-item scalars spilled outside the tile loop): the row kernel 1.17 ms
// a stage on average, the weight kernel 0.28, the reduction 0.01; SA1 2.05
// ms in all, SA0 0.78 (8.6% and 3.0% of their bounds). Of SA1's row kernel,
// pass 1 takes about 1.0 ms, the gf atomics 0.3 (before they were paired)
// and the scratch stores 0.05 (sed-made variants without each). The
// 64-bit keys' butterfly costs less than a max and a tie count by warp
// reductions over each column's 8 lanes (redux.sync with per-group masks:
// 5x slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kNs = 128;         // slots per centroid
constexpr int kThreads = 256;    // two warpgroups a block
constexpr int kWgs = 2;
constexpr int kWgThreads = 128;
constexpr int kRows = 64;        // rows per tile (wgmma's m)
constexpr int kN = 128;          // columns per product (wgmma's n)
constexpr int kOutMax = 2 * kN;  // widest layer (C3)
constexpr int kLayers = 3;

using bf16_t = __nv_bfloat16;
using u64 = unsigned long long;

struct BwdArgs {
  const float* raw;    // [b, s, kNs, kin] f32: rows past the count zero
  const int* idx;      // [b, s, kNs]
  const float* cent;   // [b, s, 3]
  const float* g;      // [b, s, c3]
  const bf16_t* w1t;   // [n1p, k1] bf16 W1^T (prepare_sa_weights), zero-padded to 16
  const bf16_t* w2t;   // [n2p, n1p]
  const bf16_t* w3t;   // [n3p, n2p]
  const float* w1f;    // [kin, c1] f32: rows 0-2 the recentring term
  const float* b1;
  const float* b2;
  const float* b3;
  float* gf;           // [b, n, kin - 3] f32, zeroed by the caller; null: none
  float* dw1;          // [kin, c1]
  float* db1;          // [c1]
  float* dw2;          // [c1, c2]
  float* db2;
  float* dw3;          // [c2, c3]
  float* db3;
  // scratch: tiles [tiles][kRows][width] in the canonical layout
  bf16_t* x;           // A_1: bf16(raw - c), width k1
  bf16_t* h1;          // width n1p
  bf16_t* h2;          // width n2p
  bf16_t* d1;          // bf16(dz1), width n1p
  bf16_t* d2;          // width n2p
  bf16_t* d3;          // width n3p
  int* ntiles;         // [items]: tiles an item wrote
  float* dbp;          // [grid][n1p + n2p + n3p]: db partials of the row kernel's blocks
  float* dwp;          // [kLayers][splits][kOutMax][kN]: dW^T partials
  int b, s, n, kin, c1, c2, c3;
  int k1, n1p, n2p, n3p;
  int cpb, items, tpi, grid, splits;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline uint32_t align128(uint32_t x) { return (x + 127u) & ~127u; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower column
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A [rows][k] bf16 matrix in shared (or scratch) memory in wgmma's canonical
// layout without swizzle: 8x8 core matrices of 128 contiguous bytes (8 rows
// of 16 bytes), core (r / 8, k / 8) at (k / 8) * rows * 16 + (r / 8) * 128.
__host__ __device__ constexpr uint32_t core_offset(int r, int k, int rows) {
  return (uint32_t)((k >> 3) * rows * 16 + (r >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFFu) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

// The K-major descriptor of a canonical matrix of `rows` rows: the leading
// byte offset (next 8 k) rows * 16, the stride byte offset (next 8 rows) 128.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int rows) {
  return make_desc(addr, rows * 16, 128);
}

// The same canonical matrix read transposed, as an MN-major operand (the
// transpose bit set): its columns are the operand's m (or n), its rows the
// operand's k. Core matrices are then 8 contiguous m by 8 k at 16 bytes;
// the stride byte offset is the next 8 m, rows * 16 bytes, the leading byte
// offset the next 8 k, 128 (CUTLASS's interleaved MN-major form; the
// swapped assignment gave wrong products on an H100).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int rows) {
  return make_desc(addr, 128, rows * 16);
}

// d (+)= a b on a 64 x 128 tile, m64n128k16, bf16 operands and f32
// accumulators (scale_d 0: d = a b). kTa, kTb: 1 where A, B are MN-major
// (the PTX of CUTLASS's SM90_64x128x16_F32BF16BF16_SS and _RS).
template <int kTa, int kTb>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTa), "n"(kTb));
}

// A in registers: a0-a3 the m16n8k16 A fragment of the warp's 16 rows.
template <int kTb>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d), "n"(kTb));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// No shared-memory access moves across it: bounds how many loads of an
// unrolled epilogue the compiler hoists together (each a live register).
__device__ __forceinline__ void load_fence() { asm volatile("" ::: "memory"); }

// Shared memory written by threads, then read by wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The 128 threads of warpgroup wg (named barrier 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The row kernel
// ---------------------------------------------------------------------------

// Its dynamic shared memory, in bytes from the start: W1^T [kN][kN] (dx
// reads all kN input columns), W2^T [kN][kN], W3^T [n3][kN] in
// the canonical layout, zero past each layer; the biases in f32 and, a
// float4 a layer-1 column, its bias and W1's xyz rows; each warp's running
// column sums of dz1, dz2, dz3 [8][n1p + n2p + n3p]; then each warpgroup's
// own area: its A tile [kRows][k1], the (max, ties) keys of its item
// [cpb][c3] (then (max, share)), the item's packed row map, its centroids,
// counts and first packed rows, the tile's row map, and each thread's ReLU
// masks of layers 1 and 2 (4 words: out of the registers between the
// forward and the backward products).
struct RowsLayout {
  uint32_t w1, w2, w3, bias, l1c, dbs, wg0, per_wg, total;
  uint32_t atile, keys, rowmap, cent, cnt, off, mape, masks;
};

__host__ __device__ inline int n3_cols(int n3p) { return n3p > kN ? 2 * kN : kN; }

__host__ __device__ inline RowsLayout rows_layout(int k1, int n1p, int n2p, int n3p, int c3,
                                                  int cpb) {
  RowsLayout l;
  const int n3 = n3_cols(n3p);
  l.w1 = 0;
  l.w2 = l.w1 + 2u * kN * kN;
  l.w3 = l.w2 + 2u * kN * kN;
  l.bias = l.w3 + 2u * n3 * kN;
  l.l1c = align128(l.bias + 4u * (2 * kN + n3));
  l.dbs = l.l1c + 16u * kN;
  l.wg0 = align128(l.dbs + 4u * 8 * (n1p + n2p + n3p));
  l.atile = 0;
  l.keys = align128(2u * kRows * k1);
  l.rowmap = align128(l.keys + 8u * cpb * c3);
  l.cent = align128(l.rowmap + 4u * cpb * kNs);
  l.cnt = align128(l.cent + 4u * 3 * cpb);
  l.off = align128(l.cnt + 4u * cpb);
  l.mape = align128(l.off + 4u * cpb);
  l.masks = align128(l.mape + 4u * kRows);
  l.per_wg = align128(l.masks + 16u * kWgThreads);
  l.total = l.wg0 + kWgs * l.per_wg;
  return l;
}

// W^T [rows_src, k_src] bf16 (row-major, zero-padded to 16) into shared
// memory as [rows][kN], blocks of kN rows each canonical; zero past the
// source. cp.async by the whole block; the caller waits.
__device__ __forceinline__ void stage_weights(unsigned char* dst, const bf16_t* src, int rows_src,
                                              int k_src, int rows) {
  constexpr int per_row = kN / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, q = i - r * per_row;
    unsigned char* d = dst + (size_t)(r / kN) * kN * kN * 2 + core_offset(r % kN, 8 * q, kN);
    if (r < rows_src && 8 * q < k_src) {
      cp_async16(d, src + (size_t)r * k_src + 8 * q);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// A thread's two rows of the tile's C fragments (lo = 16 warp + lane / 4,
// hi = lo + 8): their centroids in the item (-1 past its rows).
struct RowInfo {
  int g_lo, g_hi;
};

// (max bits, ties) of a (centroid, channel): merging keeps the larger max
// and adds the ties of an equal one (non-negative floats order as their
// bits).
__device__ __forceinline__ u64 key_merge(u64 a, u64 b) {
  const uint32_t ma = (uint32_t)(a >> 32), mb = (uint32_t)(b >> 32);
  return ma > mb ? a : mb > ma ? b : a + (b & 0xFFFFFFFFull);
}
__device__ __forceinline__ void key_merge_shared(u64* p, u64 k) {
  u64 old = *reinterpret_cast<volatile u64*>(p);
  while (true) {
    const u64 merged = key_merge(old, k);
    if (merged == old) return;
    const u64 seen = atomicCAS(p, old, merged);
    if (seen == old) return;
    old = seen;
  }
}

// One level of a butterfly over the warp's 8 row groups: lanes kHalf * 2
// apart trade half of v (the lane with that bit keeps the upper half), each
// combining what it keeps with what it gets. After levels 8, 4 and 2, v[0]
// and v[1] of lane l hold columns 8 (8 half + l / 4) + 2 (l % 4) + {0, 1}
// over the warp's 16 rows (sa.cu's pool_half order).
template <int kHalf, typename T, typename Op>
__device__ __forceinline__ void trade(T (&v)[16], int lane, Op op) {
  const bool up = lane & (2 * kHalf);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const T send = up ? v[k] : v[k + kHalf];
    const T keep = up ? v[k + kHalf] : v[k];
    v[k] = op(keep, __shfl_xor_sync(0xffffffffu, send, 2 * kHalf));
  }
}
template <typename T, typename Op>
__device__ __forceinline__ void butterfly(T (&v)[16], int lane, Op op) {
  trade<8>(v, lane, op);
  trade<4>(v, lane, op);
  trade<2>(v, lane, op);
}

// The column sums over the warp's 16 rows of a product's C fragments,
// added to the warp's running sums (row: column 0 of the product; width
// columns, a multiple of 16), two columns a lane and half.
__device__ __forceinline__ void sum_columns(const float (&acc)[64], float* row, int width,
                                            int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (64 * half >= width) break;  // uniform
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = 32 * half + 4 * (i >> 1) + (i & 1);
      v[i] = acc[e] + acc[e + 2];
    }
    butterfly(v, lane, [](float x, float y) { return x + y; });
    const int c = 64 * half + 8 * (lane >> 2) + 2 * (lane & 3);
    if (c < width) {
      float2* p = reinterpret_cast<float2*>(row + c);
      const float2 old = *p;
      *p = make_float2(old.x + v[0], old.y + v[1]);
    }
  }
}

// The C fragments of a product (columns n0 ..) as bf16 A fragments of the
// next product (the 4-byte pairs of rows lo and hi, 8-column group j at
// f[2 j] and f[2 j + 1]), and their canonical store: 8-column group j of a
// [kRows][width] tile, the warp's 16 rows, 128 contiguous bytes a half.
template <int N>
__device__ __forceinline__ void pack_frags(const float (&acc)[64], uint32_t (&f)[N], int j0) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    f[2 * (j0 + j)] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    f[2 * (j0 + j) + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}
template <int N>
__device__ __forceinline__ void store_frags(bf16_t* tile, const uint32_t (&f)[N], int groups,
                                            int warp, int lane) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile) + warp * 256 + lane * 4;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    if (j < groups) {
      *reinterpret_cast<uint32_t*>(base + j * kRows * 16) = f[2 * j];
      *reinterpret_cast<uint32_t*>(base + j * kRows * 16 + 128) = f[2 * j + 1];
    }
  }
}

// A product with A in registers: acc = sum over k steps kk < ksteps of
// f[4 kk .. 4 kk + 3] times B at b_addr(kk).
template <int kTb, int N, typename Addr>
__device__ __forceinline__ void product_rs(float (&acc)[64], uint32_t (&f)[N], int ksteps,
                                           Addr b_addr) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 4; ++kk) {
    if (kk < ksteps) {
      wgmma_rs<kTb>(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3], b_addr(kk),
                    kk > 0);
    }
  }
  wg_commit();
  wg_wait0();
  reg_fence(acc);
  reg_fence(f);
}

// Layer 3's z = ReLU(acc + b) of one product (columns from b; width of them
// real, past it acc stays 0), in place.
__device__ __forceinline__ void relu_bias(float (&acc)[64], const float* b, int width, int q) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    if (8 * j >= width) break;  // uniform
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float u = __fadd_rn(acc[4 * j + e], b[8 * j + 2 * q + (e & 1)]);
      acc[4 * j + e] = u > 0.f ? u : 0.f;
    }
  }
}

template <int P>
using Product = std::integral_constant<int, P>;

// The forward of one tile, both passes alike (the same instructions on the
// same operands): layer 1 from the A tile, layers 2 and 3 from registers.
// h1 and h2 as bf16 A fragments (stored to the scratch tiles in pass 2) and
// their ReLU masks as bits (bit e of m[e / 32]: C element e > 0; in pass 2
// stored to the thread's mask words, layer 1's then layer 2's); layer 3's
// z, a product of kN columns at a time (two where n3p > kN), handed to
// consume(Product<p>) in acc before the next is issued, so that one
// product's accumulators are live at a time.
template <bool kStore, typename Consume>
__device__ __forceinline__ void forward_tile(const BwdArgs& a, uint32_t atile, uint32_t w1s,
                                             uint32_t w2s, uint32_t w3s, const float* bias,
                                             const float4* l1c, const float* cent,
                                             const RowInfo& ri, int q, float (&acc)[64],
                                             uint32_t (&h)[32], uint32_t* masks,
                                             bf16_t* h1_tile, bf16_t* h2_tile, int warp,
                                             int lane, Consume consume) {
  // layer 1: A the raw rows, B W1^T, both in shared memory
  wg_fence();
  for (int kk = 0; kk < a.k1 / 16; ++kk) {
    wgmma_ss<0, 0>(acc, desc_k(atile + kk * 32 * kRows, kRows), desc_k(w1s + kk * 32 * kN, kN),
                   kk > 0);
  }
  wg_commit();
  wg_wait0();
  reg_fence(acc);
  // (acc + b1) - W1[:3]^T c of the row's own centroid, ReLU; columns past
  // the layer's stay 0 (zero weights and bias)
  const int cr[2] = {3 * max(ri.g_lo, 0), 3 * max(ri.g_hi, 0)};  // rows' centroids in cent
  uint32_t m1[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    if (8 * j >= a.n1p) break;  // uniform
    load_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float4 k = l1c[8 * j + 2 * q + t];  // b1, W1[0], W1[1], W1[2] of the column
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 2 * r + t;
        const float rc =
            __fmaf_rn(k.w, cent[cr[r] + 2],
                      __fmaf_rn(k.z, cent[cr[r] + 1], __fmul_rn(k.y, cent[cr[r]])));
        acc[4 * j + e] = __fsub_rn(__fadd_rn(acc[4 * j + e], k.x), rc);
        m1[j >> 3] |= (acc[4 * j + e] > 0.f ? 1u : 0u) << (4 * (j & 7) + e);
        acc[4 * j + e] = fmaxf(acc[4 * j + e], 0.f);
      }
    }
  }
  reg_fence(m1);  // the bits, kept as bits: not re-derived from the activations later
  if constexpr (kStore) *reinterpret_cast<uint2*>(masks) = make_uint2(m1[0], m1[1]);
  pack_frags(acc, h, 0);
  if constexpr (kStore) store_frags(h1_tile, h, a.n1p / 8, warp, lane);

  // layer 2: A h1 in registers, B W2^T
  product_rs<0>(acc, h, a.n1p / 16, [&](int kk) { return desc_k(w2s + kk * 32 * kN, kN); });
  uint32_t m2[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    if (8 * j >= a.n2p) break;  // uniform
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[4 * j + e] = __fadd_rn(acc[4 * j + e], bias[kN + 8 * j + 2 * q + (e & 1)]);
      m2[j >> 3] |= (acc[4 * j + e] > 0.f ? 1u : 0u) << (4 * (j & 7) + e);
      acc[4 * j + e] = fmaxf(acc[4 * j + e], 0.f);
    }
  }
  reg_fence(m2);
  if constexpr (kStore) *reinterpret_cast<uint2*>(masks + 2) = make_uint2(m2[0], m2[1]);
  pack_frags(acc, h, 0);
  if constexpr (kStore) store_frags(h2_tile, h, a.n2p / 8, warp, lane);

  // layer 3: A h2 in registers, B W3^T, one or two products
  const int k3 = a.n2p / 16;
  product_rs<0>(acc, h, k3, [&](int kk) { return desc_k(w3s + kk * 32 * kN, kN); });
  relu_bias(acc, bias + 2 * kN, a.n3p, q);
  consume(Product<0>{});
  if (a.n3p > kN) {
    product_rs<0>(acc, h, k3,
                  [&](int kk) { return desc_k(w3s + 2 * kN * kN + kk * 32 * kN, kN); });
    relu_bias(acc, bias + 3 * kN, a.n3p - kN, q);
    consume(Product<1>{});
  }
}

// Pass 1: the (max, ties) of the warp's 16 rows of z (layer 3's columns n0
// ..) merged into the item's keys, centroid by centroid of the rows
// (g_first .. g_last; packed rows take consecutive centroids): a butterfly
// of (max, ties) keys over the warp's row groups, then one merge a lane and
// column.
__device__ __forceinline__ void merge_keys(const float (&z)[64], int n0, int c3, const RowInfo& ri,
                                           int g_first, int g_last, u64* keys, int lane) {
  const auto key_of = [](bool mine, float v) {
    return mine ? (u64)__float_as_uint(v) << 32 | 1ull : 0ull;
  };
  for (int g = max(g_first, 0); g <= g_last; ++g) {  // warp-uniform
    const bool lo = ri.g_lo == g, hi = ri.g_hi == g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (n0 + 64 * half >= c3) break;  // uniform
      u64 k[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e = 32 * half + 4 * (i >> 1) + (i & 1);
        k[i] = key_merge(key_of(lo, z[e]), key_of(hi, z[e + 2]));
      }
      butterfly(k, lane, [](u64 x, u64 y) { return key_merge(x, y); });
      const int c = n0 + 64 * half + 8 * (lane >> 2) + 2 * (lane & 3);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (c + t < c3) key_merge_shared(keys + g * c3 + c + t, k[t]);
      }
    }
  }
}

// Pass 2: z (layer 3's columns n0 ..) into dz3: a row's share g / ties of
// its centroid's channel where z is the max, else 0 (keys hold max bits <<
// 32 | share bits; the share is 0 where the max is 0).
__device__ __forceinline__ void dz3_of(float (&z)[64], int n0, int c3, const RowInfo& ri,
                                       const u64* keys, int q) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    load_fence();
    const int c = n0 + 8 * j + 2 * q;  // even, as c3 is: a 16-byte pair of keys
    if (n0 + 8 * j >= c3) {  // uniform: past the layer, z is 0 and so is dz3
      z[4 * j] = z[4 * j + 1] = z[4 * j + 2] = z[4 * j + 3] = 0.f;
      continue;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = r == 0 ? ri.g_lo : ri.g_hi;
      ulonglong2 kv = make_ulonglong2(0ull, 0ull);
      if (g >= 0 && c < c3) kv = *reinterpret_cast<const ulonglong2*>(keys + g * c3 + c);
      const int e = 4 * j + 2 * r;
      z[e] = __float_as_uint(z[e]) == (uint32_t)(kv.x >> 32) ? __uint_as_float((uint32_t)kv.x)
                                                              : 0.f;
      z[e + 1] = __float_as_uint(z[e + 1]) == (uint32_t)(kv.y >> 32)
                     ? __uint_as_float((uint32_t)kv.y)
                     : 0.f;
    }
  }
}

// acc *= the ReLU mask in the words mw (bit e: C element e), over the width
// real columns (past them the product's weights are 0, and so is acc).
__device__ __forceinline__ void apply_mask(float (&acc)[64], const uint32_t* mw, int width) {
  const uint2 w = *reinterpret_cast<const uint2*>(mw);
  const uint32_t m[2] = {w.x, w.y};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    if (8 * (e >> 2) >= width) break;  // uniform
    if (!((m[e >> 5] >> (e & 31)) & 1u)) acc[e] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1) sa_bwd_rows_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const int cpb = a.cpb, kin = a.kin, c3 = a.c3;
  const RowsLayout lay = rows_layout(a.k1, a.n1p, a.n2p, a.n3p, c3, cpb);
  const int n3 = n3_cols(a.n3p);
  const int tid = threadIdx.x;

  // ---- the block: weights, biases and W1's xyz rows, once ---------------
  stage_weights(sm + lay.w1, a.w1t, a.n1p, a.k1, kN);
  stage_weights(sm + lay.w2, a.w2t, a.n2p, a.n1p, kN);
  stage_weights(sm + lay.w3, a.w3t, a.n3p, a.n2p, n3);
  cp_commit();
  float* bias = reinterpret_cast<float*>(sm + lay.bias);  // b1 [kN], b2 [kN], b3 [n3]
  float4* l1c = reinterpret_cast<float4*>(sm + lay.l1c);  // [kN]: b1, W1[0], W1[1], W1[2]
  const int nb = a.n1p + a.n2p + a.n3p;
  float* dbs = reinterpret_cast<float*>(sm + lay.dbs);    // [8 warps][nb]: dz1, dz2, dz3 sums
  for (int j = tid; j < 2 * kN + n3; j += kThreads) {
    const int j2 = j - kN, j3 = j2 - kN;
    bias[j] = j2 < 0 ? (j < a.c1 ? a.b1[j] : 0.f)
              : j3 < 0 ? (j2 < a.c2 ? a.b2[j2] : 0.f) : (j3 < c3 ? a.b3[j3] : 0.f);
  }
  for (int j = tid; j < kN; j += kThreads) {
    l1c[j] = j < a.c1 ? make_float4(a.b1[j], a.w1f[j], a.w1f[a.c1 + j], a.w1f[2 * a.c1 + j])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < 8 * nb; i += kThreads) dbs[i] = 0.f;

  const int wg = tid / kWgThreads, wt = tid % kWgThreads;
  const int warp = wt >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* ws = sm + lay.wg0 + wg * lay.per_wg;
  u64* keys = reinterpret_cast<u64*>(ws + lay.keys);       // [cpb][c3]
  int* rowmap = reinterpret_cast<int*>(ws + lay.rowmap);   // packed row -> p << 12 | j << 5 | g
  float* cent = reinterpret_cast<float*>(ws + lay.cent);   // [cpb][3]
  int* cnt = reinterpret_cast<int*>(ws + lay.cnt);         // [cpb]; -1: no centroid
  int* off = reinterpret_cast<int*>(ws + lay.off);         // [cpb]: first packed row
  int* mape = reinterpret_cast<int*>(ws + lay.mape);       // [kRows]: the tile's rows' entries
  const uint32_t atile = smem_u32(ws + lay.atile);
  const uint32_t w1s = smem_u32(sm + lay.w1), w2s = smem_u32(sm + lay.w2);
  const uint32_t w3s = smem_u32(sm + lay.w3);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
  __syncthreads();

  const int tile_x = kRows * a.k1, tile_1 = kRows * a.n1p;  // elements a scratch tile
  const int tile_2 = kRows * a.n2p, tile_3 = kRows * a.n3p;
  const int sums = (wg * 4 + warp) * nb;  // this warp's row of dbs: dz1 [n1p], dz2, dz3
  const unsigned groups = (a.s + cpb - 1) / cpb;
  for (int item = blockIdx.x * kWgs + wg; item < a.items; item += gridDim.x * kWgs) {
    const int b = (unsigned)item / groups, s0 = ((unsigned)item % groups) * cpb;
    const int row0 = b * a.s + s0;  // the item's first centroid row
    wg_sync(wg);  // the warpgroup is past the last item's keys and maps
    // ---- the item's centroids, counts (by the fill rule) and packed rows:
    // centroid g owns count rows from the exclusive prefix off[g]
    for (int i = wt; i < 3 * cpb; i += kWgThreads) {
      cent[i] = s0 + i / 3 < a.s ? a.cent[(size_t)row0 * 3 + i] : 0.f;
    }
    for (int g = warp; g < cpb; g += kWgThreads / 32) {
      int kept = -1;
      if (s0 + g < a.s) {
        const int* ix = a.idx + (size_t)(row0 + g) * kNs;
        const int first = ix[0];
        kept = 1;
#pragma unroll
        for (int u = 0; u < kNs / 32; ++u) {
          const int j = lane + 32 * u;
          kept += __popc(__ballot_sync(0xffffffffu, j > 0 && ix[j] != first));
        }
      }
      if (lane == 0) cnt[g] = kept;
    }
    for (int i = wt; i < cpb * c3; i += kWgThreads) keys[i] = 0ull;
    wg_sync(wg);
    const int nrows = lane < cpb ? max(cnt[lane], 0) : 0;
    int incl = nrows;  // every warp scans the counts; warp 0 keeps the offsets
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (wt < cpb) off[wt] = incl - nrows;
    wg_sync(wg);
    for (int i = wt; i < cpb * kNs; i += kWgThreads) {
      const int g = i / kNs, j = i - g * kNs;
      if (j < cnt[g]) rowmap[off[g] + j] = a.idx[(size_t)(row0 + g) * kNs + j] << 12 | j << 5 | g;
    }
    wg_sync(wg);

    const int tiles = (total + kRows - 1) / kRows;
    const int tile0 = item * a.tpi;  // the item's first scratch tile
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t < tiles; ++t) {
        // the tile's rows, then their raw rows rounded to bf16 into the A
        // tile; in pass 2 also A_1, the recentred rows, into the scratch
        wg_sync(wg);  // the warpgroup is past the last tile's products
        if (wt < kRows) {
          const int row = t * kRows + wt;
          mape[wt] = row < total ? rowmap[row] : -1;
        }
        wg_sync(wg);
        bf16_t* xt = a.x + (size_t)(tile0 + t) * tile_x;
        {
          float v[8][8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = wt + u * kWgThreads, r = i % kRows, k0 = 8 * (i / kRows);
            const int e = k0 < a.k1 ? mape[r] : -1;
#pragma unroll
            for (int c = 0; c < 8; ++c) v[u][c] = 0.f;
            if (e >= 0 && k0 < kin) {
              const float* src =
                  a.raw + ((size_t)(row0 + (e & 31)) * kNs + ((e >> 5) & 127)) * kin + k0;
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                if (k0 + c < kin) v[u][c] = src[c];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = wt + u * kWgThreads, r = i % kRows, k0 = 8 * (i / kRows);
            if (k0 >= a.k1) break;
            const uint32_t o = core_offset(r, k0, kRows);
            *reinterpret_cast<uint4*>(ws + lay.atile + o) =
                make_uint4(pack_bf16(v[u][0], v[u][1]), pack_bf16(v[u][2], v[u][3]),
                           pack_bf16(v[u][4], v[u][5]), pack_bf16(v[u][6], v[u][7]));
            if (pass == 1) {
              const int e = mape[r];
              if (k0 == 0 && e >= 0) {
                const float* c = cent + 3 * (e & 31);
                v[u][0] = __fsub_rn(v[u][0], c[0]);
                v[u][1] = __fsub_rn(v[u][1], c[1]);
                v[u][2] = __fsub_rn(v[u][2], c[2]);
              }
              *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xt) + o) =
                  make_uint4(pack_bf16(v[u][0], v[u][1]), pack_bf16(v[u][2], v[u][3]),
                             pack_bf16(v[u][4], v[u][5]), pack_bf16(v[u][6], v[u][7]));
            }
          }
        }
        fence_proxy_async();
        wg_sync(wg);  // the A tile is written

        const int lo = 16 * warp + (lane >> 2);
        RowInfo ri;
        ri.g_lo = mape[lo] >= 0 ? mape[lo] & 31 : -1;
        ri.g_hi = mape[lo + 8] >= 0 ? mape[lo + 8] & 31 : -1;
        float acc[64];
        uint32_t h[32];
        uint32_t* masks = reinterpret_cast<uint32_t*>(ws + lay.masks) + 4 * wt;
        if (pass == 0) {
          const int* rows = mape + 16 * warp;
          const int g_first = rows[0] >= 0 ? rows[0] & 31 : -1;
          const int e16 = rows[lane & 15];
          const int g_last = __reduce_max_sync(0xffffffffu, e16 >= 0 ? e16 & 31 : -1);
          forward_tile<false>(a, atile, w1s, w2s, w3s, bias, l1c, cent, ri, q, acc, h, masks,
                              nullptr, nullptr, warp, lane, [&](auto p) {
                                merge_keys(acc, decltype(p)::value * kN, c3, ri, g_first, g_last,
                                           keys, lane);
                              });
          continue;
        }
        // dz3: the max-pool's cotangent, its column sums, its bf16 fragments
        const size_t t1 = tile0 + t;  // this tile's index in the scratch
        uint32_t d3[64];
#pragma unroll
        for (int i = 32; i < 64; ++i) d3[i] = 0u;
        forward_tile<true>(a, atile, w1s, w2s, w3s, bias, l1c, cent, ri, q, acc, h, masks,
                           a.h1 + t1 * tile_1, a.h2 + t1 * tile_2, warp, lane, [&](auto p) {
                             constexpr int P = decltype(p)::value;
                             dz3_of(acc, P * kN, c3, ri, keys, q);
                             sum_columns(acc, dbs + sums + a.n1p + a.n2p + P * kN,
                                         a.n3p - P * kN, lane);
                             pack_frags(acc, d3, 16 * P);
                           });
        store_frags(a.d3 + t1 * tile_3, d3, a.n3p / 8, warp, lane);
        // dz2 = (dz3 W3^T) [u2 > 0]: B the shared W3^T read MN-major
        product_rs<1>(acc, d3, a.n3p / 16, [&](int kk) {
          return desc_mn(w3s + (kk >> 3) * 2 * kN * kN + (kk & 7) * 256, kN);
        });
        apply_mask(acc, masks + 2, a.n2p);
        sum_columns(acc, dbs + sums + a.n1p, a.n2p, lane);
        pack_frags(acc, h, 0);
        store_frags(a.d2 + t1 * tile_2, h, a.n2p / 8, warp, lane);
        // dz1 = (dz2 W2^T) [u1 > 0]
        product_rs<1>(acc, h, a.n2p / 16,
                      [&](int kk) { return desc_mn(w2s + kk * 256, kN); });
        apply_mask(acc, masks, a.n1p);
        sum_columns(acc, dbs + sums, a.n1p, lane);
        pack_frags(acc, h, 0);
        store_frags(a.d1 + t1 * tile_1, h, a.n1p / 8, warp, lane);
        if (a.gf != nullptr) {  // dx = dz1 W1^T; the features' columns into gf
          product_rs<1>(acc, h, a.n1p / 16,
                        [&](int kk) { return desc_mn(w1s + kk * 256, kN); });
          // a column pair (k, k + 1) at once where both are features and
          // 8-byte aligned (the wrapper lays gf out so that they are)
          const int cf = kin - 3;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int me = mape[lo + 8 * r];
            if (me < 0) continue;
            float* row = a.gf + ((size_t)b * a.n + (me >> 12)) * cf - 3;  // row[k]: column k
#pragma unroll
            for (int j = 0; j < kN / 8; ++j) {
              const int k = 8 * j + 2 * q;
              if (k >= kin) break;  // k grows with j
              const float v0 = round_bf16(acc[4 * j + 2 * r]);
              const float v1 = round_bf16(acc[4 * j + 2 * r + 1]);
              if (k >= 3 && k + 1 < kin && (reinterpret_cast<uintptr_t>(row + k) & 7u) == 0) {
                atomicAdd(reinterpret_cast<float2*>(row + k), make_float2(v0, v1));
              } else {
                if (k >= 3) atomicAdd(row + k, v0);
                if (k + 1 >= 3 && k + 1 < kin) atomicAdd(row + k + 1, v1);
              }
            }
          }
        }
      }
      if (pass == 0) {
        // (max, ties) -> (max, share): g / ties where the max is > 0, else 0
        wg_sync(wg);
        for (int g = 0; g < cpb && cnt[g] >= 0; ++g) {
          for (int c = wt; c < c3; c += kWgThreads) {
            const u64 kv = keys[g * c3 + c];
            const uint32_t m = (uint32_t)(kv >> 32);
            const float share =
                m != 0u ? a.g[(size_t)(row0 + g) * c3 + c] / (float)(uint32_t)kv : 0.f;
            keys[g * c3 + c] = (u64)m << 32 | __float_as_uint(share);
          }
        }
      }
    }
    if (wt == 0) a.ntiles[item] = tiles;
  }

  // ---- the bias cotangents' sums: the 8 warps' in order, into the block's
  // partial
  __syncthreads();
  for (int c = tid; c < nb; c += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < 8; ++w) sum += dbs[(size_t)w * nb + c];
    a.dbp[(size_t)blockIdx.x * nb + c] = sum;
  }
}

// ---------------------------------------------------------------------------
// The weight cotangents
// ---------------------------------------------------------------------------

constexpr uint32_t kDzBytes = 2u * kRows * kOutMax;  // a stage's dz tile
constexpr uint32_t kABytes = 2u * kRows * kN;        // a stage's A tile
constexpr uint32_t kDwSmem = 2 * (kDzBytes + kABytes);

// dW_l^T = dz_l^T A_l over the tiles of items [i0, i1) of one split, for
// layer blockIdx.y: the tiles double-buffered by cp.async, both operands
// the MN-major views of their canonical tiles; warpgroup w takes the
// 64-row chunks w and w + 2 of dW^T (its output columns).
__global__ void __launch_bounds__(kThreads, 1) sa_bwd_dw_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const int layer = blockIdx.y, split = blockIdx.x, tid = threadIdx.x;
  const bf16_t* A = layer == 0 ? a.x : layer == 1 ? a.h1 : a.h2;
  const bf16_t* D = layer == 0 ? a.d1 : layer == 1 ? a.d2 : a.d3;
  const int aw = layer == 0 ? a.k1 : layer == 1 ? a.n1p : a.n2p;
  const int dw = layer == 0 ? a.n1p : layer == 1 ? a.n2p : a.n3p;
  const uint32_t a_bytes = 2u * kRows * aw, dz_bytes = 2u * kRows * dw;
  // past each tile's columns: zero, once (the copies never write there)
  for (int st = 0; st < 2; ++st) {
    unsigned char* base = sm + st * (kDzBytes + kABytes);
    for (uint32_t o = dz_bytes + 16u * tid; o < kDzBytes; o += 16u * kThreads) {
      *reinterpret_cast<uint4*>(base + o) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (uint32_t o = a_bytes + 16u * tid; o < kABytes; o += 16u * kThreads) {
      *reinterpret_cast<uint4*>(base + kDzBytes + o) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const int i0 = (int)((long)split * a.items / a.splits);
  const int i1 = (int)((long)(split + 1) * a.items / a.splits);
  int total = 0;
  for (int i = i0; i < i1; ++i) total += a.ntiles[i];
  int it = i0, tt = 0;  // the next tile to copy: tile tt of item it
  const auto copy_next = [&](int st) {
    while (tt >= a.ntiles[it]) {
      ++it;
      tt = 0;
    }
    const size_t tile = (size_t)it * a.tpi + tt++;
    unsigned char* base = sm + st * (kDzBytes + kABytes);
    const unsigned char* dsrc = reinterpret_cast<const unsigned char*>(D) + tile * dz_bytes;
    const unsigned char* asrc = reinterpret_cast<const unsigned char*>(A) + tile * a_bytes;
    for (uint32_t o = 16u * tid; o < dz_bytes; o += 16u * kThreads) cp_async16(base + o, dsrc + o);
    for (uint32_t o = 16u * tid; o < a_bytes; o += 16u * kThreads) {
      cp_async16(base + kDzBytes + o, asrc + o);
    }
  };
  const int wg = tid / kWgThreads;
  const int chunks = dw / 64 + (dw % 64 != 0);
  const bool has0 = wg < chunks, has1 = wg + 2 < chunks;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  if (total > 0) copy_next(0);
  cp_commit();
  for (int k = 0; k < total; ++k) {
    const int st = k & 1;
    if (k + 1 < total) copy_next(st ^ 1);
    cp_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    fence_proxy_async();
    __syncthreads();  // tile k is in; everyone is past tile k - 1's products
    const uint32_t dz = smem_u32(sm + st * (kDzBytes + kABytes)), at = dz + kDzBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t db = desc_mn(at + kk * 256, kRows);
      if (has0) wgmma_ss<1, 1>(acc0, desc_mn(dz + wg * 8 * kRows * 16 + kk * 256, kRows), db, 1);
      if (has1) {
        wgmma_ss<1, 1>(acc1, desc_mn(dz + (wg + 2) * 8 * kRows * 16 + kk * 256, kRows), db,
                       1);
      }
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc0);
    reg_fence(acc1);
    __syncthreads();  // stage st may be copied into again
  }
  // dW^T rows (output columns) of the chunks, columns (inputs) 0 .. kN
  const int wt = tid % kWgThreads, warp = wt >> 5, lane = tid & 31;
  float* part = a.dwp + ((size_t)layer * a.splits + split) * kOutMax * kN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h == 0 ? has0 : has1)) continue;
    const float(&acc)[64] = h == 0 ? acc0 : acc1;
    const int m0 = (wg + 2 * h) * 64 + 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int n0 = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(part + (size_t)m0 * kN + n0) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (size_t)(m0 + 8) * kN + n0) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The partials summed in a fixed order: dW_l [in, out] from the splits' dW^T,
// db_l from the row kernel's blocks. One thread an output.
__global__ void sa_bwd_reduce_kernel(BwdArgs a) {
  const int ins[kLayers] = {a.kin, a.c1, a.c2}, outs[kLayers] = {a.c1, a.c2, a.c3};
  float* dws[kLayers] = {a.dw1, a.dw2, a.dw3};
  float* dbs[kLayers] = {a.db1, a.db2, a.db3};
  const int boff[kLayers] = {0, a.n1p, a.n1p + a.n2p};
  const int nb = a.n1p + a.n2p + a.n3p;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int l = 0; l < kLayers; ++l) {
    const long e = (long)ins[l] * outs[l];
    if (i < e) {  // input k fastest: the partials' rows read in order
      const int o = (int)(i / ins[l]), k = (int)(i % ins[l]);
      const float* p = a.dwp + (size_t)l * a.splits * kOutMax * kN + (size_t)o * kN + k;
      float sum = 0.f;
      for (int s = 0; s < a.splits; ++s) sum += p[(size_t)s * kOutMax * kN];
      dws[l][(size_t)k * outs[l] + o] = sum;
      return;
    }
    i -= e;
  }
  for (int l = 0; l < kLayers; ++l) {
    if (i < outs[l]) {
      float sum = 0.f;
      for (int blk = 0; blk < a.grid; ++blk) sum += a.dbp[(size_t)blk * nb + boff[l] + i];
      dbs[l][i] = sum;
      return;
    }
    i -= outs[l];
  }
}

// ---------------------------------------------------------------------------
// Launch plan
// ---------------------------------------------------------------------------

cudaError_t device_attribute(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaDeviceGetAttribute(value, attr, dev) : e;
}

struct BwdPlan {
  int cpb, items, tpi, grid, splits;
  size_t smem;
  size_t off[9];  // scratch: x, h1, h2, d1, d2, d3, ntiles, dbp, dwp
  size_t scratch;
};

// Centroids an item: 8 where a layer is wider than 64 (SA1, about 61 rows a
// centroid: about 8 tiles an item), else 32 (SA0, about 3.6 rows: about 2
// tiles). The row kernel's grid: one block a SM, as many as the items need;
// the weight kernel's: a third of the SMs a layer (sharing them by the
// layers' bytes, 208, 256 and 384 columns a row at SA1, took 8% longer on
// an H100). Scratch sized for every slot a valid row (2 cpb tiles an item).
cudaError_t bwd_plan(int b, int s, int kin, int c1, int c2, int c3, BwdPlan* p) {
  const int k1 = round16(kin), n1p = round16(c1), n2p = round16(c2), n3p = round16(c3);
  if (b < 1 || s < 1 || kin < 4 || k1 > kN || n1p > kN || n2p > kN || n3p > kOutMax ||
      c1 < 1 || c2 < 1 || c3 < 1)
    return cudaErrorInvalidValue;
  int optin = 0, sms = 0;
  cudaError_t e = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (e == cudaSuccess) e = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (e != cudaSuccess) return e;
  p->cpb = std::max({c1, c2, c3}) > 64 ? 8 : 32;
  p->items = b * ((s + p->cpb - 1) / p->cpb);
  p->tpi = 2 * p->cpb;
  p->smem = rows_layout(k1, n1p, n2p, n3p, c3, p->cpb).total;
  if (p->smem > (size_t)optin || kDwSmem > (uint32_t)optin) return cudaErrorInvalidValue;
  p->grid = std::min((p->items + kWgs - 1) / kWgs, sms);
  p->splits = std::max(1, std::min(p->items, sms / kLayers));
  const size_t tiles = (size_t)p->items * p->tpi;
  const size_t bytes[9] = {tiles * kRows * k1 * 2,  tiles * kRows * n1p * 2,
                           tiles * kRows * n2p * 2, tiles * kRows * n1p * 2,
                           tiles * kRows * n2p * 2, tiles * kRows * n3p * 2,
                           (size_t)p->items * 4,    (size_t)p->grid * (n1p + n2p + n3p) * 4,
                           (size_t)kLayers * p->splits * kOutMax * kN * 4};
  size_t at = 0;
  for (int i = 0; i < 9; ++i) {
    p->off[i] = at;
    at += (bytes[i] + 255) / 256 * 256;
  }
  p->scratch = at;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The backward of an exact in-cloud bf16 SA stage (see the header). raw
// [b, s, 128, kin] f32 (kin = 3 + c), idx [b, s, 128] int32, cent [b, s, 3]
// f32, g [b, s, c3] f32; w1t, w2t, w3t the bf16 W^T copies of
// prepare_sa_weights ([round16(c1), round16(kin)], ...); w1f [kin, c1] f32;
// b1, b2, b3 f32. gf [b, n, kin - 3] f32, zeroed, or null for no feature
// cotangent; dw1 [kin, c1], db1 [c1], dw2 [c1, c2], db2, dw3 [c2, c3], db3
// f32 out. scratch: mpn_sa_bwd_plan's scratch bytes, 256-byte aligned.
// Three launches on `stream`. Returns a cudaError_t.
int mpn_sa_bwd(const float* raw, const int* idx, const float* cent, const float* g,
               const bf16_t* w1t, const bf16_t* w2t, const bf16_t* w3t, const float* w1f,
               const float* b1, const float* b2, const float* b3, int b, int s, int kin, int c1,
               int c2, int c3, int n, float* gf, float* dw1, float* db1, float* dw2, float* db2,
               float* dw3, float* db3, void* scratch, void* stream) {
  BwdPlan p;
  cudaError_t e = bwd_plan(b, s, kin, c1, c2, c3, &p);
  if (e != cudaSuccess) return (int)e;
  if (gf != nullptr && n < 1) return (int)cudaErrorInvalidValue;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  BwdArgs a{raw, idx, cent, g, w1t, w2t, w3t, w1f, b1, b2, b3, gf, dw1, db1, dw2, db2, dw3, db3,
            reinterpret_cast<bf16_t*>(sc + p.off[0]), reinterpret_cast<bf16_t*>(sc + p.off[1]),
            reinterpret_cast<bf16_t*>(sc + p.off[2]), reinterpret_cast<bf16_t*>(sc + p.off[3]),
            reinterpret_cast<bf16_t*>(sc + p.off[4]), reinterpret_cast<bf16_t*>(sc + p.off[5]),
            reinterpret_cast<int*>(sc + p.off[6]), reinterpret_cast<float*>(sc + p.off[7]),
            reinterpret_cast<float*>(sc + p.off[8]), b, s, n, kin, c1, c2, c3, round16(kin),
            round16(c1), round16(c2), round16(c3), p.cpb, p.items, p.tpi, p.grid, p.splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaFuncSetAttribute(sa_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(sa_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDwSmem);
  }
  if (e != cudaSuccess) return (int)e;
  sa_bwd_rows_kernel<<<p.grid, kThreads, p.smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sa_bwd_dw_kernel<<<dim3(p.splits, kLayers), kThreads, kDwSmem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long outputs = (long)kin * c1 + (long)c1 * c2 + (long)c2 * c3 + c1 + c2 + c3;
  sa_bwd_reduce_kernel<<<(int)((outputs + 255) / 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The launches mpn_sa_bwd makes for these shapes: centroids an item, the
// row kernel's blocks, the weight kernel's splits a layer, the row
// kernel's dynamic shared memory and the scratch bytes. Returns a
// cudaError_t (cudaErrorInvalidValue for widths the kernels do not take:
// 3 + c and the hidden layers up to 128, c3 up to 256).
int mpn_sa_bwd_plan(int b, int s, int kin, int c1, int c2, int c3, long long* cpb,
                    long long* grid, long long* splits, long long* smem, long long* scratch) {
  BwdPlan p{};
  const cudaError_t e = bwd_plan(b, s, kin, c1, c2, c3, &p);
  *cpb = p.cpb;
  *grid = p.grid;
  *splits = p.splits;
  *smem = (long long)p.smem;
  *scratch = (long long)p.scratch;
  return (int)e;
}

const char* mpn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
