// The dense top-k kernels for more than a few queries: f32 vectors
// (topk_partial) and int8 codes (topk_int8_partial), each query's best k of
// every split of the corpus, which topk_merge (topk_scores.cu) finishes.
//
// Replaces the TPU kernels of src/repro/kernels/topk_scoring/topk_scoring.py
// _topk_kernel (f32; :23, its pallas_call at :168) and _topk_int8_kernel
// (int8 x int8 -> int32 dot, ranked as the f32 it rounds to; :49,
// pallas_call at :208) for Q above the narrow cutoffs (kNQMax, kNQInt8 in
// topk_scores.cu).
//
// What bounds them on an H100. Scoring Q queries against N rows of width
// D is 2QND operations. f32-accurate products take three TF32 products
// (3xTF32, topk_scores.cu's note), so at the curve's Q 128, N 524288, D
// 2048 the least time is 3 x 2QND at 495 TFLOP/s, 1.67 ms, against 1.28
// ms for the bytes: operations. int8: 2QND at 1979 TOP/s is 0.14 ms
// against 0.32 ms of bytes: bytes. The (Q, N) scores never leave
// registers; only per-split lists reach device memory.
//
// Design:
//  * Grid (query tile of kDQ = 128, split), the query tile fastest; the
//    wrapper's plan (ops.dense_plan) keeps the grid at one block an SM
//    (132), so every block holds the SM's whole shared memory and the
//    card runs one wave. Two blocks of neighbouring splits form a cluster
//    (kDCluster): each loads half of every chunk of the tile's 128 query
//    rows by TMA multicast into both, so a query byte crosses from L2
//    once per cluster and tile, at half the corpus's cost, while every
//    corpus byte still leaves device memory once. All splits walk the
//    same number of tiles (those past N score nothing: rows past n are
//    masked), so the two blocks of a cluster stay in step. A persistent
//    block walking tiles would buy nothing the split grid does not: the
//    blocks are equal, one a streaming multiprocessor.
//  * Block: two consumer warpgroups (queries 0-63 and 64-127 of the tile)
//    and a producer warpgroup (setmaxnreg: 232 and 40 registers a
//    thread). A ring of 4-12 stages, as many as shared memory holds
//    beside the lists: a stage is 64 bytes of depth (kDSpan: 16 floats, 64
//    codes) of the 128 queries and of the 128 corpus rows of a tile, in
//    TMA's SWIZZLE_64B layout (f32 also the rows' lower TF32 piece),
//    walked tile by tile, chunk by chunk. Three mbarriers a stage: full
//    (the TMA bytes landed), ready (staged and split: what the consumers
//    wait on, but for int8 by TMA, which waits on full) and empty (every
//    consumer warp of both blocks has released it; the producer waits on
//    it, and before it leaves on every stage once more, so no block exits
//    while the other may still arrive on its barriers). No block-wide
//    barrier is taken past the start.
//  * Producer: warp 8 issues the TMA loads (cp.async.bulk.tensor, tensor
//    maps from cuTensorMapEncodeTiled, found through
//    cudaGetDriverEntryPoint, passed as __grid_constant__; L2 promotion of
//    256 bytes, so a row's next three chunks come from L2). For f32,
//    warps 9-11 split each landed corpus chunk once for both consumer
//    groups: x_hi in place, x_lo * 2^12 beside it (an async-proxy fence,
//    then ready). Rows TMA cannot take (a stride off 16 bytes: f32 D % 4,
//    int8 D % 16; a base off 16 bytes; D = 0) are staged by the four
//    producer warps instead, in the same layout: 4-byte cp.async copies
//    (a word of a row not 4-byte aligned assembled from its bytes, zeros
//    past the row), each thread splitting the f32 words it copied once
//    they land, one step behind.
//  * Consumers: wgmma m64n128k8 tf32 (f32) or m64n128k32 s8 (int8), A
//    (the group's 64 query rows) from registers, loaded from the staged
//    chunk as words (conflict-free under the swizzle) and, for f32, split
//    there (the query pieces and their 2^12 multiples), B (the tile's 128
//    rows) from shared memory by descriptor (K-major, SWIZZLE_64B, 8-row
//    groups 512 bytes apart). Lane (g, t) of warp w holds queries 16w + g
//    and + 8 against rows 8j + 2t and + 1 (mma.sync's m16n8 layout, n8
//    tile j), which is how selection reads them. A step issues its
//    chunk's products, then waits only for the step before's (two
//    register sets of A fragments alternate) and releases that stage.
//    f32: a chunk group of kDGroup stages (128 floats of depth) sums into
//    a fresh accumulator (its first wgmma with scale-d 0), three products
//    a step smallest first, and is added to the running sums with one
//    rounded add (scaled back by 2^-12), since the tensor cores truncate
//    as they sum. D <= kExactDepth (kPieces 3: one chunk, nothing split):
//    the summation bound D * 2^-24 * sum |q_d c_d| leaves no room for
//    that truncation, so each thread sums its 64 dots in f64 on the CUDA
//    cores from the staged chunk (exact products, one rounding), as the
//    narrow and gathered scorers do. int8: the same groups, exact int32
//    sums.
//  * Selection: after a tile's last chunk group the running sums hold its
//    scores, and they stay there until the next tile's first group closes, so
//    the tile's selection runs after the next tile's first step is issued,
//    while those products run. Each query's k-th entry is its bar, in
//    registers: a score that cannot enter costs one compare. A split's first
//    tile sorts each query's 128 scores (sort_row) into its list. Later, for
//    k <= kLaneK, each query's survivors wait in a buffer of kDBufK entries
//    (the warp's scratch rows) and join its list kDBufK at a time: sorted in
//    the warp and merged with the list by a bitonic merge (lanes_merge32),
//    where inserting them one by one, a few shuffles each, cost most of the
//    time at k 40-80. A tile with more survivors than a buffer holds for any
//    of the warp's queries (the first tiles, rising scores) merges every
//    buffer and offers the survivors straight to the lists (a chunk of 32
//    with many winners merged at once, else inserted one by one). For k >
//    kLaneK survivors are inserted in place (mem_offer). The lists live in
//    shared memory where they fit beside a ring of kDMinStages (k up to about
//    98 for f32, 128 for int8), else in each query's slice of the output.
//    Each split writes the partial layout [Q, splits * k] that topk_merge
//    reads.
//  * Shared memory a block, from a 1024-byte aligned base: the ring, the
//    consumer warps' scratch rows (8 rows of kDSRow floats a warp, also
//    the survivor buffers), the lists where they fit, the barriers.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstring>

namespace {

#include "sm90.cuh"
#include "topk_lists.cuh"

constexpr int kDQ = 128;                 // queries per block
constexpr int kDN = 128;                 // corpus rows per tile (wgmma N)
constexpr int kDCluster = 2;             // blocks a cluster, sharing queries
constexpr int kDSpan = 64;               // bytes of a row a stage holds
constexpr int kDSteps = kDSpan / 32;     // 32-byte wgmma steps a stage
constexpr int kDBuf = kDN * kDSpan;      // bytes of one staged operand
constexpr int kDMinStages = 4;           // ring stages, at least
constexpr int kDMaxStages = 12;          // and at most
constexpr int kDThreads = 384;           // two consumer warpgroups, a producer
constexpr int kDConvThreads = 96;        // threads splitting f32 chunks
constexpr int kDGroup = 8;               // stages a fresh accumulator sums
constexpr int kDSRow = kDN + 8;          // padded scratch row (floats)
constexpr int kDScratch = 8 * 8 * kDSRow * 4;   // bytes, 8 rows a consumer warp
constexpr int kExactDepth = 8;           // f32: D at most one MMA deep
constexpr int kLaneK = 96;               // largest k offered in lanes
constexpr int kDBufK = 32;               // survivors a query's buffer holds
static_assert(kDQ == kDN, "a staged query chunk is one kDBuf too");
static_assert(16 * 2 * kDBufK <= 8 * kDSRow,
              "a warp's scratch rows hold its queries' buffers");

// A scratch row's kDN scores (ids n0 + column), best first by beats (a
// bitonic network over 4 registers a lane: partners 32 or 64 apart are in
// the lane's other registers, nearer ones a shuffle away): entry 32x +
// lane in v[x], vi[x], -inf entries with id -1.
__device__ __forceinline__ void sort_row(const float* row, int n0, int lane,
                                         float (&v)[kDN / 32],
                                         int (&vi)[kDN / 32]) {
  constexpr int X = kDN / 32;
#pragma unroll
  for (int x = 0; x < X; ++x) {
    v[x] = row[32 * x + lane];
    vi[x] = v[x] == -CUDART_INF_F ? -1 : n0 + 32 * x + lane;
  }
  constexpr int kLog = 7;                       // kDN == 1 << kLog
  static_assert(kDN == 1 << kLog, "the network sorts kDN entries");
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      float pv[X];
      int pi[X];
#pragma unroll
      for (int x = 0; x < X; ++x) {
        if (j >= 32) {
          pv[x] = v[x ^ (j >> 5)];
          pi[x] = vi[x ^ (j >> 5)];
        } else {
          pv[x] = __shfl_xor_sync(kFull, v[x], j);
          pi[x] = __shfl_xor_sync(kFull, vi[x], j);
        }
      }
#pragma unroll
      for (int x = 0; x < X; ++x) {
        // the lower entry of a pair takes the better of the two where its
        // block of 2^ls runs best first, the worse where it runs reversed
        const int e = 32 * x + lane;
        const bool want_better = ((e & j) == 0) == ((e >> ls & 1) == 0);
        if (want_better != beats(v[x], vi[x], pv[x], pi[x])) {
          v[x] = pv[x];
          vi[x] = pi[x];
        }
      }
    }
  }
}

// ---- dense: a TMA ring into wgmma (topk_partial, topk_int8_partial) --------
//
// Block roles (kDThreads = 384): warpgroups 0 and 1 consume (queries
// 64w..64w+63 of the block's 128 against each 128-row tile, one wgmma
// m64n128 accumulator each), warpgroup 2 produces (warp 8 issues the TMA
// loads, warps 9-11 split the f32 corpus chunks; all four stage rows that
// TMA cannot take). Shared memory from a 1024-byte aligned base: the ring
// (n_stages stages: the 128 queries' chunk, the 128 rows' chunk, and for
// f32 the rows' lower TF32 pieces, each kDBuf bytes, 64-byte rows in the
// SWIZZLE_64B layout), the consumer warps' scratch rows, the lists (when
// they fit), then the barriers (full, ready and empty a stage).

// Byte `byte` (< kDSpan) of staged row `row` in the SWIZZLE_64B layout TMA
// writes and wgmma reads: 16-byte unit u of the row moves to unit
// u ^ (row / 2 % 4).
__device__ __forceinline__ unsigned sw64(int row, int byte) {
  return row * kDSpan +
         ((((byte >> 4) ^ (row * kDSpan >> 7)) & (kDSpan / 16 - 1)) << 4) +
         (byte & 15);
}

// The wgmma descriptor of a K-major operand of 8-row groups 512 bytes
// apart in the SWIZZLE_64B layout (LBO unused; SBO 512 bytes).
__device__ __forceinline__ unsigned long long sw64_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFFu) >> 4) |
         (1ull << 16) | (static_cast<unsigned long long>(kDSpan / 2) << 32) |
         ((kDSpan == 128 ? 1ull : 2ull) << 62);
}

// Arrive on the barrier at the same offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar,
                                                    unsigned rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(x),
      "r"(y)
      : "memory");
}

// The same box into every block of the cluster named by `mask`, at dst and
// completing on bar in each.
__device__ __forceinline__ void tma_load_multicast(unsigned dst,
                                                   const CUtensorMap* map,
                                                   unsigned bar, int x, int y,
                                                   unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "h"(mask),
      "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmmas run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep registers a wgmma reads or writes where they are until it is done.
__device__ __forceinline__ void pin(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(int (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void pin(unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma m64n128k8 tf32 (A from registers, B from shared memory) and
// m64n128k32 s8 (exact int32 sums): d = a * b^T + (scale_d ? d : 0). Lane
// (g, t) of warp w of the warpgroup holds row 16w + g (d[4j], d[4j + 1])
// and 16w + g + 8 (d[4j + 2], d[4j + 3]) at columns 8j + 2t, 8j + 2t + 1:
// mma.sync's m16n8 layout, n8 tile j.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const unsigned (&a)[4],
                                           unsigned long long b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64],
                                         const unsigned (&a)[4],
                                         unsigned long long b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The A operands of one stage's products, in registers: f32, each query
// value's TF32 pieces ap and the same kLoScale times larger as; int8, the
// codes as they are.
template <typename In, int kPieces> struct DenseFrags {
  unsigned ap[kDSteps][kPieces][4], as[kDSteps][kPieces][4];
};
template <int kPieces> struct DenseFrags<signed char, kPieces> {
  unsigned a[kDSteps][4];
};

// Rows ra and rb of the staged queries at sq, bytes 32kk + 4t and 32kk +
// 16 + 4t of each 32-byte step kk: the A fragment of wgmma m64nNk8 tf32
// (columns t and t + 4) and of m64nNk32 s8 (codes 4t.. and 16 + 4t..),
// rows 16w + g and + 8 for lane (g, t) of warp w.
__device__ __forceinline__ void frag_words(unsigned (&a)[kDSteps][4],
                                           const unsigned char* sq, int ra,
                                           int rb, int t) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    const int b0 = 32 * kk + 4 * t;
    a[kk][0] = *reinterpret_cast<const unsigned*>(sq + sw64(ra, b0));
    a[kk][1] = *reinterpret_cast<const unsigned*>(sq + sw64(rb, b0));
    a[kk][2] = *reinterpret_cast<const unsigned*>(sq + sw64(ra, b0 + 16));
    a[kk][3] = *reinterpret_cast<const unsigned*>(sq + sw64(rb, b0 + 16));
  }
}

template <int kPieces>
__device__ __forceinline__ void load_frags(DenseFrags<float, kPieces>& f,
                                           const unsigned char* sq, int ra,
                                           int rb, int t) {
  unsigned a[kDSteps][4];
  frag_words(a, sq, ra, rb, t);
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      unsigned p[kPieces];
      tf32_split<kPieces>(p, a[kk][r]);
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        f.ap[kk][i][r] = p[i];
        f.as[kk][i][r] = __float_as_uint(__uint_as_float(p[i]) * kLoScale);
      }
    }
}

template <int kPieces>
__device__ __forceinline__ void load_frags(DenseFrags<signed char, kPieces>& f,
                                           const unsigned char* sq, int ra,
                                           int rb, int t) {
  frag_words(f.a, sq, ra, rb, t);
}

// One stage's products into part (fresh: the first replaces it): f32, the
// products a_i * b_j * kLoScale with i + j < kPieces, smallest first, b_j
// the staged corpus piece j (j > 0 staged scaled) at st + (1 + j) kDBuf;
// int8, one s8 product a step against the codes at st + kDBuf.
template <int kPieces>
__device__ __forceinline__ void dense_products(float (&part)[64],
                                               DenseFrags<float, kPieces>& f,
                                               unsigned st, int ksteps,
                                               bool fresh) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    if (kk >= ksteps) break;                      // uniform: past d
#pragma unroll
    for (int sum = kPieces - 1; sum >= 0; --sum)
#pragma unroll
      for (int i = sum; i >= 0; --i)
        wgmma_tf32(part, sum == i ? f.as[kk][i] : f.ap[kk][i],
                   sw64_desc(st + (1 + sum - i) * kDBuf) + 2 * kk,
                   fresh && kk == 0 && sum == kPieces - 1 && i == sum ? 0
                                                                      : 1);
  }
}

template <int kPieces>
__device__ __forceinline__ void dense_products(
    int (&part)[64], DenseFrags<signed char, kPieces>& f, unsigned st,
    int ksteps, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    if (kk >= ksteps) break;                      // uniform: past d
    wgmma_s8(part, f.a[kk], sw64_desc(st + kDBuf) + 2 * kk,
             fresh && kk == 0 ? 0 : 1);
  }
}

template <int kPieces>
__device__ __forceinline__ void pin_frags(DenseFrags<float, kPieces>& f) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk)
#pragma unroll
    for (int sum = kPieces - 1; sum >= 0; --sum)
#pragma unroll
      for (int i = sum; i >= 0; --i) pin(sum == i ? f.as[kk][i] : f.ap[kk][i]);
}

template <int kPieces>
__device__ __forceinline__ void pin_frags(DenseFrags<signed char, kPieces>& f) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) pin(f.a[kk]);
}

// A chunk group's sum added to the running one: f32 scaled back by
// kLoUnscale with one rounding, int32 exactly.
__device__ __forceinline__ float dense_add(float part, float acc) {
  return __fmaf_rn(part, kLoUnscale, acc);
}
__device__ __forceinline__ int dense_add(int part, int acc) {
  return part + acc;
}

// The lane's 64 dots of a chunk of d <= kExactDepth floats summed in f64
// and rounded once: queries ra and rb of the staged queries at sq, corpus
// rows 8j + 2t and + 1 of the staged rows kDBuf bytes further on, into
// part in the accumulator layout.
__device__ __forceinline__ void exact_dots(float (&part)[64],
                                           const float* sq, int d, int ra,
                                           int rb, int t) {
  const float* sc = sq + kDBuf / 4;
  double q[2][kExactDepth];
#pragma unroll
  for (int x = 0; x < kExactDepth; ++x) {
    q[0][x] = x < d ? sq[sw64(ra, 4 * x) / 4] : 0.0;
    q[1][x] = x < d ? sq[sw64(rb, 4 * x) / 4] : 0.0;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int row = 8 * j + 2 * t + b;
      double s0 = 0.0, s1 = 0.0;
#pragma unroll
      for (int x = 0; x < kExactDepth; ++x) {
        const double c = x < d ? sc[sw64(row, 4 * x) / 4] : 0.0;
        s0 = fma(q[0][x], c, s0);
        s1 = fma(q[1][x], c, s1);
      }
      part[4 * j + b] = static_cast<float>(s0);
      part[4 * j + 2 + b] = static_cast<float>(s1);
    }
}

// The corpus chunk at c (kDBuf bytes) split where it lies: each value
// becomes its leading TF32 piece in place and its lower pieces, kLoScale
// times larger, kDBuf, 2 kDBuf, ... bytes further on; a thread takes
// float4s first, first + count, ... Elementwise, so the swizzle does not
// matter.
template <int kPieces>
__device__ __forceinline__ void split_chunk(unsigned char* c, int first,
                                            int count) {
  for (int e = first; e < kDBuf / 16; e += count) {
    float4 v = reinterpret_cast<float4*>(c)[e];
    float* x = reinterpret_cast<float*>(&v);
    float lo[kPieces - 1][4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      unsigned p[kPieces];
      tf32_split<kPieces>(p, __float_as_uint(x[w]));
      x[w] = __uint_as_float(p[0]);
#pragma unroll
      for (int j = 1; j < kPieces; ++j)
        lo[j - 1][w] = __uint_as_float(p[j]) * kLoScale;
    }
    reinterpret_cast<float4*>(c)[e] = v;
#pragma unroll
    for (int j = 1; j < kPieces; ++j)
      reinterpret_cast<float4*>(c + j * kDBuf)[e] =
          make_float4(lo[j - 1][0], lo[j - 1][1], lo[j - 1][2],
                      lo[j - 1][3]);
  }
}

// One value of the chunk at c, at byte off, split as split_chunk does.
template <int kPieces>
__device__ __forceinline__ void split_word(unsigned char* c, unsigned off) {
  float* x = reinterpret_cast<float*>(c + off);
  unsigned p[kPieces];
  tf32_split<kPieces>(p, __float_as_uint(*x));
  *x = __uint_as_float(p[0]);
#pragma unroll
  for (int j = 1; j < kPieces; ++j)
    *reinterpret_cast<float*>(c + j * kDBuf + off) =
        __uint_as_float(p[j]) * kLoScale;
}

// Merge 32 candidates, one a lane (-inf: none), into the lane list ls/li
// (entry p in register p / 32 of lane p % 32; k <= 32 R): the candidates
// sorted (warp_sort), the list padded with empty entries to X = 1, 2 or 4
// registers, the better of list entry e and candidate 32 X - 1 - e taken
// (a bitonic sequence holding the best 32 X of both: the list falls, the
// reversed candidates rise), then sorted by half-cleaners of strides 16 X
// .. 1, the better to the lower entry; the first k stay. beats orders all
// entries, so ties keep the lower id.
template <int R>
__device__ __forceinline__ void lanes_merge32(float (&ls)[R], int (&li)[R],
                                              float cs, int ci, int k,
                                              int lane) {
  constexpr int X = R == 1 ? 1 : (R == 2 ? 2 : 4);
  static_assert(R <= X, "lists of up to 4 registers a lane");
  warp_sort(cs, ci, lane);
  float c[X];
  int d[X];
#pragma unroll
  for (int x = 0; x < X; ++x) {
    const int e = lane + 32 * x;
    c[x] = -CUDART_INF_F;
    d[x] = -1;
    if (x < R && e < k) {
      c[x] = ls[x < R ? x : 0];
      d[x] = li[x < R ? x : 0];
    }
  }
  const float rs = __shfl_sync(kFull, cs, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (beats(rs, ri, c[X - 1], d[X - 1])) {
    c[X - 1] = rs;
    d[X - 1] = ri;
  }
#pragma unroll
  for (int sx = X / 2; sx >= 1; sx >>= 1)
#pragma unroll
    for (int x = 0; x < X; ++x) {
      const int y = x | sx;
      if ((x & sx) == 0 && beats(c[y], d[y], c[x], d[x])) {
        const float ts = c[x];
        const int ti = d[x];
        c[x] = c[y];
        d[x] = d[y];
        c[y] = ts;
        d[y] = ti;
      }
    }
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1)
#pragma unroll
    for (int x = 0; x < X; ++x) {
      const float ps = __shfl_xor_sync(kFull, c[x], j);
      const int pi = __shfl_xor_sync(kFull, d[x], j);
      if ((lane & j) == 0 ? beats(ps, pi, c[x], d[x])
                          : beats(c[x], d[x], ps, pi)) {
        c[x] = ps;
        d[x] = pi;
      }
    }
#pragma unroll
  for (int x = 0; x < R; ++x) {
    const int e = lane + 32 * x;
    ls[x] = e < k ? c[x] : -CUDART_INF_F;
    li[x] = e < k ? d[x] : -1;
  }
}

// q [nq, d] and c [n, d] of type In; qmap and cmap their TMA maps (boxes
// of kDQ / kDCluster and kDN rows of kDSpan bytes), read when tma. Writes
// each split's top-k list of each query into part_s/part_i [nq, n_splits
// * k]. Grid (query tile of kDQ, split), n_splits a multiple of kDCluster:
// the blocks of a cluster take one query tile and neighbouring splits, and
// each walks tiles_per_split tiles (those past n score nothing). Lists are
// kept in shared memory when smem_lists, else in part_s/part_i; a query's
// list is offered its survivors in kR registers a lane (k <= 32 * kR), or
// in place (kR = 0, any k).
template <typename In, int kPieces, int kR>
__global__ void __cluster_dims__(1, kDCluster, 1)
    __launch_bounds__(kDThreads, 1)
dense_partial(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap cmap,
              const In* __restrict__ q, const In* __restrict__ c,
              float* part_s, int* part_i, int nq, int n, int d, int k,
              int tiles_per_split, int n_splits, int tma, int n_stages,
              int smem_lists) {
  constexpr bool kF32 = sizeof(In) == 4;
  // f32 by 3xTF32: the corpus chunk split by the producer (kPieces 3,
  // D <= kExactDepth, sums its dots in f64 from the chunk as staged)
  constexpr bool kSplit = kF32 && kPieces == 2;
  constexpr int kStage = (kSplit ? 3 : 2) * kDBuf;
  extern __shared__ __align__(1024) unsigned char dsm[];
  unsigned char* sm =
      dsm + ((1024u - (static_cast<unsigned>(__cvta_generic_to_shared(dsm)) &
                       1023u)) & 1023u);
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kDQ;
  const int split = blockIdx.y;
  const unsigned rank = cluster_rank();
  const int t_begin = split * tiles_per_split;
  const long long row_bytes = static_cast<long long>(d) * sizeof(In);
  // D = 0 still takes one (empty) chunk, so every tile is selected from
  const int n_chunks =
      max(1, static_cast<int>((row_bytes + kDSpan - 1) / kDSpan));
  const int steps = tiles_per_split * n_chunks;    // ring steps
  const long long width = static_cast<long long>(n_splits) * k;
  // warpgroup 1 works where its queries begin before nq
  const int busy_groups = q0 + kDQ / 2 < nq ? 2 : 1;
  float* scratch = reinterpret_cast<float*>(sm + n_stages * kStage) +
                   (warp & 7) * 8 * kDSRow;
  float* lists = reinterpret_cast<float*>(sm + n_stages * kStage + kDScratch);
  const unsigned bars = ring + n_stages * kStage + kDScratch +
                        (smem_lists ? kDQ * k * 8 : 0);
  // a stage's barriers: full (the TMA's bytes landed), ready (staged and
  // split: what the consumers wait on but for int8 by TMA, which wait on
  // full) and empty (every consumer warp of the cluster is done with it)
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (kDMaxStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kDMaxStages + s); };
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), tma ? kDConvThreads : 128);
      mbar_init(empty(s), kDCluster * 4 * busy_groups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both blocks' barriers exist before either arrives on the other's
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  if (warp >= 8) {
    // ---- producer warpgroup ------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tma) {
      if (warp == 8 && lane == 0) {
        constexpr int kElems = kDSpan / static_cast<int>(sizeof(In));
        int stage = 0, tile = t_begin, ch = 0;
        unsigned phase = 0;
        for (int s = 0; s < steps; ++s) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * kDBuf);
          const unsigned st = ring + stage * kStage;
          tma_load(st + kDBuf, &cmap, full(stage), ch * kElems, tile * kDN);
          // this block's share of the query rows, into both blocks
          tma_load_multicast(st + rank * (kDBuf / kDCluster), &qmap,
                             full(stage), ch * kElems,
                             q0 + rank * (kDQ / kDCluster),
                             (1 << kDCluster) - 1);
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
          if (++ch == n_chunks) {
            ch = 0;
            ++tile;
          }
        }
        // every stage released once more: no block of the cluster leaves
        // while the other may still arrive on its barriers
        for (int i = 0; i < n_stages; ++i) {
          mbar_wait(empty(stage), phase ^ 1);
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      } else if (kSplit && warp > 8) {
        // split each landed corpus chunk once, for both consumer groups
        int stage = 0;
        unsigned phase = 0;
        for (int s = 0; s < steps; ++s) {
          mbar_wait(full(stage), phase);
          split_chunk<2>(sm + stage * kStage + kDBuf,
                                          tid - 9 * 32, kDConvThreads);
          fence_proxy_async();
          mbar_arrive(ready(stage));
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else {
      // rows TMA cannot take (a stride off 16 bytes, an unaligned base):
      // the four warps stage each chunk in the same layout, 4-byte words
      // by cp.async (a word of a row not 4-byte aligned assembled from its
      // bytes), then each thread splits the f32 words it copied once they
      // land, one step behind
      const int pt = tid - 8 * 32;
      const auto* qb = reinterpret_cast<const unsigned char*>(q);
      const auto* cb = reinterpret_cast<const unsigned char*>(c);
      constexpr int kWords = kDSpan / 4;             // words a staged row
      int stage = 0, done = 0, tile = t_begin, ch = 0;
      unsigned phase = 0;
      for (int s = 0; s <= steps; ++s) {
        if (s < steps) {
          mbar_wait(empty(stage), phase ^ 1);
          unsigned char* st = sm + stage * kStage;
#pragma unroll 1
          for (int e = pt; e < (kDQ + kDN) * kWords; e += 128) {
            const int r = e / kWords, x = e % kWords * 4;
            const bool is_q = r < kDQ;
            const int rr = is_q ? r : r - kDQ;
            const int row = is_q ? q0 + rr : tile * kDN + rr;
            const long long off = static_cast<long long>(ch) * kDSpan + x;
            const long long have =
                row < (is_q ? nq : n) ? row_bytes - off : 0;
            unsigned char* dst = st + (is_q ? 0 : kDBuf) + sw64(rr, x);
            const unsigned char* src =
                (is_q ? qb : cb) + (have > 0 ? row * row_bytes + off : 0);
            if (have > 0 &&
                (reinterpret_cast<unsigned long long>(src) & 3) == 0) {
              asm volatile(
                  "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                      static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(static_cast<int>(min(have, 4LL)))
                  : "memory");
            } else {
              unsigned word = 0;
              for (int y = 0; y < 4 && y < have; ++y)
                word |= unsigned(src[y]) << (8 * y);
              *reinterpret_cast<unsigned*>(dst) = word;
            }
          }
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
        if (s > 0) {
          if (s < steps)
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          else
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          if constexpr (kSplit) {
            unsigned char* cs = sm + done * kStage + kDBuf;
#pragma unroll 1
            for (int e = pt + kDQ * kWords; e < (kDQ + kDN) * kWords;
                 e += 128)
              split_word<2>(
                  cs, sw64(e / kWords - kDQ, e % kWords * 4));
          }
          fence_proxy_async();
          mbar_arrive(ready(done));
          if (++done == n_stages) done = 0;
        }
        if (s < steps) {
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
          if (++ch == n_chunks) {
            ch = 0;
            ++tile;
          }
        }
      }
      if (pt == 0) {
        for (int i = 0; i < n_stages; ++i) {
          mbar_wait(empty(stage), phase ^ 1);
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (q0 + (warp >> 2) * (kDQ / 2) >= nq) return;   // uniform in the group
  const int g = lane >> 2, t = lane & 3;
  // the list of the warp's query r: 2k floats in shared memory, or the
  // query's slice of the output
  auto list_s = [&](int r) -> float* {
    const int ql = 16 * warp + r;
    return smem_lists ? lists + 2 * ql * k
                      : part_s + (q0 + ql) * width + split * k;
  };
  auto list_i = [&](int r) -> int* {
    const int ql = 16 * warp + r;
    return smem_lists ? reinterpret_cast<int*>(lists + 2 * ql * k + k)
                      : part_i + (q0 + ql) * width + split * k;
  };
  for (int r = 0; r < 16; ++r) {
    if (q0 + 16 * warp + r >= nq) break;        // uniform in the warp
    float* s = list_s(r);
    int* i = list_i(r);
    for (int p = lane; p < k; p += 32) {
      s[p] = -CUDART_INF_F;
      i[p] = -1;
    }
  }
  __syncwarp();
  // the bar of the lane's queries 16w + g + 8h: their lists' k-th entry
  float bar_s[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int bar_i[2] = {-1, -1};

  using Acc = typename DenseAcc<In>::T;
  // acc: the running sums of the tile; part: a chunk group's products
  Acc acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = Acc(0);

  // k <= 32 kR: each query's survivors wait in a buffer of kDBufK entries
  // (the warp's scratch rows hold its 16 queries' buffers) and join its
  // list kDBufK at a time (lanes_merge32); cnt[h]: the entries in the
  // buffer of the lane's query 16w + g + 8h
  int cnt[2] = {0, 0};
  auto buf_s = [&](int r) { return scratch + 2 * kDBufK * r; };
  auto buf_i = [&](int r) {
    return reinterpret_cast<int*>(scratch + 2 * kDBufK * r + kDBufK);
  };
  // the buffer of the warp's query r into its list, its bar updated
  auto flush = [&](int r) {
    constexpr int R = kR > 0 ? kR : 1;
    const int held_n = __shfl_sync(kFull, r < 8 ? cnt[0] : cnt[1],
                                   4 * (r & 7));
    if (held_n == 0) return;                      // uniform in the warp
    float* ls_p = list_s(r);
    int* li_p = list_i(r);
    float ls[R];
    int li[R];
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const int e = lane + 32 * x;
      ls[x] = e < k ? ls_p[e] : -CUDART_INF_F;
      li[x] = e < k ? li_p[e] : -1;
    }
    lanes_merge32<R>(ls, li, lane < held_n ? buf_s(r)[lane] : -CUDART_INF_F,
                     lane < held_n ? buf_i(r)[lane] : -1, k, lane);
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const int e = lane + 32 * x;
      if (e < k) {
        ls_p[e] = ls[x];
        li_p[e] = li[x];
      }
    }
    float kth_s;
    int kth_i;
    lanes_kth<R>(ls, li, k, kth_s, kth_i);
    if (r < 8 && g == r) {
      bar_s[0] = kth_s;
      bar_i[0] = kth_i;
      cnt[0] = 0;
    }
    if (r >= 8 && g == r - 8) {
      bar_s[1] = kth_s;
      bar_i[1] = kth_i;
      cnt[1] = 0;
    }
    __syncwarp();
  };
  auto flush_all = [&]() {
#pragma unroll 1
    for (int r = 0; r < 16; ++r) flush(r);
  };
  // the warp's queries (bits 8h + g) whose cnt[h] passes lim0 (h 0) or
  // lim1 (h 1)
  auto over = [&](int lim0, int lim1) {
    unsigned set = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned b =
          __ballot_sync(kFull, t == 0 && cnt[h] > (h ? lim1 : lim0));
#pragma unroll
      for (int gq = 0; gq < 8; ++gq)
        if (b >> (4 * gq) & 1u) set |= 1u << (8 * h + gq);
    }
    return set;
  };

  // selection of tile `tile` from acc: lane (g, t) holds queries
  // 16w + g + 8h, columns 8j + 2t + b of the tile in acc[4j + 2h + b]
  auto select = [&](int tile) {
    const int n0 = tile * kDN;
    unsigned m[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = q0 + 16 * warp + g + 8 * h < nq;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int id = n0 + 8 * j + 2 * t + b;
          if (valid && id < n &&
              beats(static_cast<float>(acc[4 * j + 2 * h + b]), id, bar_s[h],
                    bar_i[h]))
            m[h] |= 1u << (2 * j + b);
        }
    }
    if (kR > 0 && tile > t_begin) {
      // a query's survivors of the tile: its quad's, this lane's after
      // those of the quad's lower lanes
      int tot[2], pre[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = __popc(m[h]);
        int v = c;
        int u = __shfl_up_sync(kFull, v, 1, 4);
        if (t >= 1) v += u;
        u = __shfl_up_sync(kFull, v, 2, 4);
        if (t >= 2) v += u;
        pre[h] = v - c;
        tot[h] = __shfl_sync(kFull, v, 3, 4);
      }
      if (!__any_sync(kFull, tot[0] > kDBufK || tot[1] > kDBufK)) {
        // buffers that would overflow join their lists first
        for (unsigned fl = over(kDBufK - tot[0], kDBufK - tot[1]); fl;
             fl &= fl - 1)
          flush(__ffs(fl) - 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int p = cnt[h] + pre[h];
          float* bs = buf_s(8 * h + g);
          int* bi = buf_i(8 * h + g);
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              if (m[h] >> (2 * j + b) & 1u) {
                bs[p] = static_cast<float>(acc[4 * j + 2 * h + b]);
                bi[p] = n0 + 8 * j + 2 * t + b;
                ++p;
              }
          cnt[h] += tot[h];
        }
        __syncwarp();
        return;
      }
      // more survivors than a buffer holds: every buffer joins its list,
      // and the scratch rows take the tile as below
      flush_all();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // bits 4r..4r+3 of has[x]: query 16w + 8h + r has a survivor among
      // columns 32x..32x+31 (n8 tiles 4x..4x+3, bits 8x..8x+7 of m)
      unsigned has[kDN / 32], any = 0u;
#pragma unroll
      for (int x = 0; x < kDN / 32; ++x) {
        has[x] = __ballot_sync(kFull, (m[h] >> (8 * x) & 0xffu) != 0u);
        any |= has[x];
      }
      if (any == 0u) continue;                    // uniform in the warp
      // the 8 queries 16w + 8h + g: survivors' scores, -inf elsewhere
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 v;
        v.x = m[h] >> (2 * j) & 1u ? static_cast<float>(acc[4 * j + 2 * h])
                                   : -CUDART_INF_F;
        v.y = m[h] >> (2 * j + 1) & 1u
                  ? static_cast<float>(acc[4 * j + 2 * h + 1])
                  : -CUDART_INF_F;
        *reinterpret_cast<float2*>(scratch + g * kDSRow + 8 * j + 2 * t) =
            v;
      }
      __syncwarp();
#pragma unroll 1
      for (int r = 0; r < 8; ++r) {
        if ((any >> (4 * r) & 0xfu) == 0u) continue;   // uniform
        float* ls_p = list_s(8 * h + r);
        int* li_p = list_i(8 * h + r);
        const float* row = scratch + r * kDSRow;
        float kth_s;
        int kth_i;
        if (tile == t_begin) {
          // the list is empty: it takes the row's best min(k, kDN) at once
          float v[kDN / 32];
          int vi[kDN / 32];
          sort_row(row, n0, lane, v, vi);
#pragma unroll
          for (int x = 0; x < kDN / 32; ++x) {
            const int e = lane + 32 * x;
            if (e < k) {
              ls_p[e] = v[x];
              li_p[e] = vi[x];
            }
          }
          __syncwarp();
          kth_s = ls_p[k - 1];        // past kDN still the empty entry
          kth_i = li_p[k - 1];
        } else if (kR == 0) {
          MemList ml{ls_p, li_p, 0.f, 0};
          ml.kth_s = ml.s[k - 1];
          ml.kth_i = ml.i[k - 1];
#pragma unroll
          for (int x = 0; x < kDN / 32; ++x)
            if (has[x] >> (4 * r) & 0xfu)
              mem_offer(ml, row[32 * x + lane], n0 + 32 * x + lane, k,
                        lane);
          kth_s = ml.kth_s;
          kth_i = ml.kth_i;
        } else {
          constexpr int R = kR > 0 ? kR : 1;
          float ls[R];
          int li[R];
#pragma unroll
          for (int x = 0; x < R; ++x) {
            const int e = lane + 32 * x;
            ls[x] = e < k ? ls_p[e] : -CUDART_INF_F;
            li[x] = e < k ? li_p[e] : -1;
          }
          lanes_kth<R>(ls, li, k, kth_s, kth_i);
#pragma unroll
          for (int x = 0; x < kDN / 32; ++x) {
            if ((has[x] >> (4 * r) & 0xfu) == 0u) continue;
            const float sx = row[32 * x + lane];
            const int id = n0 + 32 * x + lane;
            const bool wins =
                sx != -CUDART_INF_F && beats(sx, id, kth_s, kth_i);
            unsigned mm = __ballot_sync(kFull, wins);
            if (mm == 0u) continue;
            if (__popc(mm) > kFewWinners) {
              // many: sorted and merged with the list at once
              lanes_merge32<R>(ls, li, wins ? sx : -CUDART_INF_F,
                               wins ? id : -1, k, lane);
              mm = 0u;
            }
            while (mm) {
              const int src = __ffs(mm) - 1;
              mm &= mm - 1;
              lanes_insert<R>(ls, li, __shfl_sync(kFull, sx, src),
                              __shfl_sync(kFull, id, src), k, lane);
            }
            lanes_kth<R>(ls, li, k, kth_s, kth_i);
          }
#pragma unroll
          for (int x = 0; x < R; ++x) {
            const int e = lane + 32 * x;
            if (e < k) {
              ls_p[e] = ls[x];
              li_p[e] = li[x];
            }
          }
        }
        if (g == r) {
          bar_s[h] = kth_s;
          bar_i[h] = kth_i;
        }
      }
      __syncwarp();   // the scratch rows are rewritten for h = 1
    }
  };

  // this lane's A fragment rows of the staged queries: 16w + g and + 8
  const int ra = 16 * warp + g, rb = ra + 8;
  const unsigned wait0 = tma && !kSplit ? full(0) : ready(0);
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty(s));
      mbar_arrive_cluster(empty(s), rank ^ 1);
    }
  };
  int stage = 0, held = -1;
  unsigned phase = 0;
  // Step `ch` of a tile: stage the chunk's A fragments into cur, issue its
  // products into part, then retire the step before (whose fragments are
  // prev) and release its stage while these run.
  auto step = [&](DenseFrags<In, kPieces>& cur,
                  DenseFrags<In, kPieces>& prev, int ch) {
    mbar_wait(wait0 + 8 * stage, phase);
    // 32-byte wgmma steps of depth (8 floats, 32 codes) before d; D = 0
    // takes one, over the zeros staged
    const long long left = row_bytes - static_cast<long long>(ch) * kDSpan;
    const int ksteps = static_cast<int>(
        max(1LL, min((left + 31) / 32, static_cast<long long>(kDSteps))));
    if constexpr (kF32 && !kSplit) {
      // D <= kExactDepth, one chunk: the tensor cores truncate as they
      // add, and a sum of so few terms has no room for that, so each dot
      // is summed in f64 on the CUDA cores (exact products, one rounding)
      exact_dots(part, reinterpret_cast<const float*>(sm + stage * kStage),
                 d, ra, rb, t);
    } else {
      load_frags(cur, sm + stage * kStage, ra, rb, t);
      wgmma_fence();
      dense_products(part, cur, ring + stage * kStage, ksteps,
                     ch % kDGroup == 0);
      wgmma_commit();
    }
    wgmma_wait<1>();
    pin_frags(prev);
    if (held >= 0) release(held);
    held = stage;
    if (++stage == n_stages) {
      stage = 0;
      phase ^= 1;
    }
  };
  // The end of a chunk group (kDGroup steps, or the tile's last): wait for
  // its products, release the stage, add the group's sum to acc (f32:
  // scaled back, one rounding; int32 exactly).
  auto close = [&](DenseFrags<In, kPieces>& cur, int ch) {
    wgmma_wait<0>();
    pin(part);
    pin_frags(cur);
    release(held);
    held = -1;
#pragma unroll
    for (int e = 0; e < 64; ++e)
      acc[e] = kSplit || !kF32
                   ? dense_add(part[e], ch < kDGroup ? Acc(0) : acc[e])
                   : part[e];
  };
  auto closes = [&](int ch) {
    return (ch + 1) % kDGroup == 0 || ch + 1 == n_chunks;
  };
  DenseFrags<In, kPieces> fa{}, fb{};
  for (int tile = t_begin; tile < t_begin + tiles_per_split; ++tile) {
    for (int ch = 0; ch < n_chunks; ch += 2) {
      step(fa, fb, ch);
      // the tile before's selection while these products run (its sums
      // stay in acc until this tile's first group closes)
      if (ch == 0 && tile > t_begin) select(tile - 1);
      if (closes(ch)) close(fa, ch);
      if (ch + 1 < n_chunks) {
        step(fb, fa, ch + 1);
        if (closes(ch + 1)) close(fb, ch + 1);
      }
    }
  }
  select(t_begin + tiles_per_split - 1);
  if (kR > 0) flush_all();

  if (!smem_lists) return;        // the lists are the output already
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int gq = q0 + 16 * warp + r;
    if (gq >= nq) break;                          // uniform in the warp
    const long long o = gq * width + split * k;
    const float* s = list_s(r);
    const int* i = list_i(r);
    for (int p = lane; p < k; p += 32) {
      part_s[o + p] = s[p];
      part_i[o + p] = i[p];
    }
  }
}

// The TMA map of `rows` rows of d values of `elem` bytes at base: boxes of
// box_rows rows by kDSpan bytes in the SWIZZLE_64B layout, zeros past the
// rows and past d, each row's bytes fetched into L2 256 at a time (the
// next stages' chunks of the same rows).
int dense_map(CUtensorMap* map, const void* base, int rows, int d, int elem,
              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kDSpan / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map,
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      kDSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The dense kernels' launch: lists offered in lanes for k <= kLaneK, in
// place beyond; kept in shared memory where they fit beside a ring of
// kDMinStages stages, else in the output. The ring takes what is left, up
// to kDMaxStages stages. vec: both inputs 16-byte aligned with rows a
// multiple of 16 bytes, the rows TMA takes.
template <typename In, int kPieces, int kR>
int launch_dense_lists(const void* q, const void* c, void* part_s,
                       void* part_i, int nq, int n, int d, int k,
                       int tiles_per_split, int n_splits, int vec,
                       cudaStream_t st) {
  constexpr int kStage = (sizeof(In) == 4 && kPieces == 2 ? 3 : 2) * kDBuf;
  const int tma = vec && d > 0;
  CUtensorMap qm, cm;
  memset(&qm, 0, sizeof(qm));
  memset(&cm, 0, sizeof(cm));
  if (tma) {
    int err = dense_map(&qm, q, nq, d, sizeof(In), kDQ / kDCluster);
    if (err == 0) err = dense_map(&cm, c, n, d, sizeof(In), kDN);
    if (err != 0) return err;
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the alignment slack, the scratch rows and the barriers; the lists
  const long long fixed = 1024 + kDScratch + 3 * kDMaxStages * 8;
  const long long lists = static_cast<long long>(kDQ) * k * 8;
  long long stages = (optin - fixed - lists) / kStage;
  const int smem_lists = stages >= kDMinStages;
  if (!smem_lists) stages = (optin - fixed) / kStage;
  if (stages > kDMaxStages) stages = kDMaxStages;
  if (stages < kDMinStages)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t bytes =
      static_cast<size_t>(fixed + stages * kStage + (smem_lists ? lists : 0));
  err = cudaFuncSetAttribute(dense_partial<In, kPieces, kR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kDQ - 1) / kDQ, n_splits);
  dense_partial<In, kPieces, kR><<<grid, kDThreads, bytes, st>>>(
      qm, cm, static_cast<const In*>(q), static_cast<const In*>(c),
      static_cast<float*>(part_s), static_cast<int*>(part_i), nq, n, d, k,
      tiles_per_split, n_splits, tma, static_cast<int>(stages), smem_lists);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int kPieces>
int launch_dense(const void* q, const void* c, void* part_s, void* part_i,
                 int nq, int n, int d, int k, int tiles_per_split,
                 int n_splits, int vec, void* stream) {
  if (nq <= 0 || n_splits <= 0 || k <= 0)
    return static_cast<int>(cudaGetLastError());
  if (n_splits % kDCluster != 0 || tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kPieces == 3) {
    // D <= kExactDepth, off the main path: its lists offered in place
    return launch_dense_lists<In, kPieces, 0>(
        q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits, vec,
        st);
  } else {
    switch (k > kLaneK ? 0 : (k + 31) / 32) {
      case 1:
        return launch_dense_lists<In, kPieces, 1>(
            q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits,
            vec, st);
      case 2:
        return launch_dense_lists<In, kPieces, 2>(
            q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits,
            vec, st);
      case 3:
        return launch_dense_lists<In, kPieces, 3>(
            q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits,
            vec, st);
      default:
        return launch_dense_lists<In, kPieces, 0>(
            q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits,
            vec, st);
    }
  }
}

}  // namespace


// Each split's top-k of each query into part_s/part_i [nq, n_splits * k]:
// queries/corpus f32 [nq, d] / [n, d]; vec = 1 when both are 16-byte
// aligned and d % 4 == 0 (rows TMA takes); n_splits a multiple of
// kDCluster, each split tiles_per_split tiles of kDN rows (ops.dense_plan).
// D <= kExactDepth sums each dot in f64 (kPieces 3).
extern "C" int topk_partial(const void* q, const void* c, void* part_s,
                            void* part_i, int nq, int n, int d, int k,
                            int tiles_per_split, int n_splits, int vec,
                            void* stream) {
  return d <= kExactDepth
             ? launch_dense<float, 3>(q, c, part_s, part_i, nq, n, d, k,
                                      tiles_per_split, n_splits, vec, stream)
             : launch_dense<float, 2>(q, c, part_s, part_i, nq, n, d, k,
                                      tiles_per_split, n_splits, vec, stream);
}

// The same for int8 codes [nq, d] / [n, d], each exact dot ranked as the
// f32 it rounds to; vec = 1 when both are 16-byte aligned and d % 16 == 0.
extern "C" int topk_int8_partial(const void* q, const void* c, void* part_s,
                                 void* part_i, int nq, int n, int d, int k,
                                 int tiles_per_split, int n_splits, int vec,
                                 void* stream) {
  return launch_dense<signed char, 1>(q, c, part_s, part_i, nq, n, d, k,
                                      tiles_per_split, n_splits, vec, stream);
}

