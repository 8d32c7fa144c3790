// Fused scoring + top-k, any k: inner products over a dense corpus (f32
// vectors and int8 codes) and over per-query candidate rows gathered from a
// table (the ivfflat probe). The Hamming top-k of the lsh scan is
// hamming_topk.cu.
//
// Replaces the TPU kernels of src/repro/kernels/topk_scoring/topk_scoring.py:
// _topk_kernel (f32; :23, its pallas_call at :168), _topk_int8_kernel (int8
// x int8 -> int32 dot, ranked as f32, rows at or past n masked in the
// kernel; :49, pallas_call at :208) and _gathered_kernel (each query scores
// its own candidate set; an id of -1 scores -inf; ties to the earliest
// candidate position), and the cross-block lax.top_k merge that follows
// each.
//
// What bounds them on an H100. Dense: scoring Q queries against N rows of
// width D is 2*Q*N*D flops over the bytes of both
// operands. f32-accurate products on the tensor cores take three TF32
// products each (below), so the least time is the larger of 3*2QND at the
// dense TF32 rate (495 TFLOP/s) and the bytes at 3.35 TB/s: at the main
// path's Q 128, N 524288, D 2048 that is 1.67 ms of operations against 1.28
// ms of bytes, so operations (at the 67 TFLOP/s of the CUDA cores it would
// be 4.10 ms). int8: 2QND at the int8 tensor-core rate (1979 TOP/s) is 0.14
// ms against 0.32 ms of bytes, so bytes. The (Q, N) score matrix never
// leaves registers: like the TPU kernels, only per-split top-k partials
// reach device memory. Gathered: the least the card must move is each
// distinct probed row once, and its 2*C_valid*D flops (C_valid valid slots
// over all queries), taken as three TF32 products at the tensor-core rate,
// are less: at the ivfflat probe of the evaluation path, 2.6 GB of distinct
// rows (0.78 ms) against 3 x 98 GFLOP (0.59 ms), so bytes. This kernel
// takes its products on the tensor cores as three TF32 products, the
// narrow scorer's (below); with the tiles' padding that is 3 x 137 GFLOP,
// about 1.4 ms at the rate mma.sync reaches. A kernel that scores each
// query's rows on their own reads a list once per query that probes it
// (about 64 at that shape), so bytes would set its time; this one shares
// each row tile among the queries that probe it.
//
// With few queries (a serving tick of 1-32, a retrieval step of 1), the
// f32 search is bound by the corpus's bytes: at Q 32, N 1,048,576, D 768,
// 3.2 GB (0.96 ms) against 1.5e11 flops taken three times (0.31 ms at the
// TF32 rate, about 0.55 ms at the rate mma.sync reaches). A 128-query
// block would run 96 zero queries through the MMAs there, and a per-split
// list of k 100 at Q 1 leaves a merge of 13,100 entries to one warp, so
// Q <= kNQMax takes the narrow kernels below instead.
//
// Q above kNQMax (kNQInt8 for int8 codes) takes the dense kernels of
// dense_topk.cu (topk_partial, topk_int8_partial: a TMA ring into wgmma,
// per-split lists), whose partial lists the merge below finishes.
//
// Design:
//  * 3xTF32 (the narrow and gathered scorers here, the dense kernels of
//    dense_topk.cu; topk_lists.cuh): f32-accurate products on the TF32
//    tensor cores. Each value x is split, x_hi = x rounded to TF32, x_lo
//    = x - x_hi (tf32_split), and the products a_lo*b_hi, a_hi*b_lo and
//    a_hi*b_hi go, small terms first, into one accumulator a chunk (about
//    22 bits of each operand, an error near 2^-21 of each term). The
//    tensor cores truncate their sums, which over a whole row of
//    like-signed terms (768 steps at D 2048) would bias it low by parts in
//    1e5, so each chunk's sum is added to the running one with a rounded
//    add. Where D <= 8, one step, the summation bound that the plain
//    version is held to (D * 2^-24 * sum |q_d c_d|) is tighter than the
//    split's error, so each value is split exactly into three TF32 pieces
//    and the six products with i + j <= 2 are taken, small first (the
//    narrow and gathered scorers sum in f64 there instead). The pieces are
//    TF32 values, whose denormals step by 2^-136, and the low piece of an
//    entry below about 2^-115 would lie there and lose its bits (the plain
//    version does not). So every product is taken 2^12 times larger: a
//    piece below the leading one enters scaled by 2^12 (the corpus's as
//    b_j * 2^12, the query's as a_i * 2^12 against the corpus's leading
//    piece), which keeps it normal for any normal entry, and each chunk's
//    sum is scaled back by 2^-12 in the fused add to the running sum.
//    Powers of two change no rounding, so entries of ordinary size give
//    the same bits as without the scale; sums past about 2^116 would
//    overflow. mma.sync is not the card's full tensor-core rate: on an
//    H100 at 700 W it issued 268-291 TFLOP/s of TF32 and about 1225 TOP/s
//    of s8 with 8 warps an SM (tools/mma_rate.py).
//  * Lists (the gathered and merge kernels): one running top-k list
//    per query ordered by score descending, ties to the lower id. For k <=
//    32 the list lives in lanes 0..k-1. For larger k it lives in memory,
//    shifted in parallel by the warp 32 entries at a time, with the k-th
//    entry cached in registers so a candidate that cannot enter costs one
//    compare: in shared memory while the block's lists fit, else in the
//    query's slice of the output in device memory, whose every access waits
//    on L2. A ballot finds the candidates that beat the current k-th entry,
//    and each is inserted in turn; in a lane list, a chunk of 32 with more
//    than four such (a list's first chunk, a run of sorted lists) is
//    sorted and merged with the list in one bitonic pass instead.
//  * gathered_tiles_kernel<kMem>: the wrapper cuts each query's valid
//    candidate positions into pieces, runs of consecutive table rows cut
//    again at 128-row tiles (an ivfflat probe's list is one run, so a
//    piece is a whole tile of it), and sorts them by tile. A block takes
//    one tile and up to 32 of its pieces (a tile probed by more queries
//    gets more blocks) and scores them as the narrow scorer does: the
//    tile's rows on the MMA's M side (one m16 tile a warp), the pieces'
//    query rows on N, rounded up to the n8 tiles that hold them, so a
//    block of 1-8 pieces (a serving tick's, a RAG call's) pays one n8
//    tile, not four; narrow_chunk's 3xTF32 products over the same ring
//    of 128-byte chunks (4 stages, cp.async, 144-byte rows for ldmatrix;
//    the query rows staged through the pieces' query map, only the 8 nt
//    a block holds), or f64 sums on the CUDA cores where D <= kExactDepth
//    (narrow_exact). Two blocks an SM. The sums then go to shared
//    memory, and each warp offers a piece's rows, as (score, position),
//    to a list of min(k, length) entries (lanes for k <= 32, else shared
//    memory), written to the piece's slot in its query's row of the
//    partials. A query's slots fill its row's first row_len entries and
//    nothing else is written; the merge reads only those. Lists key on
//    the position, so the merge's (score desc, key asc) order is the
//    reference's earliest-position rule; the wrapper maps positions to
//    ids.
//  * gathered pieces (gathered_piece_count, gathered_piece_emit): the cut
//    itself, two passes over the (Q, C) slots, a block a (query, 8192-slot
//    chunk) and a 32-slot run a thread. The count pass flags piece starts
//    and stray rows and its last block scans the counts into each chunk's
//    first piece number (the host reads the total, the flag and the most
//    a query has: the one host read, which sizes the outputs); the emit
//    pass writes each piece at its number (an end closes the piece of the
//    last start at or before it), then a block a query turns the ends
//    into lengths and scans the kept min(k, length) into slot offsets and
//    row lengths. The wrapper's stable sort by tile follows.
//  * topk_merge_kernel: the wrapper's plan (ops.merge_plan, from the rows,
//    their width and k) cuts each row into segments so that rows times
//    segments come near 8 warps on each of the 132 SMs (one segment where
//    rows are already many, or short): a warp takes a segment's top k
//    (rounds of 4 entries a lane, the next round loaded while this one is
//    offered; a chunk with many winners sorted and merged with the list at
//    once), writes it to scratch, and the row's last segment to
//    finish (an atomic count) merges the row's lists. The order (score
//    desc, id asc) is total, so the result does not depend on the cut. One
//    warp walking a whole row of 16,672 entries (the gathered search at one
//    query) took 0.23 ms, each 32 entries a round trip to memory. For the
//    gathered kernels the ids are positions; the merge writes the
//    position's id from cand_ids (-1 where the score is not finite), and
//    for the pieces path reads the first row_len entries of each row.
//  * gathered_runs_kernel (Q <= kGNQMax, the wrapper's cutoff): a block a
//    (query, run of 128 consecutive slots); ivfflat's slots are lists of
//    consecutive rows, so a run's valid rows are nearly always one range
//    and their loads coalesce. The valid slots are compacted, their rows
//    streamed 32 at a time through a 4-stage cp.async ring and scored with
//    f32 FMAs; warp 0 keeps the run's top k by (score, position). The grid
//    and the partial buffer are fixed by (Q, C), so no host read comes
//    before the launches: a stray row sets a device flag, which the
//    wrapper reads after the merge is queued. At one query each row is
//    read once by the one query that probes it, so the pieces' tile
//    sharing buys nothing there, while the pieces path's host read, sort
//    and block list cost more than the tile products.
//  * narrow_scores<In, kExact, kQT> (topk_narrow_scores, Q <= kNQMax;
//    topk_narrow_scores_int8, its s8 form, Q <= kNQInt8): the
//    operands' roles swap, corpus rows on the MMA's M side and the queries,
//    rounded up to 8 kQT (8, 16, 32 or 64), on its N side, so the products
//    cost the real queries only. One block of 8 warps an SM walks a run of
//    256-row tiles (32 rows, two m16 tiles, a warp) through a ring of 4
//    stages of 128-byte chunks of the tile's rows and of every query
//    (cp.async, 144-byte rows for ldmatrix). f32: the 3xTF32 products
//    (above) in their order, a query fragment split once for both row
//    tiles and each product issued for all 2 kQT accumulators before the
//    next; D <= kExactDepth: the dots summed in f64 on the CUDA cores
//    (exact products, one rounding), since the MMA truncates as it adds
//    and a sum of so few terms has no room for that. int8 codes
//    (narrow_scores<signed char, ...>, Q <= kNQInt8): one m16n8k32 s8 MMA
//    a (row tile, query tile) and 32-code step, four a 128-byte chunk,
//    exact int32 sums, each keyed as the f32 it rounds to (the reference
//    ranks int32.astype(float32), and at D 2048 |dot| passes 2^24, so
//    distinct dots can share an f32 and then go to the lowest id). At the
//    int8 serving tick (Q 32, N 1M, D 768) the codes are 805 MB against
//    134 MB of keys written and read again, and the s8 products 0.04 ms.
//    Each score leaves as its order key (f32_key: larger score, larger
//    unsigned key; -0.0 is +0.0, -inf the least number), Q N 4 bytes
//    against the corpus's N D 4 (or N D codes), with each tile's largest
//    key.
//  * narrow_select (topk_narrow_select): one cooperative launch (its blocks
//    co-resident, so a grid-wide barrier works) of (query, chunk) items, an
//    exact radix select over the keys, no list kept anywhere: a floor from
//    the tile maxima (the bin of the k-th largest maximum: k distinct rows
//    lie at or above it, so the k-th best key does), then a count of the
//    keys at or above it by their top 11 bits that also gathers them; where
//    they number no more than kSortK, one block a query sorts them (a
//    bitonic network in shared memory) and keeps k. Else two more digits
//    (11 and 10 bits) fix T, the k-th best key; where more keys equal T
//    than the list has room for, each item counts its ties and the collect
//    keeps the lowest ids by those counts' prefix; the k survivors are
//    sorted by (key desc, id asc), in shared memory up to kSortK, else by
//    the whole grid in device memory. Histograms are shared-memory counts
//    (lanes with one bin add once, __match_any_sync) added to a query's
//    device histogram; the item that finishes a pass last reads it. Every
//    count is order-free, so the result does not depend on the hardware's
//    order. At Q 1, N 1M, k 100 a block takes one item of 8192 keys (1024
//    a warp) a pass, and the sort a few hundred gathered keys.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegK = 32;      // largest k whose list fits in warp lanes
constexpr int kSmemK = 96;     // largest k whose lists fit in shared memory
constexpr int kMergeWarps = 8;  // warps a block of the merge
constexpr int kMergeVec = 4;    // entries a merge lane loads before offering
constexpr int kWarps = kThreads / 32;

#include "topk_lists.cuh"

// ---- tensor-core tiles of the narrow and gathered kernels -----------------

constexpr int kDChunk = 128;             // bytes of a row staged per step
constexpr int kDRow = kDChunk + 16;      // padded staged row (bytes)
constexpr int kExactDepth = 8;           // f32: D at most one MMA deep

// 16 bytes from gmem to smem, the last 16 - bytes of them zeros.
__device__ __forceinline__ void cp_async_zfill(unsigned char* smem,
                                               const unsigned char* gmem,
                                               int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage bytes [ch * kDChunk, +kDChunk) of kRowsA rows of a from row a0
// (then kRowsB rows of b from row b0) into `stage`, rows kDRow bytes
// apart, zeros past na (nb) and the rows' row_bytes. kMapB: b's staged
// row x is b_map[x] (-1: zeros) for x < nb, and rows x >= nb are left as
// they are. vec: rows 16-byte aligned, row_bytes % 16 == 0. The narrow
// scorer stages its corpus rows, then the queries; the gathered kernel its
// tile's table rows, then its pieces' query rows.
template <int kRowsA, int kRowsB, bool kMapB = false>
__device__ __forceinline__ void stage_rows(unsigned char* stage,
                                           const unsigned char* a,
                                           const unsigned char* b, int a0,
                                           int b0, int na, int nb,
                                           long long row_bytes, int ch,
                                           int vec,
                                           const int* b_map = nullptr) {
  constexpr int kCopies = (kRowsA + kRowsB) * (kDChunk / 16);
  const int tid = threadIdx.x;
  const long long c0 = static_cast<long long>(ch) * kDChunk;
  if constexpr (kMapB) {
    // b's rows through the map: staged row x < nb is b_map[x] (-1: zeros)
    for (int e = tid; e < (kRowsA + nb) * (kDChunk / 16); e += kThreads) {
      const int r = e / (kDChunk / 16), piece = e % (kDChunk / 16);
      const long long off = c0 + piece * 16;
      const bool is_a = r < kRowsA;
      const int row = is_a ? (a0 + r < na ? a0 + r : -1) : b_map[r - kRowsA];
      if (vec) {
        const bool ok = row >= 0 && off < row_bytes;
        cp_async_zfill(stage + r * kDRow + piece * 16,
                       ok ? (is_a ? a : b) + row * row_bytes + off : a,
                       ok ? 16 : 0);
        continue;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {            // 4-byte words, as below
        const long long x = off + 4 * w;
        unsigned word = 0;
        if (row >= 0) {
          const unsigned char* src = (is_a ? a : b) + row * row_bytes + x;
          if (x + 4 <= row_bytes &&
              reinterpret_cast<unsigned long long>(src) % 4 == 0) {
            word = *reinterpret_cast<const unsigned*>(src);
          } else {
#pragma unroll
            for (int y = 0; y < 4; ++y)
              if (x + y < row_bytes) word |= unsigned(src[y]) << (8 * y);
          }
        }
        *reinterpret_cast<unsigned*>(stage + r * kDRow + piece * 16 + 4 * w) =
            word;
      }
    }
    return;
  }
  if (vec) {
#pragma unroll
    for (int p = 0; p < (kCopies + kThreads - 1) / kThreads; ++p) {
      const int e = tid + p * kThreads;
      if (kCopies % kThreads != 0 && e >= kCopies) break;
      const int r = e / (kDChunk / 16), piece = e % (kDChunk / 16);
      const long long off = c0 + piece * 16;
      const bool is_a = r < kRowsA;
      const int row = is_a ? a0 + r : b0 + r - kRowsA;
      const unsigned char* base = is_a ? a : b;
      const bool ok = row < (is_a ? na : nb) && off < row_bytes;
      cp_async_zfill(stage + r * kDRow + piece * 16,
                     ok ? base + row * row_bytes + off : base, ok ? 16 : 0);
    }
  } else {
    for (int w = tid; w < (kRowsA + kRowsB) * (kDChunk / 4); w += kThreads) {
      const int r = w / (kDChunk / 4), x = (w % (kDChunk / 4)) * 4;
      const bool is_a = r < kRowsA;
      const int row = is_a ? a0 + r : b0 + r - kRowsA;
      unsigned word = 0;
      if (row < (is_a ? na : nb)) {
        const unsigned char* src =
            (is_a ? a : b) + row * row_bytes + c0 + x;
        if (c0 + x + 4 <= row_bytes &&
            reinterpret_cast<unsigned long long>(src) % 4 == 0) {
          word = *reinterpret_cast<const unsigned*>(src);
        } else {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (c0 + x + y < row_bytes) word |= unsigned(src[y]) << (8 * y);
        }
      }
      *reinterpret_cast<unsigned*>(stage + r * kDRow + x) = word;
    }
  }
}

// ---- the merge: a row's entries cut into segments over the card -----------

// An entry's id as the merge writes it: with a map (the gathered wrappers'
// cand_ids row; the entries' ids are candidate positions), the position's
// id, or -1 where the score is not finite; else the id itself.
__device__ __forceinline__ int merge_id(float s, int id, const int* map) {
  if (!map) return id;
  return isfinite(s) ? map[id] : -1;
}

// The top k of entries [lo, hi) of s/id by (score desc, id asc), into
// out_s/out_i [k] (ids through map where given). A round loads kMergeVec
// entries 32 apart a lane, the next round's before this round's are
// offered, so that loads overlap the offers. kCg: the entries were written
// by other blocks in this launch (read through L2). The list lives in
// lanes (!kMem), in the warp's slot of
// shared memory (smem) or in out_s/out_i itself.
template <bool kMem, bool kCg>
__device__ void merge_range(const float* s, const int* id, int lo, int hi,
                            int k, float* out_s, int* out_i, const int* map,
                            bool smem, int slot, int lane) {
  float ls = -CUDART_INF_F;
  int li = -1;
  MemList ml;
  if (kMem) mem_place(ml, smem, slot, out_s, out_i, k, lane);
  // the next round's entries are loaded before this round's are offered
  float vs[kMergeVec], ns[kMergeVec];
  int vi[kMergeVec], ni[kMergeVec];
  auto load = [&](int b, float (&ts)[kMergeVec], int (&ti)[kMergeVec]) {
#pragma unroll
    for (int j = 0; j < kMergeVec; ++j) {
      const int e = b + 32 * j + lane;
      ts[j] = -CUDART_INF_F;
      ti[j] = -1;
      if (e < hi) {
        ts[j] = kCg ? __ldcg(s + e) : s[e];
        ti[j] = kCg ? __ldcg(id + e) : id[e];
      }
    }
  };
  load(lo, vs, vi);
  for (int b = lo; b < hi; b += 32 * kMergeVec) {
    if (b + 32 * kMergeVec < hi) load(b + 32 * kMergeVec, ns, ni);
#pragma unroll
    for (int j = 0; j < kMergeVec; ++j) {
      if (b + 32 * j >= hi) break;                   // uniform in the warp
      if (kMem)
        mem_offer(ml, vs[j], vi[j], k, lane);
      else
        reg_offer(ls, li, vs[j], vi[j], k, lane);
    }
#pragma unroll
    for (int j = 0; j < kMergeVec; ++j) {
      vs[j] = ns[j];
      vi[j] = ni[j];
    }
  }
  if (!kMem) {
    if (lane < k) {
      out_s[lane] = ls;
      out_i[lane] = merge_id(ls, li, map);
    }
  } else if (smem) {
    for (int p = lane; p < k; p += 32) {
      const float sp = ml.s[p];
      out_s[p] = sp;
      out_i[p] = merge_id(sp, ml.i[p], map);
    }
  } else if (map) {                 // the list is out_s/out_i: map in place
    for (int p = lane; p < k; p += 32) out_i[p] = merge_id(ml.s[p], ml.i[p],
                                                           map);
  }
}

// Warp w of the grid takes segment w % n_seg of row w / n_seg: entries
// [seg * (w % n_seg), + seg) of the row's first len (row_len[q] where
// given, else width). With one segment a row it writes the row's top k to
// out. Else it writes its segment's top k (k < seg) to seg_s/seg_i [nq,
// n_seg, k], and the row's last segment to finish (counted in done[q],
// zeroed before the launch) merges the row's n_seg lists into out.
template <bool kMem>
__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i,
                  const int* __restrict__ row_len,
                  const int* __restrict__ cand_ids, float* out_s, int* out_i,
                  float* seg_s, int* seg_i, int* done, int nq, int width,
                  int k, int c, int seg, int n_seg, int smem_lists) {
  const int lane = threadIdx.x & 31, slot = threadIdx.x >> 5;
  const long long gw = static_cast<long long>(blockIdx.x) * kMergeWarps + slot;
  if (gw >= static_cast<long long>(nq) * n_seg) return;  // uniform
  const int qi = static_cast<int>(gw / n_seg);
  const int sg = static_cast<int>(gw % n_seg);
  const long long row = static_cast<long long>(qi) * width;
  const long long orow = static_cast<long long>(qi) * k;
  const int* map = cand_ids ? cand_ids + static_cast<long long>(qi) * c
                            : nullptr;
  const int len = row_len ? min(row_len[qi], width) : width;
  if (n_seg == 1) {
    merge_range<kMem, false>(part_s + row, part_i + row, 0, len, k,
                             out_s + orow, out_i + orow, map, smem_lists,
                             slot, lane);
    return;
  }
  const long long lo = static_cast<long long>(sg) * seg;
  const int hi = static_cast<int>(min(static_cast<long long>(len), lo + seg));
  merge_range<kMem, false>(part_s + row, part_i + row,
                           static_cast<int>(min(lo, static_cast<long long>(
                               len))), hi, k, seg_s + gw * k, seg_i + gw * k,
                           nullptr, smem_lists, slot, lane);
  __threadfence();                  // the list is visible before the count
  __syncwarp();                     // every lane's part fenced before it
  int last = 0;
  if (lane == 0) last = atomicAdd(done + qi, 1) == n_seg - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  const long long first = static_cast<long long>(qi) * n_seg * k;
  merge_range<kMem, true>(seg_s + first, seg_i + first, 0, n_seg * k, k,
                          out_s + orow, out_i + orow, map, smem_lists, slot,
                          lane);
}

// ---- narrow: few queries (topk_narrow_scores, topk_narrow_select) ----------

constexpr int kNQMax = 64;               // most queries the narrow path takes
constexpr int kNQInt8 = 64;              // the int8 cutoff: most int8 queries
                                         // the narrow path takes
constexpr int kNRows = 256;              // corpus rows a tile: 8 warps x 2 m16
constexpr int kNStages = 4;              // ring stages: 3 steps prefetched
constexpr int kKeyAlign = 8;             // a key row's stride: n rounded up
constexpr int kSelThreads = 256;
constexpr int kSelVec = 8;               // keys a thread loads a step
constexpr int kRadixBins = 2048;         // 11-bit digits (the last 10 bits)
constexpr int kStateInts = 11;           // a query's select state, below
constexpr int kSortK = 4096;             // largest list sorted in shared memory

// A score's order key: a larger score has a larger key; -0.0 takes +0.0's
// key and -inf the least key of any number.
__device__ __forceinline__ unsigned f32_key(float x) {
  unsigned b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float key_f32(unsigned key) {
  return __uint_as_float(key & 0x80000000u ? key & 0x7fffffffu : ~key);
}

// (ka, ia) before (kb, ib): higher key, or equal key and lower id.
__device__ __forceinline__ bool key_beats(unsigned ka, int ia, unsigned kb,
                                          int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2],
                                            unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The warp's 16 kM corpus rows (kM m16 tiles) x 8 kQT queries over one
// staged chunk: `steps` MMA steps, A for tile m from a_addr + m * 16
// rows, B for query n8 tiles 2p and 2p + 1 from b_addr + p * 16 rows;
// only the first nt n8 tiles are taken (the gathered kernel's blocks hold
// 1-kQT of them; the narrow scorer passes kQT). The 3xTF32 products
// (above) in their order with the query pieces on the MMA's N side: query pieces
// q0, q1 (hi, lo) and corpus pieces c0, c1, the products c0 * q1, c1 * q0
// and c0 * q0 each taken kLoScale times larger, the scale on a low piece
// where the product has one (q1, c1), else on c0; each chunk's sum is
// added to the running one with a rounded add. A query fragment is split
// once for all row tiles.
template <int kM, int kQT>
__device__ __forceinline__ void narrow_chunk(float (&acc)[kM][kQT][4],
                                             unsigned a_addr,
                                             unsigned b_addr, int steps,
                                             int nt = kQT) {
  float part[kM][kQT][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDChunk / 32; ++kk) {
    if (kk >= steps) break;                       // uniform: past d
    // tile m's corpus pieces: c0, c0 * kLoScale, c1 * kLoScale
    unsigned c0[kM][4], c0s[kM][4], c1s[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      unsigned raw[4];
      ldmatrix_x4(raw, a_addr + m * 16 * kDRow + kk * 32);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        unsigned p[2];
        tf32_split<2>(p, raw[r]);
        c0[m][r] = p[0];
        c0s[m][r] = __float_as_uint(__uint_as_float(p[0]) * kLoScale);
        c1s[m][r] = __float_as_uint(__uint_as_float(p[1]) * kLoScale);
      }
    }
    // tile j's query pieces: q0 and q1 * kLoScale, b0/b1 the fragment's
    // two registers (tiles 2jp and 2jp + 1 from one ldmatrix, .x2 where
    // kQT == 1)
    unsigned q0b0[kQT], q0b1[kQT], q1b0[kQT], q1b1[kQT];
#pragma unroll
    for (int jp = 0; jp < (kQT + 1) / 2; ++jp) {
      if (2 * jp >= nt) break;                    // uniform in the block
      unsigned braw[4];
      if (kQT == 1) {
        unsigned r2[2];
        ldmatrix_x2(r2, b_addr + kk * 32);
        braw[0] = r2[0];
        braw[1] = r2[1];
        braw[2] = braw[3] = 0u;
      } else {
        ldmatrix_x4(braw, b_addr + jp * 16 * kDRow + kk * 32);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * jp + h;
        if (j >= kQT) break;
        unsigned b0[2], b1[2];
        tf32_split<2>(b0, braw[2 * h]);
        tf32_split<2>(b1, braw[2 * h + 1]);
        q0b0[j] = b0[0];
        q0b1[j] = b1[0];
        q1b0[j] = __float_as_uint(__uint_as_float(b0[1]) * kLoScale);
        q1b1[j] = __float_as_uint(__uint_as_float(b1[1]) * kLoScale);
      }
    }
    // each product for every (m, j) accumulator before the next product,
    // so no MMA waits on the one before it
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < kQT; ++j)
        if (j < nt) mma_tf32(part[m][j], c0[m], q1b0[j], q1b1[j]);  // c0 q1
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < kQT; ++j)
        if (j < nt) mma_tf32(part[m][j], c1s[m], q0b0[j], q0b1[j]); // c1 q0
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < kQT; ++j)
        if (j < nt) mma_tf32(part[m][j], c0s[m], q0b0[j], q0b1[j]); // c0 q0
  }
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[m][j][e] = __fmaf_rn(part[m][j][e], kLoUnscale, acc[m][j][e]);
}

// int8 codes: the same geometry, one m16n8k32 s8 MMA a (row tile, query
// tile) and 32-code step, straight into the exact int32 sums.
template <int kM, int kQT>
__device__ __forceinline__ void narrow_chunk(int (&acc)[kM][kQT][4],
                                             unsigned a_addr,
                                             unsigned b_addr, int steps,
                                             int nt = kQT) {
#pragma unroll
  for (int kk = 0; kk < kDChunk / 32; ++kk) {
    if (kk >= steps) break;                       // uniform: past d
    unsigned a[kM][4], b0[kQT], b1[kQT];
#pragma unroll
    for (int m = 0; m < kM; ++m)
      ldmatrix_x4(a[m], a_addr + m * 16 * kDRow + kk * 32);
    // query tiles 2jp and 2jp + 1 from one ldmatrix, .x2 where kQT == 1
#pragma unroll
    for (int jp = 0; jp < (kQT + 1) / 2; ++jp) {
      if (2 * jp >= nt) break;                    // uniform in the block
      if constexpr (kQT == 1) {
        unsigned r2[2];
        ldmatrix_x2(r2, b_addr + kk * 32);
        b0[0] = r2[0];
        b1[0] = r2[1];
      } else {
        unsigned r4[4];
        ldmatrix_x4(r4, b_addr + jp * 16 * kDRow + kk * 32);
        b0[2 * jp] = r4[0];
        b1[2 * jp] = r4[1];
        b0[2 * jp + 1] = r4[2];
        b1[2 * jp + 1] = r4[3];
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < kQT; ++j)
        if (j < nt) mma_s8(acc[m][j], a[m], b0[j], b1[j]);
  }
}

// The same scores where D <= kExactDepth (one chunk, one MMA step deep):
// each (row, query) dot of at most 8 products summed in f64 on the CUDA
// cores from the staged rows at `stage` (kWarps * 16 kM rows, then the
// queries), where an f32 product is exact, then rounded once to f32.
// Split TF32 products would be exact too, but the MMA truncates as it
// adds them, which can put a sum of so few terms more than D * 2^-24 *
// sum |q c| from the plain f32 product. Lane (g, t) of warp w holds rows
// 16 kM w + g + 8x (x < 2 kM) against queries 8j + 2t + b, j < nt.
template <int kM, int kQT>
__device__ __forceinline__ void narrow_exact(float (&acc)[kM][kQT][4],
                                             const unsigned char* stage,
                                             int warp, int g, int t,
                                             int nt = kQT) {
  constexpr int kRowsA = kWarps * 16 * kM;
  double cr[2 * kM][kExactDepth];
#pragma unroll
  for (int x = 0; x < 2 * kM; ++x) {
    const float4* r = reinterpret_cast<const float4*>(
        stage + (16 * kM * warp + g + 8 * x) * kDRow);
    const float4 u = r[0], v = r[1];
    const float f[kExactDepth] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < kExactDepth; ++i) cr[x][i] = f[i];
  }
#pragma unroll
  for (int j = 0; j < kQT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float4* r = reinterpret_cast<const float4*>(
          stage + (kRowsA + 8 * j + 2 * t + b) * kDRow);
      const float4 u = r[0], v = r[1];
      const float f[kExactDepth] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int x = 0; x < 2 * kM; ++x) {
        double sum = 0.0;
#pragma unroll
        for (int i = 0; i < kExactDepth; ++i)
          sum = __fma_rn(cr[x][i], static_cast<double>(f[i]), sum);
        acc[x >> 1][j][2 * (x & 1) + b] = __double2float_rn(sum);
      }
    }
  }
}

// q [nq, d] (nq <= 8 kQT) and c [n, d] of type In (f32, or int8 codes).
// Block b scores the corpus tiles [b tiles_per_block, +tiles_per_block)
// against every query and writes each score's order key to keys[query *
// ldk + row] and each tile's largest to tile_max[query * n_tiles + tile].
// An int8 dot is exact in int32 and keyed as the f32 it rounds to, as the
// reference ranks it. First the grid zeroes scratch[0, scratch_ints): the
// select kernel's counters.
template <typename In, bool kExact, int kQT>
__global__ void __launch_bounds__(kThreads, 1)
narrow_scores(const In* __restrict__ q, const In* __restrict__ c,
              unsigned* __restrict__ keys, unsigned* __restrict__ tile_max,
              int* __restrict__ scratch, long long scratch_ints, int nq,
              int n, int d, int ldk, int tiles_per_block, int vec) {
  constexpr int kNQ = 8 * kQT;
  constexpr int kStage = (kNRows + kNQ) * kDRow;
  static_assert(kNRows == kWarps * 32, "two m16 row tiles a warp");
  extern __shared__ __align__(128) unsigned char nsm[];
  __shared__ unsigned warp_max[kWarps][kNQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + tid;
       e < scratch_ints; e += static_cast<long long>(gridDim.x) * kThreads)
    scratch[e] = 0;
  const int n_tiles = (n + kNRows - 1) / kNRows;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  const long long row_bytes = static_cast<long long>(d) * sizeof(In);
  // D = 0 still takes one (empty) chunk, so every tile writes its keys
  const int n_chunks =
      max(1, static_cast<int>((row_bytes + kDChunk - 1) / kDChunk));
  const int steps = max(t_end - t_begin, 0) * n_chunks;
  const auto* qb = reinterpret_cast<const unsigned char*>(q);
  const auto* cb = reinterpret_cast<const unsigned char*>(c);
  using Acc = typename DenseAcc<In>::T;
  Acc acc[2][kQT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = Acc(0);
  // this lane's ldmatrix row: A rows 32w + (lane & 7) + 8 * (lane >> 3 & 1)
  // at byte 16 * (lane >> 4); B rows kNRows + (lane & 7) + 8 * (lane >> 4)
  // at byte 16 * (lane >> 3 & 1) (.x2 reads lanes 0-15's only)
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(nsm));
  const int lr = lane & 7, lm = lane >> 3;
  const unsigned a_off =
      (32 * warp + lr + 8 * (lm & 1)) * kDRow + 16 * (lm >> 1);
  const unsigned b_off =
      (kNRows + lr + 8 * (lm >> 1)) * kDRow + 16 * (lm & 1);

  // the ring: step s stages chunk s % n_chunks of tile
  // t_begin + s / n_chunks, a group committed every step
#pragma unroll
  for (int s = 0; s < kNStages - 1; ++s) {
    if (s < steps)
      stage_rows<kNRows, kNQ>(nsm + s * kStage, cb, qb,
                              (t_begin + s / n_chunks) * kNRows, 0, n, nq,
                              row_bytes, s % n_chunks, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  int tile = t_begin, ch = 0;
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kNStages - 2));
    __syncthreads();   // step s has landed; step s - 1's stage is free
    const int ahead = s + kNStages - 1;
    if (ahead < steps)
      stage_rows<kNRows, kNQ>(nsm + ahead % kNStages * kStage, cb, qb,
                              (t_begin + ahead / n_chunks) * kNRows, 0, n,
                              nq, row_bytes, ahead % n_chunks, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    if constexpr (kExact) {
      narrow_exact<2, kQT>(acc, nsm + s % kNStages * kStage, warp, g, t);
    } else {
      const unsigned st = ring + s % kNStages * kStage;
      const long long left =
          row_bytes - static_cast<long long>(ch) * kDChunk;
      narrow_chunk<2, kQT>(acc, st + a_off, st + b_off,
                           static_cast<int>(min(left + 31, 128LL) / 32));
    }
    if (++ch < n_chunks) continue;
    // lane (g, t) holds rows 32w + 16m + g + 8h, queries 8j + 2t + b in
    // acc[m][j][2h + b]: each store writes 8 consecutive rows of 4
    // queries. Key 0 lies below every score's key: rows past n take it.
    const int n0 = tile * kNRows + 32 * warp + g;
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int qi = 8 * j + 2 * t + b;
        unsigned best = 0u;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = n0 + 16 * m + 8 * h;
            const unsigned key =
                f32_key(static_cast<float>(acc[m][j][2 * h + b]));
            acc[m][j][2 * h + b] = Acc(0);
            if (row < n) {
              best = max(best, key);
              if (qi < nq) keys[static_cast<long long>(qi) * ldk + row] = key;
            }
          }
        best = max(best, __shfl_xor_sync(kFull, best, 4));
        best = max(best, __shfl_xor_sync(kFull, best, 8));
        best = max(best, __shfl_xor_sync(kFull, best, 16));
        if (g == 0) warp_max[warp][qi] = best;
      }
    __syncthreads();
    if (tid < nq && tid < kNQ) {
      unsigned best = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) best = max(best, warp_max[w][tid]);
      tile_max[static_cast<long long>(tid) * n_tiles + tile] = best;
    }
    ch = 0;
    ++tile;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---- gathered: row tiles shared by the pieces that probe them --------------

constexpr int kGTR = 128;            // table rows a tile: 8 warps x one m16
constexpr int kGBQ = 32;             // pieces a block: up to four n8 tiles
constexpr int kGStage = (kGTR + kGBQ) * kDRow;     // bytes a ring stage
constexpr int kGStages = 4;          // ring stages: 3 steps prefetched
constexpr int kGMinBlocks = 2;       // blocks an SM holds
constexpr int kGSP = kGTR + 4;       // padded score row (floats): a warp's
                                     // stores of 4 pieces x 8 rows hit
                                     // 32 banks
constexpr int kPieceInts = 5;        // query, first row, length, first
                                     // position, slot offset in the query
static_assert(kGTR == kWarps * 16, "one m16 row tile a warp");
static_assert(kGBQ * kGSP * 4 + kWarps * 2 * kGTR * 4 <=
                  kGStages * kGStage, "scores and lists fit in the ring");

// One block per (row tile, up to kGBQ of the pieces that probe it): the
// pieces from blk_first[blockIdx.x] on, while they stay in its tile.
// pieces [n, 5] sorted by tile; part_s/part_i [nq, width]: piece j's
// top-min(k, length) (score, position) list goes to row query_j at
// column slot_j. The products as the narrow scorer takes them: the
// tile's rows on the MMA's M side (warp w: rows 16w..16w+15), the
// block's pieces' query rows on N, rounded up to the nt n8 tiles that
// hold them; 3xTF32 (narrow_chunk), or f64 on the CUDA cores where D <=
// kExactDepth (narrow_exact), over the staged ring of 128-byte chunks.
template <bool kMem>
__global__ void __launch_bounds__(kThreads, kGMinBlocks)
gathered_tiles_kernel(const float* __restrict__ q,
                      const float* __restrict__ table,
                      const int* __restrict__ pieces,
                      const int* __restrict__ blk_first, float* part_s,
                      int* part_i, int n, int r, int d, int k, int width,
                      int vec) {
  extern __shared__ __align__(128) unsigned char gsm[];
  __shared__ int p_q[kGBQ], p_lo[kGBQ], p_hi[kGBQ], p_pos[kGBQ], p_off[kGBQ];
  const int first = blk_first[blockIdx.x];
  if (first < 0) return;                           // uniform in the block
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile =
      pieces[static_cast<long long>(first) * kPieceInts + 1] / kGTR;
  const int row0 = tile * kGTR;
  bool mine = false;
  if (tid < kGBQ) {
    const int j = first + tid;
    const int* pc = pieces + static_cast<long long>(j) * kPieceInts;
    mine = j < n && pc[1] / kGTR == tile;
    if (mine) {
      p_q[tid] = pc[0];
      p_lo[tid] = pc[1] - row0;
      p_hi[tid] = pc[1] - row0 + pc[2];
      p_pos[tid] = pc[3];
      p_off[tid] = pc[4];
    } else {
      p_q[tid] = -1;
      p_lo[tid] = p_hi[tid] = 0;
    }
  }
  // the pieces fill the block's slots from 0: nt n8 tiles hold them
  const int nt = (__syncthreads_count(mine) + 7) / 8;

  const long long row_bytes = static_cast<long long>(d) * sizeof(float);
  const int n_chunks =
      max(1, static_cast<int>((row_bytes + kDChunk - 1) / kDChunk));
  const auto* qb = reinterpret_cast<const unsigned char*>(q);
  const auto* tb = reinterpret_cast<const unsigned char*>(table);
  float acc[1][kGBQ / 8][4];
#pragma unroll
  for (int j = 0; j < kGBQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  // this lane's ldmatrix row: A rows 16w + (lane & 7) + 8 * (lane >> 3 &
  // 1) at byte 16 * (lane >> 4); B rows kGTR + (lane & 7) + 8 * (lane >>
  // 4) at byte 16 * (lane >> 3 & 1)
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(gsm));
  const int lr = lane & 7, lm = lane >> 3;
  const unsigned a_off =
      (16 * warp + lr + 8 * (lm & 1)) * kDRow + 16 * (lm >> 1);
  const unsigned b_off = (kGTR + lr + 8 * (lm >> 1)) * kDRow + 16 * (lm & 1);
  // the narrow scorer's ring: step s stages chunk s of the tile's rows and
  // of the pieces' query rows (8 nt of them), a group committed every step
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < n_chunks)
      stage_rows<kGTR, kGBQ, true>(gsm + s * kGStage, tb, qb, row0, 0, r,
                                   8 * nt, row_bytes, s, vec, p_q);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < n_chunks; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kGStages - 2));
    __syncthreads();   // step s has landed; step s - 1's stage is free
    const int ahead = s + kGStages - 1;
    if (ahead < n_chunks)
      stage_rows<kGTR, kGBQ, true>(gsm + ahead % kGStages * kGStage, tb, qb,
                                   row0, 0, r, 8 * nt, row_bytes, ahead, vec,
                                   p_q);
    asm volatile("cp.async.commit_group;\n" ::);
    if (d <= kExactDepth) {                        // one chunk
      narrow_exact<1, kGBQ / 8>(acc, gsm + s % kGStages * kGStage, warp, g,
                                t, nt);
    } else {
      const unsigned st = ring + s % kGStages * kGStage;
      const long long left = row_bytes - static_cast<long long>(s) * kDChunk;
      narrow_chunk<1, kGBQ / 8>(acc, st + a_off, st + b_off,
                                static_cast<int>(min(left + 31, 128LL) / 32),
                                nt);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();     // every warp is done with the ring

  // the scores take the ring's place: lane (g, t) holds rows 16w + g + 8h
  // against pieces 8j + 2t + b in acc[0][j][2h + b]
  float* sc = reinterpret_cast<float*>(gsm);            // [kGBQ][kGSP]
#pragma unroll
  for (int j = 0; j < kGBQ / 8; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        sc[(8 * j + 2 * t + b) * kGSP + 16 * warp + g + 8 * h] =
            acc[0][j][2 * h + b];
  }
  __syncthreads();
  // each warp then offers a piece's rows, as (score, position), to a list
  // of min(k, length) entries, written to the piece's slots
  float* lists = sc + kGBQ * kGSP + warp * 2 * kGTR;
  for (int pj = warp; pj < kGBQ; pj += kWarps) {
    const int qi = p_q[pj];
    if (qi < 0) continue;                            // uniform in the warp
    const int lo = p_lo[pj], hi = p_hi[pj];
    const int kk = min(k, hi - lo);
    const int pos0 = p_pos[pj] - lo;
    const long long o = static_cast<long long>(qi) * width + p_off[pj];
    const float* row = sc + pj * kGSP;
    float ls = -CUDART_INF_F;
    int li = -1;
    MemList ml;
    if (kMem) {
      ml.s = lists;
      ml.i = reinterpret_cast<int*>(lists + kGTR);
      mem_init(ml, kk, lane);
    }
    for (int x0 = lo; x0 < hi; x0 += 32) {
      const int x = x0 + lane;
      const float sx = x < hi ? row[x] : -CUDART_INF_F;
      if (kMem)
        mem_offer(ml, sx, pos0 + x, kk, lane);
      else
        reg_offer(ls, li, sx, pos0 + x, kk, lane);
    }
    if (!kMem && lane < kk) {
      part_s[o + lane] = ls;
      part_i[o + lane] = li;
    } else if (kMem) {
      mem_store(ml, part_s + o, part_i + o, kk, lane);
    }
    __syncwarp();     // the list is reused by the warp's next piece
  }
}

// ---- gathered runs: few queries, each query's slots a run a block ----------

constexpr int kGNQMax = 12;          // the wrapper's cutoff: calls of at most
                                     // kGNQMax queries take gathered_runs
                                     // (the kernel takes any Q; on the
                                     // H100 it beat the pieces path at a
                                     // serving tick's Q 1-12, not at 16)
constexpr int kRunSlots = 128;       // slot positions a block (a run)
constexpr int kRunRows = 32;         // valid rows a step: 4 a warp
constexpr int kRunChunk = 512;       // bytes of each row a step: 16 a lane
constexpr int kRunStages = 4;        // ring stages: 3 steps prefetched
constexpr int kRunStage = kRunRows * kRunChunk;    // bytes a ring stage
static_assert(kRunRows == kWarps * 4, "four rows a warp");
static_assert(kRunChunk == 32 * 16, "16 bytes of a row a lane");
static_assert(kRunSlots <= kThreads && kRunSlots % 32 == 0,
              "a thread a slot, whole warps");

// One block per (run, query): slot positions [run * kRunSlots, + kRunSlots)
// of query blockIdx.y's row of rows/ids [nq, c]. The block reads the run's
// ids and rows, keeps its valid slots (id >= 0) in position order, and
// streams their rows, kRunRows at a time, through a ring of kRunStages
// stages of kRunChunk bytes a row (cp.async, zeros past the row's end),
// each row scored against the query with f32 FMAs on the CUDA cores (at a
// few queries a row is used once: half a flop a byte, so the tensor cores
// buy nothing). A valid slot whose row lies outside [0, r) is never read:
// it sets *stray and is left out. Warp 0 then offers the scores, as
// (score, position), to a list of kk = min(k, kRunSlots) entries (lanes
// for kk <= 32, else shared memory), written to columns [run * kk, + kk)
// of row query of part_s/part_p [nq, width]; a list with fewer entries
// is padded with (-inf, -1).
template <bool kMem>
__global__ void __launch_bounds__(kThreads)
gathered_runs_kernel(const float* __restrict__ q,
                     const float* __restrict__ table,
                     const int* __restrict__ rows,
                     const int* __restrict__ ids, float* part_s, int* part_p,
                     int* stray, int c, int r, int d, int k, int width,
                     int vec) {
  extern __shared__ __align__(128) unsigned char rsm[];
  __shared__ int v_row[kRunSlots], v_pos[kRunSlots], warp_n[kRunSlots / 32];
  __shared__ float v_s[kRunSlots];
  __shared__ float l_s[kMem ? kRunSlots : 1];
  __shared__ int l_i[kMem ? kRunSlots : 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int run = blockIdx.x, qi = blockIdx.y;
  const int p0 = run * kRunSlots;
  const long long srow = static_cast<long long>(qi) * c;
  // the run's valid slots, in position order
  bool ok = false, bad = false;
  int row = 0;
  if (tid < kRunSlots && p0 + tid < c && ids[srow + p0 + tid] >= 0) {
    row = rows[srow + p0 + tid];
    bad = row < 0 || row >= r;
    ok = !bad;
  }
  if (bad) *stray = 1;
  const unsigned m = __ballot_sync(kFull, ok);
  if (tid < kRunSlots && lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  int nv = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kRunSlots / 32; ++w) {
    before += w < warp ? warp_n[w] : 0;
    nv += warp_n[w];
  }
  if (ok) {
    const int x = before + __popc(m & ((1u << lane) - 1u));
    v_row[x] = row;
    v_pos[x] = p0 + tid;
  }
  __syncthreads();

  const long long row_bytes = static_cast<long long>(d) * sizeof(float);
  const int n_chunks =
      max(1, static_cast<int>((row_bytes + kRunChunk - 1) / kRunChunk));
  const int steps = (nv + kRunRows - 1) / kRunRows * n_chunks;
  const auto* tb = reinterpret_cast<const unsigned char*>(table);
  const float* qrow = q + static_cast<long long>(qi) * d;
  // step s: chunk s % n_chunks of valid rows [32 (s / n_chunks), + 32)
  auto stage = [&](int s) {
    unsigned char* st = rsm + (s % kRunStages) * kRunStage;
    const int x0 = s / n_chunks * kRunRows;
    const long long c0 = static_cast<long long>(s % n_chunks) * kRunChunk;
    if (vec) {
#pragma unroll
      for (int p = 0; p < kRunStage / 16 / kThreads; ++p) {
        const int e = tid + p * kThreads;
        const int rr = e / (kRunChunk / 16), piece = e % (kRunChunk / 16);
        if (x0 + rr >= nv) continue;
        const long long off = c0 + piece * 16;
        const bool in = off < row_bytes;
        cp_async_zfill(st + rr * kRunChunk + piece * 16,
                       in ? tb + v_row[x0 + rr] * row_bytes + off : tb,
                       in ? 16 : 0);
      }
    } else {
      for (int w = tid; w < kRunRows * (kRunChunk / 4); w += kThreads) {
        const int rr = w / (kRunChunk / 4);
        if (x0 + rr >= nv) continue;
        const long long e = c0 / 4 + w % (kRunChunk / 4);
        reinterpret_cast<float*>(st)[w] =
            e < d ? table[static_cast<long long>(v_row[x0 + rr]) * d + e]
                  : 0.f;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kRunStages - 1; ++s) {
    if (s < steps) stage(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRunStages - 2));
    __syncthreads();   // step s has landed; step s - 1's stage is free
    if (s + kRunStages - 1 < steps) stage(s + kRunStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const int x0 = s / n_chunks * kRunRows;
    const int ch = s % n_chunks;
    // this lane's four query values (zeros past d)
    const long long e0 = static_cast<long long>(ch) * (kRunChunk / 4) +
                         4 * lane;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec && e0 < d) {
      qv = __ldg(reinterpret_cast<const float4*>(qrow + e0));
    } else if (!vec) {
      qv.x = e0 < d ? __ldg(qrow + e0) : 0.f;
      qv.y = e0 + 1 < d ? __ldg(qrow + e0 + 1) : 0.f;
      qv.z = e0 + 2 < d ? __ldg(qrow + e0 + 2) : 0.f;
      qv.w = e0 + 3 < d ? __ldg(qrow + e0 + 3) : 0.f;
    }
    const unsigned char* st = rsm + (s % kRunStages) * kRunStage;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = 4 * warp + j;
      if (x0 + rr >= nv) break;                      // uniform in the warp
      const float4 t =
          *reinterpret_cast<const float4*>(st + rr * kRunChunk + 16 * lane);
      acc[j] = __fmaf_rn(qv.x, t.x, acc[j]);
      acc[j] = __fmaf_rn(qv.y, t.y, acc[j]);
      acc[j] = __fmaf_rn(qv.z, t.z, acc[j]);
      acc[j] = __fmaf_rn(qv.w, t.w, acc[j]);
    }
    if (ch == n_chunks - 1) {        // the rows are whole: sum the lanes
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        if (lane == 0 && x0 + 4 * warp + j < nv) v_s[x0 + 4 * warp + j] = v;
        acc[j] = 0.f;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();     // every score is in v_s
  if (warp != 0) return;
  const int kk = min(k, kRunSlots);
  const long long o = static_cast<long long>(qi) * width +
                      static_cast<long long>(run) * kk;
  float ls = -CUDART_INF_F;
  int li = -1;
  MemList ml;
  if (kMem) {
    ml.s = l_s;
    ml.i = l_i;
    mem_init(ml, kk, lane);
  }
  for (int x0 = 0; x0 < nv; x0 += 32) {
    const int x = x0 + lane;
    const float sx = x < nv ? v_s[x] : -CUDART_INF_F;
    const int px = x < nv ? v_pos[x] : -1;
    if (kMem)
      mem_offer(ml, sx, px, kk, lane);
    else
      reg_offer(ls, li, sx, px, kk, lane);
  }
  if (!kMem) {
    if (lane < kk) {
      part_s[o + lane] = ls;
      part_p[o + lane] = li;
    }
  } else {
    mem_store(ml, part_s + o, part_p + o, kk, lane);
  }
}

// ---- the select: an exact radix select of each query's k best keys --------

// Every block of the (cooperatively launched, so co-resident) grid waits
// here until all have arrived; bar[0] counts arrivals, bar[1] is the
// generation. Writes before it are seen after it by every block.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned seen = *gen;       // read before arriving: it moves only
    __threadfence();                  // once every block has arrived
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      // a grid that is not co-resident would wait forever: fail the
      // launch after some seconds instead (a barrier takes microseconds)
      for (long long spins = 0; *gen == seen; ++spins) {
        __nanosleep(64);
        if (spins > (1LL << 26)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Sum of v over the lanes below this one; `total` over the warp.
__device__ __forceinline__ unsigned warp_excl_scan(unsigned v,
                                                   unsigned& total) {
  const int lane = threadIdx.x & 31;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  total = __shfl_sync(kFull, x, 31);
  return x - v;
}

// Sum of v over the block's threads below this one; `total` over the
// block. Every thread of the block calls it.
__device__ __forceinline__ unsigned block_excl_scan(unsigned v,
                                                    unsigned& total) {
  __shared__ unsigned warp_sums[kSelThreads / 32];
  const int warp = threadIdx.x >> 5;
  unsigned wt;
  const unsigned before = warp_excl_scan(v, wt);
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = wt;
  __syncthreads();
  unsigned below = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kSelThreads / 32; ++w) {
    const unsigned s = warp_sums[w];
    below += w < warp ? s : 0u;
    total += s;
  }
  __syncthreads();                    // warp_sums is written again next call
  return below + before;
}

// Of kRadixBins counts h (in device memory, written by other blocks, when
// kGlobal), the bin where the running count from the top first reaches
// rem: true in the one thread that finds it, with the bin, the count of
// the bins above it and its own count; false in every thread where all
// bins together hold fewer than rem. `total`: all bins' count, in every
// thread. Every thread of the block calls it.
template <bool kGlobal>
__device__ __forceinline__ bool find_bin(const unsigned* h, unsigned rem,
                                         int& bin, unsigned& above,
                                         unsigned& count, unsigned& total) {
  constexpr int kPer = kRadixBins / kSelThreads;
  const int top = kRadixBins - kPer * threadIdx.x;  // bins [top - kPer, top)
  unsigned cnt[kPer], sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    cnt[i] = kGlobal ? __ldcg(h + top - 1 - i) : h[top - 1 - i];
    sum += cnt[i];
  }
  above = block_excl_scan(sum, total);
  if (!(above < rem && rem <= above + sum)) return false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (rem <= above + cnt[i]) {
      bin = top - 1 - i;
      count = cnt[i];
      return true;
    }
    above += cnt[i];
  }
  return false;
}

// The select's scratch (select_scratch_ints): kHeadInts ints (the grid
// barrier's two, then the number of queries that are not compact), then
// kStateInts a query: [0] the k-th best key's digits found so far (its
// prefix), [1] keys known to rank above that prefix, [2] keys of the last
// digit's bin (after the last pass: the keys equal to the k-th best), [3]
// the compact list's length (0: not compact), [4] the floor digit, [5..7]
// items done in passes 0-2, [8] slots taken by keys gathered at or above
// the floor, [9] by keys above the k-th best, [10] by keys equal to it;
// then four histograms a query (the tile maxima's top digits, passes 0-2)
// and a tie count an item.
constexpr int kHeadInts = 4;

// Called by the block that finished the last item of a query's histogram
// pass, h its bins: the bin b of this digit with count(bins above b) <
// k - state[1] <= count(bins from b up) extends the prefix. After pass 0
// (`first`), whose keys were gathered as they were counted, the query is
// compact where those keys number no more than kSortK; else it counts as
// not compact.
__device__ __forceinline__ void select_digit(const unsigned* h, int* state,
                                             int* not_compact, int bits,
                                             int k, bool first) {
  const unsigned pre = static_cast<unsigned>(__ldcg(state));
  const unsigned known = static_cast<unsigned>(__ldcg(state + 1));
  int bin;
  unsigned above, count, total;
  if (find_bin<true>(h, static_cast<unsigned>(k) - known, bin, above, count,
                     total)) {
    state[0] = static_cast<int>(pre << bits | static_cast<unsigned>(bin));
    state[1] = static_cast<int>(known + above);
    state[2] = static_cast<int>(count);
    if (!first) return;
    if (total <= kSortK)
      state[3] = static_cast<int>(total);
    else
      atomicAdd(not_compact, 1);
  }
}

// The keys [lo, hi) of row `row` that thread tid loads at step e0: kSelVec
// from e0 + kSelVec * tid (rows are kKeyAlign-aligned; past hi: zeros).
__device__ __forceinline__ void load_keys(const unsigned* row, long long e0,
                                          long long hi,
                                          unsigned (&v)[kSelVec]) {
  const long long e = e0 + kSelVec * static_cast<long long>(threadIdx.x);
  if (e < hi) {
    const uint4* p = reinterpret_cast<const uint4*>(row + e);
#pragma unroll
    for (int x = 0; x < kSelVec / 4; ++x) {
      const uint4 u = p[x];
      v[4 * x] = u.x;
      v[4 * x + 1] = u.y;
      v[4 * x + 2] = u.z;
      v[4 * x + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int x = 0; x < kSelVec; ++x) v[x] = 0u;
  }
}

// Sort the pow2 >= len entries ck/ci[0, len) of one query by (key desc,
// id asc) in the block's shared memory (a bitonic network, the entries
// past len sorting last) and write the first k: scores, and ids (-1
// where the score is -inf).
__device__ void sort_out(const unsigned* ck, const int* ci, int len, int k,
                         unsigned* sk, int* si, float* os, int* oi) {
  const int tid = threadIdx.x;
  int n_sort = 1;
  while (n_sort < len) n_sort <<= 1;
  for (int p = tid; p < n_sort; p += kSelThreads) {
    sk[p] = p < len ? __ldcg(ck + p) : 0u;
    si[p] = p < len ? __ldcg(ci + p) : 0x7fffffff;
  }
  __syncthreads();
  for (int size = 2; size <= n_sort; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n_sort / 2; i += kSelThreads) {
        const int a = 2 * i - (i & (stride - 1)), b = a + stride;
        // best first where a's block of `size` runs best first
        if (key_beats(sk[b], si[b], sk[a], si[a]) == ((a & size) == 0)) {
          const unsigned tk = sk[a];
          const int ti = si[a];
          sk[a] = sk[b];
          si[a] = si[b];
          sk[b] = tk;
          si[b] = ti;
        }
      }
      __syncthreads();
    }
  for (int p = tid; p < k; p += kSelThreads) {
    const float s = key_f32(sk[p]);
    os[p] = s;
    oi[p] = s == -CUDART_INF_F ? -1 : si[p];
  }
  __syncthreads();
}

// keys [nq, ldk] and tile_max [nq, n_tiles] from narrow_scores (keys
// [0, n) of each row); scratch zeroed by narrow_scores; cand_k/cand_i
// [nq, cap], cap the larger of kSortK and p2, the power of two at or
// above k; out_s/out_i [nq, k]. Item (q, chunk) of nq * chunks covers keys
// [chunk * per, +per) of query q, per a multiple of kNRows.
//
// Phases, a grid_sync after each:
//  * floor: a block a query counts its tile maxima by their top 11 bits
//    and takes the bin where the count from the top reaches k: k tiles'
//    largest keys lie at or above it, so the k-th best key does too, and
//    no key below that bin (the bulk of the scores) needs counting.
//  * pass 0 counts the keys at or above the floor by their top 11 bits,
//    finds the bin b of the k-th best, and gathers those keys into cand.
//    Where they number no more than kSortK (the usual case: a floor
//    leaves the scores' tail), the query is compact: the sort takes its k
//    best from them, and where every query is compact the sort follows.
//  * else the radix select goes on: passes 1 and 2 count by the next 11
//    and 10 bits the keys of b and of the next digit's bin, which leaves
//    T, the k-th best key; a count of the keys equal to T in each item
//    (only where more of them tie than the list has room for: the lowest
//    ids win), a collect of the k best into cand, and the sort.
__global__ void __launch_bounds__(kSelThreads)
narrow_select(const unsigned* __restrict__ keys,
              const unsigned* __restrict__ tile_max, int* scratch,
              unsigned* cand_k, int* cand_i, float* out_s, int* out_i,
              int nq, int n, int ldk, int k, int chunks, int cap) {
  extern __shared__ __align__(16) unsigned ssm[];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  int* not_compact = scratch + 2;
  int* state = scratch + kHeadInts;
  unsigned* hist = reinterpret_cast<unsigned*>(state + nq * kStateInts);
  int* tie_cnt = reinterpret_cast<int*>(
      hist + 4LL * nq * kRadixBins);                // [nq][chunks]
  const int items = nq * chunks;
  const int n_tiles = (n + kNRows - 1) / kNRows;
  const long long step = static_cast<long long>(kSelVec) * kSelThreads;
  long long per = (static_cast<long long>(n) + chunks - 1) / chunks;
  per = (per + kNRows - 1) / kNRows * kNRows;
  int p2 = 1;
  while (p2 < k) p2 <<= 1;

  // floor
  for (int q = blockIdx.x; q < nq; q += gridDim.x) {
    for (int b = tid; b < kRadixBins; b += kSelThreads) ssm[b] = 0u;
    __syncthreads();
    const unsigned* tm = tile_max + static_cast<long long>(q) * n_tiles;
    for (int x = tid; x < n_tiles; x += kSelThreads)
      atomicAdd(ssm + (tm[x] >> 21), 1u);
    __syncthreads();
    int bin;
    unsigned above, count, total;
    if (find_bin<false>(ssm, static_cast<unsigned>(k), bin, above, count,
                        total))
      state[q * kStateInts + 4] = bin;             // else 0: no floor
    __syncthreads();
  }
  grid_sync(bar);

  // histogram passes: digits of 11, 11 and 10 bits from the top; pass p
  // counts the keys whose higher digits equal the prefix so far, pass 0
  // those at or above the floor, which it also gathers into cand (as many
  // as fit: all of them where the query turns out compact)
  bool radix = true;
  for (int pass = 0; pass < 3 && radix; ++pass) {
    const int shift = pass == 0 ? 21 : pass == 1 ? 10 : 0;
    const int bits = pass == 2 ? 10 : 11;
    const unsigned mask = (1u << bits) - 1u;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int q = it / chunks, chk = it % chunks;
      int* st = state + q * kStateInts;
      if (pass > 0 && __ldcg(st + 3) > 0) continue;   // compact: uniform
      // pass 0: the floor digit; later, the prefix so far
      const unsigned pre = static_cast<unsigned>(__ldcg(st + (pass ? 0 : 4)));
      const long long lo = chk * per;
      const long long hi = min(lo + per, static_cast<long long>(n));
      const unsigned* row = keys + static_cast<long long>(q) * ldk;
      unsigned* ck = cand_k + static_cast<long long>(q) * cap;
      int* ci = cand_i + static_cast<long long>(q) * cap;
      for (int b = tid; b < kRadixBins; b += kSelThreads) ssm[b] = 0u;
      __syncthreads();
      for (long long e0 = lo; e0 < hi; e0 += step) {
        unsigned v[kSelVec];
        load_keys(row, e0, hi, v);
        const long long e = e0 + kSelVec * static_cast<long long>(tid);
        unsigned in_bits = 0;
#pragma unroll
        for (int x = 0; x < kSelVec; ++x) {
          const bool in =
              e + x < hi && (pass == 0 ? v[x] >> 21 >= pre
                                       : v[x] >> (shift + bits) == pre);
          in_bits |= static_cast<unsigned>(in) << x;
          const unsigned bin = in ? v[x] >> shift & mask : kRadixBins;
          // lanes with the same bin add once, by their lowest lane
          const unsigned peers = __match_any_sync(kFull, bin);
          if (in && lane == __ffs(peers) - 1)
            atomicAdd(ssm + bin, static_cast<unsigned>(__popc(peers)));
        }
        if (pass == 0) {
          unsigned wt;
          unsigned slot = warp_excl_scan(__popc(in_bits), wt);
          unsigned base = 0;
          if (wt && lane == 0)
            base = atomicAdd(reinterpret_cast<unsigned*>(st + 8), wt);
          slot += __shfl_sync(kFull, base, 0);
#pragma unroll
          for (int x = 0; x < kSelVec; ++x)
            if (in_bits >> x & 1u) {
              if (slot < static_cast<unsigned>(cap)) {
                ck[slot] = v[x];
                ci[slot] = static_cast<int>(e + x);
              }
              ++slot;
            }
        }
      }
      __syncthreads();
      unsigned* h = hist + (static_cast<long long>(pass + 1) * nq + q) *
                               kRadixBins;
      for (int b = tid; b < kRadixBins; b += kSelThreads)
        if (ssm[b]) atomicAdd(h + b, ssm[b]);
      __threadfence();
      __syncthreads();
      if (tid == 0) last = atomicAdd(st + 5 + pass, 1) == chunks - 1;
      __syncthreads();
      if (last) {
        __threadfence();
        select_digit(h, st, not_compact, bits, k, pass == 0);
      }
      __syncthreads();                // ssm is zeroed again next item
    }
    grid_sync(bar);
    // every query compact: pass 0 gathered them all
    if (pass == 0) radix = __ldcg(not_compact) > 0;
  }

  if (radix) {
    // T = state[0] is now the k-th best key: state[1] keys lie above it
    // and state[2] equal it. Where more equal it than the list has room
    // for, the lowest ids win, so each item counts its ties first.
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int q = it / chunks, chk = it % chunks;
      const int* st = state + q * kStateInts;
      const unsigned thr = static_cast<unsigned>(__ldcg(st));
      const int room = k - __ldcg(st + 1);
      // uniform in the block: compact, or every tie is taken
      if (__ldcg(st + 3) > 0 || __ldcg(st + 2) == room) continue;
      const long long lo = chk * per;
      const long long hi = min(lo + per, static_cast<long long>(n));
      const unsigned* row = keys + static_cast<long long>(q) * ldk;
      unsigned mine = 0;
      for (long long e0 = lo; e0 < hi; e0 += step) {
        unsigned v[kSelVec];
        load_keys(row, e0, hi, v);
        const long long e = e0 + kSelVec * static_cast<long long>(tid);
#pragma unroll
        for (int x = 0; x < kSelVec; ++x) mine += e + x < hi && v[x] == thr;
      }
      unsigned total;
      block_excl_scan(mine, total);
      if (tid == 0) tie_cnt[it] = static_cast<int>(total);
    }
    grid_sync(bar);

    // collect: keys above T to slots [0, state[1]) in any order, and ties
    // to [state[1], k): any of them where all fit, else the lowest ids
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int q = it / chunks, chk = it % chunks;
      int* st = state + q * kStateInts;
      if (__ldcg(st + 3) > 0) continue;             // compact: gathered
      const unsigned thr = static_cast<unsigned>(__ldcg(st));
      const int above_n = __ldcg(st + 1);
      const int room = k - above_n;
      const bool ordered = __ldcg(st + 2) > room;
      unsigned* ck = cand_k + static_cast<long long>(q) * cap;
      int* ci = cand_i + static_cast<long long>(q) * cap;
      unsigned before = 0;                  // ties in this query's earlier
      if (ordered) {                        // items, then earlier steps
        unsigned v = 0;
        for (int c2 = tid; c2 < chk; c2 += kSelThreads)
          v += static_cast<unsigned>(__ldcg(tie_cnt + q * chunks + c2));
        block_excl_scan(v, before);
      }
      const long long lo = chk * per;
      const long long hi = min(lo + per, static_cast<long long>(n));
      const unsigned* row = keys + static_cast<long long>(q) * ldk;
      for (long long e0 = lo; e0 < hi; e0 += step) {
        unsigned v[kSelVec];
        load_keys(row, e0, hi, v);
        const long long e = e0 + kSelVec * static_cast<long long>(tid);
        unsigned n_above = 0, n_tie = 0;
#pragma unroll
        for (int x = 0; x < kSelVec; ++x) {
          n_above += e + x < hi && v[x] > thr;
          n_tie += e + x < hi && v[x] == thr;
        }
        unsigned wt;
        unsigned slot = warp_excl_scan(n_above, wt);
        unsigned base = 0;
        if (wt && lane == 0)
          base = atomicAdd(reinterpret_cast<unsigned*>(st + 9), wt);
        slot += __shfl_sync(kFull, base, 0);
        unsigned tslot;
        if (ordered) {
          unsigned total;
          tslot = before + block_excl_scan(n_tie, total);
          before += total;
        } else {
          tslot = warp_excl_scan(n_tie, wt);
          base = 0;
          if (wt && lane == 0)
            base = atomicAdd(reinterpret_cast<unsigned*>(st + 10), wt);
          tslot += __shfl_sync(kFull, base, 0);
        }
#pragma unroll
        for (int x = 0; x < kSelVec; ++x) {
          if (e + x >= hi) break;
          if (v[x] > thr) {
            ck[slot] = v[x];
            ci[slot] = static_cast<int>(e + x);
            ++slot;
          } else if (v[x] == thr) {
            if (tslot < static_cast<unsigned>(room)) {
              ck[above_n + tslot] = v[x];
              ci[above_n + tslot] = static_cast<int>(e + x);
            }
            ++tslot;
          }
        }
      }
      if (chk == 0 && p2 > kSortK)          // the device-memory sort's
        for (int p = k + tid; p < p2; p += kSelThreads) {   // padding
          ck[p] = 0u;
          ci[p] = 0x7fffffff;
        }
    }
    grid_sync(bar);
  }

  // sort: a query's list (k entries, or the compact gather's) in one
  // block's shared memory where it fits; else (p2 > kSortK, so no query
  // is compact) a bitonic network over cand in device memory by the
  // whole grid, a grid_sync a stage
  if (p2 <= kSortK) {
    for (int q = blockIdx.x; q < nq; q += gridDim.x) {
      const int* st = state + q * kStateInts;
      const int len = __ldcg(st + 3) > 0 ? __ldcg(st + 3) : k;
      sort_out(cand_k + static_cast<long long>(q) * cap,
               cand_i + static_cast<long long>(q) * cap, len, k, ssm,
               reinterpret_cast<int*>(ssm + kSortK),
               out_s + static_cast<long long>(q) * k,
               out_i + static_cast<long long>(q) * k);
    }
    return;
  }
  const long long pairs = static_cast<long long>(nq) * (p2 / 2);
  const long long gstride = static_cast<long long>(gridDim.x) * kSelThreads;
  const long long gtid =
      static_cast<long long>(blockIdx.x) * kSelThreads + tid;
  for (int size = 2; size <= p2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (long long x = gtid; x < pairs; x += gstride) {
        const long long q = x / (p2 / 2);
        const int i = static_cast<int>(x % (p2 / 2));
        const int a = 2 * i - (i & (stride - 1)), b = a + stride;
        unsigned* ck = cand_k + q * cap;
        int* ci = cand_i + q * cap;
        const unsigned ka = __ldcg(ck + a), kb = __ldcg(ck + b);
        const int ia = __ldcg(ci + a), ib = __ldcg(ci + b);
        if (key_beats(kb, ib, ka, ia) == ((a & size) == 0)) {
          ck[a] = kb;
          ci[a] = ib;
          ck[b] = ka;
          ci[b] = ia;
        }
      }
      grid_sync(bar);
    }
  for (long long x = gtid; x < static_cast<long long>(nq) * k;
       x += gstride) {
    const long long q = x / k;
    const int p = static_cast<int>(x % k);
    const float s = key_f32(__ldcg(cand_k + q * cap + p));
    out_s[x] = s;
    out_i[x] = s == -CUDART_INF_F ? -1 : __ldcg(cand_i + q * cap + p);
  }
}

// ---- gathered pieces: the wrapper's cut of the candidate slots ------------
//
// A piece is a run of one query's valid slots (id >= 0) whose rows are
// consecutive table rows inside one kGTR-row tile. Slot c continues slot
// c - 1's piece when both are valid and key(c) == key(c - 1) + 1, key the
// row plus one for each whole tile before it (so a run steps by 1 inside
// a tile and by 2 across a tile's edge). Pieces are numbered in (query,
// position) order, as a scan of the flattened slots finds them. The count
// pass counts each (query, chunk)'s piece starts and flags a valid slot
// whose row lies outside the table; its last block scans the counts into
// each chunk's first piece number, the total and the most a query has
// (what the host reads to size the outputs). The emit pass writes each
// piece's first row and position at its number and its last position;
// the finish pass turns those into lengths and each query's slot offsets
// (the kept min(k, length) of its earlier pieces), its row length for the
// merge and each piece's tile for the sort by tile that follows.

constexpr int kPieceSlots = 8192;            // slots a (query, chunk) block
constexpr int kPieceVec = kPieceSlots / kSelThreads;  // a thread's run
constexpr int kPieceInfo = 4;                // total, stray, most, done
constexpr int kPieceKeys = kPieceSlots + 2;  // and a neighbour each side
static_assert(kPieceVec == 32, "a thread's run is one padded bank row");

// Staged key i's place in shared memory: one pad word every 32, so the
// threads' 32-slot runs start in 32 different banks.
__host__ __device__ constexpr int piece_pad(int i) { return i + (i >> 5); }

// Stage the keys of slots [lo - 1, lo + kPieceSlots] of the query's row
// (row0 its first slot) into keys (padded): the row plus one for each
// whole tile before it, or -2 where the slot is invalid or outside [0,
// c); loads are coalesced. Returns, in every thread, whether a valid slot
// of [lo, lo + kPieceSlots) has a row outside [0, n_rows) (keys of such
// rows do not matter: the wrapper raises). Every thread calls it.
__device__ __forceinline__ bool stage_piece_keys(
    int* keys, const int* __restrict__ rows, const int* __restrict__ ids,
    long long row0, long long lo, int c, int n_rows) {
  bool stray = false;
  for (int i = threadIdx.x; i < kPieceKeys; i += kSelThreads) {
    const long long at = lo - 1 + i;
    int key = -2;
    if (at >= 0 && at < c && ids[row0 + at] >= 0) {
      const int r = rows[row0 + at];
      key = static_cast<int>(static_cast<unsigned>(r) +
                             static_cast<unsigned>(r / kGTR));
      if (i >= 1 && i <= kPieceSlots) stray = stray || r < 0 || r >= n_rows;
    }
    keys[piece_pad(i)] = key;
  }
  return __syncthreads_or(stray);
}

// The piece starts and ends among this thread's slots (lo + 32 t + x) as
// bit masks (bit x), from the staged keys.
__device__ __forceinline__ void piece_flags(const int* keys, long long lo,
                                            int c, unsigned& starts,
                                            unsigned& ends) {
  starts = ends = 0u;
  const int t0 = threadIdx.x * kPieceVec;
#pragma unroll 8
  for (int x = 0; x < kPieceVec; ++x) {
    if (lo + t0 + x >= c) break;
    const int prev = keys[piece_pad(t0 + x)];
    const int key = keys[piece_pad(t0 + x + 1)];
    const int next = keys[piece_pad(t0 + x + 2)];
    if (key == -2) continue;
    if (key != prev + 1) starts |= 1u << x;
    if (next != key + 1) ends |= 1u << x;
  }
}

// grid (nq, chunks); counts/base [nq * chunks]; info [kPieceInfo] zeroed
// by the caller: then info[0] the pieces, info[1] 1 where a valid slot's
// row is stray, info[2] the most pieces a query has.
__global__ void __launch_bounds__(kSelThreads)
piece_count_kernel(const int* __restrict__ rows,
                     const int* __restrict__ ids, int* counts, int* base,
                     int* info, int nq, int c, int n_rows) {
  __shared__ bool last;
  __shared__ int keys[piece_pad(kPieceKeys)];
  const int tid = threadIdx.x, chunks = gridDim.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * c;
  const long long lo = static_cast<long long>(blockIdx.y) * kPieceSlots;
  const bool stray =
      stage_piece_keys(keys, rows, ids, row0, lo, c, n_rows);
  unsigned starts, ends;
  piece_flags(keys, lo, c, starts, ends);
  unsigned total;
  block_excl_scan(__popc(starts), total);
  if (tid == 0) counts[blockIdx.x * chunks + blockIdx.y] = total;
  if (stray && tid == 0) atomicOr(info + 1, 1);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(info + 3, 1) == nq * chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: each chunk's first piece number, in (query, chunk)
  // order, then each query's count
  const int cells = nq * chunks;
  unsigned carry = 0;
  for (int e0 = 0; e0 < cells; e0 += kSelThreads) {
    const int e = e0 + tid;
    const unsigned v = e < cells ? static_cast<unsigned>(__ldcg(counts + e))
                                 : 0u;
    unsigned tot;
    const unsigned before = block_excl_scan(v, tot);
    if (e < cells) base[e] = static_cast<int>(carry + before);
    carry += tot;
  }
  __syncthreads();
  int most = 0;
  for (int q = tid; q < nq; q += kSelThreads) {
    const unsigned end = q + 1 < nq ? base[(q + 1) * chunks] : carry;
    most = max(most, static_cast<int>(end - base[q * chunks]));
  }
  atomicMax(info + 2, most);
  if (tid == 0) info[0] = static_cast<int>(carry);
}

// grid (nq, chunks): each piece's first row ([1]) and position ([3]) at
// its number, its last position at [2].
__global__ void __launch_bounds__(kSelThreads)
piece_emit_kernel(const int* __restrict__ rows,
                    const int* __restrict__ ids, const int* __restrict__ base,
                    int* pieces, int c, int n_rows) {
  __shared__ int keys[piece_pad(kPieceKeys)];
  const int tid = threadIdx.x, chunks = gridDim.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * c;
  const long long lo = static_cast<long long>(blockIdx.y) * kPieceSlots;
  const long long first = lo + tid * kPieceVec;
  stage_piece_keys(keys, rows, ids, row0, lo, c, n_rows);
  unsigned starts, ends;
  piece_flags(keys, lo, c, starts, ends);
  unsigned total;
  const unsigned before = block_excl_scan(__popc(starts), total);
  // the number of the next piece to start: one end closes the piece of
  // the last start at or before it
  long long idx = static_cast<long long>(
                      base[blockIdx.x * chunks + blockIdx.y]) + before;
  for (unsigned m = starts | ends; m; m &= m - 1) {
    const int x = __ffs(m) - 1;
    const int at = static_cast<int>(first + x);
    if (starts >> x & 1u) {
      // the row from its key: key = 129 a + b for row 128 a + b, b < 128
      const int key = keys[piece_pad(tid * kPieceVec + x + 1)];
      pieces[idx * kPieceInts + 1] = key - key / (kGTR + 1);
      pieces[idx * kPieceInts + 3] = at;
      ++idx;
    }
    if (ends >> x & 1u) pieces[(idx - 1) * kPieceInts + 2] = at;
  }
}

// grid nq: each query's pieces [base[q chunks], the next query's): query
// ([0]), length ([2]), slot offset ([4]), tile; row_len[q] the kept
// entries in all.
__global__ void __launch_bounds__(kSelThreads)
piece_finish_kernel(const int* __restrict__ base, int* pieces,
                      int* tile_key, int* row_len, int nq, int chunks,
                      int n, int k) {
  const int q = blockIdx.x, tid = threadIdx.x;
  const int b0 = base[q * chunks];
  const int b1 = q + 1 < nq ? base[(q + 1) * chunks] : n;
  unsigned carry = 0;
  for (int i0 = b0; i0 < b1; i0 += kSelThreads) {
    const int i = i0 + tid;
    int* p = pieces + static_cast<long long>(i) * kPieceInts;
    int len = 0;
    if (i < b1) len = p[2] - p[3] + 1;
    const unsigned kept = static_cast<unsigned>(min(k, len));
    unsigned tot;
    const unsigned before = block_excl_scan(kept, tot);
    if (i < b1) {
      p[0] = q;
      p[2] = len;
      p[4] = static_cast<int>(carry + before);
      tile_key[i] = p[1] / kGTR;
    }
    carry += tot;
  }
  if (tid == 0) row_len[q] = static_cast<int>(carry);
}

template <typename In, bool kExact, int kQT>
int launch_narrow(const void* q, const void* c, void* keys, void* tile_max,
                  void* scratch, long long scratch_ints, int nq, int n,
                  int d, int ldk, int tiles_per_block, int n_blocks, int vec,
                  cudaStream_t st) {
  const size_t bytes = size_t(kNStages) * (kNRows + 8 * kQT) * kDRow;
  const cudaError_t err = cudaFuncSetAttribute(
      narrow_scores<In, kExact, kQT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  narrow_scores<In, kExact, kQT><<<n_blocks, kThreads, bytes, st>>>(
      static_cast<const In*>(q), static_cast<const In*>(c),
      static_cast<unsigned*>(keys), static_cast<unsigned*>(tile_max),
      static_cast<int*>(scratch), scratch_ints, nq, n, d, ldk,
      tiles_per_block, vec);
  return static_cast<int>(cudaGetLastError());
}

// The scorer for nq real queries, rounded up to 8 kQT (8, 16, 32 or 64).
template <typename In, bool kExact>
int launch_narrow_depth(const void* q, const void* c, void* keys,
                        void* tile_max, void* scratch, long long scratch_ints,
                        int nq, int n, int d, int ldk, int tiles_per_block,
                        int n_blocks, int vec, void* stream) {
  if (nq <= 0 || n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq <= 8)
    return launch_narrow<In, kExact, 1>(q, c, keys, tile_max, scratch,
                                        scratch_ints, nq, n, d, ldk,
                                        tiles_per_block, n_blocks, vec, st);
  if (nq <= 16)
    return launch_narrow<In, kExact, 2>(q, c, keys, tile_max, scratch,
                                        scratch_ints, nq, n, d, ldk,
                                        tiles_per_block, n_blocks, vec, st);
  if (nq <= 32)
    return launch_narrow<In, kExact, 4>(q, c, keys, tile_max, scratch,
                                        scratch_ints, nq, n, d, ldk,
                                        tiles_per_block, n_blocks, vec, st);
  return launch_narrow<In, kExact, 8>(q, c, keys, tile_max, scratch,
                                      scratch_ints, nq, n, d, ldk,
                                      tiles_per_block, n_blocks, vec, st);
}

}  // namespace

// The k best of each row of partial lists part_s/part_i [nq, width] by
// (score desc, id asc) to out_s/out_i [nq, k]; row_len [nq] (may be null:
// every row whole) names the entries a row holds, its first row_len[q]
// (the rest are never read). cand_ids [nq, c] (may be null): the ids are
// candidate positions, and out_i takes cand_ids[q, position], or -1 where
// the score is not finite. The plan (ops.merge_plan): each row cut into
// n_seg segments of seg entries (seg * n_seg >= width; k < seg where
// n_seg > 1), a warp each; where n_seg > 1, seg_s/seg_i hold nq * n_seg * k
// entries and done nq ints, zeroed here.
extern "C" int topk_merge(const void* part_s, const void* part_i,
                          const void* row_len, const void* cand_ids,
                          void* out_s, void* out_i, void* seg_s, void* seg_i,
                          void* done, int nq, int width, int k, int c,
                          int seg, int n_seg, void* stream) {
  if (nq <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (n_seg < 1 || seg < 1 || static_cast<long long>(seg) * n_seg < width ||
      (n_seg > 1 && (seg <= k || !seg_s || !seg_i || !done)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg > 1) {
    const cudaError_t err =
        cudaMemsetAsync(done, 0, size_t(nq) * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long warps = static_cast<long long>(nq) * n_seg;
  const dim3 grid(static_cast<unsigned>((warps + kMergeWarps - 1) /
                                        kMergeWarps));
  const float* ps = static_cast<const float*>(part_s);
  const int* pi = static_cast<const int*>(part_i);
  const int* rl = static_cast<const int*>(row_len);
  const int* ci = static_cast<const int*>(cand_ids);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  float* ss = static_cast<float*>(seg_s);
  int* si = static_cast<int*>(seg_i);
  int* dn = static_cast<int*>(done);
  const int smem = k <= kSmemK;
  const size_t bytes = smem ? size_t(kMergeWarps) * k * 8 : 0;
  if (k <= kRegK)
    topk_merge_kernel<false><<<grid, kMergeWarps * 32, 0, st>>>(
        ps, pi, rl, ci, os, oi, ss, si, dn, nq, width, k, c, seg, n_seg, 0);
  else
    topk_merge_kernel<true><<<grid, kMergeWarps * 32, bytes, st>>>(
        ps, pi, rl, ci, os, oi, ss, si, dn, nq, width, k, c, seg, n_seg,
        smem);
  return static_cast<int>(cudaGetLastError());
}

// queries f32 [nq, d], table f32 [r, d]; pieces int32 [n, 5] (query,
// first row, length, first position, slot offset) sorted by row tile of
// kGTR rows, no piece crossing a tile; blk_first int32 [n_blocks], the
// first piece of each block (every kGBQ-th piece of a tile, -1: none);
// part_s/part_i [nq, width]: each piece writes its min(k, length) slots,
// and only those (topk_merge reads a query's written prefix by its row
// length). vec = 1 when queries and table are 16-byte aligned and d % 4
// == 0.
extern "C" int gathered_tiles(const void* q, const void* table,
                              const void* pieces, const void* blk_first,
                              void* part_s, void* part_i, int n,
                              int n_blocks, int r, int d, int k, int width,
                              int vec, void* stream) {
  if (n > 0 && n_blocks > 0 && k > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* qp = static_cast<const float*>(q);
    const float* tp = static_cast<const float*>(table);
    const int* pp = static_cast<const int*>(pieces);
    const int* bp = static_cast<const int*>(blk_first);
    float* ps = static_cast<float*>(part_s);
    int* pi = static_cast<int*>(part_i);
    const size_t bytes = size_t(kGStages) * kGStage;
    cudaError_t err = cudaFuncSetAttribute(
        gathered_tiles_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gathered_tiles_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (k <= kRegK)
      gathered_tiles_kernel<false><<<n_blocks, kThreads, bytes, st>>>(
          qp, tp, pp, bp, ps, pi, n, r, d, k, width, vec);
    else
      gathered_tiles_kernel<true><<<n_blocks, kThreads, bytes, st>>>(
          qp, tp, pp, bp, ps, pi, n, r, d, k, width, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// queries f32 [nq, d], table f32 [r, d], rows/ids int32 [nq, c] (a slot is
// valid where its id is >= 0): each query's runs of kRunSlots slots, a
// block each (grid (ceil(c / kRunSlots), nq)), write their top kk =
// min(k, kRunSlots) (score, position) lists to part_s/part_p [nq, width],
// width = ceil(c / kRunSlots) * kk, every entry written. *stray (zeroed
// here first) becomes 1 where a valid slot's row lies outside [0, r); such
// a row is never read. vec = 1 when queries and table are 16-byte aligned
// and d % 4 == 0.
extern "C" int gathered_runs(const void* q, const void* table,
                             const void* rows, const void* ids, void* part_s,
                             void* part_p, void* stray, int nq, int c, int r,
                             int d, int k, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(stray, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nq <= 0 || c <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (c + kRunSlots - 1) / kRunSlots;
  const int kk = k < kRunSlots ? k : kRunSlots;
  const int width = runs * kk;
  const size_t bytes = size_t(kRunStages) * kRunStage;
  err = cudaFuncSetAttribute(gathered_runs_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gathered_runs_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(runs, nq);
  const float* qp = static_cast<const float*>(q);
  const float* tp = static_cast<const float*>(table);
  const int* rp = static_cast<const int*>(rows);
  const int* ip = static_cast<const int*>(ids);
  float* ps = static_cast<float*>(part_s);
  int* pp = static_cast<int*>(part_p);
  int* sp = static_cast<int*>(stray);
  if (kk <= kRegK)
    gathered_runs_kernel<false><<<grid, kThreads, bytes, st>>>(
        qp, tp, rp, ip, ps, pp, sp, c, r, d, k, width, vec);
  else
    gathered_runs_kernel<true><<<grid, kThreads, bytes, st>>>(
        qp, tp, rp, ip, ps, pp, sp, c, r, d, k, width, vec);
  return static_cast<int>(cudaGetLastError());
}

// queries/corpus f32 [nq, d] / [n, d], 1 <= nq <= kNQMax: each score's
// order key to keys [nq, ldk] (ldk: n rounded up to kKeyAlign) and each
// kNRows-row tile's largest to tile_max [nq, ceil(n / kNRows)], by a grid
// of n_blocks blocks of tiles_per_block tiles, which first zeroes
// scratch[0, scratch_ints) for topk_narrow_select. vec = 1 when queries
// and corpus are 16-byte aligned and d % 4 == 0. D <= kExactDepth sums in
// f64 on the CUDA cores (narrow_exact), a larger D as three TF32 products
// on the tensor cores.
extern "C" int topk_narrow_scores(const void* q, const void* c, void* keys,
                                  void* tile_max, void* scratch,
                                  long long scratch_ints, int nq, int n,
                                  int d, int ldk, int tiles_per_block,
                                  int n_blocks, int vec, void* stream) {
  if (nq > kNQMax) return static_cast<int>(cudaErrorInvalidValue);
  return d <= kExactDepth
             ? launch_narrow_depth<float, true>(
                   q, c, keys, tile_max, scratch, scratch_ints, nq, n, d,
                   ldk, tiles_per_block, n_blocks, vec, stream)
             : launch_narrow_depth<float, false>(
                   q, c, keys, tile_max, scratch, scratch_ints, nq, n, d,
                   ldk, tiles_per_block, n_blocks, vec, stream);
}

// The same for int8 codes [nq, d] / [n, d], 1 <= nq <= kNQInt8 (the int8
// cutoff): the exact int32 dots on the s8 tensor cores, each keyed as the
// f32 it rounds to. vec = 1 when both are 16-byte aligned and d % 16 == 0.
extern "C" int topk_narrow_scores_int8(const void* q, const void* c,
                                       void* keys, void* tile_max,
                                       void* scratch, long long scratch_ints,
                                       int nq, int n, int d, int ldk,
                                       int tiles_per_block, int n_blocks,
                                       int vec, void* stream) {
  if (nq > kNQInt8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_narrow_depth<signed char, false>(
      q, c, keys, tile_max, scratch, scratch_ints, nq, n, d, ldk,
      tiles_per_block, n_blocks, vec, stream);
}

// The k best of each row of topk_narrow_scores' keys [nq, ldk] (entries
// [0, n)), 1 <= k <= n, to out_s/out_i [nq, k] by (score desc, id asc),
// a score of -inf with id -1; tile_max as that kernel wrote it. scratch:
// the counters it zeroed (kHeadInts + nq * kStateInts + 4 * nq *
// kRadixBins + nq * chunks ints); cand_k/cand_i [nq, cap], cap the larger
// of kSortK and the power of two at or above k. One cooperative launch:
// its blocks are co-resident, so it passes grid_sync.
extern "C" int topk_narrow_select(const void* keys, const void* tile_max,
                                  void* scratch, void* cand_k, void* cand_i,
                                  void* out_s, void* out_i, int nq, int n,
                                  int ldk, int k, int chunks, int cap,
                                  void* stream) {
  if (nq <= 0 || k <= 0 || chunks <= 0)
    return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0, per_sm = 0;
  // the sort's kSortK keys and ids (the histograms take less)
  const size_t bytes = size_t(kSortK) * 8;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, narrow_select, kSelThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = nq * chunks, resident = sms * per_sm;
  const int grid = items < resident ? items : resident;
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned* kp = static_cast<const unsigned*>(keys);
  const unsigned* tp = static_cast<const unsigned*>(tile_max);
  int* sp = static_cast<int*>(scratch);
  unsigned* ckp = static_cast<unsigned*>(cand_k);
  int* cip = static_cast<int*>(cand_i);
  float* osp = static_cast<float*>(out_s);
  int* oip = static_cast<int*>(out_i);
  void* args[] = {&kp, &tp, &sp, &ckp, &cip, &osp, &oip, &nq, &n, &ldk, &k,
                  &chunks, &cap};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(narrow_select), dim3(grid),
      dim3(kSelThreads), args, bytes, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Count the pieces of cand_rows/cand_ids [nq, c] (int32; a slot is valid
// where its id is >= 0): counts and base [nq * chunks] (chunks =
// ceil(c / kPieceSlots)), info [kPieceInfo] zeroed by the caller, then
// holding the pieces, a stray-row flag and the most pieces a query has.
extern "C" int gathered_piece_count(const void* rows, const void* ids,
                                    void* counts, void* base, void* info,
                                    int nq, int c, int chunks, int n_rows,
                                    void* stream) {
  if (nq > 0 && c > 0 && chunks > 0)
    piece_count_kernel<<<dim3(nq, chunks), kSelThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rows), static_cast<const int*>(ids),
        static_cast<int*>(counts), static_cast<int*>(base),
        static_cast<int*>(info), nq, c, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// Write the n pieces that gathered_piece_count counted (base as it left
// it) to pieces [n, kPieceInts] in (query, position) order, each piece's
// tile to tile_key [n] and each query's kept entries, the sum of min(k,
// length) over its pieces, to row_len [nq].
extern "C" int gathered_piece_emit(const void* rows, const void* ids,
                                   const void* base, void* pieces,
                                   void* tile_key, void* row_len, int nq,
                                   int c, int chunks, int n, int n_rows,
                                   int k, void* stream) {
  if (nq <= 0 || c <= 0 || chunks <= 0)
    return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bp = static_cast<const int*>(base);
  int* pp = static_cast<int*>(pieces);
  if (n > 0)
    piece_emit_kernel<<<dim3(nq, chunks), kSelThreads, 0, st>>>(
        static_cast<const int*>(rows), static_cast<const int*>(ids), bp, pp,
        c, n_rows);
  piece_finish_kernel<<<nq, kSelThreads, 0, st>>>(
      bp, pp, static_cast<int*>(tile_key), static_cast<int*>(row_len), nq,
      chunks, n, k);
  return static_cast<int>(cudaGetLastError());
}
