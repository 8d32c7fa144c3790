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
// does its 98 GFLOP on the CUDA cores in f32 FMA (1.46 ms at their rate).
// A kernel that scores each query's rows on their own reads a list once
// per query that probes it (about 64 at that shape), so bytes would
// set its time; this one shares each row tile among the queries that probe
// it.
//
// Design (simple first; wgmma/TMA/warp specialisation are later work):
//  * dense_partial<In, kPieces, kR> (topk_partial, topk_int8_partial):
//    grid (query tile, candidate split), the query tile fastest, so the
//    blocks that share a split's rows stream them through L2 together. A
//    block of 256 threads takes 128 queries (the curve's Q 128 once, a grid
//    search's chunk of 256 twice) and walks its split's 128-row corpus
//    tiles. Each row streams in chunks of 128 bytes through a ring of 3
//    shared-memory stages fed by 16-byte cp.async two steps ahead, the ring
//    running on across tiles (zeros past Q, N and D, so a ragged D adds
//    nothing to a sum; a row that is not 16-byte aligned is staged a word
//    at a time). Queries [Q, D] and corpus [N, D] are both K-contiguous,
//    which is mma's row.col, so fragments come straight from the staged
//    rows by ldmatrix (rows padded to 144 bytes, so each 8-row matrix read
//    touches every bank once). Warp w owns queries 16w..16w+15 and all 128
//    rows of the tile: sixteen m16n8 accumulators. f32: mma.sync m16n8k8
//    TF32; each fragment value x is split in registers, x_hi = x rounded
//    to TF32, x_lo = x - x_hi (tf32_split), and the products a_lo*b_hi,
//    a_hi*b_lo and a_hi*b_hi go, small terms first, into one accumulator
//    a chunk ("3xTF32": about 22 bits of each operand, an error near 2^-21
//    of each term). The MMA truncates its sums, which over a whole row of
//    like-signed terms (768 MMAs at D 2048) would bias it low by parts in
//    1e5, so each chunk's sum is added to the running one with a rounded
//    add. Where D <= 8, one MMA step, the summation bound
//    that the plain version is held to (D * 2^-24 * sum |q_d c_d|) is
//    tighter than the split's error, so each value is split exactly into
//    three TF32 pieces and the six products with i + j <= 2 are taken,
//    small first. The pieces are TF32 values, whose denormals step by
//    2^-136, and the low piece of an entry below about 2^-115 would lie
//    there and lose its bits (the plain version does not). So every
//    product is taken 2^12 times larger: a piece below the leading one
//    enters scaled by 2^12 (the corpus's as b_j * 2^12, the query's as
//    a_i * 2^12 against the corpus's leading piece), which keeps it
//    normal for any normal entry, and each chunk's sum is scaled back by
//    2^-12 in the fused add to the running sum. Powers of two change no
//    rounding, so entries of ordinary size give the same bits as without
//    the scale; sums past about 2^116 would overflow. int8:
//    mma.sync m16n8k32 s8.s8.s32, exact int32 sums, ranked as f32 like
//    the reference's. mma.sync is not the card's full tensor-core rate:
//    on an H100 at 700 W it issued 268-291 TFLOP/s of TF32 and about 1225
//    TOP/s of s8 with 8 warps an SM (tools/mma_rate.py), so the three
//    products at the main path's shape take at least 2.8 ms this way;
//    wgmma is the way past that.
//  * Selection from the accumulators: lane (g, t) of warp w holds, for its
//    queries 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1 of
//    each n8 tile j. At the end of a tile it compares each score with its
//    query's current k-th (score, id), kept in registers; rows at or past n
//    and queries past nq never survive. If any lane of the warp has a
//    survivor, the survivors' scores go to the warp's scratch rows in shared
//    memory (-inf elsewhere). In a split's first tile every score survives
//    and the lists are empty, so each query's row is sorted (a bitonic
//    network in the warp) and its best min(k, 128) become its list at
//    once. Later, each query with survivors is offered them, 32 columns
//    at a time: for k <= 96 its list is loaded into kR = ceil(k / 32)
//    registers a lane, the 32-column chunks with a survivor are offered
//    to it by a ballot against its k-th entry, and each winner is
//    inserted by lanes_insert (reg_insert over kR registers: a few
//    shuffles an entry); then it is stored back. Beyond, mem_offer
//    inserts in place. The new k-th becomes the query's bar. After the
//    first tiles almost nothing survives, and a query without survivors
//    costs one compare per score. The lists of the block's 128 queries
//    live in shared memory beside the ring up to k = 80 (the evaluation
//    curve's largest int8 pool: 80 KB, 222 KB in all, one block an SM),
//    beyond it in each query's slice of the output in device memory. Each
//    split writes the same partial layout as the kernels before it, so
//    topk_merge is shared.
//  * Lists (the dense, gathered and merge kernels): one running top-k list
//    per query ordered by score descending, ties to the lower id. For k <=
//    32 the list lives in lanes 0..k-1. For larger k it lives in memory,
//    shifted in parallel by the warp 32 entries at a time, with the k-th
//    entry cached in registers so a candidate that cannot enter costs one
//    compare: in shared memory while the block's lists fit, else in the
//    query's slice of the output in device memory, whose every access waits
//    on L2. A ballot finds the candidates that beat the current k-th entry,
//    and each is inserted in turn.
//  * gathered_tiles_kernel<kMem>: the wrapper cuts each query's valid
//    candidate positions into pieces, runs of consecutive table rows cut
//    again at 128-row tiles (an ivfflat probe's list is one run, so a
//    piece is a whole tile of it), and sorts them by tile. A block takes
//    one tile and up to 32 of its pieces (a tile probed by more queries
//    gets more blocks): D streams through shared memory in chunks of 32,
//    the pieces' query rows and the tile's rows, in a ring of 3 stages
//    fed by 16-byte cp.async copies two chunks ahead (zero-filled past the
//    table, the block's pieces or D); each thread keeps a 4 x 4 tile of
//    the 32 x 128 f32 sums (FMA, no TF32), and a warp whose pieces are all
//    absent skips the products. At that tile the shared-memory reads (8
//    16-byte reads for 64 FMAs) limit the loop; a larger thread tile is
//    the next step. The sums then go to shared
//    memory, and each warp offers a piece's rows, as (score, position),
//    to a list of min(k, length) entries (lanes for k <= 32, else shared
//    memory), written to the piece's slot in its query's row of the
//    partials. Lists key on the position, so the merge's (score desc, key
//    asc) order is the reference's earliest-position rule; the wrapper
//    maps positions to ids.
//  * topk_merge_kernel: one warp per query merges the n_splits*k partials
//    with the same insertion, so ties still go to the lowest id (position);
//    for the gathered kernel, each query's row of piece lists.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kRegK = 32;      // largest k whose list fits in warp lanes
constexpr int kSmemK = 96;     // largest k whose lists fit in shared memory
constexpr int kMergeWarps = 8;
constexpr int kWarps = kThreads / 32;

// (s, id) beats (t, tid): higher score, or equal score and lower id.
__device__ __forceinline__ bool beats(float s, int id, float t, int tid) {
  return s > t || (s == t && id < tid);
}

// ---- k <= 32: the list lives in lanes 0..k-1 ------------------------------

// Insert (s, id) into the warp's list held in lanes 0..k-1.
__device__ __forceinline__ void reg_insert(float& ls, int& li, float s,
                                           int id, int k, int lane) {
  const unsigned ahead =
      __ballot_sync(kFull, lane < k && beats(ls, li, s, id));
  const int pos = __popc(ahead);
  if (pos >= k) return;  // uniform across the warp
  const float up_s = __shfl_up_sync(kFull, ls, 1);
  const int up_i = __shfl_up_sync(kFull, li, 1);
  if (lane == pos) {
    ls = s;
    li = id;
  } else if (lane > pos && lane < k) {
    ls = up_s;
    li = up_i;
  }
}

// Offer one candidate per lane (s = -inf means none) to the warp's list.
__device__ __forceinline__ void reg_offer(float& ls, int& li, float s,
                                          int id, int k, int lane) {
  const float kth_s = __shfl_sync(kFull, ls, k - 1);
  const int kth_i = __shfl_sync(kFull, li, k - 1);
  unsigned m = __ballot_sync(kFull, s != -CUDART_INF_F &&
                                        beats(s, id, kth_s, kth_i));
  while (m) {
    const int t = __ffs(m) - 1;
    m &= m - 1;
    reg_insert(ls, li, __shfl_sync(kFull, s, t), __shfl_sync(kFull, id, t),
               k, lane);
  }
}

// ---- k <= 32 R: entry p in register p / 32 of lane p % 32 -----------------
// The dense kernels' lists: reg_insert over R registers a lane, the same
// order and tie rule.

template <int R>
__device__ __forceinline__ void lanes_insert(float (&ls)[R], int (&li)[R],
                                             float s, int id, int k,
                                             int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    pos += __popc(__ballot_sync(
        kFull, lane + 32 * r < k && beats(ls[r], li[r], s, id)));
  if (pos >= k) return;  // uniform across the warp
  // every shuffle reads the list before any entry moves; lane 0 of
  // register r > 0 takes entry 32r - 1, from lane 31 of register r - 1
  float up_s[R], in_s[R];
  int up_i[R], in_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    up_s[r] = __shfl_up_sync(kFull, ls[r], 1);
    up_i[r] = __shfl_up_sync(kFull, li[r], 1);
    if (r > 0) {
      in_s[r] = __shfl_sync(kFull, ls[r - 1], 31);
      in_i[r] = __shfl_sync(kFull, li[r - 1], 31);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = lane + 32 * r;
    if (p == pos) {
      ls[r] = s;
      li[r] = id;
    } else if (p > pos && p < k) {
      ls[r] = r > 0 && lane == 0 ? in_s[r] : up_s[r];
      li[r] = r > 0 && lane == 0 ? in_i[r] : up_i[r];
    }
  }
}

// Entry k - 1 of a lane list, in every lane. Every register is shuffled
// and the right one kept: picking the register first would index the list
// by a runtime value, which sends it to local memory.
template <int R>
__device__ __forceinline__ void lanes_kth(const float (&ls)[R],
                                          const int (&li)[R], int k,
                                          float& kth_s, int& kth_i) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float s = __shfl_sync(kFull, ls[r], (k - 1) & 31);
    const int i = __shfl_sync(kFull, li[r], (k - 1) & 31);
    if (r == 0 || r == (k - 1) >> 5) {
      kth_s = s;
      kth_i = i;
    }
  }
}

// ---- any k: the list lives in shared or device memory s/i[0..k) ------------
// The warp's lanes read and write it; __syncwarp orders their accesses, and
// volatile keeps each access a real load or store.

struct MemList {
  volatile float* s;
  volatile int* i;
  float kth_s;   // cached entry k-1, the bar a candidate must clear
  int kth_i;
};

__device__ __forceinline__ void mem_init(MemList& l, int k, int lane) {
  for (int p = lane; p < k; p += 32) {
    l.s[p] = -CUDART_INF_F;
    l.i[p] = -1;
  }
  __syncwarp();
  l.kth_s = -CUDART_INF_F;
  l.kth_i = -1;
}

__device__ void mem_insert(MemList& l, float s, int id, int k, int lane) {
  int ahead = 0;
  for (int p = lane; p < k; p += 32) ahead += beats(l.s[p], l.i[p], s, id);
  const int pos = __reduce_add_sync(kFull, ahead);
  if (pos >= k) return;  // uniform across the warp
  // shift entries pos..k-2 up by one, top 32-entry chunk first: each chunk
  // reads the entry below before the next chunk down overwrites it
  for (int base = (k - 1) & ~31; base >= 0 && base + 31 > pos; base -= 32) {
    const int p = base + lane;
    const bool move = p > pos && p < k;
    float up_s = 0.f;
    int up_i = 0;
    if (move) {
      up_s = l.s[p - 1];
      up_i = l.i[p - 1];
    }
    __syncwarp();
    if (move) {
      l.s[p] = up_s;
      l.i[p] = up_i;
    }
    __syncwarp();
  }
  if (lane == 0) {
    l.s[pos] = s;
    l.i[pos] = id;
  }
  __syncwarp();
  l.kth_s = l.s[k - 1];
  l.kth_i = l.i[k - 1];
}

// Point l at the list of `slot` in dynamic shared memory when `smem`, else
// at s/i in device memory, and empty it.
__device__ __forceinline__ void mem_place(MemList& l, bool smem, int slot,
                                          float* s, int* i, int k,
                                          int lane) {
  extern __shared__ __align__(16) unsigned char lists[];
  if (smem) {
    float* base = reinterpret_cast<float*>(lists) + 2 * slot * k;
    l.s = base;
    l.i = reinterpret_cast<int*>(base + k);
  } else {
    l.s = s;
    l.i = i;
  }
  mem_init(l, k, lane);
}

// Copy a shared-memory list out to s/i in device memory.
__device__ __forceinline__ void mem_store(const MemList& l, float* s, int* i,
                                          int k, int lane) {
  for (int p = lane; p < k; p += 32) {
    s[p] = l.s[p];
    i[p] = l.i[p];
  }
}

__device__ __forceinline__ void mem_offer(MemList& l, float s, int id, int k,
                                          int lane) {
  unsigned m = __ballot_sync(kFull, s != -CUDART_INF_F &&
                                        beats(s, id, l.kth_s, l.kth_i));
  while (m) {
    const int t = __ffs(m) - 1;
    m &= m - 1;
    const float st = __shfl_sync(kFull, s, t);
    const int it = __shfl_sync(kFull, id, t);
    if (beats(st, it, l.kth_s, l.kth_i)) mem_insert(l, st, it, k, lane);
  }
}

// ---- gathered: row tiles shared by the pieces that probe them --------------

constexpr int kGTR = 128;            // table rows per tile
constexpr int kGBQ = 32;             // pieces per block
constexpr int kGDC = 32;             // D chunk staged per step (floats)
constexpr int kGS = kGDC + 4;        // padded staged row
constexpr int kGStage = (kGBQ + kGTR) * kGS;   // floats per stage
constexpr int kGStages = 3;          // stages in flight: 2 prefetched
constexpr int kGMinBlocks = 3;       // blocks an SM holds (80 registers)
constexpr int kGSP = kGTR + 8;       // padded score row
constexpr int kPieceInts = 5;        // query, first row, length, first
                                     // position, slot offset in the query

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Stage D chunk [d0, d0 + kGDC) of the block's query rows (qrow[j] < 0:
// zeros) and of the tile's rows (past the table: zeros) into stage[].
__device__ __forceinline__ void gathered_stage(
    float* stage, const float* __restrict__ q,
    const float* __restrict__ table, const int* qrow, long long row0, int r,
    int d, int d0, int vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int p = 0; p < (kGBQ + kGTR) * (kGDC / 4) / kThreads; ++p) {
      const int e = tid + p * kThreads;
      const int x = e / (kGDC / 4), c = d0 + (e % (kGDC / 4)) * 4;
      const float* src = table;
      bool ok = c < d;
      if (x < kGBQ) {
        ok = ok && qrow[x] >= 0;
        if (ok) src = q + static_cast<long long>(qrow[x]) * d + c;
      } else {
        const long long g = row0 + x - kGBQ;
        ok = ok && g < r;
        if (ok) src = table + g * d + c;
      }
      cp_async16(stage + x * kGS + (e % (kGDC / 4)) * 4, src, ok);
    }
  } else {
    for (int e = tid; e < (kGBQ + kGTR) * kGDC; e += kThreads) {
      const int x = e / kGDC, c = d0 + e % kGDC;
      float val = 0.f;
      if (c < d) {
        if (x < kGBQ) {
          if (qrow[x] >= 0) val = q[static_cast<long long>(qrow[x]) * d + c];
        } else if (row0 + x - kGBQ < r) {
          val = table[(row0 + x - kGBQ) * d + c];
        }
      }
      stage[x * kGS + e % kGDC] = val;
    }
  }
}

// One block per (row tile, up to kGBQ of the pieces that probe it): the
// pieces from blk_first[blockIdx.x] on, while they stay in its tile.
// pieces [n, 5] sorted by tile; part_s/part_i [nq, width]: piece j's
// top-min(k, length) (score, position) list goes to row query_j at
// column slot_j.
template <bool kMem>
__global__ void __launch_bounds__(kThreads, kGMinBlocks)
gathered_tiles_kernel(const float* __restrict__ q,
                      const float* __restrict__ table,
                      const int* __restrict__ pieces,
                      const int* __restrict__ blk_first, float* part_s,
                      int* part_i, int n, int r, int d, int k, int width,
                      int vec) {
  extern __shared__ __align__(16) float gsm[];
  __shared__ int p_q[kGBQ], p_lo[kGBQ], p_hi[kGBQ], p_pos[kGBQ], p_off[kGBQ];
  const int first = blk_first[blockIdx.x];
  if (first < 0) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tile =
      pieces[static_cast<long long>(first) * kPieceInts + 1] / kGTR;
  const long long row0 = static_cast<long long>(tile) * kGTR;
  if (tid < kGBQ) {
    const int j = first + tid;
    const int* pc = pieces + static_cast<long long>(j) * kPieceInts;
    if (j < n && pc[1] / kGTR == tile) {
      p_q[tid] = pc[0];
      p_lo[tid] = pc[1] - static_cast<int>(row0);
      p_hi[tid] = pc[1] - static_cast<int>(row0) + pc[2];
      p_pos[tid] = pc[3];
      p_off[tid] = pc[4];
    } else {
      p_q[tid] = -1;
      p_lo[tid] = p_hi[tid] = 0;
    }
  }
  __syncthreads();

  // scores: warp (wq, wr) owns pieces 16wq + qs + 4i and rows
  // 32wr + rs + 8j of the tile (lane = 8qs + rs), so each float4 read
  // of a staged row is 4 (pieces) or 8 (rows) distinct vectors: no bank
  // conflict
  const int wq = warp & 1, wr = warp >> 1;
  const int qs = lane >> 3, rs = lane & 7;
  // pieces fill the block's slots from 0, so a warp whose first slot is
  // empty has no piece: it stages and syncs, but skips the products
  const bool busy = p_q[16 * wq] >= 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int n_chunks = (d + kGDC - 1) / kGDC;
  // a ring of kGStages stages: chunk ch + kGStages - 1 is staged while
  // chunk ch is multiplied; a group is committed every step, empty or
  // not, so "all but the last kGStages - 1 groups" is always chunk ch
#pragma unroll
  for (int ch = 0; ch < kGStages - 1; ++ch) {
    if (ch < n_chunks)
      gathered_stage(gsm + ch * kGStage, q, table, p_q, row0, r, d,
                     ch * kGDC, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int ahead = ch + kGStages - 1;
    if (ahead < n_chunks)
      gathered_stage(gsm + ahead % kGStages * kGStage, q, table, p_q, row0,
                     r, d, ahead * kGDC, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kGStages - 1));
    __syncthreads();
    const float* qsm = gsm + ch % kGStages * kGStage;
    const float* tsm = qsm + kGBQ * kGS;
    if (busy) {
#pragma unroll
      for (int c = 0; c < kGDC; c += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              qsm + (16 * wq + qs + 4 * i) * kGS + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              tsm + (32 * wr + rs + 8 * j) * kGS + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
    }
    __syncthreads();   // the next step overwrites this stage
  }

  // the scores take the stages' place; each warp then selects for 4 pieces
  float* sc = gsm;                                   // [kGBQ][kGSP]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[(16 * wq + qs + 4 * i) * kGSP + 32 * wr + rs + 8 * j] = acc[i][j];
  __syncthreads();
  float* lists = gsm + kGBQ * kGSP + warp * 2 * kGTR;
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
      const float s = x < hi ? row[x] : -CUDART_INF_F;
      if (kMem)
        mem_offer(ml, s, pos0 + x, kk, lane);
      else
        reg_offer(ls, li, s, pos0 + x, kk, lane);
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

// ---- dense: tensor-core tiles (topk_partial, topk_int8_partial) ------------

constexpr int kDQ = 128;                 // queries per block
constexpr int kDN = 128;                 // corpus rows per tile
constexpr int kDChunk = 128;             // bytes of a row staged per step
constexpr int kDRow = kDChunk + 16;      // padded staged row (bytes)
constexpr int kDStages = 3;              // ring stages: 2 steps prefetched
constexpr int kDStage = (kDQ + kDN) * kDRow;          // bytes per stage
constexpr int kDSRow = kDN + 8;          // padded scratch row (floats)
constexpr int kDScratch = kWarps * 8 * kDSRow * 4;    // bytes, 8 rows a warp
constexpr int kDSmemK = 80;              // largest k with lists in smem
constexpr int kExactDepth = 8;           // f32: D at most one MMA deep
constexpr int kLaneK = 96;               // largest k offered in lanes
constexpr size_t kDFixed = size_t(kDStages) * kDStage + kDScratch;

template <typename In> struct DenseAcc { using T = float; };
template <> struct DenseAcc<signed char> { using T = int; };

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

// x as kPieces TF32 values, largest first, each but the last the TF32
// rounding (to nearest, ties away: cvt.rna's rule, by an integer add and
// mask, which run at the full ALU rate where cvt.rna.tf32 does not) of
// what the ones before leave; the last is passed as it is, and the MMA
// reads its top 10 mantissa bits. Two pieces hold about 22 of x's 24 bits
// (error below 2^-21 of x), three hold all of them.
template <int kPieces>
__device__ __forceinline__ void tf32_split(unsigned (&p)[kPieces],
                                           unsigned x) {
  float rest = __uint_as_float(x);
#pragma unroll
  for (int i = 0; i + 1 < kPieces; ++i) {
    p[i] = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
    rest = __fsub_rn(rest, __uint_as_float(p[i]));
  }
  p[kPieces - 1] = __float_as_uint(rest);
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

// The warp's 16 x 128 tile over one staged chunk: `steps` (1-4) 32-byte MMA
// steps of depth (8 floats or 32 int8 codes each), A from the staged query
// rows at a_addr, B for n8 tiles 2p and 2p + 1 from the staged corpus rows
// at b_addr + p * 16 rows. ldmatrix.x4 hands lane (g, t) word t of row g
// of four 8 x 16-byte matrices, which is exactly the A (rows 0-7 / 8-15,
// bytes 0-15 / 16-31) and B (a tile's rows, bytes 0-15 / 16-31) fragments
// of both MMA shapes. f32: the MMA truncates its sums, so 768 MMAs into
// one accumulator (D 2048) bias a sum of like-signed terms low by parts in
// 1e5, past the card tests' rtol of 1e-5; so each n8 tile sums the chunk's
// products in a fresh accumulator and adds that to its running sum with a
// rounded add. Each product a_i * b_j is taken kLoScale times larger, the
// scale on a piece below the leading one where there is one (b_j for
// j > 0, else a_i), so no such piece falls among TF32's denormals; the
// rounded add scales the chunk's sum back exactly.
constexpr float kLoScale = 4096.f;               // 2^12
constexpr float kLoUnscale = 1.f / 4096.f;

template <int kPieces>
__device__ __forceinline__ void dense_chunk(float (&acc)[16][4],
                                            unsigned a_addr, unsigned b_addr,
                                            int steps) {
  // half the n8 tiles at a time, so that their partial sums and the
  // running ones fit in registers together
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDChunk / 32; ++kk) {
      if (kk >= steps) break;                     // uniform: past d
      // a[i]: piece i of the query value; as[i]: the same times kLoScale
      unsigned raw[4], a[kPieces][4], as[kPieces][4];
      ldmatrix_x4(raw, a_addr + kk * 32);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        unsigned p[kPieces];
        tf32_split<kPieces>(p, raw[r]);
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          a[i][r] = p[i];
          as[i][r] = __float_as_uint(__uint_as_float(p[i]) * kLoScale);
        }
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        ldmatrix_x4(raw, b_addr + (4 * half + jp) * 16 * kDRow + kk * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned b0[kPieces], b1[kPieces];
          tf32_split<kPieces>(b0, raw[2 * h]);
          tf32_split<kPieces>(b1, raw[2 * h + 1]);
#pragma unroll
          for (int j = 1; j < kPieces; ++j) {       // b_j * kLoScale
            b0[j] = __float_as_uint(__uint_as_float(b0[j]) * kLoScale);
            b1[j] = __float_as_uint(__uint_as_float(b1[j]) * kLoScale);
          }
          // the products a_i * b_j * kLoScale with i + j < kPieces,
          // smallest first
#pragma unroll
          for (int sum = kPieces - 1; sum >= 0; --sum)
#pragma unroll
            for (int i = sum; i >= 0; --i)
              mma_tf32(part[2 * jp + h], sum == i ? as[i] : a[i],
                       b0[sum - i], b1[sum - i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[8 * half + j][e] =
            __fmaf_rn(part[j][e], kLoUnscale, acc[8 * half + j][e]);
  }
}

// int8: exact int32 sums, straight into the accumulators.
template <int kPieces>
__device__ __forceinline__ void dense_chunk(int (&acc)[16][4], unsigned a_addr,
                                            unsigned b_addr, int steps) {
#pragma unroll
  for (int kk = 0; kk < kDChunk / 32; ++kk) {
    if (kk >= steps) break;                       // uniform: past d
    unsigned a[4], b[4];
    ldmatrix_x4(a, a_addr + kk * 32);
#pragma unroll
    for (int jp = 0; jp < kDN / 16; ++jp) {
      ldmatrix_x4(b, b_addr + jp * 16 * kDRow + kk * 32);
      mma_s8(acc[2 * jp], a, b[0], b[1]);
      mma_s8(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// Stage bytes [ch * kDChunk, +kDChunk) of query rows q0.. and corpus rows
// n0.. (kDQ + kDN staged rows) into `stage`, zeros past nq, n and the
// rows' row_bytes. vec: rows 16-byte aligned, row_bytes % 16 == 0.
__device__ __forceinline__ void dense_stage(unsigned char* stage,
                                            const unsigned char* q,
                                            const unsigned char* c, int q0,
                                            int n0, int nq, int n,
                                            long long row_bytes, int ch,
                                            int vec) {
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(ch) * kDChunk;
  if (vec) {
#pragma unroll
    for (int p = 0; p < (kDQ + kDN) * (kDChunk / 16) / kThreads; ++p) {
      const int e = tid + p * kThreads;
      const int r = e / (kDChunk / 16), piece = e % (kDChunk / 16);
      const long long off = b0 + piece * 16;
      const bool is_q = r < kDQ;
      const int row = is_q ? q0 + r : n0 + r - kDQ;
      const unsigned char* base = is_q ? q : c;
      const bool ok = row < (is_q ? nq : n) && off < row_bytes;
      cp_async_zfill(stage + r * kDRow + piece * 16,
                     ok ? base + row * row_bytes + off : base, ok ? 16 : 0);
    }
  } else {
    for (int w = tid; w < (kDQ + kDN) * (kDChunk / 4); w += kThreads) {
      const int r = w / (kDChunk / 4), x = (w % (kDChunk / 4)) * 4;
      const bool is_q = r < kDQ;
      const int row = is_q ? q0 + r : n0 + r - kDQ;
      unsigned word = 0;
      if (row < (is_q ? nq : n)) {
        const unsigned char* src =
            (is_q ? q : c) + row * row_bytes + b0 + x;
        if (b0 + x + 4 <= row_bytes &&
            reinterpret_cast<unsigned long long>(src) % 4 == 0) {
          word = *reinterpret_cast<const unsigned*>(src);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (b0 + x + b < row_bytes) word |= unsigned(src[b]) << (8 * b);
        }
      }
      *reinterpret_cast<unsigned*>(stage + r * kDRow + x) = word;
    }
  }
}

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

// q [nq, d] and c [n, d] of type In. Writes each split's top-k list of each
// query into part_s/part_i [nq, n_splits * k]. Grid (query tile of kDQ,
// split). Lists are kept in shared memory when smem_lists, else in
// part_s/part_i; a query's list is offered its survivors in kR registers a
// lane (k <= 32 * kR), or in place (kR = 0, any k).
template <typename In, int kPieces, int kR>
__global__ void __launch_bounds__(kThreads, 1)
dense_partial(const In* __restrict__ q, const In* __restrict__ c,
              float* part_s, int* part_i, int nq, int n, int d, int k,
              int tiles_per_split, int n_splits, int vec, int smem_lists) {
  extern __shared__ __align__(128) unsigned char dsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kDQ;
  const int split = blockIdx.y;
  const int n_tiles = (n + kDN - 1) / kDN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const long long row_bytes = static_cast<long long>(d) * sizeof(In);
  // D = 0 still takes one (empty) chunk, so every tile is selected from
  const int n_chunks =
      max(1, static_cast<int>((row_bytes + kDChunk - 1) / kDChunk));
  const int steps = max(t_end - t_begin, 0) * n_chunks;
  const long long width = static_cast<long long>(n_splits) * k;
  float* scratch =
      reinterpret_cast<float*>(dsm + kDStages * kDStage) + warp * 8 * kDSRow;
  float* lists = reinterpret_cast<float*>(dsm + kDFixed);
  const auto* qb = reinterpret_cast<const unsigned char*>(q);
  const auto* cb = reinterpret_cast<const unsigned char*>(c);

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
  Acc acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = Acc(0);
  // a warp whose queries all lie past nq stages and syncs, no more
  const bool busy = q0 + 16 * warp < nq;
  // this lane's ldmatrix row: A rows 16w + (lane & 7) + 8 * (lane >> 3 & 1)
  // at byte 16 * (lane >> 4); B rows (lane & 7) + 8 * (lane >> 4) at byte
  // 16 * (lane >> 3 & 1)
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(dsm));
  const int lr = lane & 7, lm = lane >> 3;
  const unsigned a_off =
      (16 * warp + lr + 8 * (lm & 1)) * kDRow + 16 * (lm >> 1);
  const unsigned b_off = (kDQ + lr + 8 * (lm >> 1)) * kDRow + 16 * (lm & 1);

  // step s stages chunk s % n_chunks of tile t_begin + s / n_chunks; a
  // group is committed every step, empty or not, so "all but the last
  // kDStages - 2" is always step s
#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < steps)
      dense_stage(dsm + s * kDStage, qb, cb, q0,
                  (t_begin + s / n_chunks) * kDN, nq, n, row_bytes,
                  s % n_chunks, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  int tile = t_begin, ch = 0;
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDStages - 2));
    __syncthreads();   // step s has landed; step s - 1's stage is free
    const int ahead = s + kDStages - 1;
    if (ahead < steps)
      dense_stage(dsm + ahead % kDStages * kDStage, qb, cb, q0,
                  (t_begin + ahead / n_chunks) * kDN, nq, n, row_bytes,
                  ahead % n_chunks, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    if (busy) {
      const unsigned st = ring + s % kDStages * kDStage;
      const long long left = row_bytes - static_cast<long long>(ch) * kDChunk;
      dense_chunk<kPieces>(acc, st + a_off, st + b_off,
                           static_cast<int>(min(left + 31, 128LL) / 32));
    }
    if (++ch < n_chunks) continue;

    // selection: lane (g, t) holds queries 16w + g + 8h, columns
    // 8j + 2t + b of the tile in acc[j][2h + b]
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
              beats(static_cast<float>(acc[j][2 * h + b]), id, bar_s[h],
                    bar_i[h]))
            m[h] |= 1u << (2 * j + b);
        }
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
        v.x = m[h] >> (2 * j) & 1u ? static_cast<float>(acc[j][2 * h])
                                   : -CUDART_INF_F;
        v.y = m[h] >> (2 * j + 1) & 1u
                  ? static_cast<float>(acc[j][2 * h + 1])
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
            unsigned mm = __ballot_sync(kFull, sx != -CUDART_INF_F &&
                                                   beats(sx, id, kth_s,
                                                         kth_i));
            if (mm == 0u) continue;
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
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = Acc(0);
    ch = 0;
    ++tile;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

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

// The dense kernels' launch: lists offered in lanes for k <= kLaneK, in
// place beyond; kept in shared memory up to kDSmemK, else in the output.
template <typename In, int kPieces, int kR>
int launch_dense_lists(const void* q, const void* c, void* part_s,
                       void* part_i, int nq, int n, int d, int k,
                       int tiles_per_split, int n_splits, int vec,
                       cudaStream_t st) {
  const dim3 grid((nq + kDQ - 1) / kDQ, n_splits);
  const int smem_lists = k <= kDSmemK;
  const size_t bytes =
      kDFixed + (smem_lists ? size_t(kDQ) * k * 2 * sizeof(float) : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      dense_partial<In, kPieces, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_partial<In, kPieces, kR><<<grid, kThreads, bytes, st>>>(
      static_cast<const In*>(q), static_cast<const In*>(c),
      static_cast<float*>(part_s), static_cast<int*>(part_i), nq, n, d, k,
      tiles_per_split, n_splits, vec, smem_lists);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int kPieces>
int launch_dense(const void* q, const void* c, void* part_s, void* part_i,
                 int nq, int n, int d, int k, int tiles_per_split,
                 int n_splits, int vec, void* stream) {
  if (nq <= 0 || n_splits <= 0 || k <= 0)
    return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k > kLaneK ? 0 : (k + 31) / 32) {
    case 1:
      return launch_dense_lists<In, kPieces, 1>(
          q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits, vec,
          st);
    case 2:
      return launch_dense_lists<In, kPieces, 2>(
          q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits, vec,
          st);
    case 3:
      return launch_dense_lists<In, kPieces, 3>(
          q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits, vec,
          st);
    default:
      return launch_dense_lists<In, kPieces, 0>(
          q, c, part_s, part_i, nq, n, d, k, tiles_per_split, n_splits, vec,
          st);
  }
}

template <bool kMem>
__global__ void topk_merge_kernel(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i,
                                  float* out_s, int* out_i, int nq, int width,
                                  int k, int smem_lists) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= nq) return;  // uniform across the warp
  float ls = -CUDART_INF_F;
  int li = -1;
  MemList ml;
  const long long orow = static_cast<long long>(qi) * k;
  if (kMem)
    mem_place(ml, smem_lists, threadIdx.x >> 5, out_s + orow, out_i + orow,
              k, lane);
  const long long row = static_cast<long long>(qi) * width;
  for (int b = 0; b < width; b += 32) {
    const int e = b + lane;
    float s = -CUDART_INF_F;
    int id = -1;
    if (e < width) {
      s = part_s[row + e];
      id = part_i[row + e];
    }
    if (kMem)
      mem_offer(ml, s, id, k, lane);
    else
      reg_offer(ls, li, s, id, k, lane);
  }
  if (!kMem && lane < k) {
    out_s[orow + lane] = ls;
    out_i[orow + lane] = li;
  } else if (kMem && smem_lists) {
    mem_store(ml, out_s + orow, out_i + orow, k, lane);
  }
}

}  // namespace

// queries/corpus f32 [nq, d] / [n, d]; vec = 1 when both are 16-byte
// aligned and d % 4 == 0. D <= kExactDepth takes the exact three-piece split.
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

// query/corpus int8 codes [nq, d] / [n, d]; vec = 1 when both are 16-byte
// aligned and d % 16 == 0.
extern "C" int topk_int8_partial(const void* q, const void* c, void* part_s,
                                 void* part_i, int nq, int n, int d, int k,
                                 int tiles_per_split, int n_splits, int vec,
                                 void* stream) {
  return launch_dense<signed char, 1>(q, c, part_s, part_i, nq, n, d, k,
                                      tiles_per_split, n_splits, vec, stream);
}

extern "C" int topk_merge(const void* part_s, const void* part_i, void* out_s,
                          void* out_i, int nq, int width, int k,
                          void* stream) {
  if (nq > 0 && k > 0) {
    const dim3 grid((nq + kMergeWarps - 1) / kMergeWarps);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ps = static_cast<const float*>(part_s);
    const int* pi = static_cast<const int*>(part_i);
    float* os = static_cast<float*>(out_s);
    int* oi = static_cast<int*>(out_i);
    const int smem = k <= kSmemK;
    const size_t bytes = smem ? size_t(kMergeWarps) * k * 8 : 0;
    if (k <= kRegK)
      topk_merge_kernel<false><<<grid, kMergeWarps * 32, 0, st>>>(
          ps, pi, os, oi, nq, width, k, 0);
    else
      topk_merge_kernel<true><<<grid, kMergeWarps * 32, bytes, st>>>(
          ps, pi, os, oi, nq, width, k, smem);
  }
  return static_cast<int>(cudaGetLastError());
}

// queries f32 [nq, d], table f32 [r, d]; pieces int32 [n, 5] (query,
// first row, length, first position, slot offset) sorted by row tile of
// kGTR rows, no piece crossing a tile; blk_first int32 [n_blocks], the
// first piece of each block (every kGBQ-th piece of a tile, -1: none);
// part_s/part_i [nq, width], filled with (-inf, -1) by the caller. vec = 1
// when queries and table are 16-byte aligned and d % 4 == 0.
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
    const size_t bytes = kGStages * kGStage * sizeof(float);
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
