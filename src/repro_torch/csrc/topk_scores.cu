// Fused scoring + top-k, any k: inner products over a dense corpus (f32
// vectors and int8 codes), inner products over per-query candidate rows
// gathered from a table (the ivfflat probe), and Hamming distances over
// packed sign codes (the lsh scan).
//
// Replaces the TPU kernels of src/repro/kernels/topk_scoring/topk_scoring.py:
// _topk_kernel (f32), _topk_int8_kernel (int8 x int8 -> int32 dot, ranked
// as f32, rows at or past n masked in the kernel) and _gathered_kernel (each
// query scores its own candidate set; an id of -1 scores -inf; ties to the
// earliest candidate position), that of
// src/repro/kernels/lsh_hamming/lsh_hamming.py: _hamming_kernel (XOR +
// popcount over W words, top k of -distance, rows past n masked), and the
// cross-block lax.top_k merge that follows each.
//
// What bounds them on an H100. f32: operations. Scoring Q queries against N
// rows of width D is 2*Q*N*D flops over (Q + N)*D*4 bytes; at the main
// path's Q = 128 that is 64 flops a byte, above the card's f32 ridge (67
// TFLOP/s over 3.35 TB/s = 20 flops a byte). int8: bytes at the card's
// published int8 rate (1979 TOP/s, tensor cores), but this kernel does its
// dot with __dp4a on the CUDA cores, whose rate is far lower, so in practice
// the dp4a issue rate sets its time. The (Q, N) score matrix never leaves
// registers: like the TPU kernels, only per-split top-k partials reach device
// memory. Gathered: the least the card must move is each distinct probed
// row once, and its 2*C_valid*D flops (C_valid valid slots over all
// queries) then bound it at the f32 rate: at the ivfflat probe of the
// evaluation path, 98 GFLOP against 2.6 GB of distinct rows. A kernel that
// scores each query's rows on their own reads a list once per query that
// probes it (about 64 at that shape), so bytes set its time; this one
// shares each row tile among the queries that probe it, so operations do.
// Hamming: 3 integer operations (xor, popc, add) per word per (query, row)
// pair over 16 bytes a row; at W = 4 selection, not scoring, is most of
// the work.
//
// Design (simple first; wgmma/TMA/pipelining are later work):
//  * topk_partial_{reg,mem}<T>: grid (candidate split, query tile). A block of
//    256 threads holds a 32-query tile and walks its split's 128-row
//    candidate tiles. D streams through shared memory in chunks of 32
//    elements (T = float: one f32; T = int: four int8 codes packed in a
//    word, zero past D), queries row-major and candidates transposed so each
//    lane reads a 16-byte vector of 4 candidates; each thread keeps a 4x4
//    register tile of sums (f32 FMA, or int32 __dp4a). Warp w owns queries
//    4w..4w+3 of the tile, which are exactly the rows its lanes computed, so
//    selection reads scores straight from registers.
//  * Each warp keeps one running top-k list per query ordered by score
//    descending, ties to the lower id. For k <= 32 the list lives in lanes
//    0..k-1. For larger k it lives in memory, shifted in parallel by the
//    warp 32 entries at a time, with the k-th entry cached in registers so
//    a candidate that cannot enter costs one compare: in shared memory
//    while the block's lists fit in the default 48 KB (k <= 96), else in
//    the query's slice of the output in device memory, whose every access
//    waits on L2 (on an H100 at the main path's shapes, device-memory lists
//    made k = 40 take twice the time of k = 20). A ballot finds the
//    candidates that beat the current k-th entry, and each is inserted in
//    turn. Rows at or past n are masked here (no sentinel column, which
//    would break aligned loads).
//  * hamming_partial<kMem>: the same grid, tiles and lists; lane l of warp w
//    holds rows n0 + 32j + l (j < 4) and the distances to the warp's 4
//    queries in registers, words read as 16-byte vectors when W % 4 == 0.
//    Distances are small integers, so ties are the rule: the (score, id)
//    order of the lists is what returns exactly the plain version's ids.
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
constexpr int kBQ = 32;        // queries per block tile
constexpr int kBN = 128;       // candidates per block tile
constexpr int kDC = 32;        // D chunk staged in shared memory (elements)
constexpr int kQStride = kDC + 4;   // row-major query tile, 16-byte aligned
constexpr int kCStride = kBN + 4;   // transposed candidate tile
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

// ---- loading and multiplying one element type -------------------------------

// f32: elements are floats; 4 consecutive elements of row `src` from `e`.
__device__ __forceinline__ float4 load4(const float* src, int e, int d,
                                        int vec) {
  if (vec && e + 3 < d) return *reinterpret_cast<const float4*>(src + e);
  float4 v;
  v.x = e < d ? src[e] : 0.f;
  v.y = e + 1 < d ? src[e + 1] : 0.f;
  v.z = e + 2 < d ? src[e + 2] : 0.f;
  v.w = e + 3 < d ? src[e + 3] : 0.f;
  return v;
}

// int8: an element is a word of 4 codes (zero past d); 4 words from word e.
__device__ __forceinline__ int4 load4(const signed char* src, int e, int d,
                                      int vec) {
  if (vec && 4 * (e + 4) <= d)
    return *reinterpret_cast<const int4*>(src + 4 * e);
  int w[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int idx = 4 * (e + t) + b;
      const unsigned byte =
          idx < d ? static_cast<unsigned char>(src[idx]) : 0u;
      word |= byte << (8 * b);
    }
    w[t] = static_cast<int>(word);
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// packed sign codes: 4 words of row `src` from word e, zero past w.
__device__ __forceinline__ int4 load4(const int* src, int e, int w,
                                      int vec) {
  if (vec && e + 3 < w) return *reinterpret_cast<const int4*>(src + e);
  return make_int4(e < w ? src[e] : 0, e + 1 < w ? src[e + 1] : 0,
                   e + 2 < w ? src[e + 2] : 0, e + 3 < w ? src[e + 3] : 0);
}

__device__ __forceinline__ float madd(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ int madd(int a, int b, int acc) {
  return __dp4a(a, b, acc);
}

template <typename In> struct Elem;
template <> struct Elem<float> { using T = float; using V = float4; };
template <> struct Elem<signed char> { using T = int; using V = int4; };

// q [nq, d] and c [n, d] of type In. Writes each split's top-k list of each
// query into part_s/part_i [nq, n_splits * k]. Values that the main loop
// does not need (the output width) are computed where they are used, which
// keeps them out of the registers the loop's schedule needs.
template <typename In, bool kMem>
__device__ __forceinline__ void
topk_partial_body(const In* __restrict__ q, const In* __restrict__ c,
                  float* part_s, int* part_i, int nq, int n, int d, int k,
                  int tiles_per_split, int n_splits, int vec,
                  int smem_lists) {
  using T = typename Elem<In>::T;
  using V = typename Elem<In>::V;
  __shared__ __align__(16) T qs[kBQ * kQStride];
  __shared__ __align__(16) T cs[kDC * kCStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  // elements along d per row: floats, or words of 4 int8 codes
  const int de = sizeof(In) == 1 ? (d + 3) / 4 : d;

  float ls[4];
  int li[4];
  MemList ml[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ls[i] = -CUDART_INF_F;
    li[i] = -1;
    if (kMem && q0 + warp * 4 + i < nq) {  // uniform in the warp
      const long long o =
          static_cast<long long>(q0 + warp * 4 + i) * n_splits * k +
          split * k;
      mem_place(ml[i], smem_lists, warp * 4 + i, part_s + o, part_i + o, k,
                lane);
    }
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kBN;
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

    for (int d0 = 0; d0 < de; d0 += kDC) {
      // query tile: kBQ x kDC elements, one 16-byte vector per thread
      {
        const int r = tid / (kDC / 4);
        const int c4 = (tid % (kDC / 4)) * 4;
        const int gq = q0 + r;
        V v = {};
        if (gq < nq) v = load4(q + static_cast<long long>(gq) * d, d0 + c4,
                               d, vec);
        *reinterpret_cast<V*>(&qs[r * kQStride + c4]) = v;
      }
      // candidate tile: kBN x kDC elements, transposed into cs[e][n]
#pragma unroll
      for (int p = 0; p < (kBN * kDC / 4) / kThreads; ++p) {
        const int e = tid + p * kThreads;
        const int r = e / (kDC / 4);
        const int c4 = (e % (kDC / 4)) * 4;
        const int gn = n0 + r;
        V v = {};
        if (gn < n) v = load4(c + static_cast<long long>(gn) * d, d0 + c4,
                              d, vec);
        cs[(c4 + 0) * kCStride + r] = v.x;
        cs[(c4 + 1) * kCStride + r] = v.y;
        cs[(c4 + 2) * kCStride + r] = v.z;
        cs[(c4 + 3) * kCStride + r] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kDC; cc += 4) {
        V qv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const V*>(
              &qs[(warp * 4 + i) * kQStride + cc]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          cv[t] = *reinterpret_cast<const V*>(
              &cs[(cc + t) * kCStride + lane * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T qa[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            acc[i][0] = madd(qa[t], cv[t].x, acc[i][0]);
            acc[i][1] = madd(qa[t], cv[t].y, acc[i][1]);
            acc[i][2] = madd(qa[t], cv[t].z, acc[i][2]);
            acc[i][3] = madd(qa[t], cv[t].w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }

    // selection: warp owns queries warp*4 + i, lane holds candidates
    // n0 + lane*4 + j; int8 sums are ranked as f32, like the reference's
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kMem && q0 + warp * 4 + i >= nq) continue;  // uniform in the warp
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int id = n0 + lane * 4 + j;
        const float s =
            id < n ? static_cast<float>(acc[i][j]) : -CUDART_INF_F;
        if (kMem)
          mem_offer(ml[i], s, id, k, lane);
        else
          reg_offer(ls[i], li[i], s, id, k, lane);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + warp * 4 + i;
    const long long o =
        static_cast<long long>(gq) * n_splits * k + split * k;
    if (gq >= nq) continue;  // uniform in the warp
    if (!kMem && lane < k) {
      part_s[o + lane] = ls[i];
      part_i[o + lane] = li[i];
    } else if (kMem && smem_lists) {
      mem_store(ml[i], part_s + o, part_i + o, k, lane);
    }
  }
}

// The kernels of the two list layouts. Left to its own heuristics, the
// compiler gives the long-k body about 100 registers (two blocks per SM) and
// the k <= 32 body 64; held to four blocks per SM (64 registers, a little
// spill in the insertion path) the long-k body ran about 20 % faster on an
// H100 at the main path's shapes, while the same bound on the k <= 32 body
// changed its schedule and cost it 10 %.
template <typename In>
__global__ void __launch_bounds__(kThreads)
topk_partial_reg(const In* __restrict__ q, const In* __restrict__ c,
                 float* part_s, int* part_i, int nq, int n, int d, int k,
                 int tiles_per_split, int n_splits, int vec) {
  topk_partial_body<In, false>(q, c, part_s, part_i, nq, n, d, k,
                               tiles_per_split, n_splits, vec, 0);
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 4)
topk_partial_mem(const In* __restrict__ q, const In* __restrict__ c,
                 float* part_s, int* part_i, int nq, int n, int d, int k,
                 int tiles_per_split, int n_splits, int vec, int smem_lists) {
  topk_partial_body<In, true>(q, c, part_s, part_i, nq, n, d, k,
                              tiles_per_split, n_splits, vec, smem_lists);
}

// q [nq, w] and c [n, w] packed codes. Writes each split's top-k list of
// -distance for each query into part_s/part_i [nq, n_splits * k].
template <bool kMem>
__global__ void __launch_bounds__(kThreads)
hamming_partial_kernel(const int* __restrict__ q, const int* __restrict__ c,
                       float* part_s, int* part_i, int nq, int n, int w,
                       int k, int tiles_per_split, int n_splits, int vec,
                       int smem_lists) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  float ls[4];
  int li[4];
  MemList ml[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ls[i] = -CUDART_INF_F;
    li[i] = -1;
    if (kMem && q0 + warp * 4 + i < nq) {  // uniform in the warp
      const long long o =
          static_cast<long long>(q0 + warp * 4 + i) * n_splits * k +
          split * k;
      mem_place(ml[i], smem_lists, warp * 4 + i, part_s + o, part_i + o, k,
                lane);
    }
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kBN;
    int dist[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dist[i][j] = 0;
    for (int x = 0; x < w; x += 4) {
      int4 cv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + 32 * j + lane;
        cv[j] = gn < n ? load4(c + static_cast<long long>(gn) * w, x, w, vec)
                       : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gq = q0 + warp * 4 + i;
        const int4 qv = gq < nq ? load4(q + static_cast<long long>(gq) * w,
                                        x, w, vec)
                                : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dist[i][j] += __popc(qv.x ^ cv[j].x) + __popc(qv.y ^ cv[j].y) +
                        __popc(qv.z ^ cv[j].z) + __popc(qv.w ^ cv[j].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kMem && q0 + warp * 4 + i >= nq) continue;  // uniform in the warp
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int id = n0 + 32 * j + lane;
        const float s =
            id < n ? -static_cast<float>(dist[i][j]) : -CUDART_INF_F;
        if (kMem)
          mem_offer(ml[i], s, id, k, lane);
        else
          reg_offer(ls[i], li[i], s, id, k, lane);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + warp * 4 + i;
    const long long o =
        static_cast<long long>(gq) * n_splits * k + split * k;
    if (gq >= nq) continue;  // uniform in the warp
    if (!kMem && lane < k) {
      part_s[o + lane] = ls[i];
      part_i[o + lane] = li[i];
    } else if (kMem && smem_lists) {
      mem_store(ml[i], part_s + o, part_i + o, k, lane);
    }
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

template <typename In>
int launch_partial(const void* q, const void* c, void* part_s, void* part_i,
                   int nq, int n, int d, int k, int tiles_per_split,
                   int n_splits, int vec, void* stream) {
  if (nq > 0 && n_splits > 0 && k > 0) {
    const dim3 grid(n_splits, (nq + kBQ - 1) / kBQ);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const In* qp = static_cast<const In*>(q);
    const In* cp = static_cast<const In*>(c);
    float* ps = static_cast<float*>(part_s);
    int* pi = static_cast<int*>(part_i);
    const int smem = k <= kSmemK;
    const size_t bytes = smem ? size_t(kBQ) * k * 8 : 0;
    if (k <= kRegK)
      topk_partial_reg<In><<<grid, kThreads, 0, st>>>(
          qp, cp, ps, pi, nq, n, d, k, tiles_per_split, n_splits, vec);
    else
      topk_partial_mem<In><<<grid, kThreads, bytes, st>>>(
          qp, cp, ps, pi, nq, n, d, k, tiles_per_split, n_splits, vec,
          smem);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_hamming(const void* q, const void* c, void* part_s, void* part_i,
                   int nq, int n, int w, int k, int tiles_per_split,
                   int n_splits, int vec, void* stream) {
  if (nq > 0 && n_splits > 0 && k > 0) {
    const dim3 grid(n_splits, (nq + kBQ - 1) / kBQ);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* qp = static_cast<const int*>(q);
    const int* cp = static_cast<const int*>(c);
    float* ps = static_cast<float*>(part_s);
    int* pi = static_cast<int*>(part_i);
    const int smem = k <= kSmemK;
    const size_t bytes = smem ? size_t(kBQ) * k * 8 : 0;
    if (k <= kRegK)
      hamming_partial_kernel<false><<<grid, kThreads, 0, st>>>(
          qp, cp, ps, pi, nq, n, w, k, tiles_per_split, n_splits, vec, 0);
    else
      hamming_partial_kernel<true><<<grid, kThreads, bytes, st>>>(
          qp, cp, ps, pi, nq, n, w, k, tiles_per_split, n_splits, vec,
          smem);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries/corpus f32 [nq, d] / [n, d]; vec = 1 when both are 16-byte
// aligned and d % 4 == 0.
extern "C" int topk_partial(const void* q, const void* c, void* part_s,
                            void* part_i, int nq, int n, int d, int k,
                            int tiles_per_split, int n_splits, int vec,
                            void* stream) {
  return launch_partial<float>(q, c, part_s, part_i, nq, n, d, k,
                               tiles_per_split, n_splits, vec, stream);
}

// query/corpus int8 codes [nq, d] / [n, d]; vec = 1 when both are 16-byte
// aligned and d % 16 == 0.
extern "C" int topk_int8_partial(const void* q, const void* c, void* part_s,
                                 void* part_i, int nq, int n, int d, int k,
                                 int tiles_per_split, int n_splits, int vec,
                                 void* stream) {
  return launch_partial<signed char>(q, c, part_s, part_i, nq, n, d, k,
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

// packed sign codes int32 [nq, w] / [n, w]; vec = 1 when both are 16-byte
// aligned and w % 4 == 0. The same argument layout as topk_partial, so the
// wrapper and topk_merge are shared.
extern "C" int hamming_partial(const void* q, const void* c, void* part_s,
                               void* part_i, int nq, int n, int w, int k,
                               int tiles_per_split, int n_splits, int vec,
                               void* stream) {
  return launch_hamming(q, c, part_s, part_i, nq, n, w, k, tiles_per_split,
                        n_splits, vec, stream);
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
