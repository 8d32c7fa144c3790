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
// list once, and its 2*Q*C*D flops then bound it at the f32 rate; this
// kernel reads each query's candidate rows anew (no reuse across queries
// beyond what L2 happens to hold), so the bytes of Q*C_valid rows set its
// time. Hamming: 3 integer operations (xor, popc, add) per word per
// (query, row) pair over 16 bytes a row; at W = 4 selection, not scoring,
// is most of the work.
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
//  * gathered_partial<kMem>: grid (query, group of 8 splits); each warp owns
//    one (query, split of the candidate positions). For every 32 positions
//    each lane loads one (row, id); the warp then computes the dot of each
//    valid candidate in turn (lanes stride D in 16-byte vectors, a shuffle
//    tree sums them), lane t keeping candidate t's score, and offers the 32
//    (score, position) pairs to its list. Invalid slots cost one load of
//    their id. Lists key on the position, so the merge's (score desc, key
//    asc) order is the reference's earliest-position rule; the wrapper maps
//    positions to ids.
//  * topk_merge_kernel: one warp per query merges the n_splits*k partials
//    with the same insertion, so ties still go to the lowest id (position).
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

// q [nq, d]; candidate p of query qi is table[rows[qi, p]], valid when
// ids[qi, p] >= 0. Writes each split's top-k list of (score, position) into
// part_s/part_i [nq, n_splits * k].
template <bool kMem>
__global__ void __launch_bounds__(kThreads)
gathered_partial_kernel(const float* __restrict__ q,
                        const float* __restrict__ table,
                        const int* __restrict__ rows,
                        const int* __restrict__ ids, float* part_s,
                        int* part_i, int nq, int c, int d, int k,
                        int per_split, int n_splits, int vec,
                        int smem_lists) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x;
  const int split = blockIdx.y * kWarps + warp;
  if (qi >= nq || split >= n_splits) return;  // uniform in the warp
  const int p_begin = split * per_split;
  const int p_end = min(p_begin + per_split, c);
  const float* qrow = q + static_cast<long long>(qi) * d;
  const long long crow = static_cast<long long>(qi) * c;
  const long long o = (static_cast<long long>(qi) * n_splits + split) * k;

  float ls = -CUDART_INF_F;
  int li = -1;
  MemList ml;
  if (kMem) mem_place(ml, smem_lists, warp, part_s + o, part_i + o, k, lane);

  for (int p0 = p_begin; p0 < p_end; p0 += 32) {
    const int p = p0 + lane;
    int my_row = 0;
    int my_id = -1;
    if (p < p_end) {
      my_row = rows[crow + p];
      my_id = ids[crow + p];
    }
    float my_s = -CUDART_INF_F;
    unsigned live = __ballot_sync(kFull, my_id >= 0);
    while (live) {
      const int t = __ffs(live) - 1;
      live &= live - 1;
      const float* v =
          table + static_cast<long long>(__shfl_sync(kFull, my_row, t)) * d;
      float acc = 0.f;
      if (vec) {
#pragma unroll 4
        for (int e = 4 * lane; e < d; e += 128) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + e);
          const float4 b = *reinterpret_cast<const float4*>(v + e);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      } else {
        for (int e = lane; e < d; e += 32) acc = fmaf(qrow[e], v[e], acc);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (lane == t) my_s = acc;
    }
    if (kMem)
      mem_offer(ml, my_s, p, k, lane);
    else
      reg_offer(ls, li, my_s, p, k, lane);
  }
  if (!kMem && lane < k) {
    part_s[o + lane] = ls;
    part_i[o + lane] = li;
  } else if (kMem && smem_lists) {
    mem_store(ml, part_s + o, part_i + o, k, lane);
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

// queries f32 [nq, d], table f32 [r, d], rows/ids int32 [nq, c]; positions
// [p * per_split, (p + 1) * per_split) of each query form split p; vec = 1
// when queries and table are 16-byte aligned and d % 4 == 0.
extern "C" int gathered_partial(const void* q, const void* table,
                                const void* rows, const void* ids,
                                void* part_s, void* part_i, int nq, int c,
                                int d, int k, int per_split, int n_splits,
                                int vec, void* stream) {
  if (nq > 0 && n_splits > 0 && k > 0) {
    const dim3 grid(nq, (n_splits + kWarps - 1) / kWarps);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* qp = static_cast<const float*>(q);
    const float* tp = static_cast<const float*>(table);
    const int* rp = static_cast<const int*>(rows);
    const int* ip = static_cast<const int*>(ids);
    float* ps = static_cast<float*>(part_s);
    int* pi = static_cast<int*>(part_i);
    const int smem = k <= kSmemK;
    const size_t bytes = smem ? size_t(kWarps) * k * 8 : 0;
    if (k <= kRegK)
      gathered_partial_kernel<false><<<grid, kThreads, 0, st>>>(
          qp, tp, rp, ip, ps, pi, nq, c, d, k, per_split, n_splits, vec, 0);
    else
      gathered_partial_kernel<true><<<grid, kThreads, bytes, st>>>(
          qp, tp, rp, ip, ps, pi, nq, c, d, k, per_split, n_splits, vec,
          smem);
  }
  return static_cast<int>(cudaGetLastError());
}
