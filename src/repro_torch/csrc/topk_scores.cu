// Fused inner-product scoring + top-k over a dense corpus, any k, for f32
// vectors and for int8 codes.
//
// Replaces the TPU kernels of src/repro/kernels/topk_scoring/topk_scoring.py:
// _topk_kernel (f32) and _topk_int8_kernel (int8 x int8 -> int32 dot, ranked
// as f32, rows at or past n masked in the kernel), and the cross-block
// lax.top_k merge that follows each (topk_scoring.py:187, :217).
//
// What bounds them on an H100. f32: operations. Scoring Q queries against N
// rows of width D is 2*Q*N*D flops over (Q + N)*D*4 bytes; at the main
// path's Q = 128 that is 64 flops a byte, above the card's f32 ridge (67
// TFLOP/s over 3.35 TB/s = 20 flops a byte). int8: bytes at the card's
// published int8 rate (1979 TOP/s, tensor cores), but this kernel does its
// dot with __dp4a on the CUDA cores, whose rate is far lower, so in practice
// the dp4a issue rate sets its time. The (Q, N) score matrix never leaves
// registers: like the TPU kernels, only per-split top-k partials reach device
// memory.
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
//  * topk_merge_kernel: one warp per query merges the n_splits*k partials
//    with the same insertion, so ties still go to the lowest id.
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
