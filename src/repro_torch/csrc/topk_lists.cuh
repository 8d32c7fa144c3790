// The top-k kernels' lists and shared arithmetic, included inside the
// anonymous namespace of topk_scores.cu and dense_topk.cu: the order of
// entries (beats), lists in lanes, in registers and in memory, and (from
// tf32.cuh) the 3xTF32 split of f32 values for the tensor cores.

#include "tf32.cuh"

constexpr unsigned kFull = 0xffffffffu;

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

// Sort the warp's 32 entries, one a lane, best first by beats (a bitonic
// network: equal entries stay where they are).
__device__ __forceinline__ void warp_sort(float& s, int& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ps = __shfl_xor_sync(kFull, s, stride);
      const int pi = __shfl_xor_sync(kFull, id, stride);
      // a block of `size` runs best first where lane & size is 0; its
      // lower lane of a pair keeps the better entry there
      const bool better_here = ((lane & stride) == 0) == ((lane & size) == 0);
      if (better_here ? beats(ps, pi, s, id) : beats(s, id, ps, pi)) {
        s = ps;
        id = pi;
      }
    }
  }
}

// Offer one candidate per lane (s = -inf means none) to the warp's list.
// Up to kFewWinners lanes that beat the k-th entry are inserted one by
// one; more (a list's first chunks, sorted lists merged) are sorted and
// merged with the list at once (the better of entry i and candidate 31 -
// i is a bitonic sequence holding the best 32; five more steps sort it),
// where inserting each would take a ballot and shuffles apiece. Lanes
// k..31 stay at (-inf, -1), as reg_insert leaves them, so either way the
// list is the k best by beats.
constexpr int kFewWinners = 4;

__device__ __forceinline__ void reg_offer(float& ls, int& li, float s,
                                          int id, int k, int lane) {
  const float kth_s = __shfl_sync(kFull, ls, k - 1);
  const int kth_i = __shfl_sync(kFull, li, k - 1);
  const bool win = s != -CUDART_INF_F && beats(s, id, kth_s, kth_i);
  unsigned m = __ballot_sync(kFull, win);
  if (__popc(m) <= kFewWinners) {
    while (m) {
      const int t = __ffs(m) - 1;
      m &= m - 1;
      reg_insert(ls, li, __shfl_sync(kFull, s, t), __shfl_sync(kFull, id, t),
                 k, lane);
    }
    return;
  }
  float cs = win ? s : -CUDART_INF_F;
  int ci = win ? id : -1;
  warp_sort(cs, ci, lane);
  const float rs = __shfl_sync(kFull, cs, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (beats(rs, ri, ls, li)) {
    ls = rs;
    li = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const float ps = __shfl_xor_sync(kFull, ls, stride);
    const int pi = __shfl_xor_sync(kFull, li, stride);
    if ((lane & stride) == 0 ? beats(ps, pi, ls, li) : beats(ls, li, ps, pi)) {
      ls = ps;
      li = pi;
    }
  }
  if (lane >= k) {
    ls = -CUDART_INF_F;
    li = -1;
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

template <typename In> struct DenseAcc { using T = float; };
template <> struct DenseAcc<signed char> { using T = int; };
