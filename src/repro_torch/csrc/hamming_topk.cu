// Exact top-k of -Hamming distance over packed sign codes, by a counting
// select (the lsh scan).
//
// Replaces the TPU kernel src/repro/kernels/lsh_hamming/lsh_hamming.py::
// _hamming_kernel (:27, its pallas_call at :67): XOR + popcount over W
// packed int32 words, rows past n masked, the top k of -distance with ties
// to the lowest id, and the lax.top_k merge across its grid that follows.
//
// What bounds it on an H100: the popcounts. A (query, row) pair takes W
// 32-bit popc, which the SMs issue at a lower rate than other integer
// operations (tools/mma_rate.py measures it); bytes are each code read once
// (16 bytes a row at W 4) and the k results written once, less.
//
// Design. Distances are integers in [0, 32W], so the k-th smallest of a
// query is found by counting, not by comparing candidates; no list is kept
// and no merge follows. Three kernels, launched in turn by hamming_topk:
//  * hamming_count_kernel: grid (split of the corpus, 32-query tile); a
//    block of 256 threads walks its split's 128-row tiles in id order; warp
//    w owns queries 4w..4w+3 and lane l the rows n0 + 32j + l (j < 4), whose
//    distances to the warp's queries it computes with popc on 16-byte code
//    loads (a word at a time where W % 4 or the alignment says so). Each
//    distance adds one to its query's histogram of 32W + 1 bins, which only
//    the owning warp touches (shared memory while the block's 32
//    histograms fit in 48 KB, W <= 11; else the query's row of the global
//    histogram directly). The histograms go out once a split, as
//    hist[query][split][bin].
//    Where W <= 7 a distance fits a byte, and the kernel also writes
//    each one to dist8[query][row] (Q N bytes: 268 MB at Q 512, N 524288,
//    less time than computing them again).
//  * hamming_threshold_kernel: a warp a query sums its histogram over the
//    splits, 32 bins at a time with a warp scan, and finds t, the first
//    distance with count(<= t) >= k. It rewrites, for every bin up to t
//    and every split, the output slot where that split's rows of that
//    distance start: count(< bin) plus the same bin's rows in earlier
//    splits. thr[query] = t.
//  * hamming_collect_kernel: the count kernel's walk again, reading each
//    distance back from dist8, or recomputing it where W > 7. A row is
//    kept when its distance is at most t (one compare drops almost every
//    row, and one ballot a query drops a tile with none). A kept row's
//    slot is its bin's start for the split plus its rank among the split's
//    earlier rows of that distance: __match_any_sync groups the lanes of a
//    32-row chunk by distance, popc of the lower lanes of its group ranks a
//    lane, and the group's lowest lane moves the bin's running start on by
//    the group's size. Chunks run in id order, so slots follow (distance,
//    id): the plain version's order (score descending, ties to the lowest
//    id). A row at distance t is written only if its slot is below k; every
//    slot below k is written, since count(<= t) >= k.
// The histograms' bin counts are atomic adds from one warp each, so their
// values, the threshold and the output do not depend on the order the
// hardware runs them in.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHThreads = 256;
constexpr int kHWarps = kHThreads / 32;
constexpr int kHQ = 32;                  // queries per block
constexpr int kHN = 128;                 // corpus rows per tile
constexpr int kHQW = 4;                  // queries per warp: kHQ / kHWarps
constexpr int kHSmem = 48 * 1024;        // histograms in shared memory below
constexpr int kStoreWords = 7;           // distances fit a byte: 32 w < 256

// 4 words of row `src` from word e, zero past w.
__device__ __forceinline__ int4 load4(const int* src, int e, int w,
                                      int vec) {
  if (vec && e + 3 < w) return *reinterpret_cast<const int4*>(src + e);
  return make_int4(e < w ? src[e] : 0, e + 1 < w ? src[e + 1] : 0,
                   e + 2 < w ? src[e + 2] : 0, e + 3 < w ? src[e + 3] : 0);
}

// dist[i][j]: distance of query q0w + i to row n0 + 32j + lane (0 past nq
// or n).
__device__ __forceinline__ void tile_dist(const int* __restrict__ q,
                                          const int* __restrict__ c,
                                          int q0w, int nq, int n0, int n,
                                          int w, int vec, int lane,
                                          int (&dist)[kHQW][4]) {
#pragma unroll
  for (int i = 0; i < kHQW; ++i)
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
    for (int i = 0; i < kHQW; ++i) {
      const int gq = q0w + i;
      const int4 qv = gq < nq ? load4(q + static_cast<long long>(gq) * w, x,
                                      w, vec)
                              : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dist[i][j] += __popc(qv.x ^ cv[j].x) + __popc(qv.y ^ cv[j].y) +
                      __popc(qv.z ^ cv[j].z) + __popc(qv.w ^ cv[j].w);
    }
  }
}

// The bins of query `gq` (the block's query `qi`) for split `split`: in
// dynamic shared memory when `smem`, else its row of hist [nq][n_splits]
// [bins].
__device__ __forceinline__ int* bins_of(int* hist, int smem, int gq, int qi,
                                        int split, int n_splits, int bins) {
  extern __shared__ int sh[];
  return smem ? sh + qi * bins
              : hist + (static_cast<long long>(gq) * n_splits + split) * bins;
}

// kStore: also write each distance as a byte, dist8[query][row].
template <bool kStore>
__global__ void __launch_bounds__(kHThreads)
hamming_count_kernel(const int* __restrict__ q, const int* __restrict__ c,
                     int* hist, unsigned char* __restrict__ dist8, int nq,
                     int n, int w, int bins, int tiles_per_split,
                     int n_splits, int vec, int smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int q0w = blockIdx.y * kHQ + warp * kHQW;
  if (q0w >= nq) return;  // uniform in the warp; no block-wide sync below
  const int n_tiles = (n + kHN - 1) / kHN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  int* h[kHQW];
#pragma unroll
  for (int i = 0; i < kHQW; ++i) {
    h[i] = bins_of(hist, smem, q0w + i, warp * kHQW + i, split, n_splits,
                   bins);
    if (q0w + i < nq)
      for (int b = lane; b < bins; b += 32) h[i][b] = 0;
  }
  __syncwarp();
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kHN;
    int dist[kHQW][4];
    tile_dist(q, c, q0w, nq, n0, n, w, vec, lane, dist);
#pragma unroll
    for (int i = 0; i < kHQW; ++i) {
      if (q0w + i >= nq) continue;  // uniform in the warp
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int id = n0 + 32 * j + lane;
        if (id >= n) continue;
        atomicAdd(h[i] + dist[i][j], 1);
        if (kStore)
          dist8[static_cast<long long>(q0w + i) * n + id] =
              static_cast<unsigned char>(dist[i][j]);
      }
    }
  }
  __syncwarp();
  if (smem) {
#pragma unroll
    for (int i = 0; i < kHQW; ++i) {
      if (q0w + i >= nq) continue;
      int* out = hist + (static_cast<long long>(q0w + i) * n_splits + split)
                            * bins;
      for (int b = lane; b < bins; b += 32) out[b] = h[i][b];
    }
  }
}

__global__ void __launch_bounds__(kHThreads)
hamming_threshold_kernel(int* hist, int* thr, int nq, int bins,
                         int n_splits, int k) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kHWarps + (threadIdx.x >> 5);
  if (qi >= nq) return;  // uniform in the warp
  int* row = hist + static_cast<long long>(qi) * n_splits * bins;
  int below = 0;  // rows at distances below this chunk of bins
  int t = -1;
  for (int b0 = 0; b0 < bins && t < 0; b0 += 32) {
    const int b = b0 + lane;
    int tot = 0;
    if (b < bins)
      for (int s = 0; s < n_splits; ++s) tot += row[s * bins + b];
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const unsigned hit = __ballot_sync(kFull, b < bins && below + incl >= k);
    if (b < bins) {
      int start = below + incl - tot;  // count(< b)
      for (int s = 0; s < n_splits; ++s) {
        const int v = row[s * bins + b];
        row[s * bins + b] = start;
        start += v;
      }
    }
    if (hit) t = b0 + __ffs(hit) - 1;
    below += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) thr[qi] = t;
}

// Collect the kept rows of one tile for the warp's queries: dist[i][j] is
// query q0w + i's distance to row n0 + 32j + lane; t[i] its threshold (-1:
// no such query), cur[i] its running bin starts for the split.
__device__ __forceinline__ void collect_tile(const int (&dist)[kHQW][4],
                                             const int (&t)[kHQW],
                                             int* const (&cur)[kHQW], int n0,
                                             int n, int q0w, int k, int lane,
                                             float* out_s, int* out_i) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kHQW; ++i) {
    if (t[i] < 0) continue;  // uniform in the warp: no such query
    // one ballot for the tile's 128 rows: most tiles keep none
    const bool any = (n0 + lane < n && dist[i][0] <= t[i]) ||
                     (n0 + 32 + lane < n && dist[i][1] <= t[i]) ||
                     (n0 + 64 + lane < n && dist[i][2] <= t[i]) ||
                     (n0 + 96 + lane < n && dist[i][3] <= t[i]);
    if (!__ballot_sync(kFull, any)) continue;
    const long long orow = static_cast<long long>(q0w + i) * k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int id = n0 + 32 * j + lane;
      const int d = dist[i][j];
      const bool keep = id < n && d <= t[i];
      if (!__ballot_sync(kFull, keep)) continue;
      // lanes of one distance form a group; non-kept lanes stand alone
      const unsigned grp = __match_any_sync(kFull, keep ? d : -1 - lane);
      const int rank = __popc(grp & below);
      const int start = keep ? cur[i][d] : 0;
      const int slot = start + rank;
      if (keep && slot < k) {
        out_s[orow + slot] = -static_cast<float>(d);
        out_i[orow + slot] = id;
      }
      __syncwarp();
      if (keep && rank == 0) cur[i][d] = start + __popc(grp);
      __syncwarp();
    }
  }
}

// kStored: read each distance back from dist8 instead of recomputing it.
template <bool kStored>
__global__ void __launch_bounds__(kHThreads)
hamming_collect_kernel(const int* __restrict__ q, const int* __restrict__ c,
                       int* hist, const int* __restrict__ thr,
                       const unsigned char* __restrict__ dist8, float* out_s,
                       int* out_i, int nq, int n, int w, int bins, int k,
                       int tiles_per_split, int n_splits, int vec,
                       int smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int q0w = blockIdx.y * kHQ + warp * kHQW;
  if (q0w >= nq) return;  // uniform in the warp
  const int n_tiles = (n + kHN - 1) / kHN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  int* cur[kHQW];
  int t[kHQW];
#pragma unroll
  for (int i = 0; i < kHQW; ++i) {
    const int gq = q0w + i;
    t[i] = gq < nq ? thr[gq] : -1;
    cur[i] = bins_of(hist, smem, gq, warp * kHQW + i, split, n_splits, bins);
    if (smem && gq < nq) {
      const int* start = hist + (static_cast<long long>(gq) * n_splits
                                 + split) * bins;
      for (int b = lane; b <= t[i]; b += 32) cur[i][b] = start[b];
    }
  }
  __syncwarp();
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kHN;
    int dist[kHQW][4];
    if (kStored) {
#pragma unroll
      for (int i = 0; i < kHQW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int id = n0 + 32 * j + lane;
          dist[i][j] = t[i] >= 0 && id < n
                           ? dist8[static_cast<long long>(q0w + i) * n + id]
                           : 0;
        }
    } else {
      tile_dist(q, c, q0w, nq, n0, n, w, vec, lane, dist);
    }
    collect_tile(dist, t, cur, n0, n, q0w, k, lane, out_s, out_i);
  }
}

}  // namespace

// packed sign codes int32 q [nq, w] and c [n, w], 1 <= k <= n; hist int32
// [nq, n_splits, 32w + 1] and thr int32 [nq] are scratch, and so is dist8
// uint8 [nq, n] where w <= kStoreWords (else it may be a dummy); out_s f32
// and out_i int32 [nq, k]. vec = 1 when both code arrays are 16-byte
// aligned and w % 4 == 0.
extern "C" int hamming_topk(const void* q, const void* c, void* hist,
                            void* thr, void* dist8, void* out_s, void* out_i,
                            int nq, int n, int w, int k, int tiles_per_split,
                            int n_splits, int vec, void* stream) {
  if (nq > 0 && n > 0 && k > 0 && n_splits > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int bins = 32 * w + 1;
    const int smem = static_cast<long long>(kHQ) * bins * 4 <= kHSmem;
    const size_t bytes = smem ? size_t(kHQ) * bins * 4 : 0;
    const dim3 grid(n_splits, (nq + kHQ - 1) / kHQ);
    const int* qp = static_cast<const int*>(q);
    const int* cp = static_cast<const int*>(c);
    int* hp = static_cast<int*>(hist);
    int* tp = static_cast<int*>(thr);
    unsigned char* dp = static_cast<unsigned char*>(dist8);
    const bool stored = w <= kStoreWords;
    if (stored)
      hamming_count_kernel<true><<<grid, kHThreads, bytes, st>>>(
          qp, cp, hp, dp, nq, n, w, bins, tiles_per_split, n_splits, vec,
          smem);
    else
      hamming_count_kernel<false><<<grid, kHThreads, bytes, st>>>(
          qp, cp, hp, dp, nq, n, w, bins, tiles_per_split, n_splits, vec,
          smem);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hamming_threshold_kernel<<<(nq + kHWarps - 1) / kHWarps, kHThreads, 0,
                               st>>>(hp, tp, nq, bins, n_splits, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* os = static_cast<float*>(out_s);
    int* oi = static_cast<int*>(out_i);
    if (stored)
      hamming_collect_kernel<true><<<grid, kHThreads, bytes, st>>>(
          qp, cp, hp, tp, dp, os, oi, nq, n, w, bins, k, tiles_per_split,
          n_splits, vec, smem);
    else
      hamming_collect_kernel<false><<<grid, kHThreads, bytes, st>>>(
          qp, cp, hp, tp, dp, os, oi, nq, n, w, bins, k, tiles_per_split,
          n_splits, vec, smem);
  }
  return static_cast<int>(cudaGetLastError());
}
