// One weighted label-propagation round over ELL adjacency (Alg. 2 steps 1-3).
//
// Replaces the TPU kernel src/repro/kernels/label_prop/label_prop.py::_lp_kernel.
//
// For node n with neighbour ids nbr[n, 0..K) (-1 padding, in any slot),
// weights wgt[n, k] and current labels, the new label is argmax_j S(l_j) with
//   S(l_j) = sum_k w_k [l_k == l_j],  l_k = labels[nbr[n, k]],
// over the valid slots j, ties going to the smaller label; a node with no
// neighbours keeps its label. The table may be a block of rows of a larger
// graph (the sharded pipeline's node-partitioned rounds): row n is node
// row0 + n, whose own label is labels[row0 + n]; neighbour ids are global
// and the output is the block's, out[0..n).
//
// What bounds it on an H100: device-memory bytes. Per node it reads K ids,
// the weights of its valid slots and their gathered labels, and writes one
// label; its deg^2 compare-adds are far below the card's rates. The TPU
// kernel got its neighbour labels pre-gathered by XLA as an (N, K) tensor;
// here the labels[nbr] gather happens inside the kernel, so no (N, K)
// gathered-label tensor is written and re-read per round.
//
// Design: one warp a node, lane j holding slot j. A ballot of the valid
// slots (nbr >= 0) drives the sum: each lane owns candidate slot j and
// accumulates S(l_j) over the set bits of that mask, in slot order,
// receiving (l_k, w_k) by warp shuffle. So a node costs 2 deg shuffles, not
// 2 K, and a node with no neighbour a ballot. A padding slot only ever
// added an exact +0.0 (the sum starts at +0.0 and never becomes -0.0), so
// skipping it leaves every sum unchanged, and each term adds exactly 0 or
// w_k, so FMA contraction cannot change it: the plain PyTorch version
// (core/label_prop.py::ell_round), which adds over all K slots in order,
// agrees bit for bit. Two redux.sync reductions take the largest score (its
// f32 bits mapped to an order-preserving int) and then the smallest label
// among the maxima. Where K <= 32 (the sampling path's ELL) a warp takes
// kNodes nodes and issues all their id, label and weight loads before any
// sum, so more of the bytes are in flight at once; a longer K runs a
// general loop over 32-slot chunks of one node at a time.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kNodes = 4;          // nodes a warp takes where K <= 32

// An int whose order is the order of the non-NaN f32 x (-0.0 never occurs).
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The warp's argmax: the smallest label among the lanes whose candidate
// (s, l) has the largest score; lanes with l == INT_MAX hold no candidate.
// INT_MAX when no lane holds one.
__device__ __forceinline__ int warp_argmax(float s, int l) {
  const int key = l != INT_MAX ? order_key(s) : INT_MIN;
  const int top = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, l != INT_MAX && key == top ? l : INT_MAX);
}

// K <= 32: node node0 + i of the warp in slot `lane`.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lp_round_narrow(const int* __restrict__ labels, const int* __restrict__ nbr,
                const float* __restrict__ wgt, int* __restrict__ out, int n,
                int k, int row0) {
  const int lane = threadIdx.x & 31;
  const long long node0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
       (threadIdx.x >> 5)) * kNodes;
  if (node0 >= n) return;  // uniform across the warp
  int u[kNodes], lk[kNodes];
  float wk[kNodes];
#pragma unroll
  for (int i = 0; i < kNodes; ++i)
    u[i] = node0 + i < n && lane < k ? nbr[(node0 + i) * k + lane] : -1;
  // lane i < kNodes: node node0 + i's own label, kept when it has no
  // neighbour
  const int own =
      lane < kNodes && node0 + lane < n ? labels[row0 + node0 + lane] : 0;
#pragma unroll
  for (int i = 0; i < kNodes; ++i) {
    lk[i] = u[i] >= 0 ? labels[u[i]] : -1;
    wk[i] = u[i] >= 0 ? wgt[(node0 + i) * k + lane] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kNodes; ++i) {
    if (node0 + i >= n) break;  // uniform across the warp
    const unsigned valid = __ballot_sync(kFull, u[i] >= 0);
    int best = INT_MAX;
    if (valid) {
      float acc = 0.f;
      for (unsigned m = valid; m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        const int l = __shfl_sync(kFull, lk[i], t);
        const float w = __shfl_sync(kFull, wk[i], t);
        acc += (l == lk[i]) ? w : 0.f;
      }
      best = warp_argmax(acc, u[i] >= 0 ? lk[i] : INT_MAX);
    }
    const int keep = __shfl_sync(kFull, own, i);
    if (lane == 0) out[node0 + i] = best == INT_MAX ? keep : best;
  }
}

// Any K: one node a warp, lanes striding over 32-slot chunks.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lp_round_wide(const int* __restrict__ labels, const int* __restrict__ nbr,
              const float* __restrict__ wgt, int* __restrict__ out, int n,
              int k, int row0) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (node >= n) return;  // uniform across the warp
  const long long row = static_cast<long long>(node) * k;

  float best_s = 0.f;
  int best_l = INT_MAX;
  for (int jb = 0; jb < k; jb += 32) {
    const int j = jb + lane;
    const int uj = j < k ? nbr[row + j] : -1;
    const int lj = uj >= 0 ? labels[uj] : -1;
    float acc = 0.f;
    for (int kb = 0; kb < k; kb += 32) {
      const int kk = kb + lane;
      const int uk = kk < k ? nbr[row + kk] : -1;
      const unsigned valid = __ballot_sync(kFull, uk >= 0);
      if (!valid) continue;  // uniform across the warp
      const int lk = uk >= 0 ? labels[uk] : -1;
      const float wk = uk >= 0 ? wgt[row + kk] : 0.f;
      for (unsigned m = valid; m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        const int l = __shfl_sync(kFull, lk, t);
        const float w = __shfl_sync(kFull, wk, t);
        acc += (l == lj) ? w : 0.f;
      }
    }
    if (uj >= 0 && (best_l == INT_MAX || acc > best_s ||
                    (acc == best_s && lj < best_l))) {
      best_s = acc;
      best_l = lj;
    }
  }
  const int best = warp_argmax(best_s, best_l);
  if (lane == 0)
    out[node] = best == INT_MAX ? labels[static_cast<long long>(row0) + node]
                                : best;
}

}  // namespace

extern "C" int lp_round(const void* labels, const void* nbr, const void* wgt,
                        void* out, int n, int k, int row0, void* stream) {
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* lp = static_cast<const int*>(labels);
    const int* np = static_cast<const int*>(nbr);
    const float* wp = static_cast<const float*>(wgt);
    int* op = static_cast<int*>(out);
    if (k <= 32) {
      const int per_block = kWarpsPerBlock * kNodes;
      lp_round_narrow<<<(n + per_block - 1) / per_block,
                        kWarpsPerBlock * 32, 0, st>>>(lp, np, wp, op, n, k,
                                                      row0);
    } else {
      lp_round_wide<<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock,
                      kWarpsPerBlock * 32, 0, st>>>(lp, np, wp, op, n, k,
                                                    row0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
