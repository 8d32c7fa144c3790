// One weighted label-propagation round over ELL adjacency (Alg. 2 steps 1-3).
//
// Replaces the TPU kernel src/repro/kernels/label_prop/label_prop.py::_lp_kernel.
//
// For node n with neighbour ids nbr[n, 0..K) (-1 padding), weights wgt[n, k]
// and current labels, the new label is argmax_j S(l_j) with
//   S(l_j) = sum_k w_k [l_k == l_j],  l_k = labels[nbr[n, k]],
// ties going to the smaller label; a node with no neighbours keeps its label.
//
// What bounds it on an H100: device-memory bytes. Per node it reads K ids,
// K weights and K gathered labels (8K + 4 bytes of dense traffic plus K
// random 4-byte label reads) and does at most K^2 compare-adds, far below
// the card's f32 rate. The TPU kernel got its neighbour labels pre-gathered
// by XLA as an (N, K) tensor; here the labels[nbr] gather happens inside the
// kernel, so no (N, K) gathered-label tensor is written and re-read per round.
//
// Design: one warp per node; lanes stride over the K slots, so any K works.
// Each lane owns candidate slot j and accumulates S(l_j) over k = 0..K-1 in
// order, receiving (l_k, w_k) by warp shuffle. Each term adds exactly 0 or
// w_k, so FMA contraction cannot change the sum, and the plain PyTorch
// version (core/label_prop.py::ell_round), which adds in the same order,
// agrees bit for bit. Two warp reductions give the max score, then the
// smallest label among the maxima.
#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int slot_label(const int* __restrict__ labels,
                                          const int* __restrict__ nbr,
                                          long long idx, bool in_range) {
  if (!in_range) return -1;
  const int u = nbr[idx];
  return u >= 0 ? labels[u] : -1;
}

__global__ void lp_round_kernel(const int* __restrict__ labels,
                                const int* __restrict__ nbr,
                                const float* __restrict__ wgt,
                                int* __restrict__ out, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (node >= n) return;  // uniform across the warp
  const long long row = static_cast<long long>(node) * k;

  float best_s = -CUDART_INF_F;
  int best_l = INT_MAX;
  for (int jb = 0; jb < k; jb += 32) {
    const int j = jb + lane;
    const int lj = slot_label(labels, nbr, row + j, j < k);
    float acc = 0.f;
    for (int kb = 0; kb < k; kb += 32) {
      const int kk = kb + lane;
      const int lk = slot_label(labels, nbr, row + kk, kk < k);
      const float wk = lk >= 0 ? wgt[row + kk] : 0.f;
      const int cnt = min(32, k - kb);
      for (int t = 0; t < cnt; ++t) {
        const int l = __shfl_sync(kFull, lk, t);
        const float w = __shfl_sync(kFull, wk, t);
        acc += (l == lj) ? w : 0.f;
      }
    }
    if (lj >= 0 && (acc > best_s || (acc == best_s && lj < best_l))) {
      best_s = acc;
      best_l = lj;
    }
  }
  float smax = best_s;
  for (int off = 16; off > 0; off >>= 1)
    smax = fmaxf(smax, __shfl_xor_sync(kFull, smax, off));
  int cand = (best_l != INT_MAX && best_s == smax) ? best_l : INT_MAX;
  for (int off = 16; off > 0; off >>= 1)
    cand = min(cand, __shfl_xor_sync(kFull, cand, off));
  if (lane == 0) out[node] = (cand == INT_MAX) ? labels[node] : cand;
}

}  // namespace

extern "C" int lp_round(const void* labels, const void* nbr, const void* wgt,
                        void* out, int n, int k, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lp_round_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(labels), static_cast<const int*>(nbr),
        static_cast<const float*>(wgt), static_cast<int*>(out), n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
