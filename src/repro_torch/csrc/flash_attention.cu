// GQA attention with an online softmax: causal, sliding-window or
// bidirectional.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel.
//
// For each (batch b, head h, query row i) it takes the softmax over the
// allowed keys j of s_ij = (q_i . k_j) * scale, scale = 1/sqrt(D), and
// forms sum_j p_ij v_j. Key j is allowed when j <= i (causal) and
// j > i - window (window); other keys in [0, Skv) score -1e30, the
// reference's masked logit, so a row with no allowed key averages v over
// all Skv keys, as the plain softmax does. Keys past Skv and rows past Sq
// are masked here (keys score -inf, rows are not written): nothing is
// padded, where the reference pads both and hides padded keys behind a
// sentinel dimension. The running max m starts at -1e30, as in the
// reference, so the terms a row gathers from wholly masked keys before its
// first allowed key are rescaled to 0 there. m, l and acc are f32; the
// output is acc / max(l, 1e-30) in the input's type (f32 or bf16). The kv
// head of query head h is h / (H / Hkv), read in place (the Pallas wrapper
// materialises the repeat). q, k and v are read through their (B, S, H)
// strides, D at unit stride, so the (B, S, H, D) layout needs no copy.
//
// What bounds it on an H100: at the retrieval encoder's shape (B 256,
// S 64 or 24, H 4, D 32, f32) bytes: q, k, v and o are 33.5 MB a call at
// S 64, 0.010 ms at 3.35 TB/s, against 0.5 GFLOP, 0.008 ms at 67 TFLOP/s.
// That is one small launch per layer per batch of 256 passages, so launch
// overhead, not the card, is expected to set the pace there. At long
// sequence lengths (S 2048, D 128, bf16) operations bound it, and this
// kernel, on the CUDA cores in f32, is far from the tensor cores' rate.
//
// Design (first version: simple and right). A block of 4 warps takes 32
// query rows of one (b, h): the Q tile sits in shared memory as f32, and
// the block loops over K/V tiles of 32 keys staged through shared memory.
// Each warp owns 8 query rows; in the score step lane j owns key j of the
// tile and forms its 8 scores from float4 reads of its K row (rows padded
// by 4 floats, so the lanes' reads do not conflict) and broadcast reads of
// Q. Two butterfly reductions give each row's tile max and sum, so every
// lane holds the same m and l. The probabilities go to shared memory, and
// for P.V each lane owns D/32 output dims (D 16: lanes 16-31 repeat lanes
// 0-15 and do not write). Tiles that no row of the block may see are
// skipped, but only when every row of the block has an allowed key: a row
// with none averages over all keys, as the plain version does.
// Tensor-core products (mma.sync / wgmma), TMA and a warp-specialised
// pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;              // warps per block
constexpr int kRows = 8;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;      // the reference's masked logit

struct Args {
  int b, sq, skv, h, hkv;
  int qs_b, qs_s, qs_h, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h;
  int causal, window;                  // window < 0: none
  float scale;
  int n_qtiles;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Allowed keys of row i lie in [lo(i), hi(i)] (before the Skv bound).
__device__ __forceinline__ int key_lo(const Args& a, int i) {
  return a.window >= 0 ? max(0, i - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const Args& a, int i) {
  return a.causal ? min(i, a.skv - 1) : a.skv - 1;
}

template <int D>
constexpr int smem_floats() {
  return kBQ * D + kBK * (D + 4) + kBK * D + kWarps * kRows * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, const Args a) {
  constexpr int KS = D + 4;                   // padded K row, in floats
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output dims per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBQ][D]
  float* k_s = q_s + kBQ * D;                     // [kBK][KS]
  float* v_s = k_s + kBK * KS;                    // [kBK][D]
  float* p_s = v_s + kBK * D;                     // [kWarps][kRows][kBK]

  const int tile = blockIdx.x % a.n_qtiles;
  const int bh = blockIdx.x / a.n_qtiles;
  const int bi = bh / a.h, hi = bh % a.h;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = tile * kBQ;
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  const bool active = q0 + r0 < a.sq;         // uniform across the warp

  const long long qb = (long long)bi * a.qs_b + (long long)hi * a.qs_h;
  const long long kb = (long long)bi * a.ks_b + (long long)hk * a.ks_h;
  const long long vb = (long long)bi * a.vs_b + (long long)hk * a.vs_h;
  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int i = q0 + r;
    q_s[e] = i < a.sq ? to_f32(q[qb + (long long)i * a.qs_s + c]) : 0.f;
  }

  // The kv tiles to visit: all of them, unless every row of the block has
  // an allowed key, in which case only those some row may see.
  bool every_row = true;
  for (int i = q0; i <= q_last; ++i)
    every_row = every_row && key_lo(a, i) <= key_hi(a, i);
  int t_lo = 0, t_hi = (a.skv + kBK - 1) / kBK - 1;
  if (every_row) {
    t_lo = key_lo(a, q0) / kBK;
    t_hi = key_hi(a, q_last) / kBK;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }
  const int dim0 = D >= 32 ? lane : (lane % D);
  float* p_w = p_s + warp * kRows * kBK;

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the last tile's K/V reads are done (and Q staged)
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int j = k0 + r;
      const bool in = j < a.skv;
      k_s[r * KS + c] = in ? to_f32(k[kb + (long long)j * a.ks_s + c]) : 0.f;
      v_s[r * D + c] = in ? to_f32(v[vb + (long long)j * a.vs_s + c]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float* krow = k_s + lane * KS;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(q_s + (r0 + r) * D + c);
        sc[r] = fmaf(qq.x, kk.x, sc[r]);
        sc[r] = fmaf(qq.y, kk.y, sc[r]);
        sc[r] = fmaf(qq.z, kk.z, sc[r]);
        sc[r] = fmaf(qq.w, kk.w, sc[r]);
      }
    }

    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + r0 + r;
      const bool ok =
          (!a.causal || j <= i) && (a.window < 0 || j > i - a.window);
      float x = ok ? sc[r] * a.scale : kMasked;
      if (j >= a.skv) x = -CUDART_INF_F;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(x - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[r][t] *= alpha;
      p_w[r * kBK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int jj = 0; jj < kBK; jj += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          vv[u][t] = v_s[(jj + u) * D + dim0 + 32 * t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(p_w + r * kBK + jj);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          acc[r][t] = fmaf(pp.x, vv[0][t], acc[r][t]);
          acc[r][t] = fmaf(pp.y, vv[1][t], acc[r][t]);
          acc[r][t] = fmaf(pp.z, vv[2][t], acc[r][t]);
          acc[r][t] = fmaf(pp.w, vv[3][t], acc[r][t]);
        }
      }
    }
    __syncwarp();      // p_w is rewritten by the next tile
  }

  if (!active || lane >= D) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + r0 + r;
    if (i >= a.sq) break;
    const float denom = fmaxf(l[r], 1e-30f);
    T* o = out + (((long long)bi * a.sq + i) * a.h + hi) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t) put(o + dim0 + 32 * t, acc[r][t] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)a.b * a.h * a.n_qtiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  flash_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, bytes,
                       stream>>>(static_cast<const T*>(q),
                                 static_cast<const T*>(k),
                                 static_cast<const T*>(v),
                                 static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* out, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, a, stream);
    case 32: return launch<T, 32>(q, k, v, out, a, stream);
    case 64: return launch<T, 64>(q, k, v, out, a, stream);
    case 128: return launch<T, 128>(q, k, v, out, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, sq, h, d], k/v [b, skv, hkv, d] through the given (b, s, h)
// strides in elements, d at unit stride; out a new contiguous
// [b, sq, h, d]. dtype 0 = f32, 1 = bf16; d in {16, 32, 64, 128};
// window < 0 for none. Returns a cudaError_t (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv, int h,
                               int hkv, int d, int qs_b, int qs_s, int qs_h,
                               int ks_b, int ks_s, int ks_h, int vs_b,
                               int vs_s, int vs_h, int causal, int window,
                               int dtype, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (hkv <= 0 || h % hkv != 0 || skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{b, sq, skv, h, hkv, qs_b, qs_s, qs_h, ks_b, ks_s, ks_h,
         vs_b, vs_s, vs_h, causal, window, scale, (sq + kBQ - 1) / kBQ};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, out, a, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, out, a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
