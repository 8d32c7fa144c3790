// GQA attention: causal, sliding-window or bidirectional.
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
// sentinel dimension. Sums are f32; the output is sum / max(l, 1e-30) in
// the input's type (f32 or bf16). The kv head of query head h is
// h / (H / Hkv), read in place (the Pallas wrapper materialises the
// repeat). q, k and v are read through their (B, S, H) strides, D at unit
// stride, so the (B, S, H, D) layout needs no copy.
//
// What bounds it on an H100. At the retrieval encoder's shape (B 256,
// S 64 or 24, H 4, D 32, f32, bidirectional) bytes: q, k, v and o are
// 33.5 MB a call at S 64, 0.010 ms at 3.35 TB/s, against 0.54 GFLOP, which
// as three TF32 products (3xTF32, tf32.cuh) take 0.0033 ms at the tensor
// cores' 495 TFLOP/s (0.008 ms as f32 FMAs on the CUDA cores). At the LM
// configs' S 2048, 32 heads over 4, D 128, bf16, causal, operations: 34
// GFLOP, 0.035 ms at the tensor cores' 989 TFLOP/s.
//
// Four kernels.
//
//  * flash_short_tc (f32, D 32, 1 <= Skv <= 64, rows and strides TMA can
//    describe: the encoder's passages and queries). Persistent blocks, two
//    an SM (kRBlocks), each walking work items (b, query head, 64 query
//    rows) with the grid's stride, so there is no second wave. Warp 4 of a
//    block is the producer: one lane keeps a ring of kRStages stages full,
//    each the item's Q (64 rows), K and V (Skv rows rounded up to 32 or 64)
//    boxes of a (B, S, H, D) tensor map (cp.async.bulk.tensor, zeros past
//    Sq and Skv, SWIZZLE_128B: the 16-byte chunk c of row r lands at chunk
//    c ^ (r % 8) of its 128-byte row), completing on the stage's full
//    mbarrier; at the encoder's 1024 items a block has at most four, so
//    every load of the call is in flight from the start. Warps 0-3 are the
//    consumers, 16 query rows each: S = Q K^T and O = P V are
//    mma.sync.m16n8k8 TF32 products of split operands (x = hi + lo,
//    tf32_split), hi*lo, lo*hi, then hi*hi (about 22 bits of each operand,
//    an error near 2^-21 of each product), each product into a fresh
//    accumulator that holds the whole sum (S over D 32, O over the Skv
//    keys). Lane (g, t) reads 16-byte words: Q row g (and g + 8) floats
//    8t..8t+7, which with K row 8j + g floats 8t..8t+7 make k-step kk's A
//    and B fragments (D is summed in the order 8t + 2kk, 8t + 2kk + 1, an
//    order of the sum like any other); S's accumulators are then the A
//    fragments of P for O = P V with no shuffle (P's key order within 8
//    keys 2t, 2t + 1, so V's B fragment is rows 8kk + 2t and + 1), and V's
//    columns are taken n-tile n's column c = d 4c + n, so one 16-byte word
//    of each of those rows gives all four n-tiles and a lane ends with
//    output floats 8t..8t+7 of its two rows, two 16-byte stores each. Under
//    the swizzle every such word of a quarter warp is in a different bank
//    group. The softmax is exact in one pass in registers (scores in log2
//    units, exp2f): a row's max and sum over the 4 lanes that hold it. A
//    consumer warp releases the stage (the empty mbarrier) after its last
//    read of V. Rows that are not 16-byte aligned, strides that are not
//    positive multiples of 16 bytes, and every other type, width or Skv
//    keep flash_short.
//  * flash_short (Skv <= 128 otherwise). A row fits one block whole, so
//    there is no online softmax: one block per (b, kv head, 64 query rows;
//    32 where the kv head has no more) stages that kv head's whole K and V
//    once and serves every query head of its group (GQA reads K/V once).
//    Rows of the block are (position, head-in-group) pairs,
//    position-major, so a contiguous (B, S, H, D) q is read as one run. Q
//    and K land in shared memory by 16-byte cp.async copies (f32, aligned
//    strides; bf16 goes through 16-byte loads and a conversion), V by a
//    second copy group that lands while the scores are formed. Thread
//    (rg, cg) of a (rows/4) x 16 grid owns rows 4rg..4rg+3 and keys
//    cg + 16j, a 4 x (Skv/16) tile of S = QK^T in registers, fed by float4
//    reads of Q (broadcast) and K (rows padded by 4 floats, so the 16 keys
//    a warp reads hit distinct banks). The softmax is exact in one pass:
//    each row's max and sum are reduced once over the 16 lanes that share
//    it (4 shuffle steps each). P (not yet normalised) goes to shared
//    memory in Q/K's place, and the same thread grid forms P.V, rows
//    4rg..4rg+3 by dims cg*D/16.., from float4 reads of P and vector reads
//    of V; the thread already holds its rows' sums. Products are f32 FMAs
//    on the CUDA cores.
//  * flash_long_tc (Skv > 128, bf16, 16-byte aligned rows; on no path of
//    the port yet): FlashAttention-2 on the tensor cores. A block of 4
//    warps takes 64 query rows of one (b, h), 16 a warp, and walks K/V
//    tiles of 64 keys, double-buffered through shared memory by cp.async
//    (rows padded by 16 bytes, so ldmatrix reads no bank twice). Q's
//    fragments stay in registers; S = QK^T and O += PV are
//    mma.sync.m16n8k16 bf16 products with f32 sums, P going from S's
//    accumulators to A fragments in registers (rounded to bf16, as the
//    plain version rounds it). The online softmax (running max m from
//    -1e30, sum l, O rescaled) is kept in registers, a row's max reduced
//    over the 4 lanes that hold it. Late query tiles, which see the most
//    keys under a causal mask, are scheduled first.
//  * flash_long (Skv > 128 otherwise: f32, or bf16 rows that are not
//    16-byte aligned): a block of 4 warps takes 32 query rows of one
//    (b, h) and loops over K/V tiles of 32 keys with the same online
//    softmax, on the CUDA cores in f32.
//  Both long kernels skip the K/V tiles that no row of the block may see,
//  but only when every row of the block has an allowed key: a row with
//  none averages over all keys, as the plain version does.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

namespace {

#include "sm90.cuh"
#include "tf32.cuh"

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e30f;      // the reference's masked logit

struct Args {
  int b, sq, skv, h, hkv;
  int qs_b, qs_s, qs_h, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h;
  int causal, window;                  // window < 0: none
  float scale;
  int n_qtiles;
  int vec;                             // 16-byte aligned rows and strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Key j is allowed for query row i (before the Skv bound).
__device__ __forceinline__ bool allowed(const Args& a, int i, int j) {
  return (!a.causal || j <= i) && (a.window < 0 || j > i - a.window);
}

// ---- flash_short -----------------------------------------------------------

constexpr int kShortMax = 128;         // the longest Skv it takes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage one 16-byte vector of a row into f32 shared memory: 4 f32 by
// cp.async, or 8 bf16 by one load and a conversion; element-wise when the
// row is not 16-byte aligned.
__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        int vec) {
  if (vec) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) dst[t] = src[t];
  }
}
__device__ __forceinline__ void stage16(float* dst, const __nv_bfloat16* src,
                                        int vec) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float4 lo, hi;
    float2 f = __bfloat1622float2(h[0]);
    lo.x = f.x; lo.y = f.y;
    f = __bfloat1622float2(h[1]);
    lo.z = f.x; lo.w = f.y;
    f = __bfloat1622float2(h[2]);
    hi.x = f.x; hi.y = f.y;
    f = __bfloat1622float2(h[3]);
    hi.z = f.x; hi.w = f.y;
    reinterpret_cast<float4*>(dst)[0] = lo;
    reinterpret_cast<float4*>(dst)[1] = hi;
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) dst[t] = __bfloat162float(src[t]);
  }
}

// ROWS query rows a block (64, or 32 where a kv head has no more), 4 a
// thread: ROWS / 4 row groups by 16 column groups of threads.
template <int D, int SKV, int ROWS>
struct ShortLayout {                   // in floats
  static constexpr int QS = D + 4;     // padded Q and K row
  static constexpr int PS = SKV + 4;   // padded P row
  static constexpr int QK = (ROWS + SKV) * QS;
  static constexpr int P = ROWS * PS;
  static constexpr int U = QK > P ? QK : P;   // Q and K, then P
  static constexpr int floats = U + SKV * D;  // + V
  static constexpr int threads = ROWS * 4;
  // 1024 threads an SM at the encoder's widths, where 64 registers a
  // thread suffice; wider tiles get the registers
  static constexpr int min_blocks = D <= 32 && SKV <= 64 ? 1024 / threads
                                                         : 1;
};

// Load DT consecutive floats of shared memory (DT in {1, 2, 4, 8}).
template <int DT>
__device__ __forceinline__ void load_dt(float (&r)[DT], const float* p) {
  if constexpr (DT % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DT; t += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + t);
      r[t] = x.x; r[t + 1] = x.y; r[t + 2] = x.z; r[t + 3] = x.w;
    }
  } else if constexpr (DT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  } else {
    r[0] = p[0];
  }
}

template <typename T, int D, int SKV, int ROWS>
__global__ void __launch_bounds__(ShortLayout<D, SKV, ROWS>::threads,
                                  ShortLayout<D, SKV, ROWS>::min_blocks)
flash_short(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, const Args a) {
  using L = ShortLayout<D, SKV, ROWS>;
  constexpr int kSThreads = L::threads;
  constexpr int NJ = SKV / 16;         // keys a thread scores
  constexpr int DT = D / 16;           // output dims a thread owns
  constexpr int VW = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int NV = D / VW;           // vectors per row
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [ROWS][QS]
  float* k_s = q_s + ROWS * L::QS;                // [SKV][QS]
  float* p_s = q_s;                               // [ROWS][PS], later
  float* v_s = q_s + L::U;                        // [SKV][D]

  const int grp = a.h / a.hkv;
  const int n_rows = grp * a.sq;       // query rows of this kv head
  const int tile = blockIdx.x % a.n_qtiles;
  const int bhk = blockIdx.x / a.n_qtiles;
  const int bi = bhk / a.hkv, hk = bhk % a.hkv;
  const int r0 = tile * ROWS;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;

  // Q rows r = i * grp + g (position i, head hk * grp + g) and K: group 0
  const T* kb = k + (long long)bi * a.ks_b + (long long)hk * a.ks_h;
  const T* vb = v + (long long)bi * a.vs_b + (long long)hk * a.vs_h;
  for (int e = tid; e < ROWS * NV; e += kSThreads) {
    const int r = e / NV, c = (e % NV) * VW;
    float* dst = q_s + r * L::QS + c;
    const int gr = r0 + r;
    if (gr < n_rows) {
      const int i = gr / grp, h = hk * grp + gr % grp;
      stage16(dst, q + (long long)bi * a.qs_b + (long long)i * a.qs_s +
                       (long long)h * a.qs_h + c, a.vec);
    } else {
#pragma unroll
      for (int t = 0; t < VW; ++t) dst[t] = 0.f;
    }
  }
  for (int e = tid; e < SKV * NV; e += kSThreads) {
    const int j = e / NV, c = (e % NV) * VW;
    float* dst = k_s + j * L::QS + c;
    if (j < a.skv) {
      stage16(dst, kb + (long long)j * a.ks_s + c, a.vec);
    } else {
#pragma unroll
      for (int t = 0; t < VW; ++t) dst[t] = 0.f;
    }
  }
  cp_async_commit();
  for (int e = tid; e < SKV * NV; e += kSThreads) {     // V: group 1
    const int j = e / NV, c = (e % NV) * VW;
    float* dst = v_s + j * D + c;
    if (j < a.skv) {
      stage16(dst, vb + (long long)j * a.vs_s + c, a.vec);
    } else {
#pragma unroll
      for (int t = 0; t < VW; ++t) dst[t] = 0.f;   // P is 0 there, V too
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // S = Q K^T: rows 4rg + rr, keys cg + 16j
  float s[4][NJ];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[rr][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kk[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      kk[j] = *reinterpret_cast<const float4*>(k_s + (cg + 16 * j) * L::QS +
                                               d);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 qq =
          *reinterpret_cast<const float4*>(q_s + (4 * rg + rr) * L::QS + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[rr][j] = fmaf(qq.x, kk[j].x, s[rr][j]);
        s[rr][j] = fmaf(qq.y, kk[j].y, s[rr][j]);
        s[rr][j] = fmaf(qq.z, kk[j].z, s[rr][j]);
        s[rr][j] = fmaf(qq.w, kk[j].w, s[rr][j]);
      }
    }
  }

  // exact softmax: each row's max and sum over its 16 lanes, once
  float l[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = (r0 + 4 * rg + rr) / grp;
    float mx = kMasked;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int key = cg + 16 * j;
      float x = allowed(a, i, key) ? s[rr][j] * a.scale : kMasked;
      if (key >= a.skv) x = -CUDART_INF_F;
      s[rr][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[rr][j] = expf(s[rr][j] - mx);
      sum += s[rr][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    l[rr] = sum;
  }
  __syncthreads();                     // every read of Q and K is done
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      p_s[(4 * rg + rr) * L::PS + cg + 16 * j] = s[rr][j];
  cp_async_wait<0>();
  __syncthreads();

  // O = P V: rows 4rg + rr, dims cg*DT .. cg*DT + DT - 1; keys past Skv
  // (rounded up to 4) carry P = 0 and are not visited
  float o[4][DT];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int t = 0; t < DT; ++t) o[rr][t] = 0.f;
  const int kend = min(SKV, (a.skv + 3) & ~3);
#pragma unroll 2
  for (int kk = 0; kk < kend; kk += 4) {
    float vv[4][DT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      load_dt<DT>(vv[u], v_s + (kk + u) * D + cg * DT);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 pp =
          *reinterpret_cast<const float4*>(p_s + (4 * rg + rr) * L::PS + kk);
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        o[rr][t] = fmaf(pp.x, vv[0][t], o[rr][t]);
        o[rr][t] = fmaf(pp.y, vv[1][t], o[rr][t]);
        o[rr][t] = fmaf(pp.z, vv[2][t], o[rr][t]);
        o[rr][t] = fmaf(pp.w, vv[3][t], o[rr][t]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int gr = r0 + 4 * rg + rr;
    if (gr >= n_rows) break;
    const int i = gr / grp, h = hk * grp + gr % grp;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* dst = out + (((long long)bi * a.sq + i) * a.h + h) * D + cg * DT;
#pragma unroll
    for (int t = 0; t < DT; ++t) put(dst + t, o[rr][t] / denom);
  }
}

// ---- flash_short_tc: f32 short rows on the tensor cores -------------------

constexpr int kRDim = 32;              // D: a 128-byte f32 row, one swizzle
                                       // span of TMA's SWIZZLE_128B
constexpr int kRMaxKeys = 64;          // the longest Skv it takes
constexpr int kRWarpRows = 16;         // query rows a consumer warp (mma's M)
constexpr int kRWarps = 4;             // consumer warps a block
constexpr int kRStages = 4;            // ring stages
constexpr int kRBlocks = 2;            // blocks an SM
constexpr int kRRows = kRWarps * kRWarpRows;     // query rows a work item
constexpr int kRThreads = (kRWarps + 1) * 32;    // and the producer warp
constexpr int kRRowBytes = kRDim * 4;
constexpr int kRStage = (kRRows + 2 * kRMaxKeys) * kRRowBytes;   // Q, K, V
constexpr int kRSmem = 1024 + kRStages * kRStage + 2 * kRStages * 8;

// Float offset of 16-byte chunk c of row r in a SWIZZLE_128B box of
// 128-byte rows from a 1024-byte aligned base.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * kRDim + ((c ^ (r & 7)) << 2);
}

__device__ __forceinline__ void tma_load_4d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int h, int s,
                                            int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(0),
      "r"(h), "r"(s), "r"(b)
      : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16-byte word's four floats, split: hi[i] + lo[i] = the i-th.
__device__ __forceinline__ void split4(const float4& x, unsigned* hi,
                                       unsigned* lo) {
  const float f[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned p[2];
    tf32_split<2>(p, __float_as_uint(f[i]));
    hi[i] = p[0];
    lo[i] = p[1];
  }
}

// Work item it: batch row, query head and query tile.
struct Item {
  int b, h, qt;
  __device__ Item(const Args& a, int it)
      : b(it / (a.h * a.n_qtiles)),
        h(it / a.n_qtiles % a.h),
        qt(it % a.n_qtiles) {}
};

// NT n-tiles of 8 keys: 4 (Skv <= 32) or 8 (Skv <= 64).
template <int NT>
__global__ void __launch_bounds__(kRThreads, kRBlocks)
flash_short_tc(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               float* __restrict__ out, const Args a) {
  extern __shared__ float4 smem4[];
  const unsigned raw =
      static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  const unsigned ring_s = (raw + 1023) & ~1023u;
  const float* ring =
      reinterpret_cast<const float*>(smem4) + (ring_s - raw) / 4;
  const unsigned bars = ring_s + kRStages * kRStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kRStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = a.b * a.h * a.n_qtiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kRWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kRWarps) {               // the producer
    if (lane == 0) {
      const int grp = a.h / a.hkv;
      int n = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
        const int s = n % kRStages;
        if (n >= kRStages) mbar_wait(empty(s), (n / kRStages - 1) & 1);
        const Item w(a, it);
        const unsigned dst = ring_s + s * kRStage;
        mbar_expect_tx(full(s), (kRRows + 2 * 8 * NT) * kRRowBytes);
        tma_load_4d(dst, &qmap, full(s), w.h, w.qt * kRRows, w.b);
        tma_load_4d(dst + kRRows * kRRowBytes, &kmap, full(s), w.h / grp, 0,
                    w.b);
        tma_load_4d(dst + (kRRows + kRMaxKeys) * kRRowBytes, &vmap, full(s),
                    w.h / grp, 0, w.b);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const float log2_scale = a.scale * 1.4426950408889634f;  // log2(e)
  const bool masks = a.causal || a.window >= 0;
  int n = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
    const int s = n % kRStages;
    const Item w(a, it);
    const int r0 = w.qt * kRRows + warp * kRWarpRows;   // the warp's rows
    const float* qs = ring + s * (kRStage / 4) + warp * kRWarpRows * kRDim;
    const float* ks = ring + s * (kRStage / 4) + kRRows * kRDim;
    const float* vs = ks + kRMaxKeys * kRDim;
    mbar_wait(full(s), (n / kRStages) & 1);
    if (r0 >= a.sq) {                  // uniform: no row of this warp
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      continue;
    }

    // Q: floats 8t..8t+7 of rows g (qh/ql 0-7) and g + 8 (8-15); k-step
    // kk's A fragment is floats 2kk and 2kk + 1 of each
    unsigned qh[16], ql[16];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        split4(*reinterpret_cast<const float4*>(qs + sw128(g + 8 * rr,
                                                           2 * t + c)),
               qh + 8 * rr + 4 * c, ql + 8 * rr + 4 * c);

    // S = Q K^T: n-tile j holds keys 8j + 2t, + 1 of rows g and g + 8
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += 4) {
      unsigned kh[4][8], kl[4][8];     // floats 8t..8t+7 of key 8j + g
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          split4(*reinterpret_cast<const float4*>(
                     ks + sw128(8 * (j0 + jj) + g, 2 * t + c)),
                 kh[jj] + 4 * c, kl[jj] + 4 * c);
#pragma unroll
      for (int kk = 0; kk < kRDim / 8; ++kk) {
        const unsigned ah[4] = {qh[2 * kk], qh[8 + 2 * kk], qh[2 * kk + 1],
                                qh[9 + 2 * kk]};
        const unsigned al[4] = {ql[2 * kk], ql[8 + 2 * kk], ql[2 * kk + 1],
                                ql[9 + 2 * kk]};
        // each product for the four n-tiles before the next, so no MMA
        // waits on the one before it
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          mma_tf32(sc[j0 + jj], ah, kl[jj][2 * kk], kl[jj][2 * kk + 1]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          mma_tf32(sc[j0 + jj], al, kh[jj][2 * kk], kh[jj][2 * kk + 1]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          mma_tf32(sc[j0 + jj], ah, kh[jj][2 * kk], kh[jj][2 * kk + 1]);
      }
    }

    // exact softmax in log2 units: row g (e 0, 1) and g + 8 (e 2, 3)
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e >> 1), key = 8 * j + 2 * t + (e & 1);
        float x = sc[j][e] * log2_scale;
        if (masks && !allowed(a, i, key)) x = kMasked;
        if (key >= a.skv) x = -CUDART_INF_F;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - mx[e >> 1]);
        l[e >> 1] += sc[j][e];
      }

    // O = P V: k-step kk is keys 8kk + 2t (A's a0, a1) and + 1 (a2, a3),
    // S's n-tile kk as it stands; n-tile n's column c is d = 4c + n
    float o[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned ph[4], pl[4];
      split4(make_float4(sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]), ph,
             pl);
      unsigned vh[2][4], vl[2][4];     // rows 8kk + 2t + u, floats 4g..4g+3
#pragma unroll
      for (int u = 0; u < 2; ++u)
        split4(*reinterpret_cast<const float4*>(
                   vs + sw128(8 * kk + 2 * t + u, g)),
               vh[u], vl[u]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) mma_tf32(o[nn], ph, vl[0][nn], vl[1][nn]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) mma_tf32(o[nn], pl, vh[0][nn], vh[1][nn]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) mma_tf32(o[nn], ph, vh[0][nn], vh[1][nn]);
    }
    __syncwarp();                      // every read of the stage is done
    if (lane == 0) mbar_arrive(empty(s));

    // row g + 8rr: o[n][2rr] is d 8t + n, o[n][2rr + 1] d 8t + 4 + n
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(kFull, l[rr], 1);
      l[rr] += __shfl_xor_sync(kFull, l[rr], 2);
      const int i = r0 + g + 8 * rr;
      if (i >= a.sq) continue;
      const float inv = 1.f / fmaxf(l[rr], 1e-30f);
      float4* dst = reinterpret_cast<float4*>(
          out + (((long long)w.b * a.sq + i) * a.h + w.h) * kRDim + 8 * t);
      dst[0] = make_float4(o[0][2 * rr] * inv, o[1][2 * rr] * inv,
                           o[2][2 * rr] * inv, o[3][2 * rr] * inv);
      dst[1] = make_float4(o[0][2 * rr + 1] * inv, o[1][2 * rr + 1] * inv,
                           o[2][2 * rr + 1] * inv, o[3][2 * rr + 1] * inv);
    }
  }
}

// ---- flash_long ------------------------------------------------------------

constexpr int kWarps = 4;              // warps per block
constexpr int kRows = 8;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;

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
constexpr int long_smem_floats() {
  return kBQ * D + kBK * (D + 4) + kBK * D + kWarps * kRows * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_long(const T* __restrict__ q, const T* __restrict__ k,
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
      float x = allowed(a, i, j) ? sc[r] * a.scale : kMasked;
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

// ---- flash_long_tc: bf16 on the tensor cores -------------------------------

constexpr int kTRows = 64;             // query rows per block, 16 a warp
constexpr int kTKeys = 64;             // keys per K/V tile
constexpr int kTThreads = 128;

template <int D>
struct TcLayout {                      // in bf16 elements
  static constexpr int S = D + 8;      // padded row: 16 bytes more, so the
                                       // 8 rows an ldmatrix reads hit
                                       // distinct banks
  static constexpr int Q = kTRows * S;
  static constexpr int KV = kTKeys * S;
  static constexpr int elems = Q + 4 * KV;   // Q, then K and V twice
};

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Stage rows [r0, r0 + n) of a (row -> base + row * rs) bf16 matrix of
// width D into sm (row stride S); rows at or past `lim` are zeros.
template <int D, int S, int N>
__device__ __forceinline__ void tc_stage(__nv_bfloat16* sm,
                                         const __nv_bfloat16* base,
                                         long long rs, int r0, int lim) {
  constexpr int NV = D / 8;            // 16-byte vectors a row
  for (int e = threadIdx.x; e < N * NV; e += kTThreads) {
    const int r = e / NV, c = (e % NV) * 8;
    const bool ok = r0 + r < lim;
    cp_async16_zfill(sm + r * S + c, ok ? base + (r0 + r) * rs + c : base,
                     ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kTThreads, 2)
flash_long_tc(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, const Args a) {
  using L = TcLayout<D>;
  constexpr int S = L::S;
  constexpr int NT = kTKeys / 8;       // n-tiles of S per warp
  constexpr int KD = D / 16;           // k-steps over D
  constexpr int ND = D / 8;            // n-tiles of O per warp
  extern __shared__ float4 smem4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* k_s = q_s + L::Q;     // [2][kTKeys][S]
  __nv_bfloat16* v_s = k_s + 2 * L::KV;

  // heavy (late, causal) query tiles first
  const int tile = a.n_qtiles - 1 - blockIdx.x % a.n_qtiles;
  const int bh = blockIdx.x / a.n_qtiles;
  const int bi = bh / a.h, hi = bh % a.h;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = tile * kTRows;
  const int q_last = min(q0 + kTRows, a.sq) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qb =
      q + (long long)bi * a.qs_b + (long long)hi * a.qs_h;
  const __nv_bfloat16* kb =
      k + (long long)bi * a.ks_b + (long long)hk * a.ks_h;
  const __nv_bfloat16* vb =
      v + (long long)bi * a.vs_b + (long long)hk * a.vs_h;

  bool every_row = true;
  for (int i = q0; i <= q_last; ++i)
    every_row = every_row && key_lo(a, i) <= key_hi(a, i);
  int t_lo = 0, t_hi = (a.skv + kTKeys - 1) / kTKeys - 1;
  if (every_row) {
    t_lo = key_lo(a, q0) / kTKeys;
    t_hi = key_hi(a, q_last) / kTKeys;
  }

  tc_stage<D, S, kTRows>(q_s, qb, a.qs_s, q0, a.sq);
  tc_stage<D, S, kTKeys>(k_s, kb, a.ks_s, t_lo * kTKeys, a.skv);
  tc_stage<D, S, kTKeys>(v_s, vb, a.vs_s, t_lo * kTKeys, a.skv);
  cp_async_commit();

  unsigned qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;     // and row0 + 8

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int st = (kt - t_lo) & 1;
    if (kt < t_hi) {                   // the next tile lands meanwhile
      tc_stage<D, S, kTKeys>(k_s + (st ^ 1) * L::KV, kb, a.ks_s,
                             (kt + 1) * kTKeys, a.skv);
      tc_stage<D, S, kTKeys>(v_s + (st ^ 1) * L::KV, vb, a.vs_s,
                             (kt + 1) * kTKeys, a.skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == t_lo) {
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        ldsm_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * S + ks * 16 +
                            (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt_s = k_s + st * L::KV;
    const __nv_bfloat16* vt_s = v_s + st * L::KV;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned b[4];
        ldsm_x4(b, kt_s + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * S +
                       ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // online softmax over the tile: rows row0 (e = 0, 1) and row0 + 8
    const int k0 = kt * kTKeys;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + (e >> 1) * 8, j = k0 + n * 8 + 2 * t4 + (e & 1);
        float x = allowed(a, i, j) ? sc[n][e] * a.scale : kMasked;
        if (j >= a.skv) x = -CUDART_INF_F;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    unsigned pa[kTKeys / 16][4];       // P as the A operand, in bf16
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(sc[n][e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V
#pragma unroll
    for (int kp = 0; kp < kTKeys / 16; ++kp) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, vt_s + (kp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                S + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa[kp], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa[kp], b[2], b[3]);
      }
    }
    __syncthreads();                   // the next prefetch reuses a stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int i = row0 + r * 8;
    if (i >= a.sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = out + (((long long)bi * a.sq + i) * a.h + hi) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8 + 2 * t4) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ---- launch ----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, int SKV, int ROWS>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        void* out, Args a, cudaStream_t stream) {
  using L = ShortLayout<D, SKV, ROWS>;
  const size_t bytes = L::floats * sizeof(float);
  const cudaError_t err = allow_smem(flash_short<T, D, SKV, ROWS>, bytes);
  if (err != cudaSuccess) return err;
  a.n_qtiles = (a.h / a.hkv * a.sq + ROWS - 1) / ROWS;
  const long long blocks = (long long)a.b * a.hkv * a.n_qtiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  flash_short<T, D, SKV, ROWS><<<static_cast<unsigned>(blocks), L::threads,
                                 bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T, int D, int SKV>
cudaError_t launch_short(const void* q, const void* k, const void* v,
                         void* out, const Args& a, cudaStream_t stream) {
  if (a.h / a.hkv * a.sq <= 32)
    return launch_rows<T, D, SKV, 32>(q, k, v, out, a, stream);
  return launch_rows<T, D, SKV, 64>(q, k, v, out, a, stream);
}

// An operand of flash_short_tc: (B, S, H, kRDim) f32 at base through the
// (b, s, h) strides in elements, read in boxes of `rows` rows of one head.
struct MapKey {
  const void* base;
  int b, s, h, sb, ss, sh, rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && b == o.b && s == o.s && h == o.h &&
           sb == o.sb && ss == o.ss && sh == o.sh && rows == o.rows;
  }
};

// The tensor map of an operand: SWIZZLE_128B boxes, zeros past S. False
// where TMA cannot describe it.
bool short_tc_map(CUtensorMap* map, const MapKey& o) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || o.sb <= 0 || o.ss <= 0 || o.sh <= 0) return false;
  const cuuint64_t dims[4] = {kRDim, static_cast<cuuint64_t>(o.h),
                              static_cast<cuuint64_t>(o.s),
                              static_cast<cuuint64_t>(o.b)};
  const cuuint64_t strides[3] = {4ull * o.sh, 4ull * o.ss, 4ull * o.sb};
  const cuuint32_t box[4] = {kRDim, 1, static_cast<cuuint32_t>(o.rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<void*>(o.base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What a launch of flash_short_tc would redo on the host, kept: the maps
// of the last kMapSlots operands (a map holds only an address and a
// geometry, so an equal key gives an equal map; the encoder's layers reuse
// the allocator's blocks batch after batch), and each device's SM count
// after its shared-memory opt-in is set. Encoding three maps and the
// opt-in cost about as much host time as the kernel takes on the card.
constexpr int kMapSlots = 32;
constexpr int kMaxDevices = 64;
struct HostCache {
  std::mutex mu;
  MapKey keys[kMapSlots] = {};
  CUtensorMap maps[kMapSlots];
  int next = 0;
  int sms[kMaxDevices] = {};
};
HostCache host_cache;

bool cached_map(CUtensorMap* map, const MapKey& key) {
  std::lock_guard<std::mutex> lock(host_cache.mu);
  for (int i = 0; i < kMapSlots; ++i)
    if (host_cache.keys[i] == key) {
      *map = host_cache.maps[i];
      return true;
    }
  if (!short_tc_map(map, key)) return false;
  host_cache.keys[host_cache.next] = key;
  host_cache.maps[host_cache.next] = *map;
  host_cache.next = (host_cache.next + 1) % kMapSlots;
  return true;
}

// The current device's SM count, its shared-memory opt-in for both
// instances set on first use.
cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(host_cache.mu);
  if (dev < kMaxDevices && host_cache.sms[dev] > 0) {
    *sms = host_cache.sms[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(flash_short_tc<4>, kRSmem);
  if (e == cudaSuccess) e = allow_smem(flash_short_tc<8>, kRSmem);
  if (e == cudaSuccess && dev < kMaxDevices) host_cache.sms[dev] = *sms;
  return e;
}

// flash_short_tc where it takes the operands (f32 of width kRDim, reached
// from launch_d; 1 <= Skv <= kRMaxKeys; 16-byte aligned rows and positive
// strides that TMA describes): its cudaError_t; -1 where it does not take
// them, and flash_short runs.
int launch_short_tc(const void* q, const void* k, const void* v, void* out,
                    Args a, cudaStream_t stream) {
  if (!a.vec || a.skv < 1 || a.skv > kRMaxKeys) return -1;
  const int nt = a.skv <= 32 ? 4 : 8;  // n-tiles of 8 keys
  CUtensorMap m[3];
  if (!cached_map(&m[0], {q, a.b, a.sq, a.h, a.qs_b, a.qs_s, a.qs_h,
                          kRRows}) ||
      !cached_map(&m[1], {k, a.b, a.skv, a.hkv, a.ks_b, a.ks_s, a.ks_h,
                          8 * nt}) ||
      !cached_map(&m[2], {v, a.b, a.skv, a.hkv, a.vs_b, a.vs_s, a.vs_h,
                          8 * nt}))
    return -1;
  a.n_qtiles = (a.sq + kRRows - 1) / kRRows;
  const long long items = (long long)a.b * a.h * a.n_qtiles;
  if (items >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(
      items < (long long)kRBlocks * sms ? items : (long long)kRBlocks * sms);
  float* o = static_cast<float*>(out);
  if (nt == 4)
    flash_short_tc<4><<<grid, kRThreads, kRSmem, stream>>>(m[0], m[1], m[2],
                                                           o, a);
  else
    flash_short_tc<8><<<grid, kRThreads, kRSmem, stream>>>(m[0], m[1], m[2],
                                                           o, a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_long(const void* q, const void* k, const void* v,
                        void* out, Args a, cudaStream_t stream) {
  const size_t bytes = long_smem_floats<D>() * sizeof(float);
  const cudaError_t err = allow_smem(flash_long<T, D>, bytes);
  if (err != cudaSuccess) return err;
  a.n_qtiles = (a.sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)a.b * a.h * a.n_qtiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  flash_long<T, D><<<static_cast<unsigned>(blocks), kThreads, bytes,
                     stream>>>(static_cast<const T*>(q),
                               static_cast<const T*>(k),
                               static_cast<const T*>(v),
                               static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_long_tc(const void* q, const void* k, const void* v,
                           void* out, Args a, cudaStream_t stream) {
  const size_t bytes = TcLayout<D>::elems * sizeof(__nv_bfloat16);
  const cudaError_t err = allow_smem(flash_long_tc<D>, bytes);
  if (err != cudaSuccess) return err;
  a.n_qtiles = (a.sq + kTRows - 1) / kTRows;
  const long long blocks = (long long)a.b * a.h * a.n_qtiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  flash_long_tc<D><<<static_cast<unsigned>(blocks), kTThreads, bytes,
                     stream>>>(static_cast<const __nv_bfloat16*>(q),
                               static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v),
                               static_cast<__nv_bfloat16*>(out), a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     const Args& a, cudaStream_t stream) {
  if (a.skv > kShortMax) {
    if constexpr (sizeof(T) == 2) {    // bf16 with 16-byte rows
      if (a.vec) return launch_long_tc<D>(q, k, v, out, a, stream);
    }
    return launch_long<T, D>(q, k, v, out, a, stream);
  }
  if constexpr (sizeof(T) == 4 && D == kRDim) {   // f32 rows of 128 bytes
    const int err = launch_short_tc(q, k, v, out, a, stream);
    if (err >= 0) return static_cast<cudaError_t>(err);
  }
  if (a.skv > 64) return launch_short<T, D, 128>(q, k, v, out, a, stream);
  if (a.skv > 32) return launch_short<T, D, 64>(q, k, v, out, a, stream);
  return launch_short<T, D, 32>(q, k, v, out, a, stream);
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* out, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, out, a, stream);
    case 32: return launch_d<T, 32>(q, k, v, out, a, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, a, stream);
    case 128: return launch_d<T, 128>(q, k, v, out, a, stream);
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
  // 16-byte vectors: every row start 16-byte aligned
  const int vw = dtype == 0 ? 4 : 8;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int strides[9] = {qs_b, qs_s, qs_h, ks_b, ks_s, ks_h,
                          vs_b, vs_s, vs_h};
  int vec = ptrs % 16 == 0;
  for (int t = 0; t < 9; ++t) vec = vec && strides[t] % vw == 0;
  Args a{b, sq, skv, h, hkv, qs_b, qs_s, qs_h, ks_b, ks_s, ks_h,
         vs_b, vs_s, vs_h, causal, window, scale, 0, vec};
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
