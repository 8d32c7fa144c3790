// The 3xTF32 split of f32 values for the tensor cores, included inside the
// anonymous namespace of the sources that take f32 products on them
// (topk_scores.cu and dense_topk.cu through topk_lists.cuh;
// flash_attention.cu).

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

// The tensor cores' f32 products (3xTF32) truncate as they sum, so each
// chunk's products go into a fresh accumulator, added to the running sum
// with a rounded add. Each product a_i * b_j is taken kLoScale times
// larger, the scale on a piece below the leading one where there is one
// (b_j for j > 0, else a_i), so no such piece falls among TF32's
// denormals; the rounded add scales the chunk's sum back exactly.
constexpr float kLoScale = 4096.f;               // 2^12
constexpr float kLoUnscale = 1.f / 4096.f;
