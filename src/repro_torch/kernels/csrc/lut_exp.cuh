// The AFU's LUT exponential, shared by the AFU softmax (afu.cu) and the
// LUT mode of the TDA kernels (tda_decode_body.cuh, tda_mixed.cu), as the
// reference shares src/repro/kernels/afu/ref.py::lut_exp.
//
// exp on [-16, 0] as 64 evenly spaced samples joined by straight lines.
// Inputs below -16 clamp to table[0] = exp(-16), about 1.1e-7, not to 0: a
// masked key reaches 0 only through the mask applied after the exp. lut(0)
// is exactly 1 (table[62] + (1 - table[62]) * 1 is exact in f32), so a
// block that leaves the running max unchanged rescales by exactly 1. The
// steps are written with round-to-nearest intrinsics, so the compiler fuses
// none of them into an FMA: the same roundings as the reference's jnp.
//
// The reference divides (xc + 16) by 16; here it is multiplied by 1/16.
// Both give the same bits: 1/16 = 0.0625 is exact in f32, and dividing by
// a power of two and multiplying by its exact reciprocal round the same
// real number (a scaling by 2^-4, exact unless it leaves the normal range,
// which xc + 16 in [0, 16] never does). tests/test_torch_afu.py holds the
// two forms bit-equal in an f32 mirror of these steps.
#pragma once

namespace lut {

constexpr int kSize = 64;
constexpr float kRange = 16.f;

// Table position of x: the index i0 of the segment's left sample and the
// fraction of the way to the next one.
__device__ __forceinline__ int lut_index(float x, float* frac) {
  const float xc = fminf(fmaxf(x, -kRange), 0.f);
  const float f = __fmul_rn(__fmul_rn(__fadd_rn(xc, kRange), 1.f / kRange),
                            static_cast<float>(kSize - 1));
  const int i0 = min(max(__float2int_rd(f), 0), kSize - 2);
  *frac = __fsub_rn(f, static_cast<float>(i0));
  return i0;
}

// t: the kSize-entry table (shared memory in every caller).
__device__ __forceinline__ float lut_exp(float x, const float* t) {
  float frac;
  const int i0 = lut_index(x, &frac);
  const float lo = t[i0];
  return __fadd_rn(lo, __fmul_rn(__fsub_rn(t[i0 + 1], lo), frac));
}

// The same function from a table of kSize - 1 pairs {t[i], t[i+1] - t[i]}
// (lut_pairs), one 8-byte load an element. The difference is the f32
// subtraction that lut_exp does, made once per entry: the same bits.
__device__ __forceinline__ float lut_exp(float x, const float2* tp) {
  float frac;
  const float2 p = tp[lut_index(x, &frac)];
  return __fadd_rn(p.x, __fmul_rn(p.y, frac));
}

// Fill tp (kSize - 1 pairs) from the table t, thread tid of nt.
__device__ __forceinline__ void lut_pairs(const float* t, float2* tp, int tid,
                                          int nt) {
  for (int i = tid; i < kSize - 1; i += nt) {
    const float lo = t[i];
    tp[i] = make_float2(lo, __fsub_rn(t[i + 1], lo));
  }
}

}  // namespace lut
