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
#pragma once

namespace lut {

constexpr int kSize = 64;
constexpr float kRange = 16.f;

// t: the kSize-entry table (shared memory in every caller).
__device__ __forceinline__ float lut_exp(float x, const float* t) {
  const float xc = fminf(fmaxf(x, -kRange), 0.f);
  const float f = __fmul_rn(__fdiv_rn(__fadd_rn(xc, kRange), kRange),
                            static_cast<float>(kSize - 1));
  const int i0 = min(max(__float2int_rd(f), 0), kSize - 2);
  const float frac = __fsub_rn(f, static_cast<float>(i0));
  const float lo = t[i0];
  return __fadd_rn(lo, __fmul_rn(__fsub_rn(t[i0 + 1], lo), frac));
}

}  // namespace lut
