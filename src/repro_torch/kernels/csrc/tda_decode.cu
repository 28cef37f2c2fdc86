// Slot-decode attention over contiguous lanes for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tda/tda.py::tda_decode_attention
// (pallas_call at tda.py:203). The body, its design and what bounds it are
// in tda_decode_body.cuh, shared with the paged kernel; this file only says
// where a lane position lives: position p of slot b is token row b * S + p
// of the (B, S, Hkv, D) lanes (scales (B, S, Hkv)). No block table is read,
// and S need not be a multiple of any tile: hi is clamped to S.
#include "tda_decode_body.cuh"

struct LaneAddr {
  int S;
  __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ size_t row(int b, int p) const {
    return (size_t)b * S + p;
  }
};

// q (B, Hq, D); k, v (B, S, Hkv, D) in q's type, or int8 codes with
// ks, vs (B, S, Hkv) f32 (quant = 1); bounds (B, 2) int32 [lo, hi);
// out (B, Hq, D) f32. dtype: 0 = float32, 1 = bfloat16 (q's type).
// Requires Hq % Hkv == 0, Hq / Hkv <= 8, D <= 128 (the wrapper checks).
extern "C" int tda_decode(const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* bounds,
                          void* out, int B, int Hq, int Hkv, int D, int S,
                          int dtype, int quant, float scale, void* stream) {
  return tda::launch_decode(q, k, v, ks, vs, bounds, out, B, Hq, Hkv, D, dtype,
                            quant, scale, LaneAddr{S}, stream);
}
