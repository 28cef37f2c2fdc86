// Slot-decode attention over contiguous lanes for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tda/tda.py::tda_decode_attention
// (pallas_call at tda.py:203). The body, its design and what bounds it are
// in tda_decode_body.cuh, shared with the paged kernel; this file only says
// where a lane position lives: position p of slot b is token row b * S + p
// of the (B, S, Hkv, D) lanes (scales (B, S, Hkv)). No block table is read,
// and S need not be a multiple of any tile or split: hi is clamped to S.
// The LUT mode's blocks of bk positions follow the reference's padded
// lane: the last one may reach past S, whose positions are masked by hi.
#include "tda_decode_body.cuh"

struct LaneAddr {
  int S;
  __device__ __host__ __forceinline__ int limit() const { return S; }
  __device__ __host__ __forceinline__ int seg() const { return S > 1 ? S : 1; }
  __device__ __forceinline__ size_t row(int b, int p) const {
    return (size_t)b * S + p;
  }
};

// q (B, Hq, D); k, v (B, S, Hkv, D) in q's type, or int8 codes with
// ks, vs (B, S, Hkv) f32 (quant = 1); bounds (B, 2) int32 [lo, hi);
// table: null (exact exp) or the 64-entry f32 LUT, whose blocks are bk
// positions aligned at multiples of bk (the reference's min(block_k, S));
// ws: ceil(S / split) * B * Hq * (D + 2) f32 and counters:
// B * Hkv * ceil(Hq / Hkv / 8) int32, zero (both may be null with one
// split); out (B, Hq, D) f32. split: the positions of a split (>= S with a
// table). dtype: 0 = float32, 1 = bfloat16 (q's type). Requires
// Hq % Hkv == 0, D <= 256 and, with a table, 1 <= bk <= 256 (the wrapper
// checks); groups above 8 rows run in group tiles.
extern "C" int tda_decode(const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* bounds,
                          const void* table, void* ws, void* counters,
                          void* out, int B, int Hq, int Hkv, int D, int S,
                          int bk, int split, int dtype, int quant, float scale,
                          void* stream) {
  return tda::launch_decode(q, k, v, ks, vs, bounds, table, ws, counters, out,
                            B, Hq, Hkv, D, dtype, quant, scale, bk, split,
                            LaneAddr{S}, stream);
}
