// Paged slot-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tda/tda.py::tda_paged_decode_attention
// (pallas_call at tda.py:282): the slot's logical lane [lo, hi) lives in a
// physical page pool (P, ps, Hkv, D) behind a per-slot block table; fp
// keys/values, or int8 codes with per-(token, head) f32 scale pools
// (P, ps, Hkv) read through the same block table; exact exp, or the AFU's
// LUT exp with one page per softmax block. The body, its design and
// what bounds it are in tda_decode_body.cuh, shared with the contiguous
// kernel; this file only says where a lane position lives: position p of
// slot b is row bt[b, p / ps] * ps + p % ps of the pool, the block-table
// entry clamped to [0, P-1] in-kernel (entries outside [lo, hi), the FREE
// sentinel among them, are never read). A page's positions lie in
// consecutive rows, so the body looks the entry up once per staged tile.
#include "tda_decode_body.cuh"

struct PagedAddr {
  const int* bt;
  int nblk, ps, P;
  __device__ __host__ __forceinline__ int limit() const { return nblk * ps; }
  __device__ __host__ __forceinline__ int seg() const { return ps; }
  __device__ __forceinline__ size_t row(int b, int p) const {
    const int page = min(max(bt[(size_t)b * nblk + p / ps], 0), P - 1);
    return (size_t)page * ps + p % ps;
  }
};

// q (B, Hq, D); k, v (P, ps, Hkv, D) in q's type, or int8 codes with
// ks, vs (P, ps, Hkv) f32 (quant = 1); bounds (B, 2) int32 [lo, hi);
// bt (B, nblk) int32; table: null (exact exp) or the 64-entry f32 LUT, one
// page per LUT-mode block; ws: ceil(nblk ps / split) * B * Hq * (D + 2) f32
// and counters: B * Hkv * ceil(Hq / Hkv / 8) int32, zero (both may be null
// with one split); out (B, Hq, D) f32. split: the positions of a split, a
// divisor or a multiple of ps (>= nblk ps with a table). dtype:
// 0 = float32, 1 = bfloat16 (q's type). Requires Hq % Hkv == 0, D <= 256
// and, with a table, ps <= 256 (the wrapper checks); groups above 8 rows
// run in group tiles.
extern "C" int tda_paged_decode(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* bounds, const void* bt,
                                const void* table, void* ws, void* counters,
                                void* out, int B, int Hq, int Hkv, int D,
                                int P, int ps, int nblk, int split, int dtype,
                                int quant, float scale, void* stream) {
  return tda::launch_decode(q, k, v, ks, vs, bounds, table, ws, counters, out,
                            B, Hq, Hkv, D, dtype, quant, scale, ps, split,
                            PagedAddr{static_cast<const int*>(bt), nblk, ps, P},
                            stream);
}
