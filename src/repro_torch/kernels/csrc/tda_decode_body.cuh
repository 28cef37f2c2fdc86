// Slot-decode attention body shared by the contiguous-lane and paged-lane
// decode kernels, for Hopper (sm_90a): split-K (flash-decoding).
//
// Replaces the TPU kernels src/repro/kernels/tda/tda.py::tda_decode_attention
// (tda.py:168, pallas_call at :203) and ::tda_paged_decode_attention
// (tda.py:220, pallas_call at :282), which share their math in _tda_body
// (tda.py:77). Here too the math is written once: `decode_kernel` is
// templated on the query type, the K/V element type (float, bf16, or int8
// codes with per-(token, head) f32 scales) and an address functor that says
// where position p of slot b's lane lives. tda_decode.cu (contiguous lanes,
// (B, S, Hkv, D)) and tda_paged_decode.cu (page pools behind a block table)
// only supply that functor and a C entry point.
//
// One query token per slot attends the lane's [lo, hi); softmax in f32;
// GQA (any G = Hq / Hkv query rows per kv head); output zeros when
// hi <= lo.
//
// What bounds it on this card: bytes. Each visited key/value element (2
// bytes in bf16, 1 in int8 plus a 4-byte scale per head row of D) meets only
// G query rows (5 at qwen2.5-32b): about G flops per byte, far below the
// ~295 flops/byte where an H100 stops being memory-bound. At the served
// shape (8 slots, 8 kv heads of 128, about 2 630 live tokens of 544-token
// lanes or 128-token pages) the kernel must read 10.8 MB in bf16, 3.29 us at
// 3.35 TB/s, or 5.5 MB in int8, 1.73 us. A kernel this short is bound in
// practice by its chains of dependent steps (a load, a reduction, the
// merge), so the design shortens them. What it does:
//
//   1. Split-K over the key axis. The grid is (split, kv head, slot): split
//      i of a slot covers lane positions [i L, (i + 1) L), L from the
//      wrapper's plan (kernels/tda/tda.py::decode_split_plan: 64 positions,
//      half a 128-token page, so that a split never crosses a page). A
//      split that misses [lo, hi) exits at once, so the work follows
//      occupancy; at the served shape about 390 blocks are live, against 64
//      for one block per (slot, head). The split's first row (its
//      block-table entry) is looked up before the bounds arrive, not after.
//   2. One launch, merged in the kernel. Each live split computes the
//      partial (acc[G][D], m[G], l[G]) in f32 and, when its (slot, head) has
//      more than one live split, stores it in the wrapper's workspace. The
//      block that finishes last (a __threadfence, then an atomicAdd on a
//      per-(slot, head) counter that it resets to 0 for the next launch)
//      merges the partials in split order, as the reference's
//      kernels/tda/sharded.py::merge_partials does: m* = max m, rescale by
//      exp(m - m*), sum, divide by max(l*, 1e-30). It reads every m and l
//      at once into shared memory first, then keeps the accumulators of 4
//      splits in flight per thread, so the merge costs a few rounds of
//      loads, not one per (split, output). The order is fixed, so the result is the
//      same from run to run; there are no float atomics. A (slot, head)
//      with one live split writes its output directly.
//   3. K/V staged with 16-byte cp.async in their stored type: neighbouring
//      threads copy neighbouring 16-byte pieces of a key row (256 B in bf16,
//      128 B in int8) into shared memory, 64 keys a tile (32 in f32), rows
//      padded by 16 bytes so that the reads below meet no bank conflict.
//      A split of one tile (the served case) takes one stage; longer
//      splits take two, the next tile copied while this one is computed,
//      as in tda_mixed.cu. The lane address is found once per tile (tiles
//      never cross a page), an int8 scale once per (key, head) row.
//      Elements are converted to f32 on use. Rows whose bytes are no
//      multiple of 16 fall back to element copies.
//   4. Groups above kMaxG = 8 rows are tiled. A block holds the query rows
//      of one group tile: ceil(G / 8) tiles of ceil(G / tiles) rows each
//      (G = 12 at starcoder2-15b: two tiles of 6; G = 10 at
//      recurrentgemma-2b: two of 5), the grid's y axis runs over (kv head,
//      tile), and each tile reads the same K/V split, which the second tile
//      finds in L2. A tile is the G <= 8 body unchanged (one tile there,
//      the same code, registers and shared memory); its partials, counter
//      and merge are the tile's own. Holding all G rows in one block would
//      double the per-thread accumulators (acc[G][4]) and the q and p
//      buffers at G = 16, past the 128-thread block's register budget.
//   5. Head dims up to 256, in two instances. The body is a template on its
//      largest head dim kMaxD, and the launch picks 128 for D <= 128 (the
//      instance every earlier row ran: the same code, registers and shared
//      memory) and 256 above (recurrentgemma-2b's local layers: 10 q heads
//      of 256 over one kv head, two group tiles of 5). At 256 a lane scores
//      a half row of 128 elements and accumulates 8 elements of D, the
//      staged rows are 256 elements wide, and one stage is 2 x 64 x 264 x
//      2 B = 67.6 KB in bf16 (66.6 KB in f32, 34.8 KB in int8): past the
//      48 KB default, so the launch opts in to 2 stages of dynamic shared
//      memory with cudaFuncSetAttribute (the card allows 227 KB a block),
//      as it already did. Keys per tile stay 64 (32 in f32), so all 4 warps
//      score. Columns past D (D = 136 or 192 on the 256 instance) are zero
//      in shared memory and in q, as below 128.
//   6. CUDA cores, a warp per key group. A warp scores 16 keys at once, two
//      lanes a key, each lane half of D against the G query rows held in
//      shared memory as f32 (read as broadcasts); one shuffle joins the
//      halves. The warp's online softmax then takes the group's max and
//      sum by 4 shuffles per row, and P @ V runs with lanes over D (4
//      elements each), p read back from a per-warp buffer. Each warp keeps
//      its own (m, l, acc) in registers, with no barrier inside a tile; the
//      4 warps merge at the end of the block, in warp order, by the same
//      rescale as the splits. Two lanes a key, not 32, keep the shuffle
//      chains short: a score reduced over a whole warp costs 5 dependent
//      shuffles per (key, row).
//
// LUT mode (kLut, a table of the AFU's 64-entry exp given): both
// exponentials of the online softmax go through lut::lut_exp, and then the
// result depends on where the rescaling happens, since lut(a) * lut(b) !=
// lut(a + b): a split merge would move the output about 1e-2 off the plain
// version, against a limit of 1e-5. So with a table the plan has one split
// per (slot, head) (L = the lane width), and the block walks the reference's
// blocks in order: bk positions aligned at multiples of bk in lane
// coordinates (bk = min(block_k, S) for contiguous lanes, the page size for
// paged ones), each visited when it meets [lo, hi). A block's keys are
// scored (K staged as in point 3, one stage) into p_s[G][bk] (bk <= 256),
// then the block max, p = lut(s - m_new) and alpha = lut(m_old - m_new)
// are taken once per row, then V streams through the per-warp
// accumulators, which share the block's running max and merge by plain
// sums at the end. No model path runs the LUT mode.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lut_exp.cuh"

namespace tda {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kGroup = 16;            // keys a warp scores together
constexpr int kMaxBk = 256;           // largest LUT-mode block (positions)
constexpr int kMaxSplits = 128;       // splits of one lane (merge buffer)
constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-30f;

template <typename T>  // elements in 16 bytes
constexpr int kVec = 16 / static_cast<int>(sizeof(T));
template <typename T, int kMaxD>  // a staged row: kMaxD padded by 16 bytes
constexpr int kStride = kMaxD + kVec<T>;
template <typename T>  // keys of one tile
constexpr int kTileKeys = sizeof(T) == 4 ? 32 : 64;
template <typename T, int kMaxD>  // one stage: a K tile and a V tile
constexpr int kStageBytes =
    2 * kTileKeys<T> * kStride<T, kMaxD> * static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of shared memory as f32.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float (&x)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char4 c = *reinterpret_cast<const char4*>(&w[i]);
    x[4 * i] = c.x, x[4 * i + 1] = c.y, x[4 * i + 2] = c.z, x[4 * i + 3] = c.w;
  }
}
// Four consecutive elements (16-, 8- or 4-byte aligned) as f32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  load16(p, x);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  x[0] = c.x, x[1] = c.y, x[2] = c.z, x[3] = c.w;
}

// The N (4 or 8) consecutive elements a lane accumulates, as f32.
template <int N, typename T>
__device__ __forceinline__ void load_lane(const T* p, float (&x)[N]) {
  if constexpr (N == 4) {
    load4(p, x);
  } else if constexpr (sizeof(T) == 2) {  // 8 bf16: one 16-byte load
    load16(p, x);
  } else {
    float a[4], b[4];
    load4(p, a);
    load4(p + 4, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[i], x[4 + i] = b[i];
  }
}

// Max and sum over the 16 lanes of a half warp (both halves alike).
__device__ __forceinline__ float group_max(float x) {
  for (int o = kGroup / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = kGroup / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n consecutive token rows (row0, row0 + 1, ...) of head h into dst
// (rows of kStride): 16-byte cp.async pieces, neighbouring threads on
// neighbouring pieces of a row, or element copies when rows are not 16-byte
// multiples (vec == 0).
template <typename TKV, int kMaxD>
__device__ __forceinline__ void stage_rows(TKV* dst, const TKV* __restrict__ src,
                                           size_t row0, int n, int Hkv, int h,
                                           int D, int vec, int tid) {
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const TKV* base = src + (row0 * Hkv + h) * D;
  if (vec) {
    const int per_row = D / kVec<TKV>;
    for (int i = tid; i < n * per_row; i += kThreads) {
      const int t = i / per_row, c = i - t * per_row;
      cp16(dst + t * kStride<TKV, kMaxD> + c * kVec<TKV>,
           base + t * stride + c * kVec<TKV>);
    }
  } else {
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      dst[t * kStride<TKV, kMaxD> + d] = base[t * stride + d];
    }
  }
}

// Addr: `int limit() const` (the lane width; hi is clamped to it), `int
// seg() const` (positions [j seg, (j + 1) seg) lie in consecutive token
// rows) and `size_t row(int b, int p) const` (the token row of lane
// position p of slot b: element (row * Hkv + h) * D + d of k/v, scale
// row * Hkv + h).
// Grid (splits, Hkv * tiles, B), nstage * kStageBytes<TKV, kMaxD> bytes of
// dynamic shared memory; a block's y index is h * tiles + t (group tile t
// of kv head h, tile_rows rows from row t * tile_rows of the group); split:
// positions a split holds (kLut: >= the lane width, one split). ws: the
// splits' partials, acc (splits, B, Hq, D) then (m, l) (splits, B, Hq, 2),
// f32; counters: B * Hkv * tiles ints, 0 between launches; both may be
// null with one split. kLut: table (lut::kSize f32) and bk
// (the LUT-mode block, <= kMaxBk) are read; otherwise ignored.
template <typename TQ, typename TKV, bool kLut, int kMaxD, typename Addr>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ bounds,
              const float* __restrict__ table, float* __restrict__ ws,
              int* __restrict__ counters, float* __restrict__ out, int Hq,
              int Hkv, int D, float scale, int bk, int split, int vec,
              int nstage, int tiles, int tile_rows, Addr addr) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kTile = kTileKeys<TKV>;
  constexpr int kS = kStride<TKV, kMaxD>;
  constexpr int kHalf = kMaxD / 2;      // elements of D a lane scores
  constexpr int kPerLane = kMaxD / 32;  // elements of D a lane accumulates
  constexpr int kQStride = kHalf + 4;   // q_s half rows: both halves in 1 wavefront
  // nstage stages of [K tile, V tile]; after the key loop, the warps' f32
  // accumulators ([warp][g][d], 16 KB at kMaxD 128, 32 KB at 256), then the
  // split merge's weights.
  extern __shared__ __align__(16) unsigned char dyn_s[];
  __shared__ __align__(16) float q_s[kMaxG][2][kQStride];
  __shared__ float sc_s[2][2][kTile];
  __shared__ float pw_s[kWarps][kMaxG][kGroup];
  __shared__ float p_s[kLut ? kMaxG : 1][kLut ? kMaxBk : 1];
  __shared__ float lut_s[kLut ? lut::kSize : 1];
  __shared__ float m_s[kWarps][kMaxG], l_s[kWarps][kMaxG], a_s[kMaxG];
  __shared__ int last_s;

  const int sp = blockIdx.x, h = blockIdx.y / tiles, b = blockIdx.z;
  const int B = gridDim.z, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // This block's query rows: the group tile's, rows [g0, g0 + G) of kv
  // head h's group (all of it when tiles == 1).
  const int g0 = (blockIdx.y % tiles) * tile_rows;
  const int G = min(tile_rows, Hq / Hkv - g0);
  const int row_h = h * (Hq / Hkv) + g0;  // first query row of the tile
  const int limit = addr.limit(), seg = addr.seg();
  // The split's first row, looked up while the bounds load.
  const int pa = min(sp * split, max(limit - 1, 0));
  const size_t row_a = limit > 0 ? addr.row(b, pa) : 0;
  const int lo = max(bounds[2 * b], 0);
  const int hi = min(bounds[2 * b + 1], limit);
  const int first = lo / split;
  const int n_live = hi > lo ? (hi - 1) / split - first + 1 : 0;
  float* o = out + (static_cast<size_t>(b) * Hq + row_h) * D;
  if (n_live == 0) {  // never attended: zeros, from split 0
    if (sp == 0) {
      for (int i = tid; i < G * D; i += kThreads) o[i] = 0.f;
    }
    return;
  }
  if (sp < first || sp >= first + n_live) return;  // misses [lo, hi)
  const int p0 = max(lo, sp * split), p1 = min(hi, sp * split + split);

  auto stage = [&](int st, int which) {
    return reinterpret_cast<TKV*>(dyn_s) + (2 * st + which) * kTile * kS;
  };
  if (D < kMaxD) {  // columns past D stay 0: lanes read whole halves
    uint4* z = reinterpret_cast<uint4*>(dyn_s);
    for (int i = tid; i < nstage * kStageBytes<TKV, kMaxD> / 16; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  for (int i = tid; i < kMaxG * kMaxD; i += kThreads) {
    const int g = i / kMaxD, d = i - g * kMaxD;
    q_s[g][d / kHalf][d % kHalf] =
        g < G && d < D ? to_f32(q[(static_cast<size_t>(b) * Hq + row_h + g) * D + d])
                       : 0.f;
  }
  float acc[kMaxG][kPerLane];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[g][e] = 0.f;
  }

  // The next tile from position t0: at most kTile keys, inside [.., end)
  // and inside one run of consecutive rows.
  auto tile_end = [&](int t0, int end) {
    return min(min(t0 + kTile, end), (t0 / seg + 1) * seg);
  };
  // Stage the K and/or V rows of positions [t0, t0 + n) into stage st,
  // with their int8 scales; commits one cp.async group.
  auto issue = [&](int t0, int n, int st, bool with_k, bool with_v) {
    const size_t r0 = t0 / seg == pa / seg ? row_a + (t0 - pa) : addr.row(b, t0);
    if (with_k) {
      stage_rows<TKV, kMaxD>(stage(st, 0), k, r0, n, Hkv, h, D, vec, tid);
      if (kQuant && tid < n) cp4(&sc_s[st][0][tid], ks + (r0 + tid) * Hkv + h);
    }
    if (with_v) {
      stage_rows<TKV, kMaxD>(stage(st, 1), v, r0, n, Hkv, h, D, vec, tid);
      if (kQuant && tid < n) cp4(&sc_s[st][1][tid], vs + (r0 + tid) * Hkv + h);
    }
    cp_commit();
  };
  // Scores of key j0 + (lane % 16) of stage st (n keys staged), scaled, in
  // both halves of the warp; kNegInf past n.
  auto score = [&](int st, int j0, int n, float (&s)[kMaxG]) {
    const int t = j0 + lane % kGroup, half = lane / kGroup;
    float part[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
    if (t < n) {
      const TKV* kr = stage(st, 0) + t * kS + half * kHalf;
#pragma unroll
      for (int c = 0; c < kHalf / kVec<TKV>; ++c) {
        float x[kVec<TKV>];
        load16(kr + c * kVec<TKV>, x);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float* qh = &q_s[g][half][c * kVec<TKV>];
#pragma unroll
            for (int i = 0; i < kVec<TKV>; i += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qh + i);
              part[g] += qv.x * x[i] + qv.y * x[i + 1] + qv.z * x[i + 2] +
                         qv.w * x[i + 3];
            }
          }
        }
      }
    }
    const float f = t < n ? scale * (kQuant ? sc_s[st][0][t] : 1.f) : 0.f;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float x = part[g] + __shfl_xor_sync(0xffffffffu, part[g], kGroup);
        s[g] = t < n ? x * f : kNegInf;
      }
    }
  };
  // acc[g] += p[g][tt] v(j0 + tt) over keys tt < nt of stage st (p: f32,
  // row stride pstride, the int8 value scales not yet applied).
  auto accumulate = [&](int st, int j0, int nt, const float* p, int pstride) {
    const TKV* vt = stage(st, 1) + j0 * kS + lane * kPerLane;
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      float vx[kPerLane];
      load_lane<kPerLane>(vt + tt * kS, vx);
      const float f = kQuant ? sc_s[st][1][j0 + tt] : 1.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pv = p[g * pstride + tt] * f;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) acc[g][e] += pv * vx[e];
        }
      }
    }
  };
  float* acc_s = reinterpret_cast<float*>(dyn_s);
  auto store_acc = [&]() {  // this warp's accumulators to acc_s[warp]
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int d = lane * kPerLane + e;
        if (g < G && d < D) acc_s[(warp * kMaxG + g) * kMaxD + d] = acc[g][e];
      }
    }
  };

  if constexpr (kLut) {
    if (tid < lut::kSize) lut_s[tid] = table[tid];
    if (tid < G) {
      m_s[0][tid] = kNegInf;
      l_s[0][tid] = 0.f;
    }
    __syncthreads();
    for (int blk0 = lo / bk * bk; blk0 < hi; blk0 += bk) {
      const int a0 = max(lo, blk0), e0 = min(hi, blk0 + bk), nb = e0 - a0;
      for (int t0 = a0; t0 < e0;) {  // the block's scores into p_s
        const int te = tile_end(t0, e0), n = te - t0;
        issue(t0, n, 0, true, false);
        cp_wait<0>();
        __syncthreads();
        for (int j0 = warp * kGroup; j0 < n; j0 += kWarps * kGroup) {
          float s[kMaxG];
          score(0, j0, n, s);
          const int t = j0 + lane;
          if (lane < kGroup && t < n) {
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g < G) p_s[g][t0 - a0 + t] = s[g];
            }
          }
        }
        __syncthreads();
        t0 = te;
      }
      // The block's statistics: one warp per query row.
      for (int g = warp; g < G; g += kWarps) {
        float bm = kNegInf;
        for (int t = lane; t < nb; t += 32) bm = fmaxf(bm, p_s[g][t]);
        const float m_old = m_s[0][g];
        const float m_new = fmaxf(m_old, warp_max(bm));
        float sum = 0.f;
        for (int t = lane; t < nb; t += 32) {
          const float p = lut::lut_exp(p_s[g][t] - m_new, lut_s);
          p_s[g][t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float a = lut::lut_exp(m_old - m_new, lut_s);
          a_s[g] = a;
          l_s[0][g] = l_s[0][g] * a + sum;
          m_s[0][g] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        const float a = g < G ? a_s[g] : 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) acc[g][e] *= a;
      }
      for (int t0 = a0; t0 < e0;) {  // then P @ V
        const int te = tile_end(t0, e0), n = te - t0;
        issue(t0, n, 0, false, true);
        cp_wait<0>();
        __syncthreads();
        for (int j0 = warp * kGroup; j0 < n; j0 += kWarps * kGroup)
          accumulate(0, j0, min(kGroup, n - j0), &p_s[0][t0 - a0 + j0], kMaxBk);
        __syncthreads();
        t0 = te;
      }
    }
    // The warps share the running max: their accumulators add up.
    store_acc();
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float x = 0.f;
      for (int w = 0; w < kWarps; ++w) x += acc_s[(w * kMaxG + g) * kMaxD + d];
      // Never-attended lanes keep l == 0 and acc == 0: the output is 0.
      o[i] = x / fmaxf(l_s[0][g], kEps);
    }
    return;
  } else {
    float m[kMaxG], l[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) m[g] = kNegInf, l[g] = 0.f;
    int t0 = p0, te = tile_end(p0, p1), st = 0;
    issue(t0, te - t0, 0, true, true);
    while (t0 < p1) {
      const int n = te - t0;
      const int ne = te < p1 ? tile_end(te, p1) : te;
      const bool ahead = te < p1 && nstage > 1;
      if (ahead) {  // the next tile's copy overlaps this tile's products
        issue(te, ne - te, st ^ 1, true, true);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      for (int j0 = warp * kGroup; j0 < n; j0 += kWarps * kGroup) {
        float s[kMaxG];
        score(st, j0, n, s);
        const int t = j0 + lane % kGroup;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float m_new = fmaxf(m[g], group_max(s[g]));
            const float a = expf(m[g] - m_new);
            const float p = t < n ? expf(s[g] - m_new) : 0.f;
            l[g] = l[g] * a + group_sum(p);
            m[g] = m_new;
#pragma unroll
            for (int e = 0; e < kPerLane; ++e) acc[g][e] *= a;
            if (lane < kGroup) pw_s[warp][g][lane] = p;
          }
        }
        __syncwarp();
        accumulate(st, j0, min(kGroup, n - j0), &pw_s[warp][0][0], kGroup);
        __syncwarp();
      }
      __syncthreads();  // this stage is free again
      if (te < p1 && !ahead) issue(te, ne - te, 0, true, true);
      t0 = te;
      te = ne;
      st = ahead ? st ^ 1 : 0;
    }
    // Merge the warps (a warp that saw no key holds (0, kNegInf, 0)).
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) m_s[warp][g] = m[g], l_s[warp][g] = l[g];
      }
    }
    store_acc();
    __syncthreads();
    const int nsplit = gridDim.x;
    const size_t step = static_cast<size_t>(B) * Hq;  // one split's rows
    float* ws_acc = ws;
    float* ws_ml = ws + static_cast<size_t>(nsplit) * step * D;
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float mb = kNegInf;
      for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, m_s[w][g]);
      float x = 0.f, y = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(m_s[w][g] - mb);
        x += acc_s[(w * kMaxG + g) * kMaxD + d] * f;
        y += l_s[w][g] * f;
      }
      if (n_live == 1) {
        o[i] = x / fmaxf(y, kEps);
      } else {
        const size_t row = sp * step + static_cast<size_t>(b) * Hq + row_h + g;
        ws_acc[row * D + d] = x;
        if (d == 0) ws_ml[2 * row] = mb, ws_ml[2 * row + 1] = y;
      }
    }
    if (n_live == 1) return;
    // The last live split of this (slot, head, tile) to finish merges
    // them all.
    int* counter = &counters[static_cast<size_t>(b) * gridDim.y + blockIdx.y];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_s = atomicAdd(counter, 1) == n_live - 1;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    // Every split's (m, l) at once, then the weights exp(m - m*) per split
    // and row, and l*; then the accumulators in split order.
    float* w_s = reinterpret_cast<float*>(dyn_s);  // [split][g]
    float* lw_s = w_s + kMaxSplits * kMaxG;
    const size_t row0 = static_cast<size_t>(b) * Hq + row_h;
    for (int i = tid; i < n_live * G; i += kThreads) {
      const int j = i / G, g = i - j * G;
      const size_t row = (first + j) * step + row0 + g;
      w_s[i] = __ldcg(&ws_ml[2 * row]);
      lw_s[i] = __ldcg(&ws_ml[2 * row + 1]);
    }
    __syncthreads();
    if (tid < G) {
      float mb = kNegInf;
      for (int j = 0; j < n_live; ++j) mb = fmaxf(mb, w_s[j * G + tid]);
      float y = 0.f;
      for (int j = 0; j < n_live; ++j) {
        const float f = expf(w_s[j * G + tid] - mb);
        w_s[j * G + tid] = f;
        y += lw_s[j * G + tid] * f;
      }
      a_s[tid] = y;
    }
    __syncthreads();
    constexpr int kOut = kMaxG * kMaxD / kThreads;  // outputs a thread, at most
    float x[kOut];
    int gu[kOut];  // each output's query row; G when past the last row
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      x[u] = 0.f;
      gu[u] = min((tid + u * kThreads) / D, G);
    }
#pragma unroll 4
    for (int j = 0; j < n_live; ++j) {  // the loads of 4 splits in flight
      const float* src = ws_acc + ((first + j) * step + row0) * D + tid;
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        if (gu[u] < G) x[u] += __ldcg(src + u * kThreads) * w_s[j * G + gu[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      if (gu[u] < G) o[tid + u * kThreads] = x[u] / fmaxf(a_s[gu[u]], kEps);
    }
    if (tid == 0) *counter = 0;  // ready for the next launch
  }
}

template <typename TQ, typename TKV, bool kLut, int kMaxD, typename Addr>
int launch_kernel(dim3 grid, int nstage, cudaStream_t s, const TQ* q,
                  const TKV* k, const TKV* v, const float* ks, const float* vs,
                  const int* bounds, const float* table, float* ws,
                  int* counters, float* out, int Hq, int Hkv, int D,
                  float scale, int bk, int split, int vec, int tiles,
                  int tile_rows, const Addr& addr) {
  auto* kern = decode_kernel<TQ, TKV, kLut, kMaxD, Addr>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kStageBytes<TKV, kMaxD>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<grid, kThreads, nstage * kStageBytes<TKV, kMaxD>, s>>>(
      q, k, v, ks, vs, bounds, table, ws, counters, out, Hq, Hkv, D, scale,
      bk, split, vec, nstage, tiles, tile_rows, addr);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int kMaxD, typename Addr>
int launch_typed(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int* bounds, const float* table,
                 float* ws, int* counters, float* out, int B, int Hq, int Hkv,
                 int D, float scale, int bk, int split, const Addr& addr,
                 cudaStream_t s) {
  const int limit = addr.limit(), seg = addr.seg();
  const int nsplit = limit > split ? (limit + split - 1) / split : 1;
  if (nsplit > kMaxSplits || (nsplit > 1 && (!ws || !counters))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Group tiles of at most kMaxG rows, as even as they come.
  const int G = Hq / Hkv;
  const int tiles = (G + kMaxG - 1) / kMaxG;
  const int tile_rows = (G + tiles - 1) / tiles;
  const dim3 grid(nsplit, Hkv * tiles, B);
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  const int vec = (D * sizeof(TKV)) % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  // One stage when a split is one tile (at most kTile keys, in one run of
  // rows) and in the LUT mode; two to overlap the tiles of longer splits.
  const bool one_tile = split <= kTileKeys<TKV> && (seg % split == 0 || seg >= limit);
  const int nstage = table || one_tile ? 1 : 2;
  if (table) {
    return launch_kernel<TQ, TKV, true, kMaxD, Addr>(
        grid, nstage, s, qt, kt, vt, ks, vs, bounds, table, ws, counters, out,
        Hq, Hkv, D, scale, bk, split, vec, tiles, tile_rows, addr);
  }
  return launch_kernel<TQ, TKV, false, kMaxD, Addr>(
      grid, nstage, s, qt, kt, vt, ks, vs, bounds, table, ws, counters, out,
      Hq, Hkv, D, scale, bk, split, vec, tiles, tile_rows, addr);
}

// The dtype / K-V type instances of one kMaxD.
template <int kMaxD, typename Addr>
int launch_dtype(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int* bd, const float* tb, float* w,
                 int* c, float* o, int B, int Hq, int Hkv, int D, int dtype,
                 int quant, float scale, int bk, int split, const Addr& addr,
                 cudaStream_t s) {
  if (dtype == 0 && !quant) {
    return launch_typed<float, float, kMaxD>(q, k, v, ks, vs, bd, tb, w, c, o,
                                             B, Hq, Hkv, D, scale, bk, split,
                                             addr, s);
  } else if (dtype == 1 && !quant) {
    return launch_typed<__nv_bfloat16, __nv_bfloat16, kMaxD>(
        q, k, v, ks, vs, bd, tb, w, c, o, B, Hq, Hkv, D, scale, bk, split, addr,
        s);
  } else if (dtype == 0 && quant) {
    return launch_typed<float, int8_t, kMaxD>(q, k, v, ks, vs, bd, tb, w, c, o,
                                              B, Hq, Hkv, D, scale, bk, split,
                                              addr, s);
  } else if (dtype == 1 && quant) {
    return launch_typed<__nv_bfloat16, int8_t, kMaxD>(
        q, k, v, ks, vs, bd, tb, w, c, o, B, Hq, Hkv, D, scale, bk, split, addr,
        s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch ceil(width / split) splits for each (kv head, group tile, slot),
// ceil(G / 8) group tiles per kv head. dtype: q's
// type, 0 = float32, 1 = bfloat16; quant: 0 = k/v in q's type, 1 = int8
// codes with f32 scales ks/vs; table: null for the exact exp, else the
// 64-entry LUT with blocks of bk positions (1 <= bk <= kMaxBk) and then
// split >= the lane width; ws, counters: the workspace and zeroed counters
// (null allowed with one split; B * Hkv * ceil(G / 8) counters). At most
// kMaxSplits splits; head dims 1 to 256. Returns
// cudaGetLastError() after the launch.
template <typename Addr>
int launch_decode(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* bounds, const void* table,
                  void* ws, void* counters, void* out, int B, int Hq, int Hkv,
                  int D, int dtype, int quant, float scale, int bk, int split,
                  const Addr& addr, void* stream) {
  if (B == 0) return 0;
  if (split < 1 || (table && (bk < 1 || bk > kMaxBk || split < addr.limit()))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bd = static_cast<const int*>(bounds);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const float* tb = static_cast<const float*>(table);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  float* o = static_cast<float*>(out);
  // The instance: kMaxD 128 up to D = 128 (every earlier row's), 256 above.
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 128) {
    return launch_dtype<128>(q, k, v, kss, vss, bd, tb, w, c, o, B, Hq, Hkv,
                             D, dtype, quant, scale, bk, split, addr, s);
  }
  return launch_dtype<256>(q, k, v, kss, vss, bd, tb, w, c, o, B, Hq, Hkv, D,
                           dtype, quant, scale, bk, split, addr, s);
}

}  // namespace tda
