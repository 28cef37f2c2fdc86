// Slot-decode attention body shared by the contiguous-lane and paged-lane
// decode kernels, for Hopper (sm_90a).
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
// One query token per slot attends the lane's [lo, hi); online softmax in
// f32; GQA; output zeros when hi <= lo.
//
// What bounds it on this card: bytes. Each visited key/value element (2
// bytes in bf16, 1 in int8 plus a 4-byte scale per head row of D) meets only
// G = Hq / Hkv query rows (5 at qwen2.5-32b full width): about G flops per
// byte read, far below the ~295 flops/byte where an H100 stops being
// memory-bound. So the design reads every visited K/V element from device
// memory exactly once, and int8 lanes move 2 * Hkv * (D + 4) bytes a token
// instead of 2 * Hkv * D * 2 (0.516x at D = 128):
//   * one thread block per (slot, kv head); its G query rows share every
//     key/value tile it loads, so G need not be a power of two;
//   * the block walks only the positions in [lo, hi) (clamped to the lane),
//     in tiles of 32 keys staged in shared memory as f32; int8 codes are
//     dequantized (code * scale[pos, h]) while the tile is staged, so a
//     dense fp lane never exists in device memory; any lane width works,
//     the ragged tail is masked by hi;
//   * m, l live in shared memory and the (G, D) accumulator in registers,
//     all f32. The sequential kv-block grid axis of the TPU kernels becomes
//     this loop inside the block: blocks cannot carry state across the grid.
// Tensor cores are not used: at G <= 8 query rows the products are tiny, and
// the first version is the simple one; split-K (flash-decoding) across
// blocks, which the card needs to fill 132 SMs at small batch, and 16-byte
// vector loads are later speed steps.
//
// LUT mode (kLut, a table of the AFU's 64-entry exp given): both
// exponentials of the online softmax go through lut::lut_exp, and then the
// result depends on where the rescaling happens, since lut(a) * lut(b) !=
// lut(a + b). So the statistics follow the reference's blocks, not this
// kernel's 32-key tiles: blocks of bk positions aligned at multiples of bk
// in lane coordinates (bk = min(block_k, S) for contiguous lanes, the page
// size for paged ones), each visited when it meets [lo, hi). A block first
// scores all its visited keys (K staged 32 at a time) into p_s[G][bk]
// (bk <= 256: 8 KB at G = 8), then takes the block max, p = lut(s - m_new)
// and alpha = lut(m_old - m_new) once, then streams V through the
// accumulator. K and V are still read once each. The exact mode (kLut
// false) is the loop above, unchanged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lut_exp.cuh"

namespace tda {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per shared-memory tile == warp width
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;
constexpr int kMaxBk = 256;  // largest LUT-mode block (positions)
constexpr int kPer = kMaxG * kMaxD / kThreads;  // accumulators per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Addr: `int limit() const` (the lane width; hi is clamped to it) and
// `size_t row(int b, int p) const` (the token row of lane position p of slot
// b: element (row * Hkv + h) * D + d of k/v, scale row * Hkv + h).
// kLut: table (lut::kSize f32) and bk (the LUT-mode block, <= kMaxBk) are
// read; otherwise both are ignored.
template <typename TQ, typename TKV, bool kLut, typename Addr>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ bounds,
              const float* __restrict__ table, float* __restrict__ out,
              int Hq, int Hkv, int D, float scale, int bk, Addr addr) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float k_s[kTile][kMaxD + 1];
  __shared__ float v_s[kTile][kMaxD + 1];
  __shared__ float p_s[kMaxG][kLut ? kMaxBk : kTile];
  __shared__ float lut_s[kLut ? lut::kSize : 1];
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int lo = max(bounds[2 * b], 0);
  const int hi = min(bounds[2 * b + 1], addr.limit());

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = to_f32(q[((size_t)b * Hq + h * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if constexpr (kLut) {
    if (tid < lut::kSize) lut_s[tid] = table[tid];
  }
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if constexpr (kLut) {
    // Stage n rows from lane position p0 of k or v into dst as f32 (int8
    // codes times their scale).
    auto stage = [&](float (*dst)[kMaxD + 1], const TKV* __restrict__ src,
                     const float* __restrict__ sc, int p0, int n) {
      for (int i = tid; i < n * D; i += kThreads) {
        const int t = i / D, d = i % D;
        const size_t hrow = addr.row(b, p0 + t) * Hkv + h;
        float x = to_f32(src[hrow * D + d]);
        if constexpr (kQuant) x *= sc[hrow];
        dst[t][d] = x;
      }
    };
    for (int blk0 = lo < hi ? lo / bk * bk : hi; blk0 < hi; blk0 += bk) {
      const int p0 = max(lo, blk0), nb = min(hi, blk0 + bk) - p0;
      for (int t0 = 0; t0 < nb; t0 += kTile) {  // scores of the block
        const int n = min(kTile, nb - t0);
        stage(k_s, k, ks, p0 + t0, n);
        __syncthreads();
        for (int i = tid; i < G * n; i += kThreads) {
          const int g = i / n, t = i % n;
          float s = 0.f;
          for (int d = 0; d < D; ++d) s += q_s[g][d] * k_s[t][d];
          p_s[g][t0 + t] = s * scale;
        }
        __syncthreads();
      }
      // The block's statistics: one warp per query row.
      for (int g = warp; g < G; g += kThreads / 32) {
        float bm = kNegInf;
        for (int t = lane; t < nb; t += 32) bm = fmaxf(bm, p_s[g][t]);
        const float m_old = m_s[g];
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
          l_s[g] = l_s[g] * a + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (i < G * D) acc[j] *= a_s[i / D];
      }
      for (int t0 = 0; t0 < nb; t0 += kTile) {  // then P @ V
        const int n = min(kTile, nb - t0);
        stage(v_s, v, vs, p0 + t0, n);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads;
          if (i < G * D) {
            const int g = i / D, d = i % D;
            float o = acc[j];
            for (int t = 0; t < n; ++t) o += p_s[g][t0 + t] * v_s[t][d];
            acc[j] = o;
          }
        }
        __syncthreads();
      }
    }
  } else {
    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int n = min(kTile, hi - t0);
      for (int i = tid; i < n * D; i += kThreads) {
        const int t = i / D, d = i % D;
        const size_t hrow = addr.row(b, t0 + t) * Hkv + h;
        float kx = to_f32(k[hrow * D + d]);
        float vx = to_f32(v[hrow * D + d]);
        if constexpr (kQuant) {
          kx *= ks[hrow];
          vx *= vs[hrow];
        }
        k_s[t][d] = kx;
        v_s[t][d] = vx;
      }
      __syncthreads();
      for (int i = tid; i < G * n; i += kThreads) {
        const int g = i / n, t = i % n;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += q_s[g][d] * k_s[t][d];
        p_s[g][t] = s * scale;
      }
      __syncthreads();
      // Online-softmax statistics: one warp per query row, one lane per key.
      for (int g = warp; g < G; g += kThreads / 32) {
        const float s = lane < n ? p_s[g][lane] : kNegInf;
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = lane < n ? expf(s - m_new) : 0.f;
        if (lane < n) p_s[g][lane] = p;
        const float sum = warp_sum(p);
        if (lane == 0) {
          const float a = expf(m_old - m_new);
          a_s[g] = a;
          l_s[g] = l_s[g] * a + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (i < G * D) {
          const int g = i / D, d = i % D;
          float o = acc[j] * a_s[g];
          for (int t = 0; t < n; ++t) o += p_s[g][t] * v_s[t][d];
          acc[j] = o;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * D) {
      const int g = i / D, d = i % D;
      // Never-attended lanes keep l == 0 and acc == 0: the output is 0.
      out[((size_t)b * Hq + h * G + g) * D + d] = acc[j] / fmaxf(l_s[g], 1e-30f);
    }
  }
}

template <typename TQ, typename TKV, typename Addr>
int launch_typed(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int* bounds, const float* table,
                 float* out, int B, int Hq, int Hkv, int D, float scale, int bk,
                 const Addr& addr, cudaStream_t s) {
  const dim3 grid(B, Hkv);
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  if (table) {
    decode_kernel<TQ, TKV, true, Addr><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, ks, vs, bounds, table, out, Hq, Hkv, D, scale, bk, addr);
  } else {
    decode_kernel<TQ, TKV, false, Addr><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, ks, vs, bounds, table, out, Hq, Hkv, D, scale, bk, addr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch one (slot, kv head) block each. dtype: q's type, 0 = float32,
// 1 = bfloat16; quant: 0 = k/v in q's type, 1 = int8 codes with f32 scales
// ks/vs; table: null for the exact exp, else the 64-entry LUT with blocks
// of bk positions (1 <= bk <= kMaxBk). Returns cudaGetLastError() after the
// launch.
template <typename Addr>
int launch_decode(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* bounds, const void* table,
                  void* out, int B, int Hq, int Hkv, int D, int dtype,
                  int quant, float scale, int bk, const Addr& addr,
                  void* stream) {
  if (B == 0) return 0;
  if (table && (bk < 1 || bk > kMaxBk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bd = static_cast<const int*>(bounds);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const float* tb = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  if (dtype == 0 && !quant) {
    return launch_typed<float, float>(q, k, v, kss, vss, bd, tb, o, B, Hq, Hkv,
                                      D, scale, bk, addr, s);
  } else if (dtype == 1 && !quant) {
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, kss, vss, bd, tb, o, B, Hq, Hkv, D, scale, bk, addr, s);
  } else if (dtype == 0 && quant) {
    return launch_typed<float, int8_t>(q, k, v, kss, vss, bd, tb, o, B, Hq, Hkv,
                                       D, scale, bk, addr, s);
  } else if (dtype == 1 && quant) {
    return launch_typed<__nv_bfloat16, int8_t>(q, k, v, kss, vss, bd, tb, o, B,
                                               Hq, Hkv, D, scale, bk, addr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tda
