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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tda {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per shared-memory tile == warp width
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;
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
template <typename TQ, typename TKV, typename Addr>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ bounds,
              float* __restrict__ out, int Hq, int Hkv, int D, float scale,
              Addr addr) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float k_s[kTile][kMaxD + 1];
  __shared__ float v_s[kTile][kMaxD + 1];
  __shared__ float p_s[kMaxG][kTile];
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
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
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

// Launch one (slot, kv head) block each. dtype: q's type, 0 = float32,
// 1 = bfloat16; quant: 0 = k/v in q's type, 1 = int8 codes with f32 scales
// ks/vs. Returns cudaGetLastError() after the launch.
template <typename Addr>
int launch_decode(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* bounds, void* out, int B, int Hq,
                  int Hkv, int D, int dtype, int quant, float scale,
                  const Addr& addr, void* stream) {
  if (B == 0) return 0;
  const dim3 grid(B, Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bd = static_cast<const int*>(bounds);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  float* o = static_cast<float*>(out);
  if (dtype == 0 && !quant) {
    decode_kernel<float, float, Addr><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kss, vss, bd, o, Hq, Hkv, D, scale, addr);
  } else if (dtype == 1 && !quant) {
    decode_kernel<__nv_bfloat16, __nv_bfloat16, Addr><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kss, vss, bd, o, Hq, Hkv, D, scale,
        addr);
  } else if (dtype == 0 && quant) {
    decode_kernel<float, int8_t, Addr><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), kss, vss, bd, o, Hq, Hkv, D, scale, addr);
  } else if (dtype == 1 && quant) {
    decode_kernel<__nv_bfloat16, int8_t, Addr><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), kss, vss, bd, o, Hq, Hkv, D, scale, addr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tda
