// Paged slot-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tda/tda.py::tda_paged_decode_attention
// (pallas_call at tda.py:282): one query token per slot attends the slot's
// logical KV lane [lo, hi), whose pages live in a physical pool (P, ps, Hkv, D)
// behind a per-slot block table; online softmax in f32; GQA; output zeros
// when hi <= lo. fp keys/values only (the int8 and LUT-exp variants come
// with the kv_quant / AFU slice).
//
// What bounds it on this card: bytes. Each visited key/value element (2 bytes
// in bf16) meets only G = Hq / Hkv query rows (5 at qwen2.5-32b full width):
// about G flops per byte read, far below the ~295 flops/byte where an H100
// stops being memory-bound. So the design reads every visited K/V element
// from device memory exactly once:
//   * one thread block per (slot, kv head); its G query rows share every
//     key/value tile it loads, so G need not be a power of two;
//   * the block walks only the positions in [lo, hi) (so only the pages
//     that meet the span), in tiles of 32 keys staged in shared memory as
//     f32; the block table entry is read and clamped to [0, P-1] in-kernel;
//   * m, l live in shared memory and the (G, D) accumulator in registers,
//     all f32. The sequential kv-block grid axis of the TPU kernel becomes
//     this loop inside the block: blocks cannot carry state across the grid.
// Tensor cores are not used: at G <= 8 query rows the products are tiny, and
// the first version is the simple one; split-K (flash-decoding) across
// blocks, which the card needs to fill 132 SMs at small batch, is a later
// speed step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ bounds,
                    const int* __restrict__ bt, float* __restrict__ out,
                    int Hq, int Hkv, int D, int P, int ps, int nblk,
                    float scale) {
  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float k_s[kTile][kMaxD + 1];
  __shared__ float v_s[kTile][kMaxD + 1];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int lo = max(bounds[2 * b], 0);
  const int hi = min(bounds[2 * b + 1], nblk * ps);

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
      const int t = i / D, d = i % D, p = t0 + t;
      const int page = min(max(bt[(size_t)b * nblk + p / ps], 0), P - 1);
      const size_t off = (((size_t)page * ps + p % ps) * Hkv + h) * D + d;
      k_s[t][d] = to_f32(k[off]);
      v_s[t][d] = to_f32(v[off]);
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

}  // namespace

// q (B, Hq, D); k, v (P, ps, Hkv, D); bounds (B, 2) int32 [lo, hi);
// bt (B, nblk) int32; out (B, Hq, D) f32. dtype: 0 = float32, 1 = bfloat16.
// Requires Hq % Hkv == 0, Hq / Hkv <= 8, D <= 128 (the wrapper checks).
extern "C" int tda_paged_decode(const void* q, const void* k, const void* v,
                                const void* bounds, const void* bt, void* out,
                                int B, int Hq, int Hkv, int D, int P, int ps,
                                int nblk, int dtype, float scale, void* stream) {
  if (B == 0) return 0;
  const dim3 grid(B, Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bd = static_cast<const int*>(bounds);
  const int* tb = static_cast<const int*>(bt);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bd, tb, o, Hq, Hkv, D, P, ps, nblk, scale);
  } else if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bd, tb, o, Hq, Hkv, D, P, ps, nblk,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
