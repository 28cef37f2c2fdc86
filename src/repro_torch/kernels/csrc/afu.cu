// AFU kernels for Hopper (sm_90a): the LUT-exp row softmax and the fused
// residual + LayerNorm.
//
// Replace the TPU kernels src/repro/kernels/afu/afu.py::softmax_lut
// (afu.py:35, pallas_call at :41) and ::layernorm_residual (afu.py:61,
// pallas_call at :68). The TPU kernels hold a block of rows, with the whole
// feature axis, in VMEM and do every pass there: one read from HBM, one
// write. Here one thread block owns one row.
//
// What bounds them on this card: bytes. Softmax reads each input once and
// writes one f32 (a few operations per element); LayerNorm reads x and res
// and writes one f32. So the design reads every element from device memory
// once when the row fits a block's shared memory:
//   * softmax_lut: three passes over the row, all in f32: the row max; the
//     sum of lut(x - max); then lut(x - max) / sum. Not one pass with a
//     running max: under the LUT exp, rescaling a running sum by
//     lut(m_old - m_new) is a different function from the reference's.
//     Pass 1 stages the row in shared memory and pass 2 overwrites it with
//     the exps, so pass 3 only divides. The 64-entry table sits in shared
//     memory. A row longer than 12 K entries (48 KB; the LM head's 152 064)
//     is re-read from device memory in each pass instead, through the 50 MB
//     L2, by a block of 1024 threads;
//   * layernorm_residual: h = x + res in f32 is staged once; the mean, then
//     the variance of h - mean (two passes over the staged h, not
//     E[h^2] - mean^2), then (h - mean) * rsqrt(var + eps) * scale + bias.
//     Rows past 12 K entries recompute h from device memory in each pass.
// Rows are independent: grid = R blocks. At small R (a decode step's 8
// rows) most SMs idle; splitting a row across blocks is a later speed step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "lut_exp.cuh"

namespace {

constexpr int kThreads = 256;       // a row staged in shared memory
constexpr int kThreadsLong = 1024;  // a row re-read from device memory
constexpr int kMaxStaged = 12 * 1024;  // f32 entries: 48 KB of shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum (or max) over the block, returned to every thread. red: 32 floats of
// shared memory; the leading barrier lets back-to-back calls reuse it.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < static_cast<int>(blockDim.x / 32) ? red[lane]
                                               : (kMax ? -CUDART_INF_F : 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

template <typename T, bool kStaged>
__global__ void softmax_lut_kernel(const T* __restrict__ x,
                                   const float* __restrict__ table,
                                   float* __restrict__ out, int C) {
  extern __shared__ float row_s[];  // C entries when kStaged
  __shared__ float lut_s[lut::kSize];
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * C;
  if (tid < lut::kSize) lut_s[tid] = table[tid];
  float m = -CUDART_INF_F;
  for (int c = tid; c < C; c += nt) {
    const float v = to_f32(x[base + c]);
    if constexpr (kStaged) row_s[c] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce<true>(m, red);  // its barriers also publish lut_s
  float s = 0.f;
  for (int c = tid; c < C; c += nt) {
    const float v = kStaged ? row_s[c] : to_f32(x[base + c]);
    const float e = lut::lut_exp(v - m, lut_s);
    if constexpr (kStaged) row_s[c] = e;  // each thread reads back its own
    s += e;
  }
  s = block_reduce<false>(s, red);
  for (int c = tid; c < C; c += nt) {
    const float e =
        kStaged ? row_s[c] : lut::lut_exp(to_f32(x[base + c]) - m, lut_s);
    out[base + c] = e / s;
  }
}

template <typename T, bool kStaged>
__global__ void ln_res_kernel(const T* __restrict__ x,
                              const T* __restrict__ res,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int C, float eps) {
  extern __shared__ float h_s[];  // C entries when kStaged
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * C;
  float s = 0.f;
  for (int c = tid; c < C; c += nt) {
    const float h = to_f32(x[base + c]) + to_f32(res[base + c]);
    if constexpr (kStaged) h_s[c] = h;
    s += h;
  }
  const float mu = block_reduce<false>(s, red) / C;
  float q = 0.f;
  for (int c = tid; c < C; c += nt) {
    const float h =
        kStaged ? h_s[c] : to_f32(x[base + c]) + to_f32(res[base + c]);
    q += (h - mu) * (h - mu);
  }
  const float r = rsqrtf(block_reduce<false>(q, red) / C + eps);
  for (int c = tid; c < C; c += nt) {
    const float h =
        kStaged ? h_s[c] : to_f32(x[base + c]) + to_f32(res[base + c]);
    out[base + c] = (h - mu) * r * scale[c] + bias[c];
  }
}

// One block per row; a row of at most kMaxStaged entries is held in dynamic
// shared memory (<= 48 KB, no opt-in attribute needed).
template <typename T>
int launch_softmax(const void* x, const float* table, float* out, int R,
                   int C, cudaStream_t s) {
  if (R == 0 || C == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  if (C <= kMaxStaged) {
    softmax_lut_kernel<T, true>
        <<<R, kThreads, C * sizeof(float), s>>>(xt, table, out, C);
  } else {
    softmax_lut_kernel<T, false><<<R, kThreadsLong, 0, s>>>(xt, table, out, C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln(const void* x, const void* res, const float* scale,
              const float* bias, float* out, int R, int C, float eps,
              cudaStream_t s) {
  if (R == 0 || C == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  if (C <= kMaxStaged) {
    ln_res_kernel<T, true><<<R, kThreads, C * sizeof(float), s>>>(
        xt, rt, scale, bias, out, C, eps);
  } else {
    ln_res_kernel<T, false><<<R, kThreadsLong, 0, s>>>(xt, rt, scale, bias,
                                                       out, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (R, C) in dtype (0 = float32, 1 = bfloat16); table (64,) f32;
// out (R, C) f32. Returns cudaGetLastError() after the launch.
extern "C" int softmax_lut(const void* x, const void* table, void* out, int R,
                           int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_softmax<float>(x, t, o, R, C, s);
  if (dtype == 1) return launch_softmax<__nv_bfloat16>(x, t, o, R, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, res (R, C) in dtype (0 = float32, 1 = bfloat16); scale, bias (C,) f32;
// out (R, C) f32. Returns cudaGetLastError() after the launch.
extern "C" int layernorm_residual(const void* x, const void* res,
                                  const void* scale, const void* bias,
                                  void* out, int R, int C, int dtype,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_ln<float>(x, res, sc, bi, o, R, C, eps, s);
  if (dtype == 1)
    return launch_ln<__nv_bfloat16>(x, res, sc, bi, o, R, C, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
