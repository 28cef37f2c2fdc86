// Mixed-step (chunked-prefill + decode) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tda/tda.py::tda_mixed_attention
// (pallas_call at tda.py:459). Row b carries S chunk queries; column j sits
// at absolute position ci + j, with bounds[b] = [ci, n_new]. Each query
// attends the union of
//   (a) the PRE-write paged lane: lane slot r in [0, min(ci, ring)) holds
//       token p_r = ci-1 - ((ci-1-r) mod ring), valid when p_r >= 0 (and
//       p_r > ci + j - window with a window), and
//   (b) the row's own chunk keys i: causal i <= j, i < n_new (and
//       j - i < window).
// Online softmax in f32, GQA. fp keys/values only (no int8 / LUT variants).
//
// Output convention: columns j >= n_new are never read by the caller (the
// reference calls them garbage); this kernel skips their work, so a decode
// row (n_new == 1) in a step of width S costs one column, not S. It still
// writes them as zeros, so that the projections after attention see finite
// values (the output comes from torch.empty). Rows with no key at all
// (ci == 0, n_new == 0) give zeros.
//
// What bounds it on this card: by the card's peaks, bytes. In the served
// shapes (8 rows of 256 columns, 660 of them live, 40 q / 8 kv heads of
// 128) the live work reads about 8.8 MB of cache and
// chunk keys/values and 6.8 MB of live queries and writes 13.5 MB of live
// f32 outputs: about 8.7 us at HBM peak, while its 3.5 GFLOP would take
// about 3.5 us on the bf16 tensor cores. The zero-writes of unread columns
// (about 28 MB more) are this kernel's own cost, outside that bound. This
// first version computes the products on the CUDA cores in f32, so in
// practice it is bound by f32 FMA throughput and shared-memory bandwidth,
// far above either.
//
// The TPU kernel keeps an (S*Hq, D) f32 scratch across a sequential grid
// axis: 256*40*128*4 B = 5.2 MB, 23x the 227 KB a block may hold. So the queries are tiled instead: one block per
// (row b, kv head, tile of 16 query rows, counting across the chunk columns
// x G), each looping over key tiles of 32 staged in shared memory as f32,
// first over the cache pages that meet [0, min(ci, ring)) and then over the
// in-row chunk keys it can see. A tile's (16, D) accumulator stays in
// registers, its m and l in shared memory. Tensor-core (wgmma) tiles are a
// later speed step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per shared-memory tile
constexpr int kQR = 16;    // query rows per block
constexpr int kMaxD = 128;
constexpr int kPer = kQR * kMaxD / kThreads;  // accumulators per thread
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
mixed_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ kr,
             const T* __restrict__ vr, const int* __restrict__ bounds,
             const int* __restrict__ bt, float* __restrict__ out, int S,
             int Hq, int Hkv, int D, int P, int ps, int nblk, int ring,
             int window, float scale) {
  __shared__ float q_s[kQR][kMaxD];
  __shared__ float k_s[kTile][kMaxD + 1];
  __shared__ float v_s[kTile][kMaxD + 1];
  __shared__ float p_s[kQR][kTile];
  __shared__ unsigned char ok_s[kQR][kTile];
  __shared__ float m_s[kQR], l_s[kQR], a_s[kQR];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.z * kQR;  // first query row: row r = j * G + g
  const int nr = min(kQR, S * G - r0);
  const int ci = max(bounds[2 * b], 0);
  const int nn = min(max(bounds[2 * b + 1], 0), S);

  // Columns at or past n_new are written as zeros and cost nothing else.
  if (r0 / G >= nn) {
    for (int i = tid; i < nr * D; i += kThreads) {
      const int rr = i / D, d = i % D, r = r0 + rr;
      out[(((size_t)b * S + r / G) * Hq + h * G + r % G) * D + d] = 0.f;
    }
    return;
  }
  const int j_last = (r0 + nr - 1) / G;
  const int n_cache = min(min(ci, ring), nblk * ps);
  const int n_row = min(nn, j_last + 1);
  const int total = n_cache + n_row;

  for (int i = tid; i < kQR * D; i += kThreads) {
    const int rr = i / D, d = i % D, r = r0 + rr;
    q_s[rr][d] = rr < nr
        ? to_f32(q[(((size_t)b * S + r / G) * Hq + h * G + r % G) * D + d])
        : 0.f;
  }
  if (tid < kQR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int u0 = 0; u0 < total; u0 += kTile) {
    const int n = min(kTile, total - u0);
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D, d = i % D, u = u0 + t;
      if (u < n_cache) {  // pre-write lane slot r = u, through the table
        const int page = min(max(bt[(size_t)b * nblk + u / ps], 0), P - 1);
        const size_t off = (((size_t)page * ps + u % ps) * Hkv + h) * D + d;
        k_s[t][d] = to_f32(k[off]);
        v_s[t][d] = to_f32(v[off]);
      } else {  // in-row chunk key i = u - n_cache
        const size_t off = (((size_t)b * S + (u - n_cache)) * Hkv + h) * D + d;
        k_s[t][d] = to_f32(kr[off]);
        v_s[t][d] = to_f32(vr[off]);
      }
    }
    __syncthreads();
    for (int i = tid; i < kQR * n; i += kThreads) {
      const int rr = i / n, t = i % n, u = u0 + t;
      const int j = (r0 + rr) / G;
      bool ok = rr < nr && j < nn;
      if (u < n_cache) {
        const int p_r = (ci - 1) - (ci - 1 - u) % ring;  // u <= ci - 1
        ok = ok && p_r >= 0 && u < ring;
        if (window > 0) ok = ok && p_r > ci + j - window;
      } else {
        const int ii = u - n_cache;
        ok = ok && ii <= j && ii < nn;
        if (window > 0) ok = ok && (j - ii) < window;
      }
      float s = 0.f;
      if (ok)
        for (int d = 0; d < D; ++d) s += q_s[rr][d] * k_s[t][d];
      p_s[rr][t] = ok ? s * scale : kNegInf;
      ok_s[rr][t] = ok;
    }
    __syncthreads();
    for (int rr = warp; rr < kQR; rr += kThreads / 32) {
      const bool ok = lane < n && ok_s[rr][lane];
      const float s = ok ? p_s[rr][lane] : kNegInf;
      const float m_old = m_s[rr];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      if (lane < n) p_s[rr][lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[rr] = a;
        l_s[rr] = l_s[rr] * a + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < kQR * D) {
        const int rr = i / D, d = i % D;
        float o = acc[j] * a_s[rr];
        for (int t = 0; t < n; ++t) o += p_s[rr][t] * v_s[t][d];
        acc[j] = o;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    if (i < nr * D) {
      const int rr = i / D, d = i % D, r = r0 + rr;
      const float o = (r / G) < nn ? acc[j] / fmaxf(l_s[rr], 1e-30f) : 0.f;
      out[(((size_t)b * S + r / G) * Hq + h * G + r % G) * D + d] = o;
    }
  }
}

}  // namespace

// q (B, S, Hq, D); k, v (P, ps, Hkv, D); k_row, v_row (B, S, Hkv, D);
// bounds (B, 2) int32 [ci, n_new]; bt (B, nblk) int32; out (B, S, Hq, D) f32.
// window <= 0 means no window. dtype: 0 = float32, 1 = bfloat16.
// Requires Hq % Hkv == 0, D <= 128 (the wrapper checks).
extern "C" int tda_mixed(const void* q, const void* k, const void* v,
                         const void* k_row, const void* v_row,
                         const void* bounds, const void* bt, void* out, int B,
                         int S, int Hq, int Hkv, int D, int P, int ps, int nblk,
                         int ring, int window, int dtype, float scale,
                         void* stream) {
  if (B == 0 || S == 0) return 0;
  const int G = Hq / Hkv;
  const dim3 grid(B, Hkv, (S * G + kQR - 1) / kQR);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bd = static_cast<const int*>(bounds);
  const int* tb = static_cast<const int*>(bt);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    using T = float;
    mixed_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(k_row), static_cast<const T*>(v_row), bd, tb, o, S,
        Hq, Hkv, D, P, ps, nblk, ring, window, scale);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    mixed_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(k_row), static_cast<const T*>(v_row), bd, tb, o, S,
        Hq, Hkv, D, P, ps, nblk, ring, window, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
