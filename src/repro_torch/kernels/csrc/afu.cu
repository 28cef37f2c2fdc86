// AFU kernels for Hopper (sm_90a): the LUT-exp row softmax and the fused
// residual + LayerNorm.
//
// Replace the TPU kernels src/repro/kernels/afu/afu.py::softmax_lut
// (afu.py:35, pallas_call at :41) and ::layernorm_residual (afu.py:61,
// pallas_call at :68). The TPU kernels hold a block of rows, with the whole
// feature axis, in VMEM and do every pass there: one read from HBM, one
// write.
//
// What bounds them on this card: bytes. Softmax reads each input once and
// writes one f32 (a few operations per element); LayerNorm reads x and res
// and writes one f32.
//
// softmax_lut: three passes over the row, all in f32: the row max; the sum
// of lut(x - max); then lut(x - max) times the reciprocal of the sum (one
// reciprocal a row: within an ulp of the plain version's division, without
// a division's branch an element). Not one pass with a running max: under
// the LUT exp, rescaling a running sum by lut(m_old - m_new) is a different
// function from the reference's. Every regime reads each input element
// from device memory once (but rows past a cluster's shared memory) and
// writes each output once, in one launch; the host picks the regime by C
// (softmax_lut_regime; kernels/afu/afu.py::softmax_regime mirrors it):
//   * warp (C <= 1024): one warp a row, four rows a block. The row lives in
//     registers (up to 32 f32 a lane), the max and the sum are warp
//     shuffles: no block barrier but the one that publishes the table;
//   * block (C <= 24 K): one block a row stages it in shared memory (up to
//     96 KB, opted in above 48 KB); pass 2 overwrites it with the exps, so
//     pass 3 only scales. Wider rows go to clusters even where one CTA could
//     stage them (227 KB): the LM heads' rows (32 K to 256 K entries) come
//     a few at a time, and a row a block would leave most SMs idle;
//   * cluster: a thread block cluster of 16 CTAs a row, so a decode step's
//     8 rows fill 128 of the 132 SMs. Each CTA stages its slice (up to
//     24 K f32, 96 KB, so two CTAs fit an SM); the CTAs exchange their
//     partial max, then their partial sum, through distributed shared
//     memory (st.async into each peer's shared memory, counted on the
//     peer's mbarrier), and each writes its slice. A row past 16 x 24 K
//     entries re-reads its slice from device memory (through the 50 MB L2)
//     in each pass, still split over the cluster.
// Loads and stores are 16 bytes a thread where C and the pointers allow
// (C a multiple of 4 f32 or 8 bf16), else one element; a thread issues a
// batch of them (32 entries, 4 one-element loads) before it uses the
// first, so a CTA's slice arrives in one round trip. The 64-entry table
// sits in shared memory as 63 pairs {t[i], t[i+1] - t[i]} (lut_exp.cuh),
// one 8-byte load an element, the same bits as lut_exp on the table.
//
// layernorm_residual: one thread block owns one row. h = x + res in f32 is
// staged once; the mean, then the variance of h - mean (two passes over the
// staged h, not E[h^2] - mean^2), then (h - mean) * rsqrt(var + eps) *
// scale + bias. Rows past 12 K entries recompute h from device memory in
// each pass. Rows are independent: grid = R blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

#include "lut_exp.cuh"

namespace {

constexpr int kThreads = 256;       // a LayerNorm row staged in shared memory
constexpr int kThreadsLong = 1024;  // a LayerNorm row re-read from memory
constexpr int kMaxStaged = 12 * 1024;  // f32 entries: 48 KB of shared memory

// softmax_lut's regimes (the host's choice by C).
constexpr int kWarpMaxC = 1024;        // warp regime: C <= this
constexpr int kRowWarps = 4;           // rows (warps) a block there
constexpr int kBlockMaxC = 24 * 1024;  // block regime: C <= this (96 KB)
constexpr int kCluster = 16;           // CTAs a row in the cluster regime
constexpr int kSliceMax = 24 * 1024;   // f32 a CTA stages there (96 KB)
constexpr int kSliceThreads = 512;     // at most, a CTA of a cluster
// f32 a thread loads before it uses the first (one-element loads: 4)
constexpr int kBatch = 32;
enum Regime { kWarp = 0, kBlock = 1, kClusterStaged = 2, kClusterReread = 3 };

int softmax_regime(int C) {
  if (C <= kWarpMaxC) return kWarp;
  if (C <= kBlockMaxC) return kBlock;
  return (C + kCluster - 1) / kCluster <= kSliceMax ? kClusterStaged
                                                    : kClusterReread;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Elements of T in one 16-byte load.
template <typename T>
constexpr int kVecOf = 16 / static_cast<int>(sizeof(T));

// V elements of p into v: one 16-byte load when kVec, else one element.
template <bool kVec>
__device__ __forceinline__ void load_n(const float* p, float* v) {
  if constexpr (kVec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    v[0] = *p;
  }
}
template <bool kVec>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* v) {
  if constexpr (kVec) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x, v[2 * k + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// V f32 from p to v, and from v to p (V > 1: a multiple of 4, 16-byte
// accesses).
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) load_n<true>(p + k, v + k);
  }
}
template <int V>
__device__ __forceinline__ void store_n(float* p, const float* v) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

template <bool kMax>
__device__ __forceinline__ float warp_reduce(float x) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
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

// Warp regime: one warp a row; lane l holds the kN / V chunks of V
// consecutive elements that start at (j * 32 + l) * V.
template <typename T, int kN, bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
    softmax_warp_kernel(const T* __restrict__ x,
                        const float* __restrict__ table,
                        float* __restrict__ out, int R, int C) {
  constexpr int V = kVec ? kVecOf<T> : 1;
  __shared__ float2 pair_s[lut::kSize - 1];
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const size_t base = static_cast<size_t>(row) * C;
  float v[kN];
#pragma unroll
  for (int j = 0; j < kN / V; ++j) {  // every load in flight at once
    const int c = (j * 32 + lane) * V;
    if (row < R && c < C) {
      load_n<kVec>(x + base + c, v + j * V);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[j * V + k] = -CUDART_INF_F;
    }
  }
  lut::lut_pairs(table, pair_s, threadIdx.x, blockDim.x);
  __syncthreads();
  if (row >= R) return;
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kN; ++j) m = fmaxf(m, v[j]);
  m = warp_reduce<true>(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kN / V; ++j) {
    if ((j * 32 + lane) * V < C) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[j * V + k] = lut::lut_exp(__fsub_rn(v[j * V + k], m), pair_s);
        s += v[j * V + k];
      }
    }
  }
  const float r = __frcp_rn(warp_reduce<false>(s));
#pragma unroll
  for (int j = 0; j < kN / V; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < C) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[j * V + k] = __fmul_rn(v[j * V + k], r);
      store_n<V>(out + base + c, v + j * V);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cluster's exchange of partials (max, then sum): CTA r stores its
// partial k into slot r of in_s[k] in every CTA of its row's cluster with
// st.async, which counts the bytes on that CTA's bar_s[k]; each CTA waits
// on its own barrier for all kCluster partials. No cluster-wide barrier
// (and none of the GPU-scope fence it implies) sits between the passes.
// Set up before any peer may send: each barrier expects kCluster floats,
// and the cluster barrier armed here is waited on before the first send.
__device__ __forceinline__ void exchange_init(uint64_t* bar_s) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar_s + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < 2; ++k)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar_s + k)),
          "r"(kCluster * 4)
          : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The row's max (or sum) from each CTA's partial x: sent to every CTA of
// the cluster (threads 0..kCluster-1 one each), then lane r of every warp
// reads CTA r's partial from this CTA's in_s. Every CTA reduces the same
// values in the same lanes: the same bits everywhere.
template <bool kMax>
__device__ __forceinline__ float cluster_reduce(float x, float* in_s,
                                                uint64_t* bar, int rank) {
  const int tid = threadIdx.x;
  if (tid < kCluster) {
    uint32_t slot, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(slot)
                 : "r"(smem_addr(in_s + rank)), "r"(tid));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(rbar)
                 : "r"(smem_addr(bar)), "r"(tid));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];\n" ::"r"(slot),
        "r"(__float_as_uint(x)), "r"(rbar)
        : "memory");
  }
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
  const int lane = tid % 32;
  return warp_reduce<kMax>(lane < kCluster ? in_s[lane]
                                           : (kMax ? -CUDART_INF_F : 0.f));
}

// This thread's kB vectors of V elements from column c on, a step apart,
// those before c1: every load is issued before the first is used.
template <bool kVec, int kB, int V, typename T>
__device__ __forceinline__ void load_batch(const T* p, int c, int step,
                                           int c1, float* v) {
#pragma unroll
  for (int b = 0; b < kB; ++b)
    if (c + b * step < c1) load_n<kVec>(p + c + b * step, v + b * V);
}

// Block and cluster regimes: the CTA of rank r in its row's group of cs
// (cs = 1: the block regime) takes columns [r * L, min((r + 1) * L, C)),
// L a multiple of V; a thread takes every nt-th vector, kBatch f32 at a
// time. kStaged: the slice lives in dynamic shared memory. The output is
// each exp times the row's one reciprocal of the sum: within an ulp of the
// division the plain version does, without a division's branch for each
// element.
template <typename T, bool kVec, bool kStaged, bool kClusterRow>
__global__ void __launch_bounds__(1024)
    softmax_slice_kernel(const T* __restrict__ x,
                         const float* __restrict__ table,
                         float* __restrict__ out, int C, int L) {
  constexpr int V = kVec ? kVecOf<T> : 1;
  constexpr int kB = kVec ? kBatch / V : 4;  // vectors a batch
  constexpr int cs = kClusterRow ? kCluster : 1;
  extern __shared__ float4 dyn_s[];
  float* slice_s = reinterpret_cast<float*>(dyn_s);  // L entries if kStaged
  __shared__ float2 pair_s[lut::kSize - 1];
  __shared__ float red[32];
  __shared__ float in_s[2][kCluster];  // the cluster's partials, by rank
  __shared__ uint64_t bar_s[2];
  const int rank = blockIdx.x % cs, tid = threadIdx.x, step = blockDim.x * V;
  const size_t base = static_cast<size_t>(blockIdx.x / cs) * C;
  const int c0 = rank * L, c1 = min(c0 + L, C);
  const T* xr = x + base;
  if constexpr (kClusterRow) exchange_init(bar_s);
  lut::lut_pairs(table, pair_s, tid, blockDim.x);
  float m = -CUDART_INF_F;
  for (int c = c0 + tid * V; c < c1; c += kB * step) {
    float v[kBatch];
    load_batch<kVec, kB, V>(xr, c, step, c1, v);
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int cb = c + b * step;
      if (cb < c1) {
        if constexpr (kStaged) store_n<V>(slice_s + (cb - c0), v + b * V);
#pragma unroll
        for (int k = 0; k < V; ++k) m = fmaxf(m, v[b * V + k]);
      }
    }
  }
  m = block_reduce<true>(m, red);  // its barriers also publish pair_s
  if constexpr (kClusterRow) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    m = cluster_reduce<true>(m, in_s[0], &bar_s[0], rank);
  }
  float s = 0.f;
  for (int c = c0 + tid * V; c < c1; c += kB * step) {
    float v[kBatch];
    if constexpr (!kStaged) load_batch<kVec, kB, V>(xr, c, step, c1, v);
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int cb = c + b * step;
      if (cb < c1) {
        float* e = v + b * V;
        if constexpr (kStaged) load_f32<V>(slice_s + (cb - c0), e);  // own
#pragma unroll
        for (int k = 0; k < V; ++k) {
          e[k] = lut::lut_exp(__fsub_rn(e[k], m), pair_s);
          s += e[k];
        }
        if constexpr (kStaged) store_n<V>(slice_s + (cb - c0), e);
      }
    }
  }
  s = block_reduce<false>(s, red);
  if constexpr (kClusterRow) {
    s = cluster_reduce<false>(s, in_s[1], &bar_s[1], rank);
    // Every partial has arrived; no CTA leaves before its sends land.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const float r = __frcp_rn(s);
  for (int c = c0 + tid * V; c < c1; c += kB * step) {
    float v[kBatch];
    if constexpr (!kStaged) load_batch<kVec, kB, V>(xr, c, step, c1, v);
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int cb = c + b * step;
      if (cb < c1) {
        float* e = v + b * V;
        if constexpr (kStaged) load_f32<V>(slice_s + (cb - c0), e);
#pragma unroll
        for (int k = 0; k < V; ++k)
          e[k] = __fmul_rn(
              kStaged ? e[k] : lut::lut_exp(__fsub_rn(e[k], m), pair_s), r);
        store_n<V>(out + base + cb, e);
      }
    }
  }
  if constexpr (kClusterRow)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

int launch_error(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <typename T, bool kVec>
int launch_warp_rows(const T* x, const float* t, float* o, int R, int C,
                     cudaStream_t s) {
  const int grid = (R + kRowWarps - 1) / kRowWarps;
  constexpr int kT = kRowWarps * 32;
  if (C <= 256) {
    softmax_warp_kernel<T, 8, kVec><<<grid, kT, 0, s>>>(x, t, o, R, C);
  } else if (C <= 512) {
    softmax_warp_kernel<T, 16, kVec><<<grid, kT, 0, s>>>(x, t, o, R, C);
  } else {
    softmax_warp_kernel<T, 32, kVec><<<grid, kT, 0, s>>>(x, t, o, R, C);
  }
  return launch_error(cudaSuccess);
}

// A kernel's attributes, set once per device (done: a bit a device): its
// dynamic shared memory past 48 KB, and for a cluster of 16 the
// non-portable size (8 is the portable most). A refusal is returned, never
// worked around.
template <typename K>
cudaError_t set_attributes(K kernel, int smem, bool cluster,
                           std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 32 && (done.load() >> dev & 1u))) return e;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < 32) done.fetch_or(1u << dev);
  return e;
}

template <typename T, bool kVec, bool kStaged, bool kClusterRow>
int launch_slices(const T* x, const float* t, float* o, int R, int C,
                  cudaStream_t s) {
  constexpr int V = kVec ? kVecOf<T> : 1;
  constexpr int cs = kClusterRow ? kCluster : 1;
  auto kernel = softmax_slice_kernel<T, kVec, kStaged, kClusterRow>;
  const int L = ((C + cs - 1) / cs + V - 1) / V * V;
  // about 16 entries a thread (4 with one-element loads), 128 to 1024 (512
  // in a cluster) threads
  int nt = 128;
  while (nt < (kClusterRow ? kSliceThreads : 1024) &&
         nt * (V == 1 ? 4 : 16) < L)
    nt *= 2;
  const int max_smem =
      kStaged ? (kClusterRow ? kSliceMax : kBlockMaxC) * 4 : 0;
  static std::atomic<unsigned> done{0};
  const cudaError_t e = set_attributes(kernel, max_smem, kClusterRow, done);
  if (e != cudaSuccess) return launch_error(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R) * cs, 1, 1);
  cfg.blockDim = dim3(nt, 1, 1);
  cfg.dynamicSmemBytes = kStaged ? static_cast<size_t>(L) * 4 : 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kClusterRow ? 1 : 0;
  return launch_error(cudaLaunchKernelEx(&cfg, kernel, x, t, o, C, L));
}

template <typename T, bool kVec>
int launch_softmax_as(const T* x, const float* t, float* o, int R, int C,
                      cudaStream_t s) {
  switch (softmax_regime(C)) {
    case kWarp:
      return launch_warp_rows<T, kVec>(x, t, o, R, C, s);
    case kBlock:
      return launch_slices<T, kVec, true, false>(x, t, o, R, C, s);
    case kClusterStaged:
      return launch_slices<T, kVec, true, true>(x, t, o, R, C, s);
    default:
      return launch_slices<T, kVec, false, true>(x, t, o, R, C, s);
  }
}

// 16-byte accesses need C a multiple of the vector (so every row starts
// aligned) and 16-byte aligned x and out.
template <typename T>
int launch_softmax(const void* x, const float* table, float* out, int R,
                   int C, cudaStream_t s) {
  if (R == 0 || C == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  const bool vec = C % kVecOf<T> == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  return vec ? launch_softmax_as<T, true>(xt, table, out, R, C, s)
             : launch_softmax_as<T, false>(xt, table, out, R, C, s);
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
// out (R, C) f32. Returns the launch's cudaError (a refused shared-memory
// opt-in or cluster launch included), 0 on success.
extern "C" int softmax_lut(const void* x, const void* table, void* out, int R,
                           int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_softmax<float>(x, t, o, R, C, s);
  if (dtype == 1) return launch_softmax<__nv_bfloat16>(x, t, o, R, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The regime softmax_lut takes for rows of C entries: 0 warp, 1 block,
// 2 cluster (staged), 3 cluster (re-read).
extern "C" int softmax_lut_regime(int C) { return softmax_regime(C); }

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
