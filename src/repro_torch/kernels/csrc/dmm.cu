// DMM: LUT-dequant matmul for Hopper (sm_90a), y (M, N) f32 = x (M, K) @ W,
// W[k, n] = lut[code(k, n)], the 4-bit codes nibble-packed two per byte
// along K (codes (ceil(K/2), N) uint8, row 2i in the high nibble).
//
// Replaces the TPU kernel src/repro/kernels/dmm/dmm.py::dmm_matmul
// (pallas_call at dmm.py:66). As there, the point of the kernel is that a
// dense W_S never exists in device memory: each block reads its tile of
// packed codes from global memory, looks every nibble up in a 16-entry LUT
// held in shared memory and stages the dequantized f32 tile in shared
// memory next to a tile of x. Weight traffic is the compressed bytes.
//
// What bounds it on this card: at M = 8 rows (a decode step) the bytes of
// the codes (K * N / 2) — 2 flops per code byte per row, far below the
// ~295 flops/byte where an H100 turns compute-bound; at M = 2048 (a mixed
// step) the 2 M K N operations. The design does this about each:
//   * two tilings, chosen by M: 8 x 128 output tiles (one row of 4 outputs
//     per thread) for small M, 128 x 64 tiles (8 x 4 outputs per thread)
//     for large M, both 256 threads with an f32 accumulator in registers;
//   * when the output tiles alone cannot fill the 132 SMs (small M, or a
//     narrow N), K is split across blocks (grid z); each split writes its
//     partial tile to a workspace and a second kernel sums the splits in a
//     fixed order, so the result does not depend on scheduling;
//   * an odd K: x is read only for k < K, so the pad row of the codes meets
//     zero activations, as the reference's zero column of x does.
// Products run on CUDA cores in f32 (no tensor cores, no TMA): the first
// version is the simple one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSMs = 132;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Tile: BM x BN outputs per block, BK of K per step; each thread owns a
// TM x TN block of outputs (rows ty*TM.., columns tx*TN..).
template <int BM, int BN, int BK, int TM, int TN>
struct Tiling {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output block per thread");
  static_assert(BK % 2 == 0, "BK covers whole code bytes");
  static constexpr int kBM = BM, kBN = BN, kBK = BK, kTM = TM, kTN = TN;
};
using Small = Tiling<8, 128, 32, 1, 4>;
using Large = Tiling<128, 64, 16, 8, 4>;

inline bool use_small(int M) { return M <= 32; }

template <class T, typename XT>
__global__ void __launch_bounds__(kThreads)
dmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ lut, float* __restrict__ out, int M,
           int K, int N, int k_chunk) {
  constexpr int BM = T::kBM, BN = T::kBN, BK = T::kBK, TM = T::kTM,
                TN = T::kTN;
  __shared__ float xs[BK][BM + 1];  // x tile, transposed (k, m)
  __shared__ float ws[BK][BN];      // dequantized code tile (k, n)
  __shared__ float lut_s[16];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int Kp = (K + 1) / 2;
  if (tid < 16) lut_s[tid] = lut[tid];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK, kk = i % BK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < ke) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < (BK / 2) * BN; i += kThreads) {
      const int kr = i / BN, c = i % BN;
      const int gr = k0 / 2 + kr, gn = n0 + c;
      const uint8_t b = (gr < Kp && gn < N) ? codes[(size_t)gr * N + gn] : 0;
      ws[2 * kr][c] = lut_s[b >> 4];
      ws[2 * kr + 1][c] = lut_s[b & 15];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) o[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[i] = sum over s of part[s][i], in order of s.
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
    out[i] = s;
  }
}

template <class T>
int splits_for(int M, int K, int N) {
  const long tiles = (long)((M + T::kBM - 1) / T::kBM) *
                     ((N + T::kBN - 1) / T::kBN);
  if (tiles >= 2 * kSMs) return 1;
  // At least 8 BK steps per split, so a split amortizes its output tile.
  const int most = K / (8 * T::kBK);
  int want = (int)((2 * kSMs + tiles - 1) / tiles);
  if (want > most) want = most;
  return want < 1 ? 1 : want;
}

template <class T, typename XT>
int launch(const void* x, const void* codes, const void* lut, void* out,
           void* part, int M, int K, int N, int splits, cudaStream_t s) {
  const int chunk = ((K + splits - 1) / splits + T::kBK - 1) / T::kBK * T::kBK;
  const dim3 grid((N + T::kBN - 1) / T::kBN, (M + T::kBM - 1) / T::kBM, splits);
  float* dst = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(out);
  dmm_kernel<T, XT><<<grid, kThreads, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(lut), dst, M, K, N, chunk > 0 ? chunk : T::kBK);
  if (splits > 1) {
    const size_t n = (size_t)M * N;
    const int blocks = (int)((n + kThreads - 1) / kThreads < 4096
                                 ? (n + kThreads - 1) / kThreads : 4096);
    sum_splits_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(out), n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of K splits dmm() uses for this shape; the wrapper allocates a
// (splits, M, N) f32 workspace when it is above 1.
extern "C" int dmm_splits(int M, int K, int N) {
  return use_small(M) ? splits_for<Small>(M, K, N) : splits_for<Large>(M, K, N);
}

// x (M, K) f32 (dtype 0) or bf16 (dtype 1); codes (ceil(K/2), N) uint8;
// lut (16,) f32; out (M, N) f32; part the workspace (unused when splits is
// 1). Launches on `stream`; returns cudaGetLastError().
extern "C" int dmm(const void* x, const void* codes, const void* lut,
                   void* out, void* part, int M, int K, int N, int splits,
                   int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = use_small(M);
  if (dtype == 0)
    return small ? launch<Small, float>(x, codes, lut, out, part, M, K, N, splits, s)
                 : launch<Large, float>(x, codes, lut, out, part, M, K, N, splits, s);
  if (dtype == 1)
    return small
        ? launch<Small, __nv_bfloat16>(x, codes, lut, out, part, M, K, N, splits, s)
        : launch<Large, __nv_bfloat16>(x, codes, lut, out, part, M, K, N, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
