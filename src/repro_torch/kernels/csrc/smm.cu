// SMM: delta-coded sparse matmul for Hopper (sm_90a),
// z (M, N) f32 = y (M, r) f32 @ W_D, with W_D (r, N) held as a fixed number
// nnz of non-zeros per column: first (N,) int32 absolute first row index,
// deltas (nnz-1, N) uint8 or int16 (row index = first + running sum),
// vq (nnz, N) uint8 value codes, value = vq / (2^bits - 1) * scale + offset.
//
// Replaces the TPU kernel src/repro/kernels/smm/smm.py::smm_matmul
// (pallas_call at smm.py:80). The TPU cannot skip zeros, so it densifies an
// (r, bn) tile by compare-select (r x nnz selects a column) and runs a dense
// product. This kernel skips them, as the paper's SMM core does: each column
// decodes its nnz row indices by a running sum of its deltas and computes
//   z[m, n] = sum_k y[m, idx_k] * val_k,
// nnz multiply-adds per output instead of r. No dense W_D is ever formed.
//
// What bounds it on this card: the gathers. Each of the 2 M nnz N
// operations reads one y element at a data-dependent row, so the design
// keeps y where such reads are cheap and reads each stream byte once per
// block:
//   * a block stages kRows = 8 rows of y in shared memory (8 r f32: 100 KB
//     at r = 3200, so dynamic shared memory above 48 KB, its limit raised
//     once per device rather than on every launch) and walks 128
//     columns, one per thread; each decoded (index, value) pair serves the
//     8 rows from registers;
//   * threads along n read deltas and vq coalesced (neighbouring columns
//     are neighbouring bytes);
//   * the grid's fast axis runs over row blocks, so the blocks in flight
//     share one column range and its stream stays in L2;
//   * indices outside [0, r) are skipped, as the reference's scatter drops
//     them; duplicate indices add, so the gather-sum equals scatter-add;
//   * scale, offset and the value width are read from device memory (a
//     layer's slice of the stacked (L,) leaves): no host sync per call.
// f32 on CUDA cores; the first version is the simple one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kRows = 8;       // rows of y per block

template <typename DT>
__global__ void __launch_bounds__(kThreads)
smm_kernel(const float* __restrict__ y, const int* __restrict__ first,
           const DT* __restrict__ deltas, const uint8_t* __restrict__ vq,
           const float* __restrict__ scale_p, const float* __restrict__ offset_p,
           const int* __restrict__ bits_p, float* __restrict__ out, int M,
           int r, int nnz, int N) {
  extern __shared__ float ys[];  // (kRows, r)
  const int m0 = blockIdx.x * kRows;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int rows = min(kRows, M - m0);
  for (int i = threadIdx.x; i < kRows * r; i += kThreads) {
    const int m = i / r;
    ys[i] = m < rows ? y[(size_t)(m0 + m) * r + (i - m * r)] : 0.f;
  }
  __syncthreads();
  if (n >= N) return;

  const float levels = (float)((1u << __ldg(bits_p)) - 1u);  // 2^bits - 1, exact
  const float scale = __ldg(scale_p), offset = __ldg(offset_p);
  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;

  int idx = __ldg(first + n);
#pragma unroll 4
  for (int k = 0; k < nnz; ++k) {
    if (k > 0) idx += (int)deltas[(size_t)(k - 1) * N + n];
    const float v = (float)vq[(size_t)k * N + n] / levels * scale + offset;
    if (idx >= 0 && idx < r) {
#pragma unroll
      for (int m = 0; m < kRows; ++m) acc[m] = fmaf(ys[m * r + idx], v, acc[m]);
    }
  }
  for (int m = 0; m < rows; ++m) out[(size_t)(m0 + m) * N + n] = acc[m];
}

constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared-memory limit to `smem` bytes on the
// current device once, not on every launch: each instantiation remembers
// the largest size granted per device. A size beyond what a block may have
// (r too large for kRows rows of y) comes back as the attribute's error.
template <typename DT>
cudaError_t ensure_smem(size_t smem) {
  static size_t granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(smm_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
  return e;
}

template <typename DT>
int launch(const void* y, const void* first, const void* deltas,
           const void* vq, const void* scale, const void* offset,
           const void* bits, void* out, int M, int r, int nnz, int N,
           cudaStream_t s) {
  const size_t smem = (size_t)kRows * r * sizeof(float);
  const cudaError_t e = ensure_smem<DT>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kRows - 1) / kRows, (N + kThreads - 1) / kThreads);
  smm_kernel<DT><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(y), static_cast<const int*>(first),
      static_cast<const DT*>(deltas), static_cast<const uint8_t*>(vq),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const int*>(bits), static_cast<float*>(out), M, r, nnz, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M, r) f32; first (N,) int32; deltas (nnz-1, N) uint8 (delta_dtype 0)
// or int16 (1); vq (nnz, N) uint8; scale, offset: one f32 each; bits: one
// int32; out (M, N) f32. Needs 8 r * 4 bytes of shared memory; a larger r
// returns the error of raising that limit. Launches on `stream`; returns
// the first CUDA error.
extern "C" int smm(const void* y, const void* first, const void* deltas,
                   const void* vq, const void* scale, const void* offset,
                   const void* bits, void* out, int M, int r, int nnz, int N,
                   int delta_dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (delta_dtype == 0)
    return launch<uint8_t>(y, first, deltas, vq, scale, offset, bits, out, M,
                           r, nnz, N, s);
  if (delta_dtype == 1)
    return launch<int16_t>(y, first, deltas, vq, scale, offset, bits, out, M,
                           r, nnz, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
