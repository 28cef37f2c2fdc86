// SMM: delta-coded sparse matmul for Hopper (sm_90a),
// z (M, N) f32 = y (M, r) f32 @ W_D, with W_D (r, N) held as a fixed number
// nnz of non-zeros per column: first (N,) int32 absolute first row index,
// deltas (nnz-1, N) uint8 or int16 (row index = first + running sum),
// vq (nnz, N) uint8 value codes, value = vq / (2^bits - 1) * scale + offset.
// Indices outside [0, r) are dropped and duplicate indices add, as the
// reference's scatter does.
//
// Replaces the TPU kernel src/repro/kernels/smm/smm.py::smm_matmul
// (pallas_call at smm.py:80). The TPU kernel densifies an (r, bn) tile of
// W_D on chip by compare-select and runs a dense product on it; a dense W_D
// never reaches device memory. Neither body below writes one either: the
// weight traffic is the streams' bytes (about 2 bytes a non-zero). Which
// body runs is decided by the shapes and the deltas' type alone, never by
// the data (`smm_body`):
//
//  * M <= 32 (a decode step): `smm_small_kernel`, bound by the stream bytes:
//    22 MB at ffn_up (r 3200, nnz 400, N 27648), 6.6 us at 3.35 TB/s. Each
//    non-zero meets only M rows of y, so the work is a gather: z[m, n] =
//    sum_k y[m, idx_k] val_k. A block of 512 threads stages 8 rows of y
//    once, transposed (each row index's 8 values in 32 bytes, the two
//    16-byte halves swizzled so that random indices spread over the banks),
//    and walks column tiles of 16 or 32 columns (a persistent grid of at
//    most one block per tile and 132 x blocks-per-SM blocks). The streams
//    arrive by 16-byte cp.async, neighbouring columns on neighbouring
//    bytes, in a ring of 3 chunks (two in flight while one is computed).
//    Each column's nnz is split across 512 / tile-width threads (16 or 32
//    splits): a split sums its chunk's deltas, the splits' sums are
//    scanned in shared memory to give each split its start index, and each
//    split walks its rows, gathering y from shared memory into 8 f32
//    accumulators; values come from a 256-entry table of the codes'
//    values. The splits then merge in shared memory in split order, so the
//    result does not depend on scheduling; there are no atomics and no
//    workspace. What limits it is the gathers: 32 bytes of y read from
//    shared memory per non-zero, at random banks (about 2.5x the
//    conflict-free rate), several times the stream's byte bound. Ragged N
//    (N % 16 != 0) stages the same chunks with element loads. Works for
//    any order of indices, so it serves int16 deltas too. Needs 8 rows of
//    y in shared memory: r up to about 3 600.
//  * M > 32, uint8 deltas (a mixed step): `smm_tc_kernel`, bound by
//    operations: 2 M r N of dense tensor-core work at M = 2048 against
//    2 M nnz N of sparse work, which the CUDA cores could do (0.68 ms at
//    67 TFLOP/s at ffn_up) only by reading 32 bytes of y for every 8
//    products. It runs the TPU kernel's idea on Hopper: densify a transient
//    (64, 128) tile of W_D in shared memory and multiply it on the tensor
//    cores (wgmma). A block is one producer and two consumer warp groups
//    (the producer hands its registers to the consumers, setmaxnreg) and
//    walks a contiguous run of (column tile, row tile) units, column tile
//    major (a persistent grid of one block per SM). Per column tile the
//    producer stages the streams in shared memory once and walks each
//    column once: indices are sorted (core/compression.py::compress_wd),
//    so with uint8 deltas they never decrease, each K step's entries are
//    contiguous, and the walk replaces each delta by the entry's offset in
//    its K step and records where each step's entries start. Each K step
//    then writes every (offset, value) pair of its entries exactly once,
//    with independent loads, into a zeroed tile, as the bf16 parts W_hi =
//    bf16(w) and W_lo = bf16(w - W_hi) of the B operand (K-major, 128-byte
//    swizzle), over a ring of 3 stages; duplicates (delta 0) are summed in
//    f32 before the split; indices below 0 or at or past r fall in no
//    step. The consumers load y (f32) from L2 as wgmma's A operand in
//    registers, split into y_hi + y_lo, and issue y_hi W_hi + y_lo W_hi +
//    y_hi W_lo (m64n128k16) into one f32 accumulator, two steps' products
//    in flight and the y of the step after next loading meanwhile: a
//    single bf16 pass misses the check's limit, three keep the product to
//    about 2^-16 of its terms (tests/test_torch_smm_tiles.py). The least
//    tensor-core time is 3 x 2 M r N / 989 TFLOP/s: 1.1 ms at ffn_up.
//    What holds it above that: y is read again for every column tile (5.5
//    GB at ffn_up), and the densifying producer and the y loads each take
//    about as long as the products. Needs the column tile's streams and
//    step starts in shared memory: nnz up to 413 at r 3200.
//  * otherwise (int16 deltas at M > 32, or shapes past those limits):
//    `smm_kernel`, the first version's f32 CUDA-core body, which does not
//    assume sorted indices (int16 deltas may be negative): a block stages
//    8 rows of y and walks 128 columns, one per thread.
//
// scale, offset and the value width are read from device memory (a layer's
// slice of the stacked (L,) leaves): no host sync per call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSMs = 132;
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; `bytes` < 16 zero-fills the rest (0: all zeros).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float levels_of(const int* bits_p) {
  return (float)((1u << __ldg(bits_p)) - 1u);  // 2^bits - 1, exact
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` bytes on the
// current device once, not on every launch: `granted` remembers the largest
// size granted per device.
template <typename K>
cudaError_t ensure_smem(K kernel, size_t smem, size_t (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
  return e;
}

// ---------------------------------------------------------------------------
// First-version body: any order of indices (int16 deltas at M > 32)
// ---------------------------------------------------------------------------

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

  const float levels = levels_of(bits_p);
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

// ---------------------------------------------------------------------------
// Small-M body: split-nnz gather from y staged in shared memory
// ---------------------------------------------------------------------------

constexpr int kSmThreads = 512;
constexpr int kSmRows = 8;      // rows of y per block
constexpr int kSmMaxRT = 32;    // stream rows a split walks per chunk, at most
constexpr int kSmRed = kSmThreads * kSmRows * 4;  // split partials: 16 KB
constexpr int kSmPsum = 2 * kSmThreads * 4;       // split sums, 2 buffers
constexpr int kSmVtab = 256 * 4;                  // value of each code
constexpr int kSmStages = 3;                      // stream chunks in flight

// The small body's launch plan: tile width cb (16 or 32 columns), rt stream
// rows per split and chunk (a chunk is 512 / cb splits x rt rows), the
// dynamic shared memory, and the grid. smem == 0: r is too large for it.
struct SmallPlan {
  int cb, rt, nch;
  size_t smem;
  dim3 grid;
};

SmallPlan small_plan(int M, int r, int nnz, int N, int dsize) {
  SmallPlan p{};
  const size_t fixed = (size_t)32 * r + kSmRed + kSmPsum + kSmVtab;
  if (fixed >= (size_t)kSmemLimit) return p;
  // kSmStages stages of (rt x 512) bytes of deltas and of codes
  const size_t per_rt = (size_t)kSmStages * kSmThreads * (dsize + 1);
  const int rt_fit = (int)(((size_t)kSmemLimit - fixed) / per_rt);
  if (rt_fit < 1) return p;
  const int gy = (M + kSmRows - 1) / kSmRows;
  int best_cost = 0;
  for (int cb = 32; cb >= 16; cb -= 16) {
    const int S = kSmThreads / cb;
    const int rt = min(min(kSmMaxRT, rt_fit), max(1, (nnz + S - 1) / S));
    const size_t smem = fixed + per_rt * rt;
    const int per_sm = max(1, min(2048 / kSmThreads,
                                  (int)((size_t)kSmemLimit / smem)));
    const int tiles = (N + cb - 1) / cb;
    const int gx = min(tiles, max(1, kSMs * per_sm / gy));
    // time ~ rounds of tiles x the tile's work (its width)
    const int cost = (tiles + gx - 1) / gx * cb;
    if (cb == 32 || cost < best_cost) {
      best_cost = cost;
      p.cb = cb;
      p.rt = rt;
      p.nch = max(1, (nnz + S * rt - 1) / (S * rt));
      p.smem = smem;
      p.grid = dim3(gx, gy);
    }
  }
  return p;
}

// kVec: N % 16 == 0 and 16-byte aligned streams, so stream rows copy in
// 16-byte pieces.
template <typename DT, bool kVec, int cb>
__global__ void __launch_bounds__(kSmThreads, 1)
smm_small_kernel(const float* __restrict__ y, const int* __restrict__ first,
                 const DT* __restrict__ deltas, const uint8_t* __restrict__ vq,
                 const float* __restrict__ scale_p,
                 const float* __restrict__ offset_p,
                 const int* __restrict__ bits_p, float* __restrict__ out,
                 int M, int r, int nnz, int N, int rt, int nch) {
  extern __shared__ __align__(16) uint8_t dyn[];
  float4* ys = reinterpret_cast<float4*>(dyn);  // (r, 2): 8 rows of y
  float* red = reinterpret_cast<float*>(dyn + (size_t)32 * r);
  int* psum = reinterpret_cast<int*>(dyn + (size_t)32 * r + kSmRed);
  float* vtab = reinterpret_cast<float*>(dyn + (size_t)32 * r + kSmRed + kSmPsum);
  uint8_t* stages = dyn + (size_t)32 * r + kSmRed + kSmPsum + kSmVtab;

  const int tid = threadIdx.x;
  constexpr int S = kSmThreads / cb;           // splits
  const int kt = S * rt;                       // rows per chunk
  const int s = tid / cb, c = tid - s * cb;    // this thread's split, column
  const int m0 = blockIdx.y * kSmRows;
  const int rows = min(kSmRows, M - m0);
  const size_t dbytes = (size_t)kt * cb * sizeof(DT);
  const size_t stage_bytes = dbytes + (size_t)kt * cb;
  {
    const float levels = levels_of(bits_p);
    const float scale = __ldg(scale_p), offset = __ldg(offset_p);
    for (int v = tid; v < 256; v += kSmThreads)
      vtab[v] = (float)v / levels * scale + offset;
  }

  // y rows m0.. as ys[i] = (y[m0 .. m0+3][i], y[m0+4 .. m0+7][i]), the two
  // float4 halves swapped when bit 2 of i is set: a random index's half h
  // then lies in any of the 8 16-byte bank groups.
  if (r % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
    // four indices a thread, each row's four values in one 16-byte load
    for (int i = 4 * tid; i < r; i += 4 * kSmThreads) {
      float4 v[kSmRows];
#pragma unroll
      for (int m = 0; m < kSmRows; ++m)
        v[m] = m < rows ? __ldg(reinterpret_cast<const float4*>(
                              y + (size_t)(m0 + m) * r + i))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a[4] = {
          make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
          make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
          make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
          make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
      const float4 b4[4] = {
          make_float4(v[4].x, v[5].x, v[6].x, v[7].x),
          make_float4(v[4].y, v[5].y, v[6].y, v[7].y),
          make_float4(v[4].z, v[5].z, v[6].z, v[7].z),
          make_float4(v[4].w, v[5].w, v[6].w, v[7].w)};
      // index i + e at pass (e - tid) % 4: neighbouring threads' stores
      // fall in different bank groups
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        const int e = (pass + tid) & 3;
        const float4 lo = e == 0 ? a[0] : e == 1 ? a[1] : e == 2 ? a[2] : a[3];
        const float4 hi = e == 0 ? b4[0] : e == 1 ? b4[1] : e == 2 ? b4[2] : b4[3];
        const int b = ((i + e) >> 2) & 1;
        ys[2 * (i + e) + b] = lo;
        ys[2 * (i + e) + (b ^ 1)] = hi;
      }
    }
  } else {
    for (int i = tid; i < r; i += kSmThreads) {
      float v[kSmRows];
#pragma unroll
      for (int m = 0; m < kSmRows; ++m)
        v[m] = m < rows ? __ldg(y + (size_t)(m0 + m) * r + i) : 0.f;
      const int b = (i >> 2) & 1;
      ys[2 * i + b] = make_float4(v[0], v[1], v[2], v[3]);
      ys[2 * i + (b ^ 1)] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }

  // Step j of this block: its tile blockIdx.x + (j / nch) gridDim.x, chunk
  // j % nch (stream rows [chunk kt, chunk kt + kt)). A chunk's stage holds
  // D[k] = deltas[k - 1] (D[0] = 0) and vq[k] for its rows, cb columns each.
  const int tiles = (N + cb - 1) / cb;
  const int nsteps =
      (int)blockIdx.x < tiles
          ? ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nch
          : 0;
  auto load = [&](int j) {
    const int n0 = ((int)blockIdx.x + (j / nch) * (int)gridDim.x) * cb;
    const int k0 = (j % nch) * kt;
    uint8_t* st = stages + (size_t)(j % kSmStages) * stage_bytes;
    DT* ds = reinterpret_cast<DT*>(st);
    uint8_t* vs = st + dbytes;
    if constexpr (kVec) {
      constexpr int kD = 16 / sizeof(DT);  // columns per 16-byte piece
      const int dpieces = cb / kD, vpieces = cb / 16;
      for (int i = tid; i < kt * dpieces; i += kSmThreads) {
        const int row = i / dpieces, pc = i - row * dpieces;
        const int k = k0 + row, gn = n0 + pc * kD;
        const bool ok = k >= 1 && k < nnz && gn < N;
        cp_async16(smem_u32(ds + (size_t)row * cb + pc * kD),
                   ok ? deltas + (size_t)(k - 1) * N + gn : deltas,
                   ok ? 16 : 0);
      }
      for (int i = tid; i < kt * vpieces; i += kSmThreads) {
        const int row = i / vpieces, pc = i - row * vpieces;
        const int k = k0 + row, gn = n0 + pc * 16;
        const bool ok = k < nnz && gn < N;
        cp_async16(smem_u32(vs + (size_t)row * cb + pc * 16),
                   ok ? vq + (size_t)k * N + gn : vq, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kt * cb; i += kSmThreads) {
        const int row = i / cb, cc = i - row * cb;
        const int k = k0 + row, gn = n0 + cc;
        ds[i] = (k >= 1 && k < nnz && gn < N) ? deltas[(size_t)(k - 1) * N + gn]
                                              : (DT)0;
        vs[i] = (k < nnz && gn < N) ? vq[(size_t)k * N + gn] : (uint8_t)0;
      }
    }
  };

  for (int j = 0; j < kSmStages - 1; ++j) {
    if (j < nsteps) load(j);
    cp_async_commit();
  }
  float acc[kSmRows] = {};
  int carry = 0;  // this column's index before the chunk's first row
  for (int j = 0; j < nsteps; ++j) {
    cp_async_wait<kSmStages - 2>();
    __syncthreads();  // step j's chunk landed; step j - 1 fully computed
    if (j + kSmStages - 1 < nsteps) load(j + kSmStages - 1);
    cp_async_commit();

    const int ch = j % nch;
    const int n0 = ((int)blockIdx.x + (j / nch) * (int)gridDim.x) * cb;
    const int n = n0 + c;
    if (ch == 0) {
      carry = n < N ? __ldg(first + n) : 0;
#pragma unroll
      for (int m = 0; m < kSmRows; ++m) acc[m] = 0.f;
    }
    const uint8_t* st = stages + (size_t)(j % kSmStages) * stage_bytes;
    const DT* ds = reinterpret_cast<const DT*>(st);
    const uint8_t* vs = st + dbytes;
    const int k0 = ch * kt;
    const int ib = s * rt, ie = min(ib + rt, nnz - k0);
    // this split's sum of deltas, then every split's start by a scan
    int part = 0;
#pragma unroll 8
    for (int i = ib; i < ie; ++i) part += (int)ds[i * cb + c];
    int* ps = psum + (j & 1) * kSmThreads;
    ps[tid] = part;
    __syncthreads();
    int idx = carry, tot = 0;
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) {
      const int v = ps[s2 * cb + c];
      idx += s2 < s ? v : 0;
      tot += v;
    }
    carry += tot;
#pragma unroll 4
    for (int i = ib; i < ie; ++i) {
      idx += (int)ds[i * cb + c];
      const float v = vtab[vs[i * cb + c]];
      if (idx >= 0 && idx < r) {
        const int b = (idx >> 2) & 1;
        const float4 lo = ys[2 * idx + b], hi = ys[2 * idx + (b ^ 1)];
        acc[0] = fmaf(lo.x, v, acc[0]);
        acc[1] = fmaf(lo.y, v, acc[1]);
        acc[2] = fmaf(lo.z, v, acc[2]);
        acc[3] = fmaf(lo.w, v, acc[3]);
        acc[4] = fmaf(hi.x, v, acc[4]);
        acc[5] = fmaf(hi.y, v, acc[5]);
        acc[6] = fmaf(hi.z, v, acc[6]);
        acc[7] = fmaf(hi.w, v, acc[7]);
      }
    }
    if (ch == nch - 1) {
      // The splits' partials, then their sums in split order. Column c's
      // 8 values sit at (s cb + c) 8, row m at slot m ^ ((c >> 2) & 7):
      // the stores of a warp (consecutive c, one m) meet no bank twice.
      const int sw = (c >> 2) & 7;
#pragma unroll
      for (int m = 0; m < kSmRows; ++m) red[(s * cb + c) * kSmRows + (m ^ sw)] = acc[m];
      __syncthreads();
      if (tid < cb * kSmRows) {
        const int m = tid / cb, c2 = tid - m * cb, sw2 = (c2 >> 2) & 7;
        float sum = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < S; ++s2)
          sum += red[(s2 * cb + c2) * kSmRows + (m ^ sw2)];
        if (m < rows && n0 + c2 < N) out[(size_t)(m0 + m) * N + n0 + c2] = sum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Large-M body: W_D tiles densified in shared memory, wgmma
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128;  // rows of y per unit (two consumer groups x 64)
constexpr int kTcBN = 128;  // columns of W_D per unit (wgmma's n)
constexpr int kTcBK = 64;   // K step (128-byte rows of bf16)
constexpr int kTcStages = 3;
constexpr int kTcThreads = 384;  // producer + two consumer warp groups
constexpr int kTilePart = kTcBN * kTcBK * 2;  // one bf16 part: 16 KB
constexpr int kTcStage = 2 * kTilePart;       // W_hi, W_lo
// Stream rows padded from 128 to 144 bytes: the producer's threads read
// their columns at different rows, which then fall in different banks.
constexpr int kStreamRow = kTcBN + 16;
constexpr int kTcFixed = kTcStages * kTcStage + 1024 + 256 * 4;

// The tensor-core body's dynamic shared memory: the ring, the column tile's
// streams and step starts, the value table (and alignment slack).
size_t tc_smem(int r, int nnz) {
  const int nk = (r + kTcBK - 1) / kTcBK;
  return (size_t)kTcFixed + (size_t)2 * nnz * kStreamRow +
         (size_t)(nk + 1) * kTcBN * 2;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO); the leading
// offset is unused for swizzled K-major tiles. Adding 2 to it advances the
// start by one k16 slice (32 bytes).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the m64n128 accumulator fragment) += A (64 x 16 bf16,
// the m64k16 register fragment a) B (16 x 128), B bf16 K-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offset of element (row n, k) of a B tile of 128-byte rows under the
// 128-byte swizzle (16-byte chunk k / 8 of row n at chunk (k / 8) ^ (n % 8)).
__device__ __forceinline__ int swz(int n, int k) {
  return n * 128 + ((((k >> 3) ^ (n & 7))) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of one K step for one thread: per k16 slice, the four
// registers of the m64k16 fragment of y_hi and of y_lo.
struct YFrag {
  uint32_t hi[kTcBK / 16][4], lo[kTcBK / 16][4];
};
// Keeps the compiler from reusing a fragment's registers before the wgmma
// that reads them has completed.
__device__ __forceinline__ void fence_frag(YFrag& f) {
#pragma unroll
  for (int i = 0; i < kTcBK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" : "+r"(f.hi[i][j]), "+r"(f.lo[i][j])::"memory");
}

// kVec: r even and y 8-byte aligned, so a (k, k + 1) pair loads as float2.
template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1)
smm_tc_kernel(const float* __restrict__ y, const int* __restrict__ first,
              const uint8_t* __restrict__ deltas,
              const uint8_t* __restrict__ vq,
              const float* __restrict__ scale_p,
              const float* __restrict__ offset_p,
              const int* __restrict__ bits_p, float* __restrict__ out, int M,
              int r, int nnz, int N, int stream_vec) {
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t full[kTcStages], empty[kTcStages];

  const int tid = threadIdx.x;
  const uint32_t base = (smem_u32(dyn) + 1023u) & ~1023u;
  uint8_t* const gbase = dyn + (base - smem_u32(dyn));
  const int nk = (r + kTcBK - 1) / kTcBK;
  // The column tile's streams: vq rows, then deltas (row k holds the delta
  // into entry k; row 0 unused), which a first walk turns into each
  // entry's offset in its K step; then where each K step's entries start.
  uint8_t* const svq = gbase + kTcStages * kTcStage;   // (nnz, 144)
  uint8_t* const sof = svq + (size_t)nnz * kStreamRow;  // (nnz, 144)
  uint16_t* const start =
      reinterpret_cast<uint16_t*>(sof + (size_t)nnz * kStreamRow);  // (nk+1, 128)
  float* const vtab = reinterpret_cast<float*>(start + (nk + 1) * kTcBN);

  const int m_tiles = (M + kTcBM - 1) / kTcBM;
  const int units = m_tiles * ((N + kTcBN - 1) / kTcBN);
  const int u0 = (int)((long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long)(blockIdx.x + 1) * units / gridDim.x);

  {
    const float levels = levels_of(bits_p);
    const float scale = __ldg(scale_p), offset = __ldg(offset_p);
    for (int q = tid; q < 256; q += kTcThreads)
      vtab[q] = (float)q / levels * scale + offset;
  }
  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(smem_u32(&full[s]), 128);   // the producer's threads
      mbar_init(smem_u32(&empty[s]), 256);  // the consumers' threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: thread p owns column p of the unit's column tile; it
    // hands registers to the consumers (40 + 2 x 232 per 3 x 128 threads
    // fit the SM's 64 K) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int p = tid;
    int it = 0, staged = -1;
    for (int u = u0; u < u1; ++u) {
      const int nt = u / m_tiles;
      if (nt != staged) {  // this column tile's streams, once
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        const int n0 = nt * kTcBN;
        for (int i = p; i < (2 * nnz - 1) * 8; i += 128) {
          const int row = i >> 3, c = i & 7, gn = n0 + 16 * c;
          const bool is_vq = row < nnz;
          const int k = is_vq ? row : row - nnz;  // deltas row k
          const uint8_t* src = (is_vq ? vq : deltas) + (size_t)k * N + gn;
          uint8_t* dst = is_vq ? svq + (size_t)k * kStreamRow + 16 * c
                               : sof + (size_t)(k + 1) * kStreamRow + 16 * c;
          if (stream_vec) {
            const bool ok = gn < N;
            cp_async16(smem_u32(dst), ok ? src : vq, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < 16; ++e) dst[e] = gn + e < N ? src[e] : 0;
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        // Column p's walk, once per column tile: each entry's offset in
        // its K step replaces its delta, and start[kt] is the first entry
        // of step kt or later. Indices never decrease (uint8 deltas), so
        // a step's entries are contiguous; those below 0 come before
        // start[0], those at or past r at or after start[nk].
        const int n = n0 + p;
        int idx = n < N ? __ldg(first + n) : r, next = 0;
        for (int k = 0; k < nnz; ++k) {
          if (k > 0) idx += sof[k * kStreamRow + p];
          sof[k * kStreamRow + p] = (uint8_t)(idx & (kTcBK - 1));
          const int step = idx < 0 ? -1 : idx >= r ? nk : idx / kTcBK;
          for (; next <= min(step, nk); ++next) start[next * kTcBN + p] = k;
        }
        for (; next <= nk; ++next) start[next * kTcBN + p] = nnz;
        staged = nt;
      }
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kTcStages;
        mbar_wait(smem_u32(&empty[s]), ((it / kTcStages) & 1) ^ 1);
        uint8_t* const hi_t = gbase + s * kTcStage;
        uint8_t* const lo_t = hi_t + kTilePart;
        // Row p, chunk (c + p) % 8 at pass c: neighbouring rows write
        // different 16-byte bank groups (the same chunk of every row would
        // fall in one).
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int off = p * 128 + 16 * ((c + p) & 7);
          *reinterpret_cast<uint4*>(hi_t + off) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(lo_t + off) = make_uint4(0, 0, 0, 0);
        }
        // Step kt's entries; duplicates (equal offsets) are adjacent and
        // summed in f32 before the split into bf16 parts.
        const int e = start[(kt + 1) * kTcBN + p];
        int cur = -1;
        float w = 0.f;
        auto put = [&]() {
          const uint16_t h = __bfloat16_as_ushort(__float2bfloat16_rn(w));
          const float rest = w - __bfloat162float(__ushort_as_bfloat16(h));
          const int off = swz(p, cur);
          *reinterpret_cast<uint16_t*>(hi_t + off) = h;
          *reinterpret_cast<uint16_t*>(lo_t + off) =
              __bfloat16_as_ushort(__float2bfloat16_rn(rest));
        };
#pragma unroll 4
        for (int j = start[kt * kTcBN + p]; j < e; ++j) {
          const int off = sof[j * kStreamRow + p];
          const float v = vtab[svq[j * kStreamRow + p]];
          if (off != cur) {
            if (cur >= 0) put();
            cur = off;
            w = v;
          } else {
            w += v;
          }
        }
        if (cur >= 0) put();
        // The tile is read by wgmma (the async proxy).
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(smem_u32(&full[s]));
      }
    }
    return;
  }

  // ---- consumers: warp group 1 + c owns rows 64 c .. 64 c + 63 of the
  // unit's row tile, warp w of it 16 of them ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = (tid >> 7) - 1, t = tid & 127, lane = tid & 31;
  const int w = t >> 5, g = lane >> 2, q = lane & 3;
  float d[64];
  int it = 0;
  for (int u = u0; u < u1; ++u) {
    const int mt = u % m_tiles, nt = u / m_tiles;
    const int row0 = mt * kTcBM + 64 * c + 16 * w + g;  // and row0 + 8
    // y (row, k), (row, k + 1) of rows row0 + 8 (j & 1), k = 16 si + 2 q +
    // 8 (j >> 1): register j of slice si of the m64k16 fragment. All 16
    // loads of a step are issued together, then split into bf16 parts.
    // Loaded as f32 bit patterns into the fragment's registers (x into
    // hi, x + 1 into lo), then split in place.
    auto fetch = [&](int kt, YFrag& f) {
#pragma unroll
      for (int si = 0; si < kTcBK / 16; ++si)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = row0 + 8 * (j & 1);
          const int k = kt * kTcBK + 16 * si + 2 * q + 8 * (j >> 1);
          const float* src = y + (size_t)row * r + k;
          float2 v = make_float2(0.f, 0.f);
          if (row < M) {
            if (kVec && k + 1 < r) {
              v = __ldg(reinterpret_cast<const float2*>(src));
            } else {
              if (k < r) v.x = __ldg(src);
              if (k + 1 < r) v.y = __ldg(src + 1);
            }
          }
          f.hi[si][j] = __float_as_uint(v.x);
          f.lo[si][j] = __float_as_uint(v.y);
        }
    };
    auto split = [&](YFrag& f) {
#pragma unroll
      for (int si = 0; si < kTcBK / 16; ++si)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = __uint_as_float(f.hi[si][j]);
          const float x1 = __uint_as_float(f.lo[si][j]);
          const uint32_t h = pack_bf16(x0, x1);
          const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&h);
          f.hi[si][j] = h;
          f.lo[si][j] = pack_bf16(x0 - __low2float(hb), x1 - __high2float(hb));
        }
    };
    // Step kt's products are issued, then step kt - 1's are waited for
    // (two groups in flight): its stage goes back to the producer and its
    // fragment registers take step kt + 2's y, whose loads stay in flight
    // for a whole step; step kt + 1's, loaded a step earlier, are split
    // into bf16 parts meanwhile. Three fragment buffers rotate.
    auto step = [&](int kt, YFrag& cur, YFrag& nxt, YFrag& free) {
      const int s = it % kTcStages;
      const uint32_t tb = base + s * kTcStage;
      const uint64_t dh = wgmma_desc(tb), dl = wgmma_desc(tb + kTilePart);
      mbar_wait(smem_u32(&full[s]), (it / kTcStages) & 1);
      fence_frag(cur);
      wgmma_fence();
#pragma unroll
      for (int si = 0; si < kTcBK / 16; ++si) {
        wgmma_rs(d, cur.hi[si], dh + 2 * si);
        wgmma_rs(d, cur.lo[si], dh + 2 * si);
        wgmma_rs(d, cur.hi[si], dl + 2 * si);
      }
      wgmma_commit();
      wgmma_wait1();
      fence_frag(free);
      if (kt > 0) mbar_arrive(smem_u32(&empty[(it + kTcStages - 1) % kTcStages]));
      if (kt + 2 < nk) fetch(kt + 2, free);
      if (kt + 1 < nk) split(nxt);
      ++it;
    };
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    YFrag fa, fb, fc;
    fetch(0, fa);
    if (nk > 1) fetch(1, fb);
    split(fa);
    fence_acc(d);
    for (int kt = 0; kt < nk; kt += 3) {
      step(kt, fa, fb, fc);
      if (kt + 1 < nk) step(kt + 1, fb, fc, fa);
      if (kt + 2 < nk) step(kt + 2, fc, fa, fb);
    }
    wgmma_wait0();
    fence_acc(d);
    fence_frag(fa);
    fence_frag(fb);
    fence_frag(fc);
    mbar_arrive(smem_u32(&empty[(it + kTcStages - 1) % kTcStages]));
    // d[i]: row 16 w + g + 8 ((i >> 1) & 1) of the group's 64, column
    // 8 (i >> 2) + 2 q + (i & 1) of the tile
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int gm = row0 + 8 * ((i >> 1) & 1);
      const int gn = nt * kTcBN + 8 * (i >> 2) + 2 * q + (i & 1);
      if (gm < M && gn < N) out[(size_t)gm * N + gn] = d[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Body choice and launch
// ---------------------------------------------------------------------------

enum Body { kSmall = 0, kTc = 1, kFma = 2 };

int body_for(int M, int r, int nnz, int N, int delta_dtype) {
  const int dsize = delta_dtype == 0 ? 1 : 2;
  if (M <= 32 && small_plan(M, r, nnz, N, dsize).smem) return kSmall;
  if (delta_dtype == 0 && nnz <= 65535 && tc_smem(r, nnz) <= kSmemLimit - 64)
    return kTc;
  return kFma;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename DT>
int launch_small(const void* y, const void* first, const void* deltas,
                 const void* vq, const void* scale, const void* offset,
                 const void* bits, void* out, int M, int r, int nnz, int N,
                 cudaStream_t s) {
  static size_t granted[2][kMaxDevices] = {};
  static size_t granted16[2][kMaxDevices] = {};
  const SmallPlan p = small_plan(M, r, nnz, N, sizeof(DT));
  const bool vec = N % 16 == 0 && aligned16(deltas) && aligned16(vq);
  auto kernel = p.cb == 32
      ? (vec ? smm_small_kernel<DT, true, 32> : smm_small_kernel<DT, false, 32>)
      : (vec ? smm_small_kernel<DT, true, 16> : smm_small_kernel<DT, false, 16>);
  const cudaError_t e =
      ensure_smem(kernel, p.smem, p.cb == 32 ? granted[vec] : granted16[vec]);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<p.grid, kSmThreads, p.smem, s>>>(
      static_cast<const float*>(y), static_cast<const int*>(first),
      static_cast<const DT*>(deltas), static_cast<const uint8_t*>(vq),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const int*>(bits), static_cast<float*>(out), M, r, nnz, N,
      p.rt, p.nch);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* y, const void* first, const void* deltas,
              const void* vq, const void* scale, const void* offset,
              const void* bits, void* out, int M, int r, int nnz, int N,
              cudaStream_t s) {
  static size_t granted[2][kMaxDevices] = {};
  const size_t smem = tc_smem(r, nnz);
  const bool vec = r % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 7) == 0;
  auto kernel = vec ? smm_tc_kernel<true> : smm_tc_kernel<false>;
  const cudaError_t e = ensure_smem(kernel, smem, granted[vec]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int units = ((M + kTcBM - 1) / kTcBM) * ((N + kTcBN - 1) / kTcBN);
  const int stream_vec = N % 16 == 0 && aligned16(deltas) && aligned16(vq);
  kernel<<<min(units, kSMs), kTcThreads, smem, s>>>(
      static_cast<const float*>(y), static_cast<const int*>(first),
      static_cast<const uint8_t*>(deltas), static_cast<const uint8_t*>(vq),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const int*>(bits), static_cast<float*>(out), M, r, nnz, N,
      stream_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename DT>
int launch_fma(const void* y, const void* first, const void* deltas,
               const void* vq, const void* scale, const void* offset,
               const void* bits, void* out, int M, int r, int nnz, int N,
               cudaStream_t s) {
  static size_t granted[kMaxDevices] = {};
  const size_t smem = (size_t)kRows * r * sizeof(float);
  const cudaError_t e = ensure_smem(smm_kernel<DT>, smem, granted);
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

// Which body smm() runs for these shapes and delta type (delta_dtype as in
// smm()): 0 the small-M gather body, 1 the tensor-core body, 2 the
// first-version CUDA-core body.
extern "C" int smm_body(int M, int r, int nnz, int N, int delta_dtype) {
  return body_for(M, r, nnz, N, delta_dtype);
}

// y (M, r) f32; first (N,) int32; deltas (nnz-1, N) uint8 (delta_dtype 0)
// or int16 (1); vq (nnz, N) uint8; scale, offset: one f32 each; bits: one
// int32; out (M, N) f32. The small-M and first-version bodies stage 8 rows
// of y in shared memory, which bounds r (about 3 600 and 7 000); the
// tensor-core body stages a column tile's streams, which bounds nnz (413
// at r 3200); a shape past its body's bound returns the error of raising
// the shared-memory limit. Launches on `stream`; returns the first CUDA
// error.
extern "C" int smm(const void* y, const void* first, const void* deltas,
                   const void* vq, const void* scale, const void* offset,
                   const void* bits, void* out, int M, int r, int nnz, int N,
                   int delta_dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (nnz < 1 || (delta_dtype != 0 && delta_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body_for(M, r, nnz, N, delta_dtype)) {
    case kSmall:
      return delta_dtype == 0
          ? launch_small<uint8_t>(y, first, deltas, vq, scale, offset, bits,
                                  out, M, r, nnz, N, s)
          : launch_small<int16_t>(y, first, deltas, vq, scale, offset, bits,
                                  out, M, r, nnz, N, s);
    case kTc:
      return launch_tc(y, first, deltas, vq, scale, offset, bits, out, M, r,
                       nnz, N, s);
    default:
      return delta_dtype == 0
          ? launch_fma<uint8_t>(y, first, deltas, vq, scale, offset, bits,
                                out, M, r, nnz, N, s)
          : launch_fma<int16_t>(y, first, deltas, vq, scale, offset, bits,
                                out, M, r, nnz, N, s);
  }
}
