// DMM: LUT-dequant matmul for Hopper (sm_90a), y (M, N) f32 = x (M, K) @ W,
// W[k, n] = lut[code(k, n)], the 4-bit codes nibble-packed two per byte
// along K (codes (ceil(K/2), N) uint8, row 2i in the high nibble).
//
// Replaces the TPU kernel src/repro/kernels/dmm/dmm.py::dmm_matmul
// (pallas_call at dmm.py:66). As there, the point of the kernel is that a
// dense W never exists in device memory: each block reads its tile of
// packed codes and looks every nibble up in a 16-entry LUT held on chip.
// Weight traffic is the compressed bytes.
//
// What bounds it on this card: at M = 8 rows (a decode step) the bytes of
// the codes (K * N / 2), 2 flops per code byte per row, far below the
// ~295 flops/byte where an H100 turns compute-bound; at M = 2048 (a mixed
// step) the 2 M K N operations, which only the tensor cores reach.
//
// Which body runs, by (x's type, M):
//   * bf16 x, M > 32 (the compressed mixed step): `dmm_tc_kernel`, bf16
//     tensor cores through wgmma. A block owns 128 x 128 outputs and walks
//     K in steps of 64 through a ring of kStages = 8 shared-memory stages.
//     Warp group 0 is the producer: it copies the x tile with 16-byte
//     cp.async straight into the 128-byte-swizzled K-major layout wgmma
//     reads, and the (32 x 128)-byte code tile with 16-byte cp.async, and
//     arrives on a stage's mbarrier once its copies have landed (kLookahead
//     = 6 later stages in flight). The product is computed transposed,
//     y^T = W^T x^T: W is wgmma's A operand, built in registers, and the x
//     tile its B operand, read from shared memory. Warp groups 1 and 2 each
//     own 64 output columns: per K step each thread reads its 16 code bytes
//     and looks every nibble up in a 16-entry table of (W_hi, W_lo) pairs
//     held once per lane (conflict-free), which gives its m64k16 fragments
//     of W_hi = bf16(lut) and W_lo = bf16(lut - W_hi) directly; it issues
//     W_hi x^T and W_lo x^T (4 k16 slices each, m64n128k16) into one f32
//     accumulator in registers and, while those run, builds the next
//     step's fragments. Built as B tiles in shared memory instead, the
//     weights cost 32 KB of stores per step that the wgmma then reads
//     back, and shared memory was the bottleneck: that first design took
//     3.0-3.5 ms on ffn_down (M 2048, K 27648, N 3200), this one about 2.
//     A single bf16 pass misses the f32 plain version by more than the
//     check's limit at K in the thousands, while bf16 x bf16 products are
//     exact in f32 and hi + lo carries the LUT to 2^-16 of its value. Two
//     passes make the least tensor-core time 2 x 2 M K N / 989 TFLOP/s.
//   * bf16 x, M <= 32 (a decode step): `dmm_small_kernel`, bound by the
//     code bytes: 44 MB at ffn_down (K 27648, N 3200), 13.4 us. Each lane
//     loads 16 code bytes at once (16 columns x 2 K rows) and turns each
//     byte (a K pair) into its W_hi and W_lo fragment registers by one
//     8-byte load from a 256-entry table of (hi, lo) pairs, kept in 16
//     copies so that a half warp's loads meet no bank twice; mma.sync
//     m16n8k16 multiplies them by the bf16 x chunk, staged once per block
//     in shared memory (rows of 8, mma.sync's n: M <= 8, 16 or 32 in 1, 2
//     or 4 row tiles). A code byte costs a load and two instructions, not
//     2 M multiply-adds, and no f32 tile is staged. A block of 8 warps owns
//     128 columns and a K chunk; K is split so that the blocks fill the
//     SMs once (`small_plan`), the warps' partials are summed in shared
//     memory in warp order, and the splits in the same launch, in split
//     order, by the last block of the column tile to finish (a counter it
//     resets to 0): the result does not depend on scheduling and no second
//     launch runs. What holds it above the byte bound: the chain of global
//     round trips a launch cannot overlap (the table and x chunk, the
//     codes, the partials and the counter, the last block's merge), about
//     10 us, and the table loads (one shared-memory wavefront per 16 code
//     bytes).
//   * every f32 x (no serve runs it): `dmm_kernel`, the first version's
//     f32 CUDA-core body: 8 x 128 output tiles (one row of 4 outputs per
//     thread) for small M, 128 x 64 tiles (8 x 4 outputs per thread) for
//     large M, 256 threads, the dequantized tile staged as f32 in shared
//     memory.
// The tensor-core and f32 bodies may split K across blocks (grid z): when
// the output tiles alone cannot fill 2 x 132 SMs (small M, or a narrow N
// such as the k/v projections' N = 640), and, for the tensor-core body
// (one block per SM), when whole-K tiles would leave most of the last wave
// idle (`tc_splits`). Each split writes its partial tile to a workspace
// and `sum_splits_kernel` sums the splits in a fixed order, so the result
// does not depend on scheduling. Edges: rows past M, columns past N, code
// rows past ceil(K/2) and x columns at or past the split's end are
// zero-filled (so an odd K's pad code row meets zero activations, as the
// reference's zero column of x does); the output is cropped on store. The
// 16-byte copies and loads need K % 8 == 0 (x rows, tensor-core body) and
// N % 16 == 0 (code rows); other shapes load the same tiles by elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSMs = 132;
constexpr int kMaxDevices = 64;


// ---------------------------------------------------------------------------
// CUDA-core body (f32 x)
// ---------------------------------------------------------------------------

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
      xs[kk][m] = (gm < M && gk < ke) ? x[(size_t)gm * K + gk] : 0.f;
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

// ---------------------------------------------------------------------------
// Tensor-core body (bf16 x, M > 32)
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 64;
constexpr int kStages = 8, kLookahead = 6;
constexpr int kTcThreads = 384;  // producer + two consumer warp groups
constexpr int kRowBytes = kTcBK * 2;              // one swizzled x row: 128 B
constexpr int kTileX = kTcBM * kRowBytes;         // 16 KB
// Code rows padded from 128 to 144 bytes: a warp's byte reads (4 rows x 8
// columns) then fall in distinct banks.
constexpr int kCodeRow = kTcBN + 16;
constexpr int kTileC = (kTcBK / 2) * kCodeRow;    // 4.5 KB
constexpr int kStage = (kTileX + kTileC + 1023) / 1024 * 1024;  // 21 KB
constexpr int kTcSmem = kStages * kStage + 1024;  // + alignment slack
static_assert(kLookahead <= kStages - 1,
              "the consumers hold the stage of the products in flight");

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

// Byte offset of (row, 16-byte chunk c) in a tile of 128-byte rows under
// the 128-byte swizzle (tiles start 1 KB aligned).
__device__ __forceinline__ int swz(int row, int c) {
  return row * kRowBytes + ((c ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The W operand of one K step for one thread: per k16 slice, the four
// registers of the m64k16 fragment, for W_hi and W_lo.
struct WFrag {
  uint32_t hi[kTcBK / 16][4], lo[kTcBK / 16][4];
};

// Keeps the compiler from reusing a fragment's registers before the wgmma
// that reads them has completed.
__device__ __forceinline__ void fence_frag(WFrag& f) {
#pragma unroll
  for (int i = 0; i < kTcBK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" : "+r"(f.hi[i][j]), "+r"(f.lo[i][j])::"memory");
}

// kVec: K % 8 == 0 and N % 16 == 0, so x and code rows copy in 16 bytes.
template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1)
dmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ codes,
              const float* __restrict__ lut, float* __restrict__ out, int M,
              int K, int N, int k_chunk) {
  extern __shared__ uint8_t dyn[];
  // code c -> W_hi(c) | W_lo(c) << 16, one copy per lane (entry c of lane
  // l at c * 32 + l, in bank l): lookups by any codes never conflict
  __shared__ uint32_t table[16 * 32];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int nk = ke > kb ? (ke - kb + kTcBK - 1) / kTcBK : 0;
  const int Kp = (K + 1) / 2;
  const uint32_t base = (smem_u32(dyn) + 1023u) & ~1023u;
  uint8_t* const gbase = dyn + (base - smem_u32(dyn));

  for (int i = tid; i < 16 * 32; i += kTcThreads) {
    const float w = lut[i >> 5];
    const uint16_t hi = bf16_bits(w);
    table[i] = (uint32_t)hi |
               ((uint32_t)bf16_bits(w - __bfloat162float(
                    __ushort_as_bfloat16(hi))) << 16);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 128);   // the producer's threads
      mbar_init(smem_u32(&empty[s]), 256);  // the consumers' threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: x tile (swizzled) and code tile of each K step ----
    const int p = tid;
    auto load = [&](int kt, int s) {
      const int k0 = kb + kt * kTcBK;
      const uint32_t x_s = base + s * kStage, c_s = x_s + kTileX;
      for (int i = p; i < kTcBM * 8; i += 128) {  // x: 128 rows x 8 chunks
        const int m = i >> 3, c = i & 7;
        const int gm = m0 + m, gk = k0 + 8 * c;
        const int nv = gm < M ? max(0, min(8, ke - gk)) : 0;
        if constexpr (kVec) {
          cp_async16(x_s + swz(m, c), nv ? x + (size_t)gm * K + gk : x,
                     2 * nv);
        } else {
          uint16_t v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = e < nv ? __bfloat16_as_ushort(x[(size_t)gm * K + gk + e])
                          : (uint16_t)0;
          *reinterpret_cast<uint4*>(gbase + (x_s - base) + swz(m, c)) =
              make_uint4(v[0] | (uint32_t)v[1] << 16,
                         v[2] | (uint32_t)v[3] << 16,
                         v[4] | (uint32_t)v[5] << 16,
                         v[6] | (uint32_t)v[7] << 16);
        }
      }
      for (int i = p; i < (kTcBK / 2) * 8; i += 128) {  // codes: 32 x 8
        const int r = i >> 3, c = i & 7;
        const int gr = k0 / 2 + r, gn = n0 + 16 * c;
        if constexpr (kVec) {
          const bool ok = gr < Kp && gn < N;
          cp_async16(c_s + r * kCodeRow + 16 * c,
                     ok ? codes + (size_t)gr * N + gn : codes, ok ? 16 : 0);
        } else {
          uint8_t* dst = gbase + (c_s - base) + r * kCodeRow + 16 * c;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            dst[e] = (gr < Kp && gn + e < N) ? codes[(size_t)gr * N + gn + e]
                                             : (uint8_t)0;
        }
      }
    };
    // Stage j's copies are complete once the copies of kLookahead later
    // stages are in flight; the x tile is read by wgmma, hence the proxy
    // fence.
    for (int it = 0; it < nk + kLookahead; ++it) {
      if (it < nk) {
        const int s = it % kStages;
        mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);
        load(it, s);
      }
      cp_async_commit();
      if (it >= kLookahead) {
        cp_async_wait<kLookahead>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(smem_u32(&full[(it - kLookahead) % kStages]));
      }
    }
    return;
  }

  // ---- consumers: warp group 1 + c owns the tile's columns 64 c ..
  // 64 c + 63 (the rows of its m64 W fragment), warp w of it 16 of them ----
  const int c = (tid >> 7) - 1, t = tid & 127, lane = tid & 31;
  const int w = t >> 5, g = lane >> 2, q = lane & 3;
  const uint32_t* tab = table + lane;
  // Column n's code bytes of one K step -> the thread's W fragments: slice
  // si, register r holds k = 16 si + 2 q + 8 (r >> 1) and its successor of
  // column 64 c + 16 w + g + 8 (r & 1), one code byte (high nibble first).
  auto build = [&](int kt, WFrag& f) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint8_t* raw =
        gbase + s * kStage + kTileX + q * kCodeRow + 64 * c + 16 * w + g;
#pragma unroll
    for (int si = 0; si < kTcBK / 16; ++si)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t b =
            raw[(8 * si + 4 * (r >> 1)) * kCodeRow + 8 * (r & 1)];
        const uint32_t e0 = tab[32 * (b >> 4)], e1 = tab[32 * (b & 15)];
        f.hi[si][r] = __byte_perm(e0, e1, 0x5410);
        f.lo[si][r] = __byte_perm(e0, e1, 0x7632);
      }
  };
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  auto issue = [&](int kt, WFrag& f) {
    const uint64_t dx = wgmma_desc(base + (kt % kStages) * kStage);
    fence_acc(d);
    fence_frag(f);
    wgmma_fence();
#pragma unroll
    for (int si = 0; si < kTcBK / 16; ++si) {
      wgmma_rs(d, f.hi[si], dx + 2 * si);
      wgmma_rs(d, f.lo[si], dx + 2 * si);
    }
    wgmma_commit();
  };
  auto retire = [&](int kt, WFrag& f) {
    wgmma_wait0();
    fence_acc(d);
    fence_frag(f);
    mbar_arrive(smem_u32(&empty[kt % kStages]));
  };
  // Step kt's products run while the next step's fragments are built.
  WFrag fa, fb;
  if (nk > 0) build(0, fa);
  for (int kt = 0; kt < nk; kt += 2) {
    issue(kt, fa);
    if (kt + 1 < nk) build(kt + 1, fb);
    retire(kt, fa);
    if (kt + 1 >= nk) break;
    issue(kt + 1, fb);
    if (kt + 2 < nk) build(kt + 2, fa);
    retire(kt + 1, fb);
  }

  // d[i]: tile column 64 c + 16 w + g + 8 ((i >> 1) & 1), tile row
  // 8 (i >> 2) + 2 q + (i & 1)
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int gn = n0 + 64 * c + 16 * w + g + 8 * ((i >> 1) & 1);
    const int gm = m0 + 8 * (i >> 2) + 2 * q + (i & 1);
    if (gm < M && gn < N) o[(size_t)gm * N + gn] = d[i];
  }
}

// ---------------------------------------------------------------------------
// Small-M body (bf16 x, M <= 32): 16-byte code loads, mma.sync
// ---------------------------------------------------------------------------

constexpr int kSmThreads = 256;                   // 8 warps
constexpr int kSmWarps = kSmThreads / 32;
constexpr int kSmBN = 128;                        // columns per block
constexpr int kSmStep = 16;                       // K per warp step
constexpr int kSmBlockK = kSmWarps * kSmStep;     // K per block step: 128
constexpr int kSmXBytes = 48 * 1024;              // x chunk staged, at most
constexpr int kSmTable = 256 * 16 * 8;            // the byte table: 32 KB

// Row tiles of 8 (mma.sync's n) that cover M <= 32 rows.
inline int small_mt(int M) { return M <= 8 ? 1 : M <= 16 ? 2 : 4; }

size_t small_smem(int M, int chunk) {
  const int mpad = 8 * small_mt(M);
  const size_t xs = (size_t)mpad * (chunk + 8) * 2;
  const size_t red = (size_t)kSmWarps * mpad * kSmBN * 4;
  return kSmTable + (xs > red ? xs : red);
}

// The small body's K split: as many blocks as fit the SMs at once over the
// column tiles (two per SM when the table, the x chunk and the warps'
// partials fit half of shared memory), a K chunk (a multiple of 128) whose
// x rows fit kSmXBytes, at least two block steps per split. Returns
// {splits, chunk}.
struct SmallPlan {
  int splits, chunk;
};
SmallPlan small_plan(int M, int K, int N) {
  const int mpad = 8 * small_mt(M);
  const int tiles = (N + kSmBN - 1) / kSmBN;
  const int kmax = max(kSmBlockK, (kSmXBytes / (2 * mpad) - 8) / kSmBlockK *
                                      kSmBlockK);
  const int per_sm = small_smem(M, kmax) <= 110 * 1024 ? 2 : 1;
  int splits = max(per_sm * kSMs / tiles, (K + kmax - 1) / kmax);
  // at least two block steps a split: a block's set-up (the table, the x
  // chunk, the merge) outweighs one
  splits = max(1, min(splits, (K + 2 * kSmBlockK - 1) / (2 * kSmBlockK)));
  const int chunk =
      ((K + splits - 1) / splits + kSmBlockK - 1) / kSmBlockK * kSmBlockK;
  return {(K + chunk - 1) / chunk, chunk};
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Slot of output (m, n) of a warp's partial in the block's reduction
// buffer: n's bits 0-3 XORed with n's bits 5-6 and m's bits 1-2, so that
// the stores of a warp (lanes g, q at n = 16 g + .., m = 2 q + ..) and the
// loads of the sum (consecutive n) meet no bank twice.
__device__ __forceinline__ int red_slot(int m, int n) {
  return m * kSmBN + (n ^ ((n >> 5) & 3) ^ (((m >> 1) & 3) << 2));
}

// MT row tiles of 8; kVec: N % 16 == 0 and 16-byte aligned codes.
// A block owns columns n0 .. n0 + 127 and the K chunk of blockIdx.y. The
// product is computed transposed, y^T = W^T x^T, on mma.sync m16n8k16: W^T
// is the A operand, built in registers from the codes, x^T the B operand.
// Lane (g, q) of a warp loads the 16 code bytes of columns n0 + 16 g ..
// + 15 at packed rows q and q + 4 of the warp's step (16-byte loads; the
// 8 lanes of a packed row read its 128 bytes); byte 2t of a row gives A
// row g of mma tile t, byte 2t + 1 row g + 8, so tile t's 16 rows are
// columns n0 + 16 g + 2t (+ 1), and a packed row is one k pair (high nibble
// first), as the fragment wants. Each byte becomes its W_hi and W_lo pairs
// by one 8-byte load from the byte table; two products (W_hi, then W_lo)
// go into one f32 accumulator. The 8 warps take the chunk's 16-deep steps in
// turn, the codes of the next two steps in flight while one is computed; their
// partials are summed in warp order in shared memory, then the splits in
// split order by the last block of the column tile to finish (a
// __threadfence and an atomicAdd on the tile's counter, which that block
// resets to 0 for the next launch).
template <int MT, bool kVec>
__global__ void __launch_bounds__(kSmThreads)
dmm_small_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ codes,
                 const float* __restrict__ lut, float* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ counters, int M,
                 int K, int N, int chunk, int splits, int x_vec) {
  constexpr int MP = 8 * MT;
  extern __shared__ __align__(16) uint8_t dyn[];
  // code byte b (k pair: high nibble, low nibble) -> the fragment registers
  // (W_hi(hi) | W_hi(lo) << 16, W_lo(hi) | W_lo(lo) << 16), 16 copies
  // (entry b of copy l % 16 at b * 16 + l % 16): one 8-byte load a byte,
  // and a half warp's loads by any bytes meet no bank twice
  uint2* const table = reinterpret_cast<uint2*>(dyn);
  __shared__ uint2 entry[256];
  __shared__ int last_s;
  // x chunk as bf16 pairs (k, k + 1), rows of chunk / 2 + 4 words: the
  // B-fragment loads (lanes g, q at word g xw + q) meet no bank twice
  uint32_t* const xs = reinterpret_cast<uint32_t*>(dyn + kSmTable);
  float* const red = reinterpret_cast<float*>(dyn + kSmTable);  // after K
  const int xw = chunk / 2 + 4;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * kSmBN;
  const int kb = blockIdx.y * chunk, ke = min(K, kb + chunk);
  const int Kp = (K + 1) / 2;

  // Warp w takes steps w, w + 8, ...: the codes of its first two are
  // requested before the table and the x chunk are built, then each
  // step's codes two steps ahead.
  const int nst = (ke - kb + kSmStep - 1) / kSmStep;
  auto load = [&](int st, uint4& c0, uint4& c1) {
    const int kp = (kb + st * kSmStep) / 2 + q, gn = n0 + 16 * g;
    auto row = [&](int r) -> uint4 {
      if (r >= Kp) return make_uint4(0, 0, 0, 0);
      const uint8_t* src = codes + (size_t)r * N + gn;
      if constexpr (kVec) {
        return gn < N ? __ldg(reinterpret_cast<const uint4*>(src))
                      : make_uint4(0, 0, 0, 0);
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (gn + e < N) v[e >> 2] |= (uint32_t)src[e] << (8 * (e & 3));
        return make_uint4(v[0], v[1], v[2], v[3]);
      }
    };
    c0 = row(kp);
    c1 = row(kp + 4);
  };

  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0, b0 = a0, b1 = a0, c0 = a0,
        c1 = a0;
  if (w < nst) load(w, a0, a1);
  if (w + kSmWarps < nst) load(w + kSmWarps, b0, b1);

  {
    const float vh = lut[tid >> 4], vl = lut[tid & 15];  // 256 threads
    const uint16_t hh = bf16_bits(vh), hl = bf16_bits(vl);
    const uint16_t lh = bf16_bits(vh - __bfloat162float(__ushort_as_bfloat16(hh)));
    const uint16_t ll = bf16_bits(vl - __bfloat162float(__ushort_as_bfloat16(hl)));
    entry[tid] = make_uint2((uint32_t)hh | (uint32_t)hl << 16,
                            (uint32_t)lh | (uint32_t)ll << 16);
  }
  __syncthreads();
  for (int i = tid; i < 256 * 16; i += kSmThreads) table[i] = entry[i >> 4];
  if (x_vec) {  // 8 x values a load
    const int pieces = chunk / 8;
#pragma unroll 4
    for (int i = tid; i < MP * pieces; i += kSmThreads) {
      const int m = i / pieces, j = i - m * pieces;
      const int k = kb + 8 * j;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M && k < ke)  // ke - k is a multiple of 8 when K is
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k));
      *reinterpret_cast<uint4*>(xs + m * xw + 4 * j) = v;
    }
  } else {
    for (int i = tid; i < MP * (chunk / 2); i += kSmThreads) {
      const int m = i / (chunk / 2), j = i - m * (chunk / 2);
      const int k = kb + 2 * j;
      uint32_t v = 0;
      if (m < M && k < ke) {
        const __nv_bfloat16* src = x + (size_t)m * K + k;
        v = __bfloat16_as_ushort(src[0]);
        if (k + 1 < ke) v |= (uint32_t)__bfloat16_as_ushort(src[1]) << 16;
      }
      xs[m * xw + j] = v;
    }
  }
  __syncthreads();

  float d[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[mt][t][j] = 0.f;
  const uint2* tab = table + (lane & 15);
  auto compute = [&](int st, const uint4& c0, const uint4& c1) {
    const int j0 = st * (kSmStep / 2) + q;  // word of k pair 16 st + 2 q
    uint32_t b[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t* xr = xs + (8 * mt + g) * xw;
      b[mt][0] = xr[j0];
      b[mt][1] = xr[j0 + 4];
    }
    const uint32_t r0[4] = {c0.x, c0.y, c0.z, c0.w};
    const uint32_t r1[4] = {c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      // bytes 2t, 2t + 1 of the two rows: (row g, row g + 8) x (k pair q,
      // k pair q + 4)
      const uint32_t h0 = r0[t >> 1] >> (16 * (t & 1));
      const uint32_t h1 = r1[t >> 1] >> (16 * (t & 1));
      const uint32_t bytes[4] = {h0 & 0xFF, (h0 >> 8) & 0xFF, h1 & 0xFF,
                                 (h1 >> 8) & 0xFF};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const uint2 e = tab[16 * bytes[rr]];
        ahi[rr] = e.x;
        alo[rr] = e.y;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(d[mt][t], ahi, b[mt][0], b[mt][1]);
        mma16816(d[mt][t], alo, b[mt][0], b[mt][1]);
      }
    }
  };

  for (int st = w; st < nst; st += kSmWarps) {
    if (st + 2 * kSmWarps < nst) load(st + 2 * kSmWarps, c0, c1);
    compute(st, a0, a1);
    a0 = b0, a1 = b1, b0 = c0, b1 = c1;
  }

  // d[mt][t][j]: column n0 + 16 g + 2 t + (j >> 1), row 8 mt + 2 q + (j & 1)
  __syncthreads();  // every warp done with xs, which red overwrites
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[w * MP * kSmBN + red_slot(8 * mt + 2 * q + (j & 1),
                                      16 * g + 2 * t + (j >> 1))] = d[mt][t][j];
  __syncthreads();
  for (int o = tid; o < MP * kSmBN; o += kSmThreads) {
    const int m = o / kSmBN, n = o - m * kSmBN;
    if (m >= M || n0 + n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < kSmWarps; ++ww) v += red[ww * MP * kSmBN + red_slot(m, n)];
    if (splits == 1) out[(size_t)m * N + n0 + n] = v;
    else part[((size_t)blockIdx.y * M + m) * N + n0 + n] = v;
  }
  if (splits == 1) return;
  // The last split of this column tile to finish sums them all, in order.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int o = tid; o < MP * kSmBN; o += kSmThreads) {
    const int m = o / kSmBN, n = o - m * kSmBN;
    if (m >= M || n0 + n >= N) continue;
    const float* src = part + (size_t)m * N + n0 + n;
    const size_t zs = (size_t)M * N;
    float v = 0.f;
    for (int z0 = 0; z0 < splits; z0 += 8) {  // 8 loads in flight, summed in order
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        t[u] = z0 + u < splits ? __ldcg(src + (z0 + u) * zs) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) v += t[u];
    }
    out[(size_t)m * N + n0 + n] = v;
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
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

int splits_for(int BM, int BN, int BK, int M, int K, int N) {
  const long tiles = (long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles >= 2 * kSMs) return 1;
  // At least 8 BK steps per split, so a split amortizes its output tile.
  const int most = K / (8 * BK);
  int want = (int)((2 * kSMs + tiles - 1) / tiles);
  if (want > most) want = most;
  return want < 1 ? 1 : want;
}

bool use_tc(int M, int dtype) { return dtype == 1 && !use_small(M); }

// The tensor-core body runs one block per SM, so a grid of whole K tiles
// loses the rest of its last wave (400 tiles: 4 waves, the last one 4
// tiles). Below one wave, split as the CUDA-core body does; above, take the
// fewest splits (at most 4, at least 8 K steps each) that keep 90 % of the
// waves' blocks busy, else the best of them. The splits' partial tiles
// cost one write and one read of M N f32 each.
int tc_splits(int M, int K, int N) {
  const long tiles = (long)((M + kTcBM - 1) / kTcBM) *
                     ((N + kTcBN - 1) / kTcBN);
  if (tiles < kSMs) return splits_for(kTcBM, kTcBN, kTcBK, M, K, N);
  const int most = min(4, max(1, K / (8 * kTcBK)));
  int best = 1;
  double best_eff = 0.0;
  for (int s = 1; s <= most; ++s) {
    const long blocks = tiles * s;
    const double eff =
        (double)blocks / (double)(kSMs * ((blocks + kSMs - 1) / kSMs));
    if (eff >= 0.9) return s;
    if (eff > best_eff) best = s, best_eff = eff;
  }
  return best;
}

int chunk_for(int K, int splits, int BK) {
  const int chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  return chunk > 0 ? chunk : BK;
}

void sum_splits(void* part, void* out, int M, int N, int splits,
                cudaStream_t s) {
  if (splits <= 1) return;
  const size_t n = (size_t)M * N;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096
                               ? (n + kThreads - 1) / kThreads : 4096);
  sum_splits_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, splits);
}

template <class T, typename XT>
int launch_fma(const void* x, const void* codes, const void* lut, void* out,
               void* part, int M, int K, int N, int splits, cudaStream_t s) {
  const dim3 grid((N + T::kBN - 1) / T::kBN, (M + T::kBM - 1) / T::kBM, splits);
  float* dst = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(out);
  dmm_kernel<T, XT><<<grid, kThreads, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(lut), dst, M, K, N,
      chunk_for(K, splits, T::kBK));
  sum_splits(part, out, M, N, splits, s);
  return static_cast<int>(cudaGetLastError());
}

// Raises the tensor-core body's dynamic shared-memory limit once per device
// and instantiation, not on every launch.
template <bool kVec>
cudaError_t ensure_tc_smem() {
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(dmm_tc_kernel<kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kTcSmem);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = true;
  return e;
}

template <bool kVec>
int launch_tc(const void* x, const void* codes, const void* lut, void* out,
              void* part, int M, int K, int N, int splits, cudaStream_t s) {
  const cudaError_t e = ensure_tc_smem<kVec>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM, splits);
  float* dst = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(out);
  dmm_tc_kernel<kVec><<<grid, kTcThreads, kTcSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(lut), dst, M, K, N,
      chunk_for(K, splits, kTcBK));
  sum_splits(part, out, M, N, splits, s);
  return static_cast<int>(cudaGetLastError());
}

// Raises the small body's dynamic shared-memory limit to `smem` once per
// device and instantiation, not on every launch.
template <int MT, bool kVec>
cudaError_t ensure_small_smem(size_t smem) {
  static size_t granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(dmm_small_kernel<MT, kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
  return e;
}

template <int MT, bool kVec>
int launch_small_mt(const void* x, const void* codes, const void* lut,
                    void* out, void* part, void* counters, int M, int K,
                    int N, int splits, cudaStream_t s) {
  const SmallPlan p = small_plan(M, K, N);
  if (p.splits != splits || (splits > 1 && (!part || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = small_smem(M, p.chunk);
  const cudaError_t e = ensure_small_smem<MT, kVec>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kSmBN - 1) / kSmBN, splits);
  dmm_small_kernel<MT, kVec><<<grid, kSmThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(lut), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), M, K, N, p.chunk,
      splits, K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_small(const void* x, const void* codes, const void* lut, void* out,
                 void* part, void* counters, int M, int K, int N, int splits,
                 cudaStream_t s) {
  switch (small_mt(M)) {
    case 1:
      return launch_small_mt<1, kVec>(x, codes, lut, out, part, counters, M,
                                      K, N, splits, s);
    case 2:
      return launch_small_mt<2, kVec>(x, codes, lut, out, part, counters, M,
                                      K, N, splits, s);
    default:
      return launch_small_mt<4, kVec>(x, codes, lut, out, part, counters, M,
                                      K, N, splits, s);
  }
}

}  // namespace

// Which body dmm() runs for M rows of x of type dtype (as in dmm()): 0
// the small-M body, 1 the tensor-core body, 2 the f32 CUDA-core body.
extern "C" int dmm_body(int M, int dtype) {
  return dtype == 1 ? (use_small(M) ? 0 : 1) : 2;
}

// Number of K splits dmm() uses for this shape and x type (dtype as in
// dmm()); the wrapper allocates a (splits, M, N) f32 workspace when it is
// above 1.
extern "C" int dmm_splits(int M, int K, int N, int dtype) {
  if (dtype == 1)
    return use_small(M) ? small_plan(M, K, N).splits : tc_splits(M, K, N);
  return use_small(M)
      ? splits_for(Small::kBM, Small::kBN, Small::kBK, M, K, N)
      : splits_for(Large::kBM, Large::kBN, Large::kBK, M, K, N);
}

// x (M, K) f32 (dtype 0) or bf16 (dtype 1); codes (ceil(K/2), N) uint8;
// lut (16,) f32; out (M, N) f32; part the workspace (unused when splits is
// 1); counters: ceil(N / 128) ints, 0 between launches, which the small-M
// body (bf16 x, M <= 32) leaves at 0 (unused by the other bodies). Launches
// on `stream`; returns cudaGetLastError().
extern "C" int dmm(const void* x, const void* codes, const void* lut,
                   void* out, void* part, void* counters, int M, int K, int N,
                   int splits, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = use_small(M);
  if (dtype == 0)
    return small
        ? launch_fma<Small, float>(x, codes, lut, out, part, M, K, N, splits, s)
        : launch_fma<Large, float>(x, codes, lut, out, part, M, K, N, splits, s);
  if (dtype == 1) {
    const bool vec = N % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
    if (small)
      return vec ? launch_small<true>(x, codes, lut, out, part, counters, M,
                                      K, N, splits, s)
                 : launch_small<false>(x, codes, lut, out, part, counters, M,
                                       K, N, splits, s);
    return K % 8 == 0 && N % 16 == 0
        ? launch_tc<true>(x, codes, lut, out, part, M, K, N, splits, s)
        : launch_tc<false>(x, codes, lut, out, part, M, K, N, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
