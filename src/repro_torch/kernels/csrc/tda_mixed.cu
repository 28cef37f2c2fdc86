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
// Online softmax in f32, GQA. The pool holds keys/values in q's type, or
// int8 codes with per-(token, head) f32 scales (P, ps, Hkv) read through the
// same block table; the row's own chunk keys/values are always in q's type.
//
// Output convention, by `all_cols`:
//   * 0 (dense stacks): columns j >= n_new are never read by the caller (the
//     reference calls them garbage); the kernel skips their work, so a
//     decode row (n_new == 1) in a step of width S costs one column, not S.
//     It still writes them as zeros, so that the projections after
//     attention see finite values (the output comes from torch.empty).
//   * 1 (routed MoE stacks): every column is computed as the reference
//     computes it, since the experts route every column's token and a
//     column j >= n_new takes expert capacity like a live one: column j at
//     position ci + j attends the lane (window included) and the chunk keys
//     i < n_new with j - i < window. A decode row then costs S columns.
// Rows with no key at all (ci == 0, n_new == 0), and columns with none,
// give zeros.
//
// What bounds it on this card: by the card's peaks, bytes. In the served
// shapes (8 rows of 256 columns, 660 of them live, 40 q / 8 kv heads of
// 128) the live work reads about 8.8 MB of cache and chunk keys/values and
// 6.8 MB of live queries and writes 13.5 MB of live f32 outputs: about
// 8.7 us at HBM peak, while its 3.5 GFLOP would take about 3.5 us on the
// bf16 tensor cores. The zero-writes of unread columns (about 28 MB more)
// are this kernel's own cost, outside that bound. An int8 pool moves
// 1-byte codes plus a 4-byte scale per head row of D (0.516x of bf16 at
// D = 128) for the cache keys and values.
//
// Which body runs, by q's type:
//   * bf16 q (the served path; bf16 or int8 pool, exact or LUT exp):
//     `mixed_tc_kernel`, on the tensor cores. A block takes 64 packed query
//     rows (r = j * G + g, 64 / G columns) of one (row b, kv head): 20
//     blocks per (b, head) at full width, so each lane's K/V is read by 4x
//     fewer blocks than with the first version's 16 rows. Four warps own 16
//     rows each. K/V tiles of 64 keys are gathered through the block table
//     with 16-byte cp.async (int8 codes with 16- or 8-byte copies and 4-byte
//     scale copies), the cache pages first, then the row's own chunk keys,
//     into a ring of 2 stages, the next tile in flight while the current
//     one is computed; int8 codes are converted to bf16 in shared memory
//     (exact for |c| <= 127). QK^T and PV use mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate) with ldmatrix, rather than wgmma: each warp's 16 rows
//     keep their scores, running max and sum in registers, and the score
//     fragment becomes PV's A operand in registers with no trip through
//     shared memory, which wgmma (64 rows of one warp group per product,
//     B from shared memory) would need for P's two halves; at the served
//     shapes the tensor-core time is a few microseconds either way. D is
//     zero-padded to a multiple of 16 in shared memory (any D <= 128).
//     Scores are f32: the mma sum times the f32 scale, times the key scale
//     of an int8 pool. P (for an int8 pool, p times the value scale) is
//     split into hi = bf16(p) and lo = bf16(p - hi), and PV takes two
//     products into one f32 accumulator: a single bf16 P misses the exact
//     limit on peaked scores, hi + lo keeps p to 2^-16 of its value. The
//     LUT mode, held to 1e-5, takes a third part bf16(p - hi - lo) and a
//     third product: with two, a LUT output missed its plain version by
//     1.1e-5 on the card.
//     Warps whose rows all lie at dead columns skip the products.
//     LUT mode (kLut, a table of the AFU's 64-entry exp given): under a LUT
//     exp the result depends on where the running max is rescaled, so the
//     statistics follow the reference's blocks: each pool page that meets
//     [0, min(ci, ring)), then the row's chunk as one block of up to S keys.
//     A block's K tiles are scored into a 64 x 256 f32 score buffer (66 KB;
//     the wrapper keeps ps and S <= 256), each warp then takes its rows'
//     block max, lut(s - m_new) and lut(m_old - m_new) once, and the
//     block's V tiles (staged in K's buffers) go through PV.
//   * f32 q (not on the served path): `mixed_kernel`, the first version's
//     CUDA-core body: blocks of 16 query rows, 32-key tiles staged as f32,
//     products as f32 FMAs, the same LUT blocks through a 16 x 256 buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "lut_exp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per shared-memory tile
constexpr int kQR = 16;    // query rows per block
constexpr int kMaxD = 128;
constexpr int kMaxBk = 256;  // largest LUT-mode block (keys)
constexpr int kPer = kQR * kMaxD / kThreads;  // accumulators per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
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

// T: q's and the row chunk's type; TKV: the pool's (T, or int8 codes with
// scales ks/vs). kLut: table (lut::kSize f32) is read and the statistics
// follow the reference's blocks (page_size keys, then the row chunk).
template <typename T, typename TKV, bool kLut>
__global__ void __launch_bounds__(kThreads)
mixed_kernel(const T* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const float* __restrict__ ks,
             const float* __restrict__ vs, const T* __restrict__ kr,
             const T* __restrict__ vr, const int* __restrict__ bounds,
             const int* __restrict__ bt, const float* __restrict__ table,
             float* __restrict__ out, int S, int Hq, int Hkv, int D, int P,
             int ps, int nblk, int ring, int window, int all_cols,
             float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kBuf = kLut ? kMaxBk : kTile;  // keys of scores held at once
  __shared__ float q_s[kQR][kMaxD];
  __shared__ float k_s[kTile][kMaxD + 1];
  __shared__ float v_s[kLut ? 1 : kTile][kMaxD + 1];  // LUT: V reuses k_s
  __shared__ float p_s[kQR][kBuf];
  __shared__ unsigned char ok_s[kQR][kBuf];
  __shared__ float lut_s[kLut ? lut::kSize : 1];
  __shared__ float m_s[kQR], l_s[kQR], a_s[kQR];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.z * kQR;  // first query row: row r = j * G + g
  const int nr = min(kQR, S * G - r0);
  const int ci = max(bounds[2 * b], 0);
  const int nn = min(max(bounds[2 * b + 1], 0), S);
  const int nl = all_cols ? S : nn;  // columns computed

  // Columns not computed are written as zeros and cost nothing else.
  if (r0 / G >= nl) {
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
  if constexpr (kLut) {
    if (tid < lut::kSize) lut_s[tid] = table[tid];
  }
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  __syncthreads();

  // Stage n keys into dk and values into dv (either may be null) from key
  // index u0 as f32: u < n_cache is pre-write lane slot r = u, read through
  // the table (int8 codes times their scale); past it, in-row chunk key
  // i = u - n_cache.
  auto stage = [&](float (*dk)[kMaxD + 1], float (*dv)[kMaxD + 1], int u0,
                   int n) {
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D, d = i % D, u = u0 + t;
      if (u < n_cache) {
        const int page = min(max(bt[(size_t)b * nblk + u / ps], 0), P - 1);
        const size_t hrow = ((size_t)page * ps + u % ps) * Hkv + h;
        if (dk) {
          float x = to_f32(k[hrow * D + d]);
          if constexpr (kQuant) x *= ks[hrow];
          dk[t][d] = x;
        }
        if (dv) {
          float x = to_f32(v[hrow * D + d]);
          if constexpr (kQuant) x *= vs[hrow];
          dv[t][d] = x;
        }
      } else {
        const size_t off = (((size_t)b * S + (u - n_cache)) * Hkv + h) * D + d;
        if (dk) dk[t][d] = to_f32(kr[off]);
        if (dv) dv[t][d] = to_f32(vr[off]);
      }
    }
  };
  // Scores of query rows rr < kQR against the n staged keys from u0, into
  // p_s/ok_s columns c0.. (kNegInf where a key is not visible).
  auto score = [&](int u0, int n, int c0) {
    for (int i = tid; i < kQR * n; i += kThreads) {
      const int rr = i / n, t = i % n, u = u0 + t;
      const int j = (r0 + rr) / G;
      bool ok = rr < nr && j < nl;
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
      p_s[rr][c0 + t] = ok ? s * scale : kNegInf;
      ok_s[rr][c0 + t] = ok;
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  if constexpr (kLut) {
    // Blocks: each pool page [u_a, u_a + ps) below n_cache, then the chunk.
    for (int u_a = 0; u_a < total;) {
      const int nb = (u_a < n_cache ? min(u_a + ps, n_cache) : total) - u_a;
      for (int t0 = 0; t0 < nb; t0 += kTile) {  // scores of the block
        const int n = min(kTile, nb - t0);
        stage(k_s, nullptr, u_a + t0, n);
        __syncthreads();
        score(u_a + t0, n, t0);
        __syncthreads();
      }
      // The block's statistics: one warp per query row.
      for (int rr = warp; rr < kQR; rr += kThreads / 32) {
        float bm = kNegInf;
        for (int t = lane; t < nb; t += 32) bm = fmaxf(bm, p_s[rr][t]);
        const float m_old = m_s[rr];
        const float m_new = fmaxf(m_old, warp_max(bm));
        float sum = 0.f;
        for (int t = lane; t < nb; t += 32) {
          const float p =
              ok_s[rr][t] ? lut::lut_exp(p_s[rr][t] - m_new, lut_s) : 0.f;
          p_s[rr][t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float a = lut::lut_exp(m_old - m_new, lut_s);
          a_s[rr] = a;
          l_s[rr] = l_s[rr] * a + sum;
          m_s[rr] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (i < kQR * D) acc[j] *= a_s[i / D];
      }
      for (int t0 = 0; t0 < nb; t0 += kTile) {  // then P @ V
        const int n = min(kTile, nb - t0);
        stage(nullptr, k_s, u_a + t0, n);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads;
          if (i < kQR * D) {
            const int rr = i / D, d = i % D;
            float o = acc[j];
            for (int t = 0; t < n; ++t) o += p_s[rr][t0 + t] * k_s[t][d];
            acc[j] = o;
          }
        }
        __syncthreads();
      }
      u_a += nb;
    }
  } else {
    for (int u0 = 0; u0 < total; u0 += kTile) {
      const int n = min(kTile, total - u0);
      stage(k_s, v_s, u0, n);
      __syncthreads();
      score(u0, n, 0);
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
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    if (i < nr * D) {
      const int rr = i / D, d = i % D, r = r0 + rr;
      const float o = (r / G) < nl ? acc[j] / fmaxf(l_s[rr], 1e-30f) : 0.f;
      out[(((size_t)b * S + r / G) * Hq + h * G + r % G) * D + d] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16 q): mixed_tc_kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 64;     // packed query rows per block: 4 warps x 16
constexpr int kKeys = 64;     // keys per tile
constexpr int kStride = 136;  // bf16 per tile row: 128 + 8 (272 B, no
                              // ldmatrix bank conflicts)
constexpr int kSbuf = 264;    // f32 per LUT score-buffer row: 256 + 8
constexpr int kTileBytes = kKeys * kStride * 2;  // 17 KB
constexpr int kRawBytes = kKeys * kMaxD;         // int8 codes of a tile: 8 KB

// Dynamic shared memory, in bytes: the query tile, then per ring slot (2)
// one or two buffer sets (K, V; the LUT mode stages K and V of a block in
// turn, so one), each a bf16 tile, an int8 raw tile (int8 pools) and 64
// f32 scales, and per slot the tokens p_r of its pool keys; the LUT mode
// adds the score buffer, the table and m, l, alpha per row.
template <bool kLut, bool kQuant>
struct Lay {
  static constexpr int kSets = kLut ? 1 : 2;
  // Exact int8: slot 1's raw tiles lie over the query tile, dead once its
  // fragments are in registers, so that two blocks fit on an SM.
  static constexpr bool kAlias = kQuant && !kLut;
  static constexpr int kTiles = kTileBytes;
  static constexpr int kRaw = kTiles + 2 * kSets * kTileBytes;
  static constexpr int kSc =
      kRaw + (kQuant ? (kAlias ? 1 : 2) * kSets * kRawBytes : 0);
  static constexpr int kPr = kSc + 2 * kSets * kKeys * 4;
  static constexpr int kSb = kPr + 2 * kKeys * 4;
  static constexpr int kLutT = kSb + (kLut ? kRows * kSbuf * 4 : 0);
  static constexpr int kStat = kLutT + (kLut ? lut::kSize * 4 : 0);
  static constexpr int kBytes = kStat + (kLut ? 3 * kRows * 4 : 0);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Splits x0, x1 (two per register, the first in the low half) into
// kTerms bf16 parts, each the bf16 rounding of what the parts before it
// leave: x = sum of the parts + O(2^(-8 kTerms) |x|).
template <int kTerms>
__device__ __forceinline__ void split2(float x0, float x1,
                                      uint32_t (&part)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    part[i] = pack_bf16(x0, x1);
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&part[i]);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A position in the tile sequence: the tile of keys [u_a + t0, u_a + t0 +
// min(64, nb - t0)). Exact mode: one run of nb = total keys. LUT mode: the
// block [u_a, u_a + nb), its K tiles (pass 0), then its V tiles (pass 1).
struct Seq {
  int u_a, nb, pass, t0;
  __device__ bool valid(int total) const { return u_a < total; }
};

}  // namespace tc

// Block: (row b, kv head h, 64 packed query rows r = j * G + g from
// blockIdx.z * 64), 4 warps of 16 rows. TKV: the pool's type (bf16, or
// int8 codes with scales ks/vs). kLut: the statistics follow the
// reference's blocks (each page, then the row chunk), scored whole into a
// shared score buffer before P V.
template <typename TKV, bool kLut>
__global__ void __launch_bounds__(128)
mixed_tc_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
                const TKV* __restrict__ v, const float* __restrict__ ks,
                const float* __restrict__ vs,
                const __nv_bfloat16* __restrict__ kr,
                const __nv_bfloat16* __restrict__ vr,
                const int* __restrict__ bounds, const int* __restrict__ bt,
                const float* __restrict__ table, float* __restrict__ out,
                int S, int Hq, int Hkv, int D, int P, int ps, int nblk,
                int ring, int window, int all_cols, float scale) {
  using namespace tc;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  using L = Lay<kLut, kQuant>;
  // P's bf16 parts: hi + lo keeps p to 2^-16 of its value, enough for the
  // exact mode's limit; the LUT mode's 1e-5 needs a third part.
  constexpr int kTerms = kLut ? 3 : 2;
  extern __shared__ __align__(16) uint8_t sm[];
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(sm);
  auto tile = [&](int slot, int set) {
    return reinterpret_cast<__nv_bfloat16*>(
        sm + L::kTiles + (slot * L::kSets + set) * kTileBytes);
  };
  static_assert(!L::kAlias || L::kSets * kRawBytes <= kTileBytes,
                "slot 1's raw tiles fit over the query tile");
  auto raw = [&](int slot, int set) {
    return reinterpret_cast<int8_t*>(
        L::kAlias && slot == 1
            ? sm + set * kRawBytes
            : sm + L::kRaw + (slot * L::kSets + set) * kRawBytes);
  };
  auto scl = [&](int slot, int set) {
    return reinterpret_cast<float*>(sm + L::kSc +
                                    (slot * L::kSets + set) * kKeys * 4);
  };
  int* const pr_s = reinterpret_cast<int*>(sm + L::kPr);  // p_r per key
  float* const sbuf = reinterpret_cast<float*>(sm + L::kSb);
  float* const lut_s = reinterpret_cast<float*>(sm + L::kLutT);
  float* const m_s = reinterpret_cast<float*>(sm + L::kStat);
  float* const l_s = m_s + kRows;
  float* const a_s = l_s + kRows;

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.z * kRows;
  const int nr = min(kRows, S * G - r0);
  const int ci = max(bounds[2 * b], 0);
  const int nn = min(max(bounds[2 * b + 1], 0), S);
  const int nl = all_cols ? S : nn;  // columns computed
  auto out_at = [&](int rr) {  // first output element of local row rr
    const int r = r0 + rr;
    return out + (((size_t)b * S + r / G) * Hq + h * G + r % G) * D;
  };

  // Columns not computed are written as zeros and cost nothing else.
  if (r0 / G >= nl) {
    for (int i = tid; i < nr * D; i += 128) out_at(i / D)[i % D] = 0.f;
    return;
  }
  const int j_last = (r0 + nr - 1) / G;
  const int n_cache = min(min(ci, ring), nblk * ps);
  const int total = n_cache + min(nn, j_last + 1);
  const int Dp = (D + 15) & ~15;   // D zero-padded to the mma depth
  const bool vec = D % 8 == 0;     // rows copy in 16-byte pieces

  // Zero the query tile and every K/V tile once: the pad columns [D, Dp)
  // stay zero; rows past a tile's keys keep finite values of earlier tiles
  // (their scores are masked, their probabilities 0). Scales start at 1.
  for (int i = tid; i < L::kRaw / 16; i += 128)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 2 * L::kSets * kKeys; i += 128)
    reinterpret_cast<float*>(sm + L::kSc)[i] = 1.f;
  if constexpr (kLut) {
    if (tid < lut::kSize) lut_s[tid] = table[tid];
    if (tid < kRows) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
  }
  __syncthreads();

  // Query rows: live when r < S G and column j is computed.
  const int units = vec ? D / 8 : D;  // 8-element pieces, or elements
  for (int i = tid; i < kRows * units; i += 128) {
    const int rr = i / units, c = i % units, r = r0 + rr;
    if (rr >= nr || r / G >= nl) continue;
    const __nv_bfloat16* src =
        q + (((size_t)b * S + r / G) * Hq + h * G + r % G) * D;
    if (vec)
      cp16(q_s + rr * kStride + 8 * c, src + 8 * c);
    else
      q_s[rr * kStride + c] = src[c];
  }

  // Stage keys [u0, u0 + n) into ring slot `slot`: K into buffer set
  // kset and V into vset (-1: not staged). Two threads share a key, so a
  // thread makes one block-table lookup per tile and its copies depend on
  // no other load. Pool rows (u < n_cache: lane slot u through the block
  // table) also record their token p_r; the row's chunk keys (i = u -
  // n_cache) are bf16. Int8 pool rows land as codes in the raw tile
  // (converted after the copy) with their scales; chunk rows keep scale 1.
  auto stage = [&](int slot, int kset, int vset, int u0, int n) {
    const int t = tid >> 1, half = tid & 1, u = u0 + t;
    if (t >= n) return;
    const bool cache = u < n_cache;
    size_t src = 0;  // first element of the key's head row
    if (cache) {
      const int page = min(max(bt[(size_t)b * nblk + u / ps], 0), P - 1);
      src = (((size_t)page * ps + u % ps) * Hkv + h) * D;
      if (half == 0) pr_s[slot * kKeys + t] = (ci - 1) - (ci - 1 - u) % ring;
    } else {
      src = (((size_t)b * S + (u - n_cache)) * Hkv + h) * D;
    }
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const int set = kv ? vset : kset;
      if (set < 0) continue;
      __nv_bfloat16* dt = tile(slot, set) + t * kStride;
      if (!cache) {
        const __nv_bfloat16* rows = (kv ? vr : kr) + src;
        if (kQuant && half == 0) scl(slot, set)[t] = 1.f;
        if (vec) {
          for (int c = half; c < D / 8; c += 2) cp16(dt + 8 * c, rows + 8 * c);
        } else {
          for (int d = half; d < D; d += 2) dt[d] = rows[d];
        }
        continue;
      }
      const TKV* pool = (kv ? v : k) + src;
      if constexpr (kQuant) {
        const float* psc = (kv ? vs : ks) + src / D;
        float* dsc = scl(slot, set) + t;
        int8_t* dr = raw(slot, set) + t * kMaxD;
        if (!vec) {
          if (half == 0) *dsc = *psc;
          for (int d = half; d < D; d += 2)
            dt[d] = __float2bfloat16_rn(static_cast<float>(pool[d]));
        } else {
          if (half == 0) cp4(dsc, psc);
          if (D % 16 == 0) {
            for (int c = half; c < D / 16; c += 2)
              cp16(dr + 16 * c, pool + 16 * c);
          } else {
            for (int c = half; c < D / 8; c += 2) cp8(dr + 8 * c, pool + 8 * c);
          }
        }
      } else {
        if (vec) {
          for (int c = half; c < D / 8; c += 2) cp16(dt + 8 * c, pool + 8 * c);
        } else {
          for (int d = half; d < D; d += 2) dt[d] = pool[d];
        }
      }
    }
  };
  // Int8 codes of pool rows [u0, min(u0 + n, n_cache)) to bf16 (exact for
  // |c| <= 127), 8 at a time.
  auto convert = [&](int slot, int set, int u0, int n) {
    const int nc = max(0, min(n, n_cache - u0));
    __nv_bfloat16* dt = tile(slot, set);
    const int8_t* dr = raw(slot, set);
    for (int i = tid; i < nc * (D / 8); i += 128) {
      const int t = i / (D / 8), c = i % (D / 8);
      const uint2 w = *reinterpret_cast<const uint2*>(dr + t * kMaxD + 8 * c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&w);
      uint4 o;
      o.x = pack_bf16(e[0], e[1]);
      o.y = pack_bf16(e[2], e[3]);
      o.z = pack_bf16(e[4], e[5]);
      o.w = pack_bf16(e[6], e[7]);
      *reinterpret_cast<uint4*>(dt + t * kStride + 8 * c) = o;
    }
  };

  // The tile sequence. Exact: 64 keys at a time over [0, total). LUT:
  // per block (each page meeting [0, n_cache), then the chunk) its K tiles,
  // then its V tiles.
  auto block_len = [&](int u_a) {
    return (u_a < n_cache ? min(u_a + ps, n_cache) : total) - u_a;
  };
  auto first = [&]() {
    Seq s{0, kLut ? block_len(0) : total, 0, 0};
    return s;
  };
  auto next = [&](Seq s) {
    s.t0 += kKeys;
    if (s.t0 >= s.nb) {
      s.t0 = 0;
      if (kLut && s.pass == 0) {
        s.pass = 1;
      } else {
        s.u_a += s.nb;
        s.pass = 0;
        s.nb = s.u_a < total ? (kLut ? block_len(s.u_a) : s.nb) : 0;
      }
    }
    return s;
  };
  auto stage_step = [&](int slot, const Seq& s) {
    const int u0 = s.u_a + s.t0, n = min(kKeys, s.nb - s.t0);
    if (!kLut)
      stage(slot, 0, 1, u0, n);
    else if (s.pass == 0)
      stage(slot, 0, -1, u0, n);
    else
      stage(slot, -1, 0, u0, n);
  };

  // Per thread: rows ra = 16 warp + lane / 4 and rb = ra + 8 of the tile.
  const int ra = 16 * warp + g4, rb = ra + 8;
  const int ja = (r0 + ra) / G, jb = (r0 + rb) / G;
  const bool la = ra < nr && ja < nl, lb = rb < nr && jb < nl;
  const bool warp_live = 16 * warp < nr && (r0 + 16 * warp) / G < nl;
  auto key_ok = [&](int slot, int t, int u, int j) {
    if (u < n_cache) {
      const int p_r = pr_s[slot * kKeys + t];
      return p_r >= 0 && (window <= 0 || p_r > ci + j - window);
    }
    const int ii = u - n_cache;
    return ii <= j && ii < nn && (window <= 0 || j - ii < window);
  };

  Seq cur = first();
  if (cur.valid(total)) stage_step(0, cur);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  uint32_t qf[8][4];
#pragma unroll
  for (int kd = 0; kd < 8; ++kd)
    if (16 * kd < Dp)
      ldsm_x4(qf[kd], q_s + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                kStride + 16 * kd + (lane >> 4) * 8);
  if (L::kAlias) __syncthreads();  // before slot 1's codes overwrite it

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // exact mode

  // s[nb][e]: row ra (e < 2) or rb, key column 8 nb + 2 t4 + (e & 1).
  // Masked entries are -inf.
  auto scores = [&](float (&s)[8][4], int slot, int u0, int n) {
    const __nv_bfloat16* kt = tile(slot, 0);
    const float* ksc = scl(slot, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < 8; ++kd) {
      if (16 * kd >= Dp) break;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kt + (16 * np + (lane & 7) + (lane >> 4) * 8) * kStride +
                        16 * kd + ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qf[kd], bf[0], bf[1]);
        mma(s[2 * np + 1], qf[kd], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * i + 2 * t4 + (e & 1);
        const bool ok = t < n && ((e < 2) ? la && key_ok(slot, t, u0 + t, ja)
                                          : lb && key_ok(slot, t, u0 + t, jb));
        const float sc = kQuant ? s[i][e] * scale * ksc[t] : s[i][e] * scale;
        s[i][e] = ok ? sc : -INFINITY;
      }
  };
  // acc += P V over the tile, P (already times the value scales) split
  // into kTerms bf16 parts, one product each into the f32 accumulator.
  auto pv = [&](const float (&p)[8][4], const __nv_bfloat16* vt) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4][kTerms];
      split2<kTerms>(p[2 * kc][0], p[2 * kc][1], a[0]);
      split2<kTerms>(p[2 * kc][2], p[2 * kc][3], a[1]);
      split2<kTerms>(p[2 * kc + 1][0], p[2 * kc + 1][1], a[2]);
      split2<kTerms>(p[2 * kc + 1][2], p[2 * kc + 1][3], a[3]);
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        if (16 * dp >= Dp) break;
        uint32_t bf[4];
        ldsm_x4_t(bf, vt + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               kStride + 16 * dp + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          const uint32_t ai[4] = {a[0][i], a[1][i], a[2][i], a[3][i]};
          mma(acc[2 * dp], ai, bf[0], bf[1]);
          mma(acc[2 * dp + 1], ai, bf[2], bf[3]);
        }
      }
    }
  };
  auto rescale = [&](float aa, float ab) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[i][0] *= aa;
      acc[i][1] *= aa;
      acc[i][2] *= ab;
      acc[i][3] *= ab;
    }
  };

  int slot = 0;
  while (cur.valid(total)) {
    const Seq nxt = next(cur);
    if (nxt.valid(total)) stage_step(slot ^ 1, nxt);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int u0 = cur.u_a + cur.t0, n = min(kKeys, cur.nb - cur.t0);
    if (kQuant && vec) {
      convert(slot, 0, u0, n);
      if (!kLut) convert(slot, 1, u0, n);
      __syncthreads();
    }
    if (warp_live) {
      float s[8][4];
      if constexpr (!kLut) {
        scores(s, slot, u0, n);
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mx_a = fmaxf(mx_a, fmaxf(s[i][0], s[i][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[i][2], s[i][3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a));
        const float mn_b = fmaxf(m_b, quad_max(mx_b));
        const float* vsc = scl(slot, 1);
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float mn = e < 2 ? mn_a : mn_b;
            const float p = s[i][e] == -INFINITY ? 0.f : expf(s[i][e] - mn);
            if (e < 2) sum_a += p; else sum_b += p;
            s[i][e] = kQuant ? p * vsc[8 * i + 2 * t4 + (e & 1)] : p;
          }
        const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
        m_a = mn_a;
        m_b = mn_b;
        rescale(al_a, al_b);
        pv(s, tile(slot, 1));
      } else if (cur.pass == 0) {
        // Pass 1: this tile's scores into the block's columns t0.. of the
        // score buffer (masked: -inf); after the block's last tile, its
        // statistics, one warp per row, over the warp's own 16 rows.
        scores(s, slot, u0, n);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 8 * i + 2 * t4 + (e & 1);
            if (t < n) sbuf[(e < 2 ? ra : rb) * kSbuf + cur.t0 + t] = s[i][e];
          }
        if (cur.t0 + kKeys >= cur.nb) {
          __syncwarp();
          for (int i = 0; i < 16; ++i) {
            const int rr = 16 * warp + i;
            float* row = sbuf + rr * kSbuf;
            float bm = -INFINITY;
            for (int t = lane; t < cur.nb; t += 32) bm = fmaxf(bm, row[t]);
            const float m_old = m_s[rr];
            const float m_new = fmaxf(m_old, warp_max(bm));
            float sum = 0.f;
            for (int t = lane; t < cur.nb; t += 32) {
              const float x = row[t];
              const float p = x == -INFINITY ? 0.f
                                             : lut::lut_exp(x - m_new, lut_s);
              row[t] = p;
              sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
              const float a = lut::lut_exp(m_old - m_new, lut_s);
              a_s[rr] = a;
              l_s[rr] = l_s[rr] * a + sum;
              m_s[rr] = m_new;
            }
          }
          __syncwarp();
          rescale(a_s[ra], a_s[rb]);
        }
      } else {
        // Pass 2: the block's probabilities of this tile, times the value
        // scales, through P V.
        const float* vsc = scl(slot, 0);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 8 * i + 2 * t4 + (e & 1);
            const float p =
                t < n ? sbuf[(e < 2 ? ra : rb) * kSbuf + cur.t0 + t] : 0.f;
            s[i][e] = kQuant ? p * vsc[t] : p;
          }
        pv(s, tile(slot, 0));
      }
    }
    __syncthreads();
    cur = nxt;
    slot ^= 1;
  }

  // Rows: live ones divided by l, the rest of the tile's rows zeros.
  float den_a, den_b;
  if constexpr (kLut) {
    den_a = fmaxf(l_s[ra], 1e-30f);
    den_b = fmaxf(l_s[rb], 1e-30f);
  } else {
    den_a = fmaxf(quad_sum(l_a), 1e-30f);
    den_b = fmaxf(quad_sum(l_b), 1e-30f);
  }
#pragma unroll
  for (int nd = 0; nd < 16; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e < 2 ? ra : rb, d = 8 * nd + 2 * t4 + (e & 1);
      const bool live = e < 2 ? la : lb;
      if (rr < nr && d < D)
        out_at(rr)[d] = live ? acc[nd][e] / (e < 2 ? den_a : den_b) : 0.f;
    }
}

constexpr int kMaxDevices = 64;

// Raises an instantiation's dynamic shared-memory limit once per device,
// not on every launch.
template <typename TKV, bool kLut>
cudaError_t ensure_tc_smem() {
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(
      mixed_tc_kernel<TKV, kLut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::Lay<kLut, std::is_same<TKV, int8_t>::value>::kBytes);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = true;
  return e;
}

template <typename TKV, bool kLut>
int launch_tc(const void* q, const void* k, const void* v, const float* ks,
              const float* vs, const void* k_row, const void* v_row,
              const int* bounds, const int* bt, const float* table,
              float* out, int B, int S, int Hq, int Hkv, int D, int P, int ps,
              int nblk, int ring, int window, int all_cols, float scale,
              cudaStream_t s) {
  const cudaError_t e = ensure_tc_smem<TKV, kLut>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = Hq / Hkv;
  const dim3 grid(B, Hkv, (S * G + tc::kRows - 1) / tc::kRows);
  mixed_tc_kernel<TKV, kLut>
      <<<grid, 128, tc::Lay<kLut, std::is_same<TKV, int8_t>::value>::kBytes,
         s>>>(static_cast<const __nv_bfloat16*>(q),
              static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks, vs,
              static_cast<const __nv_bfloat16*>(k_row),
              static_cast<const __nv_bfloat16*>(v_row), bounds, bt, table,
              out, S, Hq, Hkv, D, P, ps, nblk, ring, window, all_cols,
              scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int launch_f32(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const void* k_row, const void* v_row,
               const int* bounds, const int* bt, const float* table,
               float* out, int B, int S, int Hq, int Hkv, int D, int P,
               int ps, int nblk, int ring, int window, int all_cols,
               float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
  const dim3 grid(B, Hkv, (S * G + kQR - 1) / kQR);
  const float* qt = static_cast<const float*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  const float* krt = static_cast<const float*>(k_row);
  const float* vrt = static_cast<const float*>(v_row);
  if (table) {
    mixed_kernel<float, TKV, true><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, ks, vs, krt, vrt, bounds, bt, table, out, S, Hq, Hkv, D,
        P, ps, nblk, ring, window, all_cols, scale);
  } else {
    mixed_kernel<float, TKV, false><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, ks, vs, krt, vrt, bounds, bt, table, out, S, Hq, Hkv, D,
        P, ps, nblk, ring, window, all_cols, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Hq, D); k, v (P, ps, Hkv, D) in q's type, or int8 codes with
// ks, vs (P, ps, Hkv) f32 (quant = 1); k_row, v_row (B, S, Hkv, D) in q's
// type; bounds (B, 2) int32 [ci, n_new]; bt (B, nblk) int32; table: null
// (exact exp) or the 64-entry f32 LUT; out (B, S, Hq, D) f32. window <= 0
// means no window. all_cols: 0 skips the columns j >= n_new (zeros), 1
// computes them (see the output convention above). dtype: 0 = float32,
// 1 = bfloat16. Requires Hq % Hkv == 0,
// D <= 128 and, with a table, ps <= 256 and S <= 256 (the wrapper checks).
extern "C" int tda_mixed(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* k_row,
                         const void* v_row, const void* bounds, const void* bt,
                         const void* table, void* out, int B, int S, int Hq,
                         int Hkv, int D, int P, int ps, int nblk, int ring,
                         int window, int dtype, int quant, int all_cols,
                         float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (D > kMaxD || (table && (ps > kMaxBk || S > kMaxBk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* bd = static_cast<const int*>(bounds);
  const int* tb = static_cast<const int*>(bt);
  const float* lt = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
#define TDA_MIXED_ARGS                                                     \
  q, k, v, kss, vss, k_row, v_row, bd, tb, lt, o, B, S, Hq, Hkv, D, P, ps, \
      nblk, ring, window, all_cols, scale, s
  if (dtype == 0) {
    return quant ? launch_f32<int8_t>(TDA_MIXED_ARGS)
                 : launch_f32<float>(TDA_MIXED_ARGS);
  }
  if (dtype == 1) {
    if (quant) {
      return lt ? launch_tc<int8_t, true>(TDA_MIXED_ARGS)
                : launch_tc<int8_t, false>(TDA_MIXED_ARGS);
    }
    return lt ? launch_tc<__nv_bfloat16, true>(TDA_MIXED_ARGS)
              : launch_tc<__nv_bfloat16, false>(TDA_MIXED_ARGS);
  }
#undef TDA_MIXED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
