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
// same block table and dequantized while the tile is staged; the row's own
// chunk keys/values are always in q's type.
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
// (about 28 MB more) are this kernel's own cost, outside that bound. An
// int8 pool moves 1-byte codes plus a 4-byte scale per head row of D
// (0.516x of bf16 at D = 128) for the cache keys and values. This
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
//
// LUT mode (kLut, a table of the AFU's 64-entry exp given): under a LUT exp
// the result depends on where the running max is rescaled, so the
// statistics follow the reference's blocks: each pool page that meets
// [0, min(ci, ring)) is one block, then the row's chunk is one block of up
// to S keys. A block first scores all its keys (K staged 32 at a time) into
// a [16][256] f32 buffer (16 KB; the wrapper keeps ps and S <= 256), then
// takes each row's block max, lut(s - m_new) and lut(m_old - m_new) once,
// then streams V, staged in K's buffer, through the accumulator. The exact
// mode (kLut false) keeps its 32-key tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
             int ps, int nblk, int ring, int window, float scale) {
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
      const float o = (r / G) < nn ? acc[j] / fmaxf(l_s[rr], 1e-30f) : 0.f;
      out[(((size_t)b * S + r / G) * Hq + h * G + r % G) * D + d] = o;
    }
  }
}

template <typename T, typename TKV>
int launch_typed(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const void* k_row, const void* v_row,
                 const int* bounds, const int* bt, const float* table,
                 float* out, int B, int S, int Hq, int Hkv, int D, int P,
                 int ps, int nblk, int ring, int window, float scale,
                 cudaStream_t s) {
  const int G = Hq / Hkv;
  const dim3 grid(B, Hkv, (S * G + kQR - 1) / kQR);
  const T* qt = static_cast<const T*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  const T* krt = static_cast<const T*>(k_row);
  const T* vrt = static_cast<const T*>(v_row);
  if (table) {
    mixed_kernel<T, TKV, true><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, ks, vs, krt, vrt, bounds, bt, table, out, S, Hq, Hkv, D,
        P, ps, nblk, ring, window, scale);
  } else {
    mixed_kernel<T, TKV, false><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, ks, vs, krt, vrt, bounds, bt, table, out, S, Hq, Hkv, D,
        P, ps, nblk, ring, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Hq, D); k, v (P, ps, Hkv, D) in q's type, or int8 codes with
// ks, vs (P, ps, Hkv) f32 (quant = 1); k_row, v_row (B, S, Hkv, D) in q's
// type; bounds (B, 2) int32 [ci, n_new]; bt (B, nblk) int32; table: null
// (exact exp) or the 64-entry f32 LUT; out (B, S, Hq, D) f32. window <= 0
// means no window. dtype: 0 = float32, 1 = bfloat16. Requires Hq % Hkv == 0,
// D <= 128 and, with a table, ps <= 256 and S <= 256 (the wrapper checks).
extern "C" int tda_mixed(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* k_row,
                         const void* v_row, const void* bounds, const void* bt,
                         const void* table, void* out, int B, int S, int Hq,
                         int Hkv, int D, int P, int ps, int nblk, int ring,
                         int window, int dtype, int quant, float scale,
                         void* stream) {
  if (B == 0 || S == 0) return 0;
  if (table && (ps > kMaxBk || S > kMaxBk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* bd = static_cast<const int*>(bounds);
  const int* tb = static_cast<const int*>(bt);
  const float* lt = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  if (dtype == 0 && !quant) {
    return launch_typed<float, float>(q, k, v, kss, vss, k_row, v_row, bd, tb,
                                      lt, o, B, S, Hq, Hkv, D, P, ps, nblk,
                                      ring, window, scale, s);
  } else if (dtype == 1 && !quant) {
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, kss, vss, k_row, v_row, bd, tb, lt, o, B, S, Hq, Hkv, D, P, ps,
        nblk, ring, window, scale, s);
  } else if (dtype == 0 && quant) {
    return launch_typed<float, int8_t>(q, k, v, kss, vss, k_row, v_row, bd, tb,
                                       lt, o, B, S, Hq, Hkv, D, P, ps, nblk,
                                       ring, window, scale, s);
  } else if (dtype == 1 && quant) {
    return launch_typed<__nv_bfloat16, int8_t>(
        q, k, v, kss, vss, k_row, v_row, bd, tb, lt, o, B, S, Hq, Hkv, D, P, ps,
        nblk, ring, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
