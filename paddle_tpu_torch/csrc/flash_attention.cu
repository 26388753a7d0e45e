// Flash attention forward and backward for Hopper (sm_90a), fp32.
//
// Four entry points, each replacing one Pallas kernel of
// paddle_tpu/kernels/flash_attention.py:
//
//   flash_attention_fwd        _flash_fwd_kernel (online-softmax forward,
//                              writes out and the row logsumexp lse)
//   flash_attention_bwd_fused  _bwd_fused_kernel (dq, dk, dv from one pass
//                              over s/p/dp when both sequences fit one
//                              fused tile)
//   flash_attention_bwd_dq     _bwd_dq_kernel (dq, tiled over queries,
//                              scanning keys)
//   flash_attention_bwd_dkv    _bwd_dkv_kernel (dk and dv, tiled over keys,
//                              scanning queries; 3xTF32 tensor cores)
//
// Semantics (those of the Pallas kernels):
// - Layout by strides. q/k/v/out/dO/dq/dk/dv are read and written through
//   the (batch, time, head) strides the caller passes (the head dim is
//   contiguous), so [B, T, H, D] and [B, H, T, D] reach the kernels without
//   a copy. lse and delta are [B, H, Tq] contiguous.
// - s = q.k * scale + kv_bias[b, k]; key positions >= Tk, query positions
//   >= Tq and, when causal, keys past i + Tk - Tq (bottom-right aligned)
//   are masked. A masked entry gets probability exactly 0 (the TPU kernel
//   sets s = -1e30, which exponentiates to the same 0 whenever the row has
//   a visible key).
// - Dropout keep bits are the murmur3-finalizer hash of (seed, b*H + h,
//   q_pos, k_pos) with global, unpadded positions, bit for bit as
//   _dropout_keep writes it; keep = bits >= threshold. The forward sums
//   the UNDROPPED p into the denominator l, drops only the numerator and
//   scales the output by 1 / (1 - p). The backward uses
//   p_v = keep * p / (1 - p), dp = keep * dp / (1 - p),
//   ds = p * (dp - delta) * scale. The seed is read from device memory.
//
// What bounds them on the card: operations. At BERT's [8, 512, 12, 64] the
// forward does 4 * B*H * Tq*Tk * D = 6.4 GFLOP against ~50 MB moved (q, k,
// v, out), ~128 flops per byte, far above the ~20 where fp32 arithmetic
// outside the tensor cores (67 TFLOP/s, TF32 stays off for parity) takes
// over from 3.35 TB/s. The backward does 2.5x the forward's products. Every
// kernel keeps its score tiles on chip (O(T) device-memory traffic).
//
// The forward, dq and fused kernels run on the FMA units, fed from shared
// memory with 16-byte loads: a 64 x 64 score tile per 256-thread block,
// each thread owning a 4 x 4 micro-tile (rows ty + 16 i, columns tx + 16 j)
// so one float4 load of a row feeds four FMAs per operand, and rows are
// padded to D + 4 floats so a half-warp's row loads spread over all 32
// banks. A thread owns the same rows in the score tile and in the output
// tile, so the online-softmax state (m, l) and the rescale stay in
// registers; row reductions are shuffles across the 16 lanes that share a
// row.
//
// The dK/dV kernel runs its four products on the tensor cores in 3xTF32
// (tf32_mma.cuh: hi/lo tf32 splits, lo.hi + hi.lo + hi.hi, about fp32's
// accuracy at 165 TFLOP/s): S^T = K Q^T and dP^T = V dO^T (both operands
// K-major), then dV += Pv^T dO and dK += dS^T Q (dO and Q read MN-major,
// which wgmma's tf32 does not take, hence mma.sync with fragments loaded by
// hand). A block owns BK keys (64 up to D = 128, 32 at 256, 16 above) and
// keeps K, V and the dK, dV tiles (in registers) while it scans the query
// tiles of BQ rows (32 up to D = 256, 16 above) through a two-step
// cp.async ring of Q, dO, lse and delta: the next step's copies are in
// flight while the current one is computed on. Up to D = 64 two blocks
// share an SM (89 KB of shared memory, at most 128 registers), which hides
// more of the tensor cores' latency than one block with 64-row query
// tiles. Per step, S^T and dP^T sum 32 head-dim columns per fresh register
// tile, the softmax gradient (bias, causal mask, dropout) goes to shared
// Pv^T and dS^T tiles, and each step's dK/dV contribution is summed in
// fresh register tiles, then added with fp32 adds (the tensor cores' sums
// are not rounded to nearest; their error grows with the length of a sum).
// Each k-step loads and splits a warp's fragments first, then runs the
// lo.hi, hi.lo and hi.hi passes over its independent products. Shared
// rows of D + 4 floats keep the K-major fragment loads free of bank
// conflicts; the MN-major ones of phase 2 meet two-way conflicts.
//
// The TPU scans K/V blocks along a sequential grid axis with state in
// VMEM scratch. CUDA blocks run in no order, so each CUDA block owns one
// (batch*head, tile) and runs the scan as a loop inside the block. The
// fused backward holds one (batch, head) whole: Q, K, V, dO and a dQ
// accumulator of all its rows stay in shared memory (208 KB at D = 64),
// and 64 x 64 sub-tiles of s/p/dp are computed once each and feed dq, dk
// and dv together. Its row limit is the port's tile: 128 rows for
// D <= 64, 64 for D <= 128 (what 227 KB of shared memory holds); longer
// sequences take the dq and dkv kernels.
//
// Head dims: the kernels are instantiated for D = 16, 32, ..., 128 (every
// multiple of 16), 256, 384 and 512; the wrapper zero-pads any other
// D <= 512 to the next of these (zero columns leave q.k and the output
// unchanged; the scale stays 1/sqrt of the unpadded D). A head dim above
// 512 runs as n = ceil(D / 512) slices of an instantiated width Ds (the
// wrapper pads D to n * Ds): the grid gains a slice axis, and a block forms
// its scores (and dP) over the whole head dim, streaming q/k (dO/v) through
// its shared tiles one slice at a time with its own slice last, then
// writes only its slice of out, dq, dk or dv (lse by slice 0). At D <= 512
// there is one slice and nothing is streamed twice. In the SIMT kernels a
// thread owns C = D / 16 output columns, and the tiles shrink with D so
// that the dq kernel's four operand tiles fit 227 KB of shared memory: 64
// rows up to D = 128, 32 rows (2 x 2 micro-tiles per thread) at D = 256,
// 16 rows (one score entry per thread) at D = 384 and 512. The fused
// backward, which holds a whole (batch, head), is not built above D = 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 64;          // rows of a tile at D <= 128
constexpr int kThreads = 256;      // 16 x 16 threads per tile
constexpr float kNegInf = -1e30f;
constexpr uint32_t kGolden = 0x9E3779B9u;

// Rows of a q tile and of a k tile at head dim D (see the note above).
__host__ __device__ constexpr int tile_rows(int D) {
  return D > 256 ? 16 : D > 128 ? 32 : kTile;
}
// Padded row stride of a score tile of T columns.
__host__ __device__ constexpr int p_ld(int T) { return T + 4; }

struct Strides {
  long long b, t, h;
};

// Shape and strides of one call. Tensors: q, k, v, out, dO, dq, dk, dv.
struct Problem {
  int B, H, Tq, Tk, D;
  Strides q, k, v, o, dout, dq, dk, dv;
  float scale;
  int causal;
  float keep_prob;     // 1 - dropout_p, as the host computes it
  uint32_t threshold;  // min(int(p * 2^32), 2^32 - 1)
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Per-(batch*head) part of the dropout hash.
__device__ __forceinline__ uint32_t head_hash(const int* seed, int g) {
  return fmix32((uint32_t)seed[0] ^ fmix32((uint32_t)g + kGolden));
}

__device__ __forceinline__ uint32_t row_hash(uint32_t hh, int q_pos) {
  return fmix32((uint32_t)q_pos + hh);
}

__device__ __forceinline__ bool keep_bit(uint32_t u, int k_pos,
                                         uint32_t threshold) {
  return fmix32(u ^ ((uint32_t)k_pos * kGolden)) >= threshold;
}

// Reductions across the 16 lanes that share a tile row (tx = lane % 16).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C consecutive floats (C = D / 16: 1 to 8, 16, 24 or 32) at column tx * C:
// float4 loads when C % 4 == 0, float2 when C is even (the address is then
// 8-byte aligned), scalar loads otherwise.
template <int C>
__device__ __forceinline__ void load_c(const float* p, float (&r)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      r[c] = t.x; r[c + 1] = t.y; r[c + 2] = t.z; r[c + 3] = t.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + c);
      r[c] = t.x; r[c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = p[c];
  }
}

template <int C>
__device__ __forceinline__ void store_c(float* p, const float (&r)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(r[c], r[c + 1], r[c + 2], r[c + 3]);
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 2)
      *reinterpret_cast<float2*>(p + c) = make_float2(r[c], r[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = r[c];
  }
}

// Copy rows [row0, row0 + n_rows) of one head (D floats each, row stride
// `ts` in device memory) into shared rows of stride D + 4, times `mul`.
// Rows at or past `limit` are filled with 0.
template <int D>
__device__ void load_rows(float* dst, const float* src, long long ts,
                          int row0, int n_rows, int limit, float mul) {
  constexpr int V4 = D / 4;
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < n_rows * V4; idx += kThreads) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) {
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * ts + c);
      val.x *= mul; val.y *= mul; val.z *= mul; val.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// acc[i][j] += A[ra + 16 i] . B[rb + 16 j] over D, A and B shared tiles of
// row stride D + 4 (the MI x MI micro-tile of one thread).
template <int D, int MI>
__device__ __forceinline__ void dot_tile(float (&acc)[MI][MI], const float* A,
                                         int ra, const float* Bm, int rb) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[MI], b[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < MI; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (rb + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j)
        acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                     a[i].w * b[j].w;
  }
}

// out[i][c] += sum_k P[ra + 16 i][k] * M[k][col0 + c] over k < T = 16 MI,
// P a score tile (row stride p_ld(T)), M a shared tile of row stride D + 4.
template <int D, int MI>
__device__ __forceinline__ void acc_pm(float (&out)[MI][D / 16],
                                       const float* P, int ra,
                                       const float* M, int col0) {
  constexpr int C = D / 16;
  constexpr int LD = D + 4;
  constexpr int T = 16 * MI, PLD = p_ld(T);
#pragma unroll 2
  for (int kk = 0; kk < T; kk += 4) {
    float4 p[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ra + 16 * i) * PLD + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float m[C];
      load_c<C>(M + (kk + u) * LD + col0, m);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float pv = u == 0 ? p[i].x : u == 1 ? p[i].y
                         : u == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int c = 0; c < C; ++c) out[i][c] += pv * m[c];
      }
    }
  }
}

// out[i][c] += sum_k PT[k][ra + 16 i] * M[k][col0 + c]: the same product
// with the score tile stored transposed (the fused kernel's 64-row tiles).
template <int D>
__device__ __forceinline__ void acc_ptm(float (&out)[4][D / 16],
                                        const float* PT, int ra,
                                        const float* M, int col0) {
  constexpr int C = D / 16;
  constexpr int LD = D + 4;
  constexpr int PLD = p_ld(kTile);
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    float m[C];
    load_c<C>(M + kk * LD + col0, m);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pv = PT[kk * PLD + ra + 16 * i];
#pragma unroll
      for (int c = 0; c < C; ++c) out[i][c] += pv * m[c];
    }
  }
}

__device__ __forceinline__ bool visible(const Problem& P, int q_pos,
                                        int k_pos) {
  return q_pos < P.Tq && k_pos < P.Tk &&
         (!P.causal || q_pos + (P.Tk - P.Tq) >= k_pos);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Key tiles (of T rows) a query tile starting at q0 scans: all, or
// (causal) those up to its last row's last visible key, at least one (as
// the TPU kernel).
__device__ __forceinline__ int key_tiles(const Problem& P, int q0, int T) {
  const int num_k = (P.Tk + T - 1) / T;
  if (!P.causal) return num_k;
  const int upper = floor_div(q0 + T - 1 + P.Tk - P.Tq, T) + 1;
  return upper < 1 ? 1 : (upper > num_k ? num_k : upper);
}

// First query tile a key tile starting at k0 needs (causal), else 0.
__device__ __forceinline__ int first_query_tile(const Problem& P, int k0,
                                                int T) {
  const int num_q = (P.Tq + T - 1) / T;
  if (!P.causal) return 0;
  const int lower = floor_div(k0 - (P.Tk - P.Tq), T);
  return lower < 0 ? 0 : (lower > num_q ? num_q : lower);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Problem P, const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const int* __restrict__ seed, float* __restrict__ out,
                     float* __restrict__ lse) {
  constexpr int C = D / 16;
  constexpr int LD = D + 4;
  constexpr int T = tile_rows(D), MI = T / 16, PLD = p_ld(T);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + T * LD;
  float* Vs = Ks + T * LD;
  float* Ps = Vs + T * LD;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  const int q0 = blockIdx.x * T;
  // head-dim slices (P.D = nsl * D above 512): this block writes slice sl
  const int nsl = P.D / D, sl = blockIdx.z;
  const float* qb = q + b * P.q.b + h * P.q.h;
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* bias_row = bias ? bias + (long long)b * P.Tk : nullptr;

  // the TPU kernel scales q before the product; with one slice, q stays
  if (nsl == 1) load_rows<D>(Qs, qb, P.q.t, q0, T, P.Tq, P.scale);

  uint32_t u[MI] = {};
  if (seed) {
    const uint32_t hh = head_hash(seed, g);
#pragma unroll
    for (int i = 0; i < MI; ++i) u[i] = row_hash(hh, q0 + ty + 16 * i);
  }

  float m[MI], l[MI], acc[MI][C];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int upper = key_tiles(P, q0, T);
  for (int j = 0; j < upper; ++j) {
    const int k0 = j * T;
    float s[MI][MI] = {};
    // the scores over every slice of the head dim, this block's own slice
    // last, so V's slice and the output's columns are this block's
    for (int i = 1; i <= nsl; ++i) {
      const int c = (sl + i) % nsl * D;
      __syncthreads();  // the previous slice's or tile's K/V/P are consumed
      if (nsl > 1) load_rows<D>(Qs, qb + c, P.q.t, q0, T, P.Tq, P.scale);
      load_rows<D>(Ks, kb + c, P.k.t, k0, T, P.Tk, 1.f);
      if (i == nsl) load_rows<D>(Vs, vb + c, P.v.t, k0, T, P.Tk, 1.f);
      __syncthreads();
      dot_tile<D, MI>(s, Qs, ty, Ks, tx);
    }

    float bj[MI];
#pragma unroll
    for (int jj = 0; jj < MI; ++jj) {
      const int kp = k0 + tx + 16 * jj;
      bj[jj] = (bias_row && kp < P.Tk) ? bias_row[kp] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[MI];
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < MI; ++jj) {
        ok[jj] = visible(P, qp, k0 + tx + 16 * jj);
        s[i][jj] = ok[jj] ? s[i][jj] + bj[jj] : kNegInf;
        mt = fmaxf(mt, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < MI; ++jj) {
        float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        ps += p;
        if (seed && !keep_bit(u[i], k0 + tx + 16 * jj, P.threshold))
          p = 0.f;
        Ps[(ty + 16 * i) * PLD + tx + 16 * jj] = p;
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    acc_pm<D, MI>(acc, Ps, ty, Vs, tx * C);
  }

  float* ob = out + b * P.o.b + h * P.o.h + sl * D;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= P.Tq) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    float o[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      o[c] = acc[i][c] / safe_l;
      if (seed) o[c] = o[c] / P.keep_prob;
    }
    store_c<C>(ob + qp * P.o.t + tx * C, o);
    if (tx == 0 && sl == 0)
      lse[(long long)g * P.Tq + qp] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// backward: shared score-tile math
// ---------------------------------------------------------------------------

// One thread's MI x MI entries of the transposed tiles p_v^T and ds^T for
// key rows k0 + ty + 16 i and query columns q0 + tx + 16 j, given
// sT = K.Q (unscaled) and dpT = V.dO. lse/delta are the query tile's
// (shared, indexed by local column). Stores into PvT and dST (row stride
// p_ld(16 MI)).
template <int MI>
__device__ __forceinline__ void grad_core_t(
    const Problem& P, const float (&sT)[MI][MI], const float (&dpT)[MI][MI],
    const float (&bk)[MI], const float* lse_s, const float* delta_s,
    const int* seed, uint32_t hh, int q0, int k0, int ty, int tx,
    float* PvT, float* dST) {
  constexpr int PLD = p_ld(16 * MI);
#pragma unroll
  for (int jj = 0; jj < MI; ++jj) {
    const int ql = tx + 16 * jj, qp = q0 + ql;
    const float lq = lse_s[ql], dq = delta_s[ql];
    const uint32_t u = seed ? row_hash(hh, qp) : 0u;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int kl = ty + 16 * i, kp = k0 + kl;
      const float sv = sT[i][jj] * P.scale + bk[i];
      const float p = visible(P, qp, kp) ? expf(sv - lq) : 0.f;
      float pv = p, dp = dpT[i][jj];
      if (seed) {
        const bool keep = keep_bit(u, kp, P.threshold);
        pv = keep ? p / P.keep_prob : 0.f;
        dp = keep ? dp / P.keep_prob : 0.f;
      }
      PvT[kl * PLD + ql] = pv;
      dST[kl * PLD + ql] = p * (dp - dq) * P.scale;
    }
  }
}

// lse and delta of query rows [q0, q0 + n) into shared memory (0 past Tq).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lse,
                                               const float* delta,
                                               const Problem& P, int g,
                                               int q0, int n) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const bool in = q0 + r < P.Tq;
    const long long at = (long long)g * P.Tq + q0 + r;
    lse_s[r] = in ? lse[at] : 0.f;
    delta_s[r] = in ? delta[at] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward: dq (query tile per block, scanning key tiles)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(Problem P, const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        const int* __restrict__ seed,
                        float* __restrict__ dq) {
  constexpr int C = D / 16;
  constexpr int LD = D + 4;
  constexpr int T = tile_rows(D), MI = T / 16, PLD = p_ld(T);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + T * LD;
  float* Ks = dOs + T * LD;
  float* Vs = Ks + T * LD;
  float* dSs = Vs + T * LD;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  const int q0 = blockIdx.x * T;
  // head-dim slices (P.D = nsl * D above 512): this block writes slice sl
  const int nsl = P.D / D, sl = blockIdx.z;
  const float* qb = q + b * P.q.b + h * P.q.h;
  const float* ob = dout + b * P.dout.b + h * P.dout.h;
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* bias_row = bias ? bias + (long long)b * P.Tk : nullptr;

  if (nsl == 1) {
    load_rows<D>(Qs, qb, P.q.t, q0, T, P.Tq, 1.f);
    load_rows<D>(dOs, ob, P.dout.t, q0, T, P.Tq, 1.f);
  }
  float lq[MI], dlt[MI];
  uint32_t u[MI] = {};
  const uint32_t hh = seed ? head_hash(seed, g) : 0u;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int qp = q0 + ty + 16 * i;
    const bool in = qp < P.Tq;
    lq[i] = in ? lse[(long long)g * P.Tq + qp] : 0.f;
    dlt[i] = in ? delta[(long long)g * P.Tq + qp] : 0.f;
    if (seed) u[i] = row_hash(hh, qp);
  }

  float acc[MI][C];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  const int upper = key_tiles(P, q0, T);
  for (int j = 0; j < upper; ++j) {
    const int k0 = j * T;
    float s[MI][MI] = {}, dp[MI][MI] = {};
    // s and dp over every slice of the head dim, this block's own slice
    // last, so K's slice is the one dq's columns need
    for (int i = 1; i <= nsl; ++i) {
      const int c = (sl + i) % nsl * D;
      __syncthreads();
      if (nsl > 1) {
        load_rows<D>(Qs, qb + c, P.q.t, q0, T, P.Tq, 1.f);
        load_rows<D>(dOs, ob + c, P.dout.t, q0, T, P.Tq, 1.f);
      }
      load_rows<D>(Ks, kb + c, P.k.t, k0, T, P.Tk, 1.f);
      load_rows<D>(Vs, vb + c, P.v.t, k0, T, P.Tk, 1.f);
      __syncthreads();
      dot_tile<D, MI>(s, Qs, ty, Ks, tx);
      dot_tile<D, MI>(dp, dOs, ty, Vs, tx);
    }
#pragma unroll
    for (int jj = 0; jj < MI; ++jj) {
      const int kp = k0 + tx + 16 * jj;
      const float bk = (bias_row && kp < P.Tk) ? bias_row[kp] : 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int qp = q0 + ty + 16 * i;
        const float sv = s[i][jj] * P.scale + bk;
        const float p = visible(P, qp, kp) ? expf(sv - lq[i]) : 0.f;
        float d = dp[i][jj];
        if (seed)
          d = keep_bit(u[i], kp, P.threshold) ? d / P.keep_prob : 0.f;
        dSs[(ty + 16 * i) * PLD + tx + 16 * jj] =
            p * (d - dlt[i]) * P.scale;
      }
    }
    __syncthreads();
    acc_pm<D, MI>(acc, dSs, ty, Ks, tx * C);
  }

  float* db = dq + b * P.dq.b + h * P.dq.h + sl * D;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < P.Tq) store_c<C>(db + qp * P.dq.t + tx * C, acc[i]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv (key tile per block, scanning query tiles), 3xTF32
// ---------------------------------------------------------------------------

// Tiles of the dK/dV kernel at head-dim slice D (see the note above): BK key
// rows per block (what the dK and dV register tiles hold), BQ query rows
// per step of the scan, two steps in flight; up to D = 64 two blocks share
// an SM (89 KB of shared memory and at most 128 registers each), above
// one. Phase 1 (S^T = K Q^T and dP^T = V dO^T, [BK x BQ]): W1 warps, each
// one 16-row fragment row x NT1 fragment columns. Phase 2 (dV += Pv^T dO,
// dK += dS^T Q, [BK x D]): 8 warps, warp w owning fragment row w % MT and
// the NJ fragment columns w / MT + NG j.
template <int D>
struct DkvCfg {
  static constexpr int BK = D <= 128 ? 64 : D <= 256 ? 32 : 16;
  static constexpr int BQ = D <= 256 ? 32 : 16;
  static constexpr int kBlocks = D <= 64 ? 2 : 1;  // per SM
  static constexpr int LD = D + 4;    // K, V, Q, dO rows (K-major banks)
  static constexpr int LDP = BQ + 4;  // Pv^T and dS^T rows
  static constexpr int MT = BK / 16;
  static constexpr int T1 = MT * (BQ / 8);  // phase 1's 16 x 8 fragments
  static constexpr int NT1 = T1 >= 8 ? T1 / 8 : 1;
  static constexpr int W1 = T1 / NT1;
  static constexpr int NG = 8 / MT;
  static constexpr int NJ = D / 8 / NG;
  static constexpr int KV = 2 * BK * LD;          // K and V
  static constexpr int QS = 2 * BQ * LD + 2 * BQ;  // a step: Q, dO, lse, delta
  static constexpr size_t kSmem =
      (size_t)(KV + 2 * QS + 2 * BK * LDP) * sizeof(float);
  static_assert(W1 <= 8 && NJ * NG * 8 == D, "warp tiling");
};

// Rows [row0, row0 + R) of one head (D floats each, row stride ts) into
// shared rows of stride D + 4 by cp.async; rows at or past limit are
// zero-filled.
template <int R, int D>
__device__ __forceinline__ void cp_rows(float* dst, const float* src,
                                        long long ts, int row0, int limit) {
  constexpr int V4 = D / 4, LD = D + 4;
  for (int idx = threadIdx.x; idx < R * V4; idx += kThreads) {
    const int r = idx / V4, c = (idx % V4) * 4;
    const bool ok = row0 + r < limit;
    tf32::cp_async16(dst + r * LD + c, ok ? src + (row0 + r) * ts + c : src,
                     ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, DkvCfg<D>::kBlocks)
    flash_bwd_dkv_kernel(Problem P, const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias,
                         const int* __restrict__ seed,
                         float* __restrict__ dk, float* __restrict__ dv) {
  using Cfg = DkvCfg<D>;
  constexpr int BK = Cfg::BK, BQ = Cfg::BQ, LD = Cfg::LD, LDP = Cfg::LDP;
  constexpr int MT = Cfg::MT, NT1 = Cfg::NT1, NG = Cfg::NG, NJ = Cfg::NJ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* ring = Vs + BK * LD;  // 2 steps of Q, dO, lse, delta
  float* PvT = ring + 2 * Cfg::QS;
  float* dST = PvT + BK * LDP;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  const int k0 = blockIdx.x * BK;
  // head-dim slices (P.D = nsl * D above 512): this block writes slice sl
  const int nsl = P.D / D, sl = blockIdx.z;
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* qb = q + b * P.q.b + h * P.q.h;
  const float* ob = dout + b * P.dout.b + h * P.dout.h;
  const uint32_t hh = seed ? head_hash(seed, g) : 0u;
  const float inv_keep = 1.f / P.keep_prob;

  // K, V (slice c) and step `st`'s Q, dO (slice c), lse and delta
  auto load_kv = [&](int c) {
    cp_rows<BK, D>(Ks, kb + c, P.k.t, k0, P.Tk);
    cp_rows<BK, D>(Vs, vb + c, P.v.t, k0, P.Tk);
  };
  auto load_q = [&](int st, int q0, int c) {
    float* Qs = ring + st * Cfg::QS;
    cp_rows<BQ, D>(Qs, qb + c, P.q.t, q0, P.Tq);
    cp_rows<BQ, D>(Qs + BQ * LD, ob + c, P.dout.t, q0, P.Tq);
    float* st_s = Qs + 2 * BQ * LD;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool ok = q0 + r < P.Tq;
      const long long at = (long long)g * P.Tq + q0 + r;
      tf32::cp_async4(st_s + r, ok ? lse + at : lse, ok);
      tf32::cp_async4(st_s + BQ + r, ok ? delta + at : delta, ok);
    }
  };

  // phase 1: warp < W1 owns key rows m1 .. m1 + 15, query columns n1 ..
  // n1 + 8 NT1 - 1 of the step's tiles
  const bool p1 = warp < Cfg::W1;
  const int m1 = (warp % MT) * 16, n1 = (warp / MT) * NT1 * 8;
  float bk[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = k0 + m1 + gid + 8 * half;
    bk[half] = (bias && kp < P.Tk) ? bias[(long long)b * P.Tk + kp] : 0.f;
  }
  // phase 2: key rows m2 .. m2 + 15, head-dim columns 8 (ng + NG j) ..
  const int m2 = (warp % MT) * 16, ng = warp / MT;
  float dka[NJ][4], dva[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int num_q = (P.Tq + BQ - 1) / BQ;
  const int iq0 = first_query_tile(P, k0, BQ);
  // one slice: K and V stay, the query tiles stream through a 2-step
  // cp.async ring; several: every (query tile, slice) step reloads all four
  // operands (the buffers hold one slice), this block's own slice last so
  // that phase 2 finds its Q and dO columns in place
  const bool ring2 = nsl == 1;
  if (ring2 && iq0 < num_q) {
    load_kv(0);
    load_q(0, iq0 * BQ, 0);
    tf32::cp_async_commit();
  }
  for (int iq = iq0; iq < num_q; ++iq) {
    const int q0 = iq * BQ;
    int st = 0;
    float sT[NT1][4], dpT[NT1][4];
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    for (int i = 1; i <= nsl; ++i) {
      if (ring2) {
        // the other step's buffers were consumed before the last barrier
        st = (iq - iq0) & 1;
        if (iq + 1 < num_q) load_q(st ^ 1, q0 + BQ, 0);
        tf32::cp_async_commit();
        tf32::cp_async_wait<1>();
      } else {
        const int c = (sl + i) % nsl * D;
        __syncthreads();  // the previous slice's operands are consumed
        load_kv(c);
        load_q(0, q0, c);
        tf32::cp_async_commit();
        tf32::cp_async_wait<0>();
      }
      __syncthreads();
      if (!p1) continue;
      const float* Qs = ring + st * Cfg::QS;
      const float* dOs = Qs + BQ * LD;
      // S^T and dP^T over this slice, 32 columns of the head dim per fresh
      // register tile
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += 32) {
        float ps[NT1][4], pd[NT1][4];
#pragma unroll
        for (int j = 0; j < NT1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ps[j][e] = pd[j][e] = 0.f;
#pragma unroll
        for (int kk = d0; kk < d0 + 32; kk += 8) {
          if (kk >= D) break;  // D = 16, 48, 80, 112: a half stage
          uint32_t kh[4], kl[4], vh[4], vl[4];
          uint32_t qh[NT1][2], ql[NT1][2], oh[NT1][2], ol[NT1][2];
          tf32::frag_a<true, LD>(Ks, m1, kk, kh, kl);
          tf32::frag_a<true, LD>(Vs, m1, kk, vh, vl);
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            tf32::frag_b<true, LD>(Qs, n1 + 8 * j, kk, qh[j], ql[j]);
            tf32::frag_b<true, LD>(dOs, n1 + 8 * j, kk, oh[j], ol[j]);
          }
          // each pass runs 2 NT1 independent products: small terms first
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            tf32::mma(ps[j], kl, qh[j]);
            tf32::mma(pd[j], vl, oh[j]);
          }
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            tf32::mma(ps[j], kh, ql[j]);
            tf32::mma(pd[j], vh, ol[j]);
          }
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            tf32::mma(ps[j], kh, qh[j]);
            tf32::mma(pd[j], vh, oh[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sT[j][e] += ps[j][e];
            dpT[j][e] += pd[j][e];
          }
      }
    }
    const float* Qs = ring + st * Cfg::QS;
    const float* dOs = Qs + BQ * LD;
    if (p1) {
      // Pv^T and dS^T of the warp's entries: key rows m1 + gid (+ 8),
      // query columns n1 + 8 j + 2 tig (+ 1)
      const float* lse_s = Qs + 2 * BQ * LD;
      const float* delta_s = lse_s + BQ;
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = n1 + 8 * j + 2 * tig + e, qp = q0 + ql;
          const float lq = lse_s[ql], dq = delta_s[ql];
          const uint32_t u = seed ? row_hash(hh, qp) : 0u;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kl = m1 + gid + 8 * half, kp = k0 + kl;
            const float sv = sT[j][2 * half + e] * P.scale + bk[half];
            const float p = visible(P, qp, kp) ? expf(sv - lq) : 0.f;
            float pv = p, dp = dpT[j][2 * half + e];
            if (seed) {
              const bool keep = keep_bit(u, kp, P.threshold);
              pv = keep ? p * inv_keep : 0.f;
              dp = keep ? dp * inv_keep : 0.f;
            }
            PvT[kl * LDP + ql] = pv;
            dST[kl * LDP + ql] = p * (dp - dq) * P.scale;
          }
        }
    }
    __syncthreads();
    // dV += Pv^T dO and dK += dS^T Q over the step's BQ queries, into fresh
    // register tiles added with fp32 adds
    float pk[NJ][4], pv[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pk[j][e] = pv[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 8) {
      uint32_t ph[4], pl[4], sh[4], sl4[4];
      tf32::frag_a<true, LDP>(PvT, m2, kk, ph, pl);
      tf32::frag_a<true, LDP>(dST, m2, kk, sh, sl4);
      // two fragment columns at a time (the last alone where NJ is odd),
      // each pass over up to 4 independent products: small terms first
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += 2) {
        constexpr int W = 2;
        uint32_t oh[W][2], ol[W][2], qh[W][2], ql[W][2];
#pragma unroll
        for (int u = 0; u < W; ++u) {
          if (j0 + u >= NJ) continue;
          const int n = (ng + NG * (j0 + u)) * 8;
          tf32::frag_b<false, LD>(dOs, n, kk, oh[u], ol[u]);
          tf32::frag_b<false, LD>(Qs, n, kk, qh[u], ql[u]);
        }
#pragma unroll
        for (int u = 0; u < W; ++u) {
          if (j0 + u >= NJ) continue;
          tf32::mma(pv[j0 + u], pl, oh[u]);
          tf32::mma(pk[j0 + u], sl4, qh[u]);
        }
#pragma unroll
        for (int u = 0; u < W; ++u) {
          if (j0 + u >= NJ) continue;
          tf32::mma(pv[j0 + u], ph, ol[u]);
          tf32::mma(pk[j0 + u], sh, ql[u]);
        }
#pragma unroll
        for (int u = 0; u < W; ++u) {
          if (j0 + u >= NJ) continue;
          tf32::mma(pv[j0 + u], ph, oh[u]);
          tf32::mma(pk[j0 + u], sh, qh[u]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dka[j][e] += pk[j][e];
        dva[j][e] += pv[j][e];
      }
    __syncthreads();  // Pv^T, dS^T and this step's ring slot are consumed
  }

  float* dkb = dk + b * P.dk.b + h * P.dk.h + sl * D;
  float* dvb = dv + b * P.dv.b + h * P.dv.h + sl * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = k0 + m2 + gid + 8 * half;
    if (kp >= P.Tk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = (ng + NG * j) * 8 + 2 * tig;
      *reinterpret_cast<float2*>(dkb + kp * P.dk.t + c) =
          make_float2(dka[j][2 * half], dka[j][2 * half + 1]);
      *reinterpret_cast<float2*>(dvb + kp * P.dv.t + c) =
          make_float2(dva[j][2 * half], dva[j][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: fused dq, dk, dv for one whole (batch, head) of <= NT tiles
// ---------------------------------------------------------------------------

template <int D, int NT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_fused_kernel(Problem P, const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           const int* __restrict__ seed,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv) {
  constexpr int C = D / 16;
  constexpr int LD = D + 4;
  constexpr int R = NT * kTile;
  constexpr int PLD = p_ld(kTile);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + R * LD;
  float* Ks = dOs + R * LD;
  float* Vs = Ks + R * LD;
  float* PvT = Vs + R * LD;
  float* dST = PvT + kTile * PLD;
  float* dQs = dST + kTile * PLD;  // [R][D]
  float* lse_s = dQs + R * D;
  float* delta_s = lse_s + R;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  load_rows<D>(Qs, q + b * P.q.b + h * P.q.h, P.q.t, 0, R, P.Tq, 1.f);
  load_rows<D>(dOs, dout + b * P.dout.b + h * P.dout.h, P.dout.t, 0, R,
               P.Tq, 1.f);
  load_rows<D>(Ks, k + b * P.k.b + h * P.k.h, P.k.t, 0, R, P.Tk, 1.f);
  load_rows<D>(Vs, v + b * P.v.b + h * P.v.h, P.v.t, 0, R, P.Tk, 1.f);
  load_row_stats(lse_s, delta_s, lse, delta, P, g, 0, R);
  for (int i = threadIdx.x; i < R * D; i += kThreads) dQs[i] = 0.f;
  const uint32_t hh = seed ? head_hash(seed, g) : 0u;
  __syncthreads();

  for (int kj = 0; kj < NT && kj * kTile < P.Tk; ++kj) {
    const int k0 = kj * kTile;
    const float* Kt = Ks + k0 * LD;
    const float* Vt = Vs + k0 * LD;
    float bk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty + 16 * i;
      bk[i] = (bias && kp < P.Tk) ? bias[(long long)b * P.Tk + kp] : 0.f;
    }
    float dka[4][C], dva[4][C];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) dka[i][c] = dva[i][c] = 0.f;

    for (int qi = 0; qi < NT && qi * kTile < P.Tq; ++qi) {
      const int q0 = qi * kTile;
      // a causal query tile that ends before this key tile sees none of it
      if (P.causal && q0 + kTile - 1 + (P.Tk - P.Tq) < k0) continue;
      const float* Qt = Qs + q0 * LD;
      const float* dOt = dOs + q0 * LD;
      float sT[4][4] = {}, dpT[4][4] = {};
      dot_tile<D, 4>(sT, Kt, ty, Qt, tx);
      dot_tile<D, 4>(dpT, Vt, ty, dOt, tx);
      grad_core_t<4>(P, sT, dpT, bk, lse_s + q0, delta_s + q0, seed, hh, q0,
                     k0, ty, tx, PvT, dST);
      __syncthreads();
      acc_pm<D, 4>(dva, PvT, ty, dOt, tx * C);
      acc_pm<D, 4>(dka, dST, ty, Qt, tx * C);
      // dq rows q0 + ty + 16 i: sum over this key tile of ds * K; each
      // thread owns its rows and columns of the accumulator
      float dqa[4][C];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) dqa[i][c] = 0.f;
      acc_ptm<D>(dqa, dST, ty, Kt, tx * C);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c)
          dQs[(q0 + ty + 16 * i) * D + tx * C + c] += dqa[i][c];
      __syncthreads();  // PvT/dST are rewritten by the next sub-tile
    }

    float* dkb = dk + b * P.dk.b + h * P.dk.h;
    float* dvb = dv + b * P.dv.b + h * P.dv.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty + 16 * i;
      if (kp >= P.Tk) continue;
      store_c<C>(dkb + kp * P.dk.t + tx * C, dka[i]);
      store_c<C>(dvb + kp * P.dv.t + tx * C, dva[i]);
    }
  }

  // every thread wrote only its own accumulator entries; no barrier needed
  // before reading them back in the same ownership
  float* dqb = dq + b * P.dq.b + h * P.dq.h;
  for (int qi = 0; qi < NT; ++qi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qi * kTile + ty + 16 * i;
      if (qp >= P.Tq) continue;
      float r[C];
      load_c<C>(dQs + qp * D + tx * C, r);
      store_c<C>(dqb + qp * P.dq.t + tx * C, r);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// dims: B, H, Tq, Tk, D, then (b, t, h) strides of q, k, v, out, dO, dq,
// dk, dv (24 values).
bool make_problem(const long long* dims, float scale, int causal,
                  float keep_prob, unsigned int threshold, Problem* P) {
  P->B = (int)dims[0]; P->H = (int)dims[1]; P->Tq = (int)dims[2];
  P->Tk = (int)dims[3]; P->D = (int)dims[4];
  Strides* s[8] = {&P->q, &P->k, &P->v, &P->o,
                   &P->dout, &P->dq, &P->dk, &P->dv};
  for (int i = 0; i < 8; ++i) {
    s[i]->b = dims[5 + 3 * i];
    s[i]->t = dims[6 + 3 * i];
    s[i]->h = dims[7 + 3 * i];
  }
  P->scale = scale;
  P->causal = causal;
  P->keep_prob = keep_prob;
  P->threshold = threshold;
  return P->B > 0 && P->H > 0 && P->Tq > 0 && P->Tk > 0;
}

// Refuse what the grid cannot express (B * H blocks along y).
bool too_many_heads(const Problem& P) {
  return (long long)P.B * P.H > 65535;
}

// Head-dim slices of a call: one up to 512 (the widest instantiation),
// else ceil(D / 512) slices of D / slices columns each, which must be a
// head dim the kernels are built for (kernels/flash_attention.py
// head_dim_plan makes it so). 0 when D cannot be sliced so.
int slices(int D) {
  const int n = (D + 511) / 512;
  return D % n == 0 ? n : 0;
}

// One block per (query tile, batch * head, head-dim slice).
dim3 q_grid(const Problem& P, int D) {
  const int T = tile_rows(D);
  return dim3((P.Tq + T - 1) / T, P.B * P.H, P.D / D);
}

// Dynamic shared memory of the SIMT kernels, in bytes: at most 208 KB
// (the fused kernel at D = 64); at D = 256 fwd 104 KB, dq 138 KB; at
// D = 512 fwd 98 KB, dq 130 KB. The dK/dV kernel's is DkvCfg::kSmem: 89
// KB at D = 64, 154 KB at 128, 209 KB at 256, 201 KB at 512.
constexpr size_t fwd_smem(int D) {
  return (size_t)(3 * tile_rows(D) * (D + 4) +
                  tile_rows(D) * p_ld(tile_rows(D))) * sizeof(float);
}
constexpr size_t dq_smem(int D) {
  return (size_t)(4 * tile_rows(D) * (D + 4) +
                  tile_rows(D) * p_ld(tile_rows(D))) * sizeof(float);
}
constexpr size_t fused_smem(int D, int NT) {
  return (size_t)(4 * NT * kTile * (D + 4) + 2 * kTile * p_ld(kTile) +
                  NT * kTile * D + 2 * NT * kTile) *
         sizeof(float);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// per-kernel limit above the 48 KB default once.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, void* stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

// The fused kernel at D's row count (fused_rows below); not built for
// D > 128, whose whole (batch, head) does not fit shared memory.
template <int D>
cudaError_t launch_fused(dim3 grid, void* stream, const Problem& P,
                         const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, const float* bias,
                         const int* seed, float* dq, float* dk, float* dv) {
  if constexpr (D > 128) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int NT = D <= 64 ? 2 : 1;
    return launch(flash_bwd_fused_kernel<D, NT>, grid, fused_smem(D, NT),
                  stream, P, q, k, v, dout, lse, delta, bias, seed, dq, dk,
                  dv);
  }
}

// The head dims the kernels are built for (kernels/flash_attention.py
// HEAD_DIMS; the wrapper pads any other D <= 512 up to one of them, and a
// D above 512 to slices of one of them).
#define DISPATCH_D(D, ...)                                    \
  switch (D) {                                                \
    case 16: { constexpr int kD = 16; __VA_ARGS__; } break;   \
    case 32: { constexpr int kD = 32; __VA_ARGS__; } break;   \
    case 48: { constexpr int kD = 48; __VA_ARGS__; } break;   \
    case 64: { constexpr int kD = 64; __VA_ARGS__; } break;   \
    case 80: { constexpr int kD = 80; __VA_ARGS__; } break;   \
    case 96: { constexpr int kD = 96; __VA_ARGS__; } break;   \
    case 112: { constexpr int kD = 112; __VA_ARGS__; } break; \
    case 128: { constexpr int kD = 128; __VA_ARGS__; } break; \
    case 256: { constexpr int kD = 256; __VA_ARGS__; } break; \
    case 384: { constexpr int kD = 384; __VA_ARGS__; } break; \
    case 512: { constexpr int kD = 512; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;               \
  }

// Rows of one (batch, head) the fused backward holds whole: 128 for
// D <= 64, 64 for D <= 128, none above (kernels/flash_attention.py routes
// by the same rule, fused_rows()).
int fused_rows(int D) { return D <= 64 ? 2 * kTile : D <= 128 ? kTile : 0; }

}  // namespace

extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, const float* bias,
                                   const int* seed, float* out, float* lse,
                                   const long long* dims, float scale,
                                   int causal, float keep_prob,
                                   unsigned int threshold, void* stream) {
  Problem P;
  if (!make_problem(dims, scale, causal, keep_prob, threshold, &P))
    return (int)cudaGetLastError();
  const int n = slices(P.D);
  if (too_many_heads(P) || n == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D / n, err = launch(flash_fwd_kernel<kD>, q_grid(P, kD),
                                   fwd_smem(kD), stream, P, q, k, v, bias,
                                   seed, out, lse));
  return (int)err;
}

extern "C" int flash_attention_bwd_dq(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* lse, const float* delta,
                                      const float* bias, const int* seed,
                                      float* dq, const long long* dims,
                                      float scale, int causal,
                                      float keep_prob,
                                      unsigned int threshold, void* stream) {
  Problem P;
  if (!make_problem(dims, scale, causal, keep_prob, threshold, &P))
    return (int)cudaGetLastError();
  const int n = slices(P.D);
  if (too_many_heads(P) || n == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D / n, err = launch(flash_bwd_dq_kernel<kD>, q_grid(P, kD),
                                   dq_smem(kD), stream, P, q, k, v, dout,
                                   lse, delta, bias, seed, dq));
  return (int)err;
}

extern "C" int flash_attention_bwd_dkv(const float* q, const float* k,
                                       const float* v, const float* dout,
                                       const float* lse, const float* delta,
                                       const float* bias, const int* seed,
                                       float* dk, float* dv,
                                       const long long* dims, float scale,
                                       int causal, float keep_prob,
                                       unsigned int threshold, void* stream) {
  Problem P;
  if (!make_problem(dims, scale, causal, keep_prob, threshold, &P))
    return (int)cudaGetLastError();
  const int n = slices(P.D);
  if (too_many_heads(P) || n == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D / n, {
    constexpr int BK = DkvCfg<kD>::BK;
    err = launch(flash_bwd_dkv_kernel<kD>,
                 dim3((P.Tk + BK - 1) / BK, P.B * P.H, n),
                 DkvCfg<kD>::kSmem, stream, P, q, k, v, dout, lse, delta,
                 bias, seed, dk, dv);
  });
  return (int)err;
}

extern "C" int flash_attention_bwd_fused(const float* q, const float* k,
                                         const float* v, const float* dout,
                                         const float* lse,
                                         const float* delta,
                                         const float* bias, const int* seed,
                                         float* dq, float* dk, float* dv,
                                         const long long* dims, float scale,
                                         int causal, float keep_prob,
                                         unsigned int threshold,
                                         void* stream) {
  Problem P;
  if (!make_problem(dims, scale, causal, keep_prob, threshold, &P))
    return (int)cudaGetLastError();
  const int rows = fused_rows(P.D);
  if (rows == 0 || P.Tq > rows || P.Tk > rows || too_many_heads(P))
    return (int)cudaErrorInvalidValue;
  dim3 grid(1, P.B * P.H);
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D, err = launch_fused<kD>(grid, stream, P, q, k, v, dout,
                                         lse, delta, bias, seed, dq, dk,
                                         dv));
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
