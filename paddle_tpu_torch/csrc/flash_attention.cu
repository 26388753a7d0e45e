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
//                              scanning queries)
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
// over from 3.35 TB/s. The backward does 2.5x the forward's products. The
// design keeps every score tile on chip (O(T) device-memory traffic) and
// feeds the FMA units from shared memory with 16-byte loads: a 64 x 64
// score tile per 256-thread block, each thread owning a 4 x 4 micro-tile
// (rows ty + 16 i, columns tx + 16 j) so one float4 load of a row feeds
// four FMAs per operand, and rows are padded to D + 4 floats so a
// half-warp's row loads spread over all 32 banks. A thread owns the same
// rows in the score tile and in the output tile, so the online-softmax
// state (m, l) and the rescale stay in registers; row reductions are
// shuffles across the 16 lanes that share a row.
//
// The TPU scans K/V blocks along a sequential grid axis with state in
// VMEM scratch. CUDA blocks run in no order, so each CUDA block owns one
// (batch*head, tile) and runs the scan as a loop inside the block. The
// fused backward holds one (batch, head) whole: Q, K, V, dO and a dQ
// accumulator of all its rows stay in shared memory (208 KB at D = 64),
// and 64 x 64 sub-tiles of s/p/dp are computed once each and feed dq, dk
// and dv together. Its row limit is the port's tile: 128 rows for
// D <= 64, 64 for D <= 128 (what 227 KB of shared memory holds); longer
// sequences take the dq and dkv kernels. Simple first: no tensor cores,
// no cp.async/TMA pipelining yet.
//
// Head dims: the kernels are instantiated for D = 16, 32, ..., 128 (every
// multiple of 16), 256, 384 and 512; the wrapper zero-pads any other
// D <= 512 to the next of these (zero columns leave q.k and the output
// unchanged; the scale stays 1/sqrt of the unpadded D). A thread owns
// C = D / 16 output columns. The tiles shrink with D so that the dq and dkv
// kernels' four operand tiles fit 227 KB of shared memory: 64 rows up to
// D = 128, 32 rows (2 x 2 micro-tiles per thread) at D = 256 (64 would
// need 284-302 KB), 16 rows (one score entry per thread) at D = 384 and
// 512 (32 would need 269 KB for dq at D = 512). The fused backward, which
// holds a whole (batch, head), is not built above D = 128.

#include <cuda_runtime.h>
#include <stdint.h>

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
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* bias_row = bias ? bias + (long long)b * P.Tk : nullptr;

  // the TPU kernel scales q before the product
  load_rows<D>(Qs, q + b * P.q.b + h * P.q.h, P.q.t, q0, T, P.Tq, P.scale);

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
    __syncthreads();  // the previous tile's K/V/P are consumed
    load_rows<D>(Ks, kb, P.k.t, k0, T, P.Tk, 1.f);
    load_rows<D>(Vs, vb, P.v.t, k0, T, P.Tk, 1.f);
    __syncthreads();

    float s[MI][MI] = {};
    dot_tile<D, MI>(s, Qs, ty, Ks, tx);

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

  float* ob = out + b * P.o.b + h * P.o.h;
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
    if (tx == 0) lse[(long long)g * P.Tq + qp] = m[i] + logf(safe_l);
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
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* bias_row = bias ? bias + (long long)b * P.Tk : nullptr;

  load_rows<D>(Qs, q + b * P.q.b + h * P.q.h, P.q.t, q0, T, P.Tq, 1.f);
  load_rows<D>(dOs, dout + b * P.dout.b + h * P.dout.h, P.dout.t, q0, T,
               P.Tq, 1.f);
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
    __syncthreads();
    load_rows<D>(Ks, kb, P.k.t, k0, T, P.Tk, 1.f);
    load_rows<D>(Vs, vb, P.v.t, k0, T, P.Tk, 1.f);
    __syncthreads();

    float s[MI][MI] = {}, dp[MI][MI] = {};
    dot_tile<D, MI>(s, Qs, ty, Ks, tx);
    dot_tile<D, MI>(dp, dOs, ty, Vs, tx);
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

  float* db = dq + b * P.dq.b + h * P.dq.h;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < P.Tq) store_c<C>(db + qp * P.dq.t + tx * C, acc[i]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv (key tile per block, scanning query tiles)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(Problem P, const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias,
                         const int* __restrict__ seed,
                         float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int C = D / 16;
  constexpr int LD = D + 4;
  constexpr int T = tile_rows(D), MI = T / 16, PLD = p_ld(T);
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* dOs = Qs + T * LD;
  float* PvT = dOs + T * LD;
  float* dST = PvT + T * PLD;
  float* lse_s = dST + T * PLD;
  float* delta_s = lse_s + T;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  const int k0 = blockIdx.x * T;
  const float* qb = q + b * P.q.b + h * P.q.h;
  const float* ob = dout + b * P.dout.b + h * P.dout.h;

  load_rows<D>(Ks, k + b * P.k.b + h * P.k.h, P.k.t, k0, T, P.Tk, 1.f);
  load_rows<D>(Vs, v + b * P.v.b + h * P.v.h, P.v.t, k0, T, P.Tk, 1.f);
  float bk[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int kp = k0 + ty + 16 * i;
    bk[i] = (bias && kp < P.Tk) ? bias[(long long)b * P.Tk + kp] : 0.f;
  }
  const uint32_t hh = seed ? head_hash(seed, g) : 0u;

  float dka[MI][C], dva[MI][C];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int num_q = (P.Tq + T - 1) / T;
  for (int iq = first_query_tile(P, k0, T); iq < num_q; ++iq) {
    const int q0 = iq * T;
    __syncthreads();
    load_rows<D>(Qs, qb, P.q.t, q0, T, P.Tq, 1.f);
    load_rows<D>(dOs, ob, P.dout.t, q0, T, P.Tq, 1.f);
    load_row_stats(lse_s, delta_s, lse, delta, P, g, q0, T);
    __syncthreads();

    float sT[MI][MI] = {}, dpT[MI][MI] = {};
    dot_tile<D, MI>(sT, Ks, ty, Qs, tx);
    dot_tile<D, MI>(dpT, Vs, ty, dOs, tx);
    grad_core_t<MI>(P, sT, dpT, bk, lse_s, delta_s, seed, hh, q0, k0, ty,
                    tx, PvT, dST);
    __syncthreads();
    acc_pm<D, MI>(dva, PvT, ty, dOs, tx * C);
    acc_pm<D, MI>(dka, dST, ty, Qs, tx * C);
  }

  float* dkb = dk + b * P.dk.b + h * P.dk.h;
  float* dvb = dv + b * P.dv.b + h * P.dv.h;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= P.Tk) continue;
    store_c<C>(dkb + kp * P.dk.t + tx * C, dka[i]);
    store_c<C>(dvb + kp * P.dv.t + tx * C, dva[i]);
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

// One block per (query tile, batch * head).
dim3 q_grid(const Problem& P, int D) {
  const int T = tile_rows(D);
  return dim3((P.Tq + T - 1) / T, P.B * P.H);
}

// Dynamic shared memory of each kernel, in bytes: at most 208 KB (the
// fused kernel at D = 64); at D = 256 fwd 104 KB, dq 138 KB, dkv 143 KB;
// at D = 512 fwd 98 KB, dq 130 KB, dkv 132 KB.
constexpr size_t fwd_smem(int D) {
  return (size_t)(3 * tile_rows(D) * (D + 4) +
                  tile_rows(D) * p_ld(tile_rows(D))) * sizeof(float);
}
constexpr size_t dq_smem(int D) {
  return (size_t)(4 * tile_rows(D) * (D + 4) +
                  tile_rows(D) * p_ld(tile_rows(D))) * sizeof(float);
}
constexpr size_t dkv_smem(int D) {
  return (size_t)(4 * tile_rows(D) * (D + 4) +
                  2 * tile_rows(D) * p_ld(tile_rows(D)) +
                  2 * tile_rows(D)) * sizeof(float);
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
// HEAD_DIMS; the wrapper pads any other D <= 512 up to one of them).
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
  if (too_many_heads(P)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D, err = launch(flash_fwd_kernel<kD>, q_grid(P, kD),
                               fwd_smem(kD), stream, P, q, k, v, bias, seed,
                               out, lse));
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
  if (too_many_heads(P)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D, err = launch(flash_bwd_dq_kernel<kD>, q_grid(P, kD),
                               dq_smem(kD), stream, P, q, k, v, dout, lse,
                               delta, bias, seed, dq));
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
  if (too_many_heads(P)) return (int)cudaErrorInvalidValue;
  const int T = tile_rows(P.D);
  dim3 grid((P.Tk + T - 1) / T, P.B * P.H);
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D, err = launch(flash_bwd_dkv_kernel<kD>, grid,
                               dkv_smem(kD), stream, P, q, k, v, dout, lse,
                               delta, bias, seed, dk, dv));
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
