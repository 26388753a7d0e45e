// Flash attention forward and backward for Hopper (sm_90a), fp32.
//
// Four entry points, each replacing one Pallas kernel of
// paddle_tpu/kernels/flash_attention.py:
//
//   flash_attention_fwd        _flash_fwd_kernel (online-softmax forward,
//                              writes out and the row logsumexp lse;
//                              3xTF32 tensor cores up to D = 128)
//   flash_attention_bwd_fused  _bwd_fused_kernel (dq, dk, dv from one pass
//                              over s/p/dp when both sequences fit one
//                              fused tile; 3xTF32 tensor cores)
//   flash_attention_bwd_dq     _bwd_dq_kernel (dq, tiled over queries,
//                              scanning keys; 3xTF32 up to D = 128)
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
// v, out), ~128 flops per byte; the backward does 2.5x the forward's
// products. Every kernel keeps its score tiles on chip (O(T) device-memory
// traffic). TF32 stays off for parity, so a product runs either on the FMA
// units in fp32 (67 TFLOP/s) or on the tensor cores in 3xTF32 (tf32_mma.cuh:
// hi/lo tf32 splits, lo.hi + hi.lo + hi.hi, about fp32's accuracy at 165
// TFLOP/s).
//
// The forward and dq kernels up to D = 128 run on the tensor cores in
// 3xTF32 mma.sync. A block owns BQ = 128 query rows, 16 per warp, resident
// in shared memory (the forward's Q scaled by `scale` first, as the TPU
// kernel; dq's Q and dO), and scans key tiles of 32 rows through a two-step
// cp.async ring of K and V: the next tile's copies are in flight while the
// current one is computed on. Up to D = 64 two blocks share an SM (68 KB
// and 102 KB of shared memory, at most 128 registers), which hides more
// latency than one block with 64-key tiles (measured on an H100). A warp
// forms its 16 x BK scores S = Q K^T (and dq's dP = dO V^T) with both operands
// K-major, 32 head-dim columns per fresh register tile added with fp32 adds
// (the tensor cores' sums are not rounded to nearest; their error grows
// with the length of a sum). Each warp owns its rows across the whole key
// tile, so the online softmax (m, l, alpha) or dq's dS = p (dp keep / (1 -
// p) - delta) scale lives in registers in the accumulator fragment layout,
// and a row's max and sum take only the 4-lane quad shuffle. That fragment
// is then the A operand of O += P V (dQ += dS K) as it stands: the product
// reads V (K) MN-major in a permuted key order (tf32::frag_b_pairs), so P
// and dS never go through shared memory. Four 8-column output fragments at
// a time sum the tile's BK keys in a fresh register tile, added into the
// accumulator (the forward's scaled by alpha). A warp whose rows all mask a
// key tile (causal) skips its products: they would add exactly 0; a tile
// that no mask reaches (edge_tile) skips the per-entry mask. exp is the
// hardware's ex2.approx (__expf: at most 2 + 1.16 |x| ulps, so for the
// x <= 0 it takes here at most ~2.4e-7 absolute on p, within the checks'
// 2e-5), measured faster than the accurate expf on an H100. There are
// no atomics: each output is written once, in a fixed order, so both
// kernels are bitwise equal from run to run. Above D = 128 they keep the
// fp32 SIMT tiles below: at D = 256 a warp's 16 x D accumulator alone takes
// 128 of a thread's 255 registers, and the forward's 128 resident rows plus
// a two-step ring of 32-row K/V tiles take 260 KB of shared memory, more
// than the 227 KB a block has.
//
// The SIMT kernels (the forward and dq above D = 128) run on the FMA
// units, fed from shared memory with 16-byte loads: a score tile per
// 256-thread block, each thread owning a micro-tile (rows ty + 16 i,
// columns tx + 16 j) so one float4 load of a row feeds four FMAs per
// operand, and rows are padded to D + 4 floats so a half-warp's row loads
// spread over all 32 banks. A thread owns the same rows in the score tile
// and in the output tile, so the online-softmax state (m, l) and the
// rescale stay in registers; row reductions are shuffles across the 16
// lanes that share a row.
//
// The dK/dV kernel runs its four products on the tensor cores in 3xTF32:
// S^T = K Q^T and dP^T = V dO^T (both operands
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
// fresh register tiles, then added with fp32 adds.
// Each k-step loads and splits a warp's fragments first, then runs the
// lo.hi, hi.lo and hi.hi passes over its independent products. Shared
// rows of D + 4 floats keep the K-major fragment loads free of bank
// conflicts; the MN-major ones of phase 2 meet two-way conflicts.
//
// The TPU scans K/V blocks along a sequential grid axis with state in
// VMEM scratch. CUDA blocks run in no order, so each CUDA block owns one
// (batch*head, tile) and runs the scan as a loop inside the block.
//
// The fused backward holds one (batch, head) whole and computes each
// s/p/dp entry once for dq, dk and dv, on the tensor cores in 3xTF32. Its
// row limit is the port's tile: 128 rows for D <= 64, 64 for D <= 128;
// longer sequences take the dq and dkv kernels. Q and dO stay resident in
// shared memory; K and V stream through a two-step cp.async ring of 16-key
// sub-tiles, so that up to D = 64 two blocks share an SM (102 KB of shared
// memory, at most 128 registers), which an H100 ran faster than K and V
// resident in 32-key sub-tiles with one block per SM. For each sub-tile:
// - phase 1 is the dq kernel's step: a warp owns 16 query rows, forms S =
//   Q K^T and dP = dO V^T from K-major operands, Pv and dS in registers in
//   the fragment layout, and dQ += dS K with dS fed from registers
//   (tf32::frag_b_pairs): dQ accumulates in registers over the whole scan,
//   with no shared accumulator. The warp also writes Pv and dS to shared
//   transposed tiles [key][query] (rows of R + 8 floats);
// - after a barrier, phase 2 is the dK/dV kernel's: the 8 warps (4 a
//   product) form the sub-tile's dV = Pv^T dO and dK = dS^T Q over the
//   query rows that see it, Pv^T and dS^T read as A operands in query-pair
//   order by 8-byte loads (tf32::frag_a_pairs) so that dO and Q are read
//   MN-major in the same order (frag_b_pairs) without bank conflicts, 32
//   query rows per fresh register tile; the results go straight to device
//   memory.
// The next sub-tile's barrier separates this phase 2 from the next phase 1,
// so one Pv^T/dS^T pair and two barriers a sub-tile do. Its splits pass lo
// unrounded (tf32::split<true>, at most 2^-21 of an operand against 2^-22):
// every warp splits every K/V fragment it loads, and halving the integer
// work of a split measured faster on an H100. The forward's lessons carry
// over: __expf, sub-tiles no mask reaches skip the per-entry mask, and
// causal sub-tiles a warp's rows cannot see are skipped (phase 2 then
// starts at the first warp that computed them). No atomics: every
// output is written once, in a fixed order, so the kernel is bitwise equal
// from run to run.
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
// there is one slice and nothing is streamed twice (the 3xTF32 forward
// and dq, at D <= 128, never see more than one). In the SIMT forward and dq
// a thread owns C = D / 16 output columns, and the tiles shrink with D so
// that the dq kernel's four operand tiles fit 227 KB of shared memory: 32
// rows (2 x 2 micro-tiles per thread) at D = 256, 16 rows (one score entry
// per thread) at D = 384 and 512. The fused backward, which holds a whole
// (batch, head), is not built above D = 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;      // threads of every block
constexpr float kNegInf = -1e30f;
constexpr uint32_t kGolden = 0x9E3779B9u;

// Rows of a q tile and of a k tile of the SIMT forward and dq at head dim
// D >= 256 (see the note above).
__host__ __device__ constexpr int tile_rows(int D) {
  return D > 256 ? 16 : 32;
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

__device__ __forceinline__ bool visible(const Problem& P, int q_pos,
                                        int k_pos) {
  return q_pos < P.Tq && k_pos < P.Tk &&
         (!P.causal || q_pos + (P.Tk - P.Tq) >= k_pos);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Key tiles (of BK rows) a query tile of BQ rows starting at q0 scans: all,
// or (causal) those up to its last row's last visible key, at least one (as
// the TPU kernel).
__device__ __forceinline__ int key_tiles(const Problem& P, int q0, int BQ,
                                         int BK) {
  const int num_k = (P.Tk + BK - 1) / BK;
  if (!P.causal) return num_k;
  const int upper = floor_div(q0 + BQ - 1 + P.Tk - P.Tq, BK) + 1;
  return upper < 1 ? 1 : (upper > num_k ? num_k : upper);
}

// True when a key tile of BK rows starting at k0 may hold an entry that a
// warp's 16 query rows starting at r0 must mask: keys past Tk, or (causal)
// keys past the first row's last visible key. Elsewhere every entry is
// visible (rows past Tq are computed but never written).
__device__ __forceinline__ bool edge_tile(const Problem& P, int r0, int k0,
                                          int BK) {
  return k0 + BK > P.Tk || (P.causal && k0 + BK - 1 > r0 + P.Tk - P.Tq);
}

// First query tile a key tile starting at k0 needs (causal), else 0.
__device__ __forceinline__ int first_query_tile(const Problem& P, int k0,
                                                int T) {
  const int num_q = (P.Tq + T - 1) / T;
  if (!P.causal) return 0;
  const int lower = floor_div(k0 - (P.Tk - P.Tq), T);
  return lower < 0 ? 0 : (lower > num_q ? num_q : lower);
}

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

// ---------------------------------------------------------------------------
// the forward and dq kernels at D <= 128: 3xTF32 tensor-core tiles
// ---------------------------------------------------------------------------

// Tiles of the 3xTF32 forward and dq kernels at head dim D <= 128 (see the
// note above): BQ = 128 query rows per block, 16 per warp, resident; key
// tiles of BK = 32 rows stream through a two-step cp.async ring of K and
// V; up to D = 64 two blocks share an SM.
template <int D>
struct QCfg {
  static constexpr int BQ = 16 * (kThreads / 32);
  static constexpr int BK = 32;
  static constexpr int kBlocks = D <= 64 ? 2 : 1;
  static constexpr int LD = D + 4;     // shared rows (LD = 4 mod 32: no bank
                                       // conflict for either fragment order)
  static constexpr int NT = BK / 8;    // 8-key fragment columns of S
  static constexpr int ND = D / 8;     // 8-column fragment columns of O, dQ
  static constexpr int KV = 2 * BK * LD;  // one ring step: K and V
  // forward: Q and two ring steps; dq: Q, dO and two ring steps
  static constexpr size_t kFwdSmem =
      (size_t)(BQ * LD + 2 * KV) * sizeof(float);
  static constexpr size_t kDqSmem =
      (size_t)(2 * BQ * LD + 2 * KV) * sizeof(float);
  static_assert(D % 8 == 0 && D <= 128, "3xTF32 tiles take D <= 128");
};

// Reductions across the 4 lanes (a quad) that share the rows of an m16n8
// accumulator fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc = A[m0, m0 + 16) . B[0, 8 NT)^T over the head dim D, both K-major
// shared tiles (row stride LD): a warp's 16 x 8 NT score fragments. 32 head-
// dim columns go into a fresh register tile, added into acc with fp32 adds;
// each k-step loads and splits the fragments first, then runs the lo.hi,
// hi.lo and hi.hi passes over NT independent products. kFast: the split of
// tf32::split<true>.
template <int D, int NT, int LD, bool kFast = false>
__device__ __forceinline__ void score_tile(float (&acc)[NT][4],
                                           const float* A, int m0,
                                           const float* B) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 32) {
    float f[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
#pragma unroll
    for (int kk = d0; kk < d0 + 32; kk += 8) {
      if (kk >= D) break;  // D = 16, 48, 80, 112: a half stage
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      tf32::frag_a<true, LD, kFast>(A, m0, kk, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tf32::frag_b<true, LD, kFast>(B, 8 * j, kk, bh[j], bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) tf32::mma(f[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) tf32::mma(f[j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) tf32::mma(f[j], ah, bh[j]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += f[j][e];
  }
}

// score_tile for two products at once, s = A1[m0, m0 + 16) . B1^T and dp =
// A2[m0, m0 + 16) . B2^T over D: each pass runs both products' 2 NT
// independent fragments, twice the chains score_tile has in flight.
template <int D, int NT, int LD, bool kFast = false>
__device__ __forceinline__ void score_tiles2(float (&s)[NT][4],
                                             float (&dp)[NT][4],
                                             const float* A1, const float* B1,
                                             const float* A2, const float* B2,
                                             int m0) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 32) {
    float f[NT][4], g[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[j][e] = g[j][e] = 0.f;
#pragma unroll
    for (int kk = d0; kk < d0 + 32; kk += 8) {
      if (kk >= D) break;  // D = 16, 48, 80, 112: a half stage
      uint32_t ah[4], al[4], ch[4], cl[4];
      uint32_t bh[NT][2], bl[NT][2], eh[NT][2], el[NT][2];
      tf32::frag_a<true, LD, kFast>(A1, m0, kk, ah, al);
      tf32::frag_a<true, LD, kFast>(A2, m0, kk, ch, cl);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tf32::frag_b<true, LD, kFast>(B1, 8 * j, kk, bh[j], bl[j]);
        tf32::frag_b<true, LD, kFast>(B2, 8 * j, kk, eh[j], el[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tf32::mma(f[j], al, bh[j]);
        tf32::mma(g[j], cl, eh[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tf32::mma(f[j], ah, bl[j]);
        tf32::mma(g[j], ch, el[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tf32::mma(f[j], ah, bh[j]);
        tf32::mma(g[j], ch, eh[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += f[j][e];
        dp[j][e] += g[j][e];
      }
  }
}

// acc = acc * alpha + P . M over one key tile: P a warp's 16 x 8 NT score
// fragments (after the softmax, in registers: frag_a_acc), M the tile's
// MN-major [key][D] shared rows (row stride LD) read in frag_b_pairs' key
// order. Four 8-column fragments at a time go into a fresh register tile
// (the whole tile's 8 NT keys summed there), which is added into acc, rows
// g scaled by alpha0 and rows g + 8 by alpha1.
template <int ND, int NT, int LD, bool kFast = false>
__device__ __forceinline__ void acc_tile(float (&acc)[ND][4],
                                         const float (&p)[NT][4],
                                         const float* M, float alpha0,
                                         float alpha1) {
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += 4) {
    float f[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[u][e] = 0.f;
#pragma unroll
    for (int kj = 0; kj < NT; ++kj) {
      uint32_t ph[4], pl[4], bh[4][2], bl[4][2];
      tf32::frag_a_acc<kFast>(p[kj], ph, pl);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + u < ND)
          tf32::frag_b_pairs<LD, kFast>(M, (n0 + u) * 8, kj * 8, bh[u],
                                        bl[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + u < ND) tf32::mma(f[u], pl, bh[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + u < ND) tf32::mma(f[u], ph, bl[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + u < ND) tf32::mma(f[u], ph, bh[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n0 + u >= ND) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + u][e] = acc[n0 + u][e] * (e < 2 ? alpha0 : alpha1) +
                         f[u][e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, QCfg<D>::kBlocks)
    flash_fwd_kernel(Problem P, const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const int* __restrict__ seed, float* __restrict__ out,
                     float* __restrict__ lse) {
  using Cfg = QCfg<D>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, LD = Cfg::LD, NT = Cfg::NT;
  constexpr int ND = Cfg::ND;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + BQ * LD;  // 2 steps of K, V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  const int q0 = blockIdx.x * BQ, m0 = warp * 16;
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* bias_row = bias ? bias + (long long)b * P.Tk : nullptr;
  auto load_kv = [&](int st, int k0) {
    float* Ks = ring + st * Cfg::KV;
    cp_rows<BK, D>(Ks, kb, P.k.t, k0, P.Tk);
    cp_rows<BK, D>(Ks + BK * LD, vb, P.v.t, k0, P.Tk);
  };
  const int upper = key_tiles(P, q0, BQ, BK);
  load_kv(0, 0);
  tf32::cp_async_commit();
  // the TPU kernel scales q before the product
  load_rows<D>(Qs, q + b * P.q.b + h * P.q.h, P.q.t, q0, BQ, P.Tq, P.scale);

  // this thread's rows of the warp's 16: qp0 (fragment row g), qp1 (g + 8)
  const int qp0 = q0 + m0 + gid, qp1 = qp0 + 8;
  uint32_t u0 = 0u, u1 = 0u;
  if (seed) {
    const uint32_t hh = head_hash(seed, g);
    u0 = row_hash(hh, qp0);
    u1 = row_hash(hh, qp1);
  }
  // causal: past this key every row of the warp sees nothing
  const int warp_last = q0 + m0 + 15 + P.Tk - P.Tq;

  float o[ND][4], m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int j = 0; j < upper; ++j) {
    const int st = j & 1, k0 = j * BK;
    // the other step's slot was consumed before the last barrier
    if (j + 1 < upper) load_kv(st ^ 1, k0 + BK);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + st * Cfg::KV;
    const float* Vs = Ks + BK * LD;
    // a key tile that every row of the warp masks would leave o, m and l
    // exactly as they are (alpha 1, p 0): skip its products
    if (!P.causal || k0 <= warp_last) {
      float s[NT][4];
      score_tile<D, NT, LD>(s, Qs, m0, Ks);
      // bias, masks and the online softmax of the warp's rows, in the
      // fragment layout: entry (jn, e) is row e < 2 ? qp0 : qp1, key
      // k0 + 8 jn + 2 tig + (e & 1)
      uint32_t vis = ~0u;
      float mt[2] = {kNegInf, kNegInf};
      if (edge_tile(P, q0 + m0, k0, BK)) {
        vis = 0u;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kp = k0 + 8 * jn + 2 * tig + c;
            const float bk = (bias_row && kp < P.Tk) ? bias_row[kp] : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + c;
              const bool ok = visible(P, r ? qp1 : qp0, kp);
              s[jn][e] = ok ? s[jn][e] + bk : kNegInf;
              vis |= (uint32_t)ok << (4 * jn + e);
            }
          }
      } else if (bias_row) {
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float bk = bias_row[k0 + 8 * jn + 2 * tig + c];
            s[jn][c] += bk;
            s[jn][2 + c] += bk;
          }
      }
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[jn][e]);
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_r[r], quad_max(mt[r]));
        alpha[r] = __expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = (vis >> (4 * jn + e)) & 1u ? __expf(s[jn][e] - m_r[r])
                                               : 0.f;
          // l sums the undropped p; dropout zeroes only the numerator
          ps[r] += p;
          if (seed && !keep_bit(r ? u1 : u0, k0 + 8 * jn + 2 * tig + (e & 1),
                                P.threshold))
            p = 0.f;
          s[jn][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + quad_sum(ps[r]);
      acc_tile<ND, NT, LD>(o, s, Vs, alpha[0], alpha[1]);
    }
    __syncthreads();  // this step's slot is consumed before it is refilled
  }

  float* ob = out + b * P.o.b + h * P.o.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qp1 : qp0;
    if (qp >= P.Tq) continue;
    const float safe_l = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      float o0 = o[jd][2 * r] / safe_l, o1 = o[jd][2 * r + 1] / safe_l;
      if (seed) {
        o0 = o0 / P.keep_prob;
        o1 = o1 / P.keep_prob;
      }
      *reinterpret_cast<float2*>(ob + qp * P.o.t + jd * 8 + 2 * tig) =
          make_float2(o0, o1);
    }
    if (tig == 0) lse[(long long)g * P.Tq + qp] = m_r[r] + logf(safe_l);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, QCfg<D>::kBlocks)
    flash_bwd_dq_kernel(Problem P, const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        const int* __restrict__ seed,
                        float* __restrict__ dq) {
  using Cfg = QCfg<D>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, LD = Cfg::LD, NT = Cfg::NT;
  constexpr int ND = Cfg::ND;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* ring = dOs + BQ * LD;  // 2 steps of K, V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  const int q0 = blockIdx.x * BQ, m0 = warp * 16;
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* bias_row = bias ? bias + (long long)b * P.Tk : nullptr;
  auto load_kv = [&](int st, int k0) {
    float* Ks = ring + st * Cfg::KV;
    cp_rows<BK, D>(Ks, kb, P.k.t, k0, P.Tk);
    cp_rows<BK, D>(Ks + BK * LD, vb, P.v.t, k0, P.Tk);
  };
  const int upper = key_tiles(P, q0, BQ, BK);
  // Q and dO stay for the whole scan; they land with the first ring step
  cp_rows<BQ, D>(Qs, q + b * P.q.b + h * P.q.h, P.q.t, q0, P.Tq);
  cp_rows<BQ, D>(dOs, dout + b * P.dout.b + h * P.dout.h, P.dout.t, q0,
                 P.Tq);
  load_kv(0, 0);
  tf32::cp_async_commit();

  // this thread's rows of the warp's 16: qp0 (fragment row g), qp1 (g + 8)
  const int qp0 = q0 + m0 + gid, qp1 = qp0 + 8;
  float lq[2], dlt[2];
  uint32_t u[2] = {0u, 0u};
  const uint32_t hh = seed ? head_hash(seed, g) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qp1 : qp0;
    const bool in = qp < P.Tq;
    lq[r] = in ? lse[(long long)g * P.Tq + qp] : 0.f;
    dlt[r] = in ? delta[(long long)g * P.Tq + qp] : 0.f;
    if (seed) u[r] = row_hash(hh, qp);
  }
  const float inv_keep = 1.f / P.keep_prob;
  // causal: past this key every row of the warp sees nothing
  const int warp_last = q0 + m0 + 15 + P.Tk - P.Tq;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < upper; ++j) {
    const int st = j & 1, k0 = j * BK;
    // the other step's slot was consumed before the last barrier
    if (j + 1 < upper) load_kv(st ^ 1, k0 + BK);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + st * Cfg::KV;
    const float* Vs = Ks + BK * LD;
    // a key tile that every row of the warp masks adds exactly 0 to dq
    if (!P.causal || k0 <= warp_last) {
      float s[NT][4], dp[NT][4];
      score_tile<D, NT, LD>(s, Qs, m0, Ks);
      score_tile<D, NT, LD>(dp, dOs, m0, Vs);
      // dS = p (dp keep / (1 - p) - delta) scale, in the fragment layout:
      // entry (jn, e) is row e < 2 ? qp0 : qp1, key k0 + 8 jn + 2 tig +
      // (e & 1); it replaces s. A tile no mask reaches skips the mask.
      const bool edge = edge_tile(P, q0 + m0, k0, BK);
      auto ds_entries = [&](int jn, int c, float bk) {
        const int kp = k0 + 8 * jn + 2 * tig + c;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float sv = s[jn][e] * P.scale + bk;
          const float p = (!edge || visible(P, r ? qp1 : qp0, kp))
                              ? __expf(sv - lq[r])
                              : 0.f;
          float d = dp[jn][e];
          if (seed)
            d = keep_bit(u[r], kp, P.threshold) ? d * inv_keep : 0.f;
          s[jn][e] = p * (d - dlt[r]) * P.scale;
        }
      };
      if (edge) {
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kp = k0 + 8 * jn + 2 * tig + c;
            ds_entries(jn, c, (bias_row && kp < P.Tk) ? bias_row[kp] : 0.f);
          }
      } else {
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            ds_entries(jn, c,
                       bias_row ? bias_row[k0 + 8 * jn + 2 * tig + c] : 0.f);
      }
      // dQ += dS K, K read MN-major in key pairs
      acc_tile<ND, NT, LD>(acc, s, Ks, 1.f, 1.f);
    }
    __syncthreads();  // this step's slot is consumed before it is refilled
  }

  float* db = dq + b * P.dq.b + h * P.dq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qp1 : qp0;
    if (qp >= P.Tq) continue;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<float2*>(db + qp * P.dq.t + jd * 8 + 2 * tig) =
          make_float2(acc[jd][2 * r], acc[jd][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// the forward and dq kernels above D = 128: fp32 SIMT tiles
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt_kernel(Problem P, const float* __restrict__ q,
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

  const int upper = key_tiles(P, q0, T, T);
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
// backward: dq above D = 128 (query tile per block, scanning key tiles), SIMT
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt_kernel(Problem P, const float* __restrict__ q,
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

  const int upper = key_tiles(P, q0, T, T);
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
// backward: fused dq, dk, dv for one whole (batch, head), 3xTF32
// ---------------------------------------------------------------------------

// Tiles of the fused backward at head dim D <= 128 (see the note above): R
// query and key rows of one (batch, head) at most (fused_rows below), Q
// and dO resident, key sub-tiles of BK rows through an NSLOT-step cp.async
// ring of K and V; up to D = 64 two blocks share an SM (102 KB of shared
// memory, at most 128 registers). Phase 1 (S, dP, dS and dQ += dS K): R /
// 16 warps of 16 query rows. Phase 2 (dV = Pv^T dO and dK = dS^T Q over the
// sub-tile's keys): 8 warps, 4 a product, warp w % 4 owning fragment row
// (w % 4) % MT and the NJ fragment columns (w % 4) / MT + NG j.
template <int D>
struct FusedCfg {
  static constexpr int R = D <= 64 ? 128 : 64;
  static constexpr int BK = 16;
  static constexpr int NSLOT = 2;
  static constexpr int kBlocks = D <= 64 ? 2 : 1;  // per SM
  static constexpr bool kFast = true;  // tf32::split<true>
  static constexpr int LD = D + 4;     // Q, dO, K, V rows
  static constexpr int LDP = R + 8;    // Pv^T, dS^T rows (8 mod 32: the
                                       // pairs' 8-byte loads meet no
                                       // bank conflict)
  static constexpr int NT = BK / 8;    // 8-key fragment columns of S
  static constexpr int ND = D / 8;     // 8-column fragment columns of dQ
  static constexpr int MT = BK / 16;   // 16-key fragment rows of dK, dV
  static constexpr int NG = 4 / MT;
  static constexpr int NJ = (ND + NG - 1) / NG;
  static constexpr int KV = 2 * BK * LD;  // one sub-tile: K and V
  static constexpr size_t kSmem =
      (size_t)(2 * R * LD + NSLOT * KV + 2 * BK * LDP) * sizeof(float);
  static_assert(D % 16 == 0 && D <= 128 && BK % 16 == 0 && BK <= 64 &&
                    NSLOT >= 2 && R % BK == 0,
                "fused backward tiles");
};

template <int D>
__global__ void __launch_bounds__(kThreads, FusedCfg<D>::kBlocks)
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
  using Cfg = FusedCfg<D>;
  constexpr int R = Cfg::R, BK = Cfg::BK, LD = Cfg::LD, LDP = Cfg::LDP;
  constexpr int NT = Cfg::NT, ND = Cfg::ND, NSLOT = Cfg::NSLOT;
  constexpr int MT = Cfg::MT, NG = Cfg::NG, NJ = Cfg::NJ;
  constexpr bool kFast = Cfg::kFast;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + R * LD;
  float* ring = dOs + R * LD;             // NSLOT sub-tiles of K, V
  float* PvT = ring + NSLOT * Cfg::KV;    // [BK][LDP]
  float* dST = PvT + BK * LDP;            // [BK][LDP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, b = g / P.H, h = g % P.H;
  const float* kb = k + b * P.k.b + h * P.k.h;
  const float* vb = v + b * P.v.b + h * P.v.h;
  const float* bias_row = bias ? bias + (long long)b * P.Tk : nullptr;
  auto load_kv = [&](int j) {
    float* Ks = ring + (j % NSLOT) * Cfg::KV;
    cp_rows<BK, D>(Ks, kb, P.k.t, j * BK, P.Tk);
    cp_rows<BK, D>(Ks + BK * LD, vb, P.v.t, j * BK, P.Tk);
  };
  const int nk = (P.Tk + BK - 1) / BK;
  // Q and dO stay for the whole scan and land with the first sub-tile;
  // NSLOT - 1 sub-tiles are in flight before the scan starts
  cp_rows<R, D>(Qs, q + b * P.q.b + h * P.q.h, P.q.t, 0, P.Tq);
  cp_rows<R, D>(dOs, dout + b * P.dout.b + h * P.dout.h, P.dout.t, 0, P.Tq);
  load_kv(0);
  tf32::cp_async_commit();
  for (int j = 1; j < NSLOT - 1; ++j) {
    if (j < nk) load_kv(j);
    tf32::cp_async_commit();
  }

  // phase 1: this warp's query rows m0 .. m0 + 15; this thread's qp0
  // (fragment row g) and qp1 (g + 8)
  const int m0 = warp * 16;
  const bool p1 = m0 < R && m0 < P.Tq;
  const int qp0 = m0 + gid, qp1 = qp0 + 8;
  float lq[2], dlt[2];
  uint32_t u[2] = {0u, 0u};
  const uint32_t hh = seed ? head_hash(seed, g) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qp1 : qp0;
    const bool in = qp < P.Tq;
    lq[r] = in ? lse[(long long)g * P.Tq + qp] : 0.f;
    dlt[r] = in ? delta[(long long)g * P.Tq + qp] : 0.f;
    if (seed) u[r] = row_hash(hh, qp);
  }
  const float inv_keep = 1.f / P.keep_prob;
  const int off = P.Tk - P.Tq;
  // causal: past this key every row of the warp sees nothing
  const int warp_last = m0 + 15 + off;
  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  // phase 2: product pr (0: dV from Pv^T and dO, 1: dK from dS^T and Q),
  // key rows mt * 16 .. of the sub-tile, fragment columns cg + NG j
  const int pr = warp >> 2, mt = (warp & 3) % MT, cg = (warp & 3) / MT;
  const float* A2 = pr ? dST : PvT;
  const float* B2 = pr ? Qs : dOs;
  float* out2 = pr ? dk + b * P.dk.b + h * P.dk.h
                   : dv + b * P.dv.b + h * P.dv.h;
  const long long ts2 = pr ? P.dk.t : P.dv.t;
  // query rows phase 2 sums over: up to Tq rounded to a fragment's 8 (the
  // rows past Tq carry p = 0)
  const int qhi = (P.Tq + 7) & ~7;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    // the slot refilled held sub-tile j - 1, consumed before the last
    // phase-1 barrier
    if (j + NSLOT - 1 < nk) load_kv(j + NSLOT - 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<NSLOT - 1>();
    // sub-tile j has landed; the last sub-tile's phase 2 is done with
    // Pv^T and dS^T
    __syncthreads();
    const float* Ks = ring + (j % NSLOT) * Cfg::KV;
    const float* Vs = Ks + BK * LD;
    // a sub-tile every row of the warp masks adds exactly 0 to dq and
    // nothing phase 2 reads: skip it
    if (p1 && (!P.causal || k0 <= warp_last)) {
      float s[NT][4], dp[NT][4];
      score_tiles2<D, NT, LD, kFast>(s, dp, Qs, Ks, dOs, Vs, m0);
      // Pv = p keep / (1 - p) and dS = p (dp keep / (1 - p) - delta)
      // scale in the fragment layout: entry (jn, e) is row e < 2 ? qp0 :
      // qp1, key k0 + 8 jn + 2 tig + (e & 1). Both go to the transposed
      // shared tiles, dS also replaces s for dQ += dS K. A sub-tile no
      // mask reaches (keys, causal, or query rows past Tq) skips the mask.
      const bool edge = k0 + BK > P.Tk || m0 + 16 > P.Tq ||
                        (P.causal && k0 + BK - 1 > m0 + off);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kl = 8 * jn + 2 * tig + c, kp = k0 + kl;
          const float bk =
              (bias_row && (!edge || kp < P.Tk)) ? bias_row[kp] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c, qp = r ? qp1 : qp0;
            const float sv = s[jn][e] * P.scale + bk;
            const float p = (!edge || visible(P, qp, kp))
                                ? __expf(sv - lq[r])
                                : 0.f;
            float pv = p, d = dp[jn][e];
            if (seed) {
              const bool keep = keep_bit(u[r], kp, P.threshold);
              pv = keep ? p * inv_keep : 0.f;
              d = keep ? d * inv_keep : 0.f;
            }
            const float ds = p * (d - dlt[r]) * P.scale;
            PvT[kl * LDP + qp] = pv;
            dST[kl * LDP + qp] = ds;
            s[jn][e] = ds;
          }
        }
      // dQ += dS K, K read MN-major in key pairs
      acc_tile<ND, NT, LD, kFast>(dqa, s, Ks, 1.f, 1.f);
    }
    __syncthreads();  // Pv^T and dS^T are complete

    // phase 2: this sub-tile's dV or dK over the query rows that see it
    // (causal: from the first warp that computed it), 32 rows per fresh
    // register tile; a sub-tile no row sees gets zeros
    const int qlo = P.causal ? max(0, floor_div(k0 - off, 16) * 16) : 0;
    float acc2[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[jj][e] = 0.f;
    for (int c0 = qlo; c0 < qhi; c0 += 32) {
      // the small terms (lo.hi, hi.lo) and hi.hi in separate fresh tiles:
      // 2 NJ independent chains of products
      float f[NJ][4], fb[NJ][4];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[jj][e] = fb[jj][e] = 0.f;
      const int c1 = min(c0 + 32, qhi);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kq = c0 + 8 * u;
        if (kq >= c1) break;
        uint32_t ah[4], al[4], bh[NJ][2], bl[NJ][2];
        tf32::frag_a_pairs<LDP, kFast>(A2, mt * 16, kq, ah, al);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND)
            tf32::frag_b_pairs<LD, kFast>(B2, (cg + NG * jj) * 8, kq,
                                          bh[jj], bl[jj]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(f[jj], al, bh[jj]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(fb[jj], ah, bh[jj]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(f[jj], ah, bl[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[jj][e] += fb[jj][e] + f[jj][e];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kp = k0 + mt * 16 + gid + 8 * half;
      if (kp >= P.Tk) continue;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int n = cg + NG * jj;
        if (n >= ND) continue;
        *reinterpret_cast<float2*>(out2 + kp * ts2 + n * 8 + 2 * tig) =
            make_float2(acc2[jj][2 * half], acc2[jj][2 * half + 1]);
      }
    }
  }

  if (!p1) return;
  float* dqb = dq + b * P.dq.b + h * P.dq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qp1 : qp0;
    if (qp >= P.Tq) continue;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<float2*>(dqb + qp * P.dq.t + jd * 8 + 2 * tig) =
          make_float2(dqa[jd][2 * r], dqa[jd][2 * r + 1]);
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

// One block per (query tile, batch * head, head-dim slice), query tiles of
// T rows.
dim3 q_grid(const Problem& P, int D, int T) {
  return dim3((P.Tq + T - 1) / T, P.B * P.H, P.D / D);
}

// Dynamic shared memory of the SIMT kernels, in bytes: at D = 256 fwd 104
// KB, dq 138 KB; at D = 512 fwd 98 KB, dq 130 KB. The dK/dV kernel's is
// DkvCfg::kSmem: 89 KB at D = 64, 154 KB at 128, 209 KB at 256, 201 KB at
// 512; the 3xTF32 forward's and dq's QCfg::kFwdSmem / kDqSmem: 68 and 102
// KB at D = 64, 132 and 198 KB at D = 128; the fused backward's
// FusedCfg::kSmem: 102 KB at D = 64, 108 KB at 128.
constexpr size_t fwd_smem(int D) {
  return (size_t)(3 * tile_rows(D) * (D + 4) +
                  tile_rows(D) * p_ld(tile_rows(D))) * sizeof(float);
}
constexpr size_t dq_smem(int D) {
  return (size_t)(4 * tile_rows(D) * (D + 4) +
                  tile_rows(D) * p_ld(tile_rows(D))) * sizeof(float);
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

// The forward and dq kernels at head-dim slice D: 3xTF32 tiles up to
// D = 128 (a 16-row warp tile's accumulator and its fresh tile take D
// registers a thread, and the resident tiles plus the ring 198 KB of shared
// memory at 128), the SIMT tiles above.
template <int D>
cudaError_t launch_fwd(void* stream, const Problem& P, const float* q,
                       const float* k, const float* v, const float* bias,
                       const int* seed, float* out, float* lse) {
  if constexpr (D <= 128) {
    return launch(flash_fwd_kernel<D>, q_grid(P, D, QCfg<D>::BQ),
                  QCfg<D>::kFwdSmem, stream, P, q, k, v, bias, seed, out,
                  lse);
  } else {
    return launch(flash_fwd_simt_kernel<D>, q_grid(P, D, tile_rows(D)),
                  fwd_smem(D), stream, P, q, k, v, bias, seed, out, lse);
  }
}

template <int D>
cudaError_t launch_dq(void* stream, const Problem& P, const float* q,
                      const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, const float* bias,
                      const int* seed, float* dq) {
  if constexpr (D <= 128) {
    return launch(flash_bwd_dq_kernel<D>, q_grid(P, D, QCfg<D>::BQ),
                  QCfg<D>::kDqSmem, stream, P, q, k, v, dout, lse, delta,
                  bias, seed, dq);
  } else {
    return launch(flash_bwd_dq_simt_kernel<D>, q_grid(P, D, tile_rows(D)),
                  dq_smem(D), stream, P, q, k, v, dout, lse, delta, bias,
                  seed, dq);
  }
}

// The fused kernel: 3xTF32 tiles up to D = 128; not built above, where a
// whole (batch, head) does not fit shared memory.
template <int D>
cudaError_t launch_fused(dim3 grid, void* stream, const Problem& P,
                         const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, const float* bias,
                         const int* seed, float* dq, float* dk, float* dv) {
  if constexpr (D > 128) {
    return cudaErrorInvalidValue;
  } else {
    return launch(flash_bwd_fused_kernel<D>, grid, FusedCfg<D>::kSmem,
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
// D <= 64, 64 for D <= 128, none above (FusedCfg::R;
// kernels/flash_attention.py routes by the same rule, fused_rows()).
int fused_rows(int D) { return D <= 64 ? 128 : D <= 128 ? 64 : 0; }

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
  DISPATCH_D(P.D / n, err = launch_fwd<kD>(stream, P, q, k, v, bias, seed,
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
  const int n = slices(P.D);
  if (too_many_heads(P) || n == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  DISPATCH_D(P.D / n, err = launch_dq<kD>(stream, P, q, k, v, dout, lse,
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
