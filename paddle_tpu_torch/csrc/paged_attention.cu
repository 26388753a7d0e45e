// Ragged paged attention over a block-paged KV pool, for Hopper (sm_90a),
// fp32. Two entry points:
//
//   paged_attention_fwd     single-query decode attention. Replaces the
//                           Pallas kernel _paged_attn_kernel in
//                           paddle_tpu/kernels/paged_attention.py
//                           (launched by _paged_attention_impl through
//                           paged_attention).
//   paged_attention_mq_fwd  multi-query window attention for speculative
//                           verify. Replaces _paged_attn_mq_kernel in the
//                           same file (launched by _paged_attention_mq_impl
//                           through paged_attention_multiquery).
//
// Layout: q [B, H, D] (or [B, Qmax, H, D]); pools [N, bs, H, D]; block
// tables [B, max_blocks] int32; context lengths [B] int32 counting every
// valid token, the query's own included.
//
// What bounds it on the card: bytes. A query row reads ctx * H * D * 4
// bytes each of K and V and does 4 flops per K/V element pair, far below
// the ~20 flops per byte where fp32 arithmetic would take over. The design
// reads only what the data needs: a CUDA block owns one (sequence, head[,
// query row]) and visits only that sequence's own table entries
// j < ceil(limit / bs), so blocks past the context are never read and the
// cost tracks real tokens, not max_blocks.
//
// The TPU kernel carries the online-softmax state (m, l, acc) in VMEM
// scratch across a sequential grid axis. Blocks on the GPU run in no order,
// so the scan lives inside one CUDA block instead, split across its warps:
// warp w takes KV blocks w, w + kWarps, ... and carries its own (m, l, acc)
// in registers (lane holds output dims lane, lane + 32, ...). Per token the
// lanes form q.k from coalesced row loads and a shuffle reduction, four
// tokens at a time so their loads and reductions overlap. At the end the
// warps' partial states merge through shared memory:
//   M = max m_w,  L = sum l_w e^(m_w - M),  out = sum acc_w e^(m_w - M) / L.
// Tokens at or past the row's limit are skipped, which is what the TPU
// kernel's -1e30 mask amounts to; the output is acc / max(l, 1e-30) as
// there, so an empty row gives 0.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 128;  // 4 output dims per lane
constexpr int kUnroll = 4;        // tokens in flight per warp
constexpr float kNegInf = -1e30f;

// One query row of one head: attend keys [0, limit) of the sequence whose
// block-table row is `table`, write D floats to `out`. E = ceil(D / 32).
template <int E>
__device__ void attend_row(const float* __restrict__ q,
                           const float* __restrict__ k_pool,
                           const float* __restrict__ v_pool,
                           const int* __restrict__ table, int max_blocks,
                           int n_blocks, int block_size, int H, int D,
                           int h, int limit, float scale,
                           float* __restrict__ out) {
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][kMaxHeadDim];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    qr[e] = d < D ? q[d] * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int nb = limit > 0 ? (limit + block_size - 1) / block_size : 0;
  if (nb > max_blocks) nb = max_blocks;
  const long long tok_stride = (long long)H * D;

  for (int j = warp; j < nb; j += kWarps) {
    int blk = table[j];
    blk = blk < 0 ? 0 : (blk >= n_blocks ? n_blocks - 1 : blk);
    const long long base =
        ((long long)blk * block_size * H + h) * (long long)D;
    const float* kb = k_pool + base;
    const float* vb = v_pool + base;
    int n_valid = limit - j * block_size;
    if (n_valid > block_size) n_valid = block_size;

    for (int i0 = 0; i0 < n_valid; i0 += kUnroll) {
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
        if (i0 + u < n_valid) {  // uniform across the warp
          const float* kr = kb + (i0 + u) * tok_stride;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int d = lane + 32 * e;
            if (d < D) part += qr[e] * kr[d];
          }
        }
        s[u] = part;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u < n_valid) {
          const float m_new = fmaxf(m, s[u]);
          const float alpha = expf(m - m_new);
          const float p = expf(s[u] - m_new);
          l = l * alpha + p;
          const float* vr = vb + (i0 + u) * tok_stride;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int d = lane + 32 * e;
            acc[e] = acc[e] * alpha + (d < D ? p * vr[d] : 0.f);
          }
          m = m_new;
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < D) acc_s[warp][d] = acc[e];
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < D) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w] - M);
      L += l_s[w] * c;
      o += acc_s[w][t] * c;
    }
    out[t] = o / fmaxf(L, 1e-30f);
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ out, int H, int D,
    int n_blocks, int block_size, int max_blocks, float scale) {
  // grid (H, B): one block per (head, sequence)
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row = ((long long)b * H + h) * D;
  attend_row<E>(q + row, k_pool, v_pool,
                tables + (long long)b * max_blocks, max_blocks, n_blocks,
                block_size, H, D, h, lens[b], scale, out + row);
}

template <int E>
__global__ void __launch_bounds__(kThreads) paged_attention_mq_kernel(
    const float* __restrict__ q, const int* __restrict__ q_lens,
    const float* __restrict__ k_pool, const float* __restrict__ v_pool,
    const int* __restrict__ tables, const int* __restrict__ lens,
    float* __restrict__ out, int Qmax, int H, int D, int n_blocks,
    int block_size, int max_blocks, float scale) {
  // grid (H, B, Qmax): one block per (head, sequence, window row). Row qi
  // of a window of q_len rows sits at ctx - q_len + qi and attends keys
  // [0, ctx - q_len + qi]; padded rows (qi >= q_len) attend the whole
  // context so they stay finite.
  const int h = blockIdx.x, b = blockIdx.y, qi = blockIdx.z;
  const int ctx = lens[b], qlen = q_lens[b];
  int limit = qi < qlen ? ctx - qlen + qi + 1 : ctx;
  if (limit > ctx) limit = ctx;
  const long long row = (((long long)b * Qmax + qi) * H + h) * D;
  attend_row<E>(q + row, k_pool, v_pool,
                tables + (long long)b * max_blocks, max_blocks, n_blocks,
                block_size, H, D, h, limit, scale, out + row);
}

}  // namespace

#define DISPATCH_E(D, ...)          \
  switch ((D + 31) / 32) {          \
    case 1: { constexpr int E = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int E = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int E = 3; __VA_ARGS__; } break; \
    default: { constexpr int E = 4; __VA_ARGS__; } break; \
  }

extern "C" int paged_attention_fwd(const float* q, const float* k_pool,
                                   const float* v_pool, const int* tables,
                                   const int* lens, float* out, int B, int H,
                                   int D, int n_blocks, int block_size,
                                   int max_blocks, float scale,
                                   void* stream) {
  if (D <= 0 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  if (B > 0 && H > 0) {
    dim3 grid(H, B);
    DISPATCH_E(D, paged_attention_kernel<E>
               <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
                   q, k_pool, v_pool, tables, lens, out, H, D, n_blocks,
                   block_size, max_blocks, scale));
  }
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_mq_fwd(const float* q, const int* q_lens,
                                      const float* k_pool,
                                      const float* v_pool, const int* tables,
                                      const int* lens, float* out, int B,
                                      int Qmax, int H, int D, int n_blocks,
                                      int block_size, int max_blocks,
                                      float scale, void* stream) {
  if (D <= 0 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  if (B > 0 && H > 0 && Qmax > 0) {
    dim3 grid(H, B, Qmax);
    DISPATCH_E(D, paged_attention_mq_kernel<E>
               <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
                   q, q_lens, k_pool, v_pool, tables, lens, out, Qmax, H,
                   D, n_blocks, block_size, max_blocks, scale));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
