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
// What bounds them on the card: bytes. A query row reads ctx * H * D * 4
// bytes each of K and V and does 4 flops per K/V element pair, far below
// the ~20 flops per byte where fp32 arithmetic would take over. Both read
// only what the data needs: a sequence's table entries j < ceil(limit /
// bs) (entries are clamped into the pool), so blocks past the context are
// never read and the cost tracks real tokens, not max_blocks. Tokens at or
// past the limit are skipped, which is what the TPU kernel's -1e30 mask
// amounts to; the output is acc / max(l, 1e-30) as there, so an empty row
// gives 0.
//
// The TPU kernel carries the online-softmax state (m, l, acc) in VMEM
// scratch across a sequential grid axis over one sequence's blocks. Blocks
// on the GPU run in no order, and one block per sequence would let the
// longest context set the pace while most SMs idle. So the single-query
// kernel splits each context into chunks of 128 tokens, and a CUDA block
// owns one (head, sequence, chunk):
//
// - The work list. The grid is (H, G): G blocks walk the list of real
//   chunks, sum_b max(1, ceil(ctx_b / 128)), in order (block y takes items
//   y, y + G, ...), each block locating its item's sequence from the context
//   lengths with a warp prefix sum. G is that count's bound from the shapes,
//   B * ceil(max_blocks * bs / 128), capped at 16 blocks an SM, so the work
//   tracks the real token count (a block past the list exits at once:
//   measured cheaper than fewer blocks that take several items in turn).
// - The tiles. Each of the block's 4 warps owns a 32-token tile of the
//   chunk and copies its K and V rows (D floats each, 256 bytes at D = 64,
//   contiguous in the pool) into shared memory with cp.async; the four
//   tiles' copies are in flight at once, and three blocks share an SM at
//   D = 64 (69 KB each), so one block's copies overlap another's
//   arithmetic. (A two-step ring per warp over chunks of 256 or 512
//   tokens measured slower on an H100: fewer blocks.)
//   Lane t forms q.k of token t from its K row (no reduction per token);
//   the tile's max and sum take one warp reduction each, not an online
//   rescale per token. Then lanes run over D for acc = P V, p broadcast by
//   shuffle. Rows past the context are zero-filled and get p = 0.
// - The merges, all in a fixed order. The 4 warps' states merge through
//   shared memory (M = max m_w, L = sum l_w e^(m_w - M), acc = sum acc_w
//   e^(m_w - M)). A one-chunk sequence writes acc / max(L, 1e-30). Else the
//   block writes its chunk's (M, L, acc) to the scratch `part` and takes a
//   ticket (an atomic add on tickets[b * H + h], the only atomic); the block
//   that draws the last ticket merges the sequence's chunks in chunk order
//   and puts the ticket back to 0, so the tickets stay zeroed between calls.
//   Which block merges varies, the order of the sums does not: the output is
//   bitwise equal from run to run. One launch does it all.
//
// The multi-query verify kernel keeps the design of attend_row below: one
// CUDA block per (sequence, head, window row) whose 8 warps split the
// row's KV blocks (warp w takes blocks w, w + 8, ...), each carrying its
// own (m, l, acc) with a per-token online softmax (q.k by lanes over D and
// a shuffle reduction, four tokens in flight), merged through shared
// memory at the end.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // tf32::cp_async16 / cp_async4

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 128;  // 4 output dims per lane
constexpr int kUnroll = 4;        // tokens in flight per warp
constexpr float kNegInf = -1e30f;

// the split single-query kernel: 4 warps of one 32-token tile each, so a
// chunk of 128 tokens
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kTile = 32;
constexpr int kChunk = kSplitWarps * kTile;

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

// ---------------------------------------------------------------------------
// the single-query kernel: split-KV chunks, tile-wise softmax
// ---------------------------------------------------------------------------

// Everything one launch of the split kernel needs.
struct SplitArgs {
  const float* q;
  const float* k_pool;
  const float* v_pool;
  const int* tables;
  const int* lens;
  float* out;
  float* part;   // [B * H * max_chunks][D + 2]: a chunk's acc, M, L
  int* tickets;  // [B * H], zero between calls
  int B, H, D, n_blocks, block_size, max_blocks, max_chunks;
  float scale;
};

// Tokens of sequence b the kernel attends: the context clamped to what
// the table can address.
__device__ __forceinline__ int seq_tokens(const SplitArgs& A, int b) {
  const int ctx = A.lens[b];
  const int cap = A.max_blocks * A.block_size;
  return ctx < 0 ? 0 : (ctx > cap ? cap : ctx);
}

// Work items of sequence b: its chunks, at least one (an empty row still
// writes its zero output).
__device__ __forceinline__ int seq_chunks(const SplitArgs& A, int b) {
  const int n = seq_tokens(A, b);
  return n == 0 ? 1 : (n + kChunk - 1) / kChunk;
}

// atomicAdd with acquire-release semantics at device scope: the writes the
// block made before its barrier are visible to whoever draws a later
// ticket, and the caller sees those of every earlier one.
__device__ __forceinline__ int ticket(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Walk the work list with a warp prefix sum over the sequences' chunk
// counts: returns the total number of items and, for item w < total, its
// sequence b and chunk c. Every lane gets the same answer.
__device__ int locate(const SplitArgs& A, int w, int& b, int& c) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  b = -1;
  c = 0;
  for (int b0 = 0; b0 < A.B; b0 += 32) {
    const int bi = b0 + lane;
    const int n = bi < A.B ? seq_chunks(A, bi) : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (b < 0) {
      const unsigned hit = __ballot_sync(0xffffffffu, base + incl > w);
      if (hit) {
        const int lb = __ffs(hit) - 1;
        b = b0 + lb;
        c = w - base - __shfl_sync(0xffffffffu, incl - n, lb);
      }
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  return base;
}

// Copy the K and V rows of tokens [t0, t0 + kTile) of sequence b, head h,
// into a warp's tiles (K rows of stride LDK, V rows of stride D); rows at
// or past t_end are zero-filled. kVec: 16-byte copies (D % 4 == 0).
template <bool kVec>
__device__ __forceinline__ void copy_tile(const SplitArgs& A, int b, int h,
                                          int t0, int t_end, float* Ks,
                                          float* Vs, int LDK) {
  const int lane = threadIdx.x & 31;
  constexpr int kW = kVec ? 4 : 1;  // floats per copy
  const int per_row = A.D / kW;
  for (int idx = lane; idx < kTile * per_row; idx += 32) {
    const int r = idx / per_row, col = (idx % per_row) * kW;
    const int t = t0 + r;
    const bool ok = t < t_end;
    long long at = 0;
    if (ok) {
      int blk = A.tables[(long long)b * A.max_blocks + t / A.block_size];
      blk = blk < 0 ? 0 : (blk >= A.n_blocks ? A.n_blocks - 1 : blk);
      const long long row =
          ((long long)blk * A.block_size + t % A.block_size) * A.H + h;
      at = row * A.D + col;
    }
    if constexpr (kVec) {
      tf32::cp_async16(Ks + r * LDK + col, A.k_pool + at, ok);
      tf32::cp_async16(Vs + r * A.D + col, A.v_pool + at, ok);
    } else {
      tf32::cp_async4(Ks + r * LDK + col, A.k_pool + at, ok);
      tf32::cp_async4(Vs + r * A.D + col, A.v_pool + at, ok);
    }
  }
}

// Shared memory of the split kernel, in floats: q (32 E), the warps'
// merge states (m, l: kSplitWarps each; acc: kSplitWarps x 32 E), then
// each warp's K tile (kTile x LDK) and V tile (kTile x D).
__host__ __device__ constexpr int split_ldk(int D, bool vec) {
  return vec ? D + 4 : (D | 1);  // float4 rows / odd stride: no conflicts
}
__host__ __device__ constexpr int split_head(int E) {
  return 32 * E + 2 * kSplitWarps + kSplitWarps * 32 * E;
}
__host__ __device__ constexpr int split_tile(int D, bool vec) {
  return kTile * (split_ldk(D, vec) + D);
}

template <int E, bool kVec>
__global__ void __launch_bounds__(kSplitThreads)
    paged_attention_split_kernel(SplitArgs A) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* m_s = q_s + 32 * E;
  float* l_s = m_s + kSplitWarps;
  float* acc_s = l_s + kSplitWarps;  // [kSplitWarps][32 E]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = A.D, LDK = split_ldk(D, kVec);
  float* Ks = smem + split_head(E) + warp * split_tile(D, kVec);
  float* Vs = Ks + kTile * LDK;
  __shared__ int last_s;

  const int h = blockIdx.x;
  int b, c;
  const int total = locate(A, 0, b, c);

  for (int w = blockIdx.y; w < total; w += gridDim.y) {
    locate(A, w, b, c);
    const int n_tok = seq_tokens(A, b), n_ch = seq_chunks(A, b);
    const int t_end = min((c + 1) * kChunk, n_tok);
    // this warp's tile: tokens [t0, t0 + kTile) of the chunk
    const int t0 = c * kChunk + warp * kTile;
    __syncthreads();  // the previous item's q, tiles and merge states are read
    const long long qrow = ((long long)b * A.H + h) * D;
    for (int d = threadIdx.x; d < 32 * E; d += kSplitThreads)
      q_s[d] = d < D ? A.q[qrow + d] * A.scale : 0.f;
    if (t0 < t_end) copy_tile<kVec>(A, b, h, t0, t_end, Ks, Vs, LDK);
    tf32::cp_async_commit();
    tf32::cp_async_wait<0>();
    __syncthreads();  // q_s is written; each warp's tile has landed

    float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    if (t0 < t_end) {
      const int n = min(kTile, t_end - t0);
      // q.k of token t0 + lane from its K row
      float s = 0.f;
      const float* kr = Ks + lane * LDK;
      if constexpr (kVec) {
#pragma unroll
        for (int d = 0; d < 32 * E; d += 4) {
          if (d < D) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + d);
            const float4 qv = *reinterpret_cast<const float4*>(q_s + d);
            s += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
      } else {
        for (int d = 0; d < D; ++d) s += q_s[d] * kr[d];
      }
      s = lane < n ? s : kNegInf;
      // one max and one sum for the tile
      m = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float p = lane < n ? expf(s - m) : 0.f;
      l = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      // acc = P V, lanes over D; zero-filled rows add 0
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[e] += pt * Vs[t * D + d];
        }
      }
    }

    // merge the warps' states through shared memory, in warp order
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[warp * 32 * E + lane + 32 * e] = acc[e];
    if (lane == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
    __syncthreads();
    const int d = threadIdx.x;
    const long long bh = (long long)b * A.H + h;
    float M = kNegInf, L = 0.f, o = 0.f;
    if (d < D) {
#pragma unroll
      for (int v = 0; v < kSplitWarps; ++v) M = fmaxf(M, m_s[v]);
#pragma unroll
      for (int v = 0; v < kSplitWarps; ++v) {
        const float cw = expf(m_s[v] - M);
        L += l_s[v] * cw;
        o += acc_s[v * 32 * E + d] * cw;
      }
    }
    if (n_ch == 1) {
      if (d < D) A.out[qrow + d] = o / fmaxf(L, 1e-30f);
      continue;
    }
    // a chunk of several: publish (acc, M, L), take a ticket; the last
    // chunk to finish merges them all in chunk order
    float* mine = A.part + (bh * A.max_chunks + c) * (D + 2);
    if (d < D) mine[d] = o;
    if (d == 0) {
      mine[D] = M;
      mine[D + 1] = L;
    }
    __syncthreads();
    if (threadIdx.x == 0) last_s = ticket(A.tickets + bh) == n_ch - 1;
    __syncthreads();
    if (!last_s) continue;
    if (d < D) {
      // the first 8 chunks' (M, L, acc) in one round of loads, then the
      // merge in chunk order: M = max, then L and acc under M
      const float* pc = A.part + bh * A.max_chunks * (D + 2);
      float mk[8], lk[8], ak[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= n_ch) break;
        const float* pk = pc + k * (D + 2);
        mk[k] = __ldcg(pk + D);
        lk[k] = __ldcg(pk + D + 1);
        ak[k] = __ldcg(pk + d);
      }
      float Mx = kNegInf;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n_ch) Mx = fmaxf(Mx, mk[k]);
      for (int k = 8; k < n_ch; ++k)
        Mx = fmaxf(Mx, __ldcg(pc + k * (D + 2) + D));
      float Lx = 0.f, ox = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= n_ch) break;
        const float cw = expf(mk[k] - Mx);
        Lx += lk[k] * cw;
        ox += ak[k] * cw;
      }
      for (int k = 8; k < n_ch; ++k) {
        const float* pk = pc + k * (D + 2);
        const float cw = expf(__ldcg(pk + D) - Mx);
        Lx += __ldcg(pk + D + 1) * cw;
        ox += __ldcg(pk + d) * cw;
      }
      A.out[qrow + d] = ox / fmaxf(Lx, 1e-30f);
    }
    if (threadIdx.x == 0) A.tickets[bh] = 0;
  }
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

// Launch the split kernel at E = ceil(D / 32), 16-byte copies when D and
// the pools allow them: G = min(items, 16 x SMs / H) blocks per head walk
// the work list (a block past its items exits at once; with more items,
// each block takes several in turn).
template <int E, bool kVec>
cudaError_t launch_split(const SplitArgs& A, long long items,
                         cudaStream_t st) {
  const size_t smem =
      (size_t)(split_head(E) + kSplitWarps * split_tile(A.D, kVec)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_split_kernel<E, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long g = (16LL * sms + A.H - 1) / A.H;
  if (g > items) g = items;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  paged_attention_split_kernel<E, kVec>
      <<<dim3(A.H, (unsigned)g), kSplitThreads, smem, st>>>(A);
  return cudaGetLastError();
}

}  // namespace

#define DISPATCH_E(D, ...)          \
  switch ((D + 31) / 32) {          \
    case 1: { constexpr int E = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int E = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int E = 3; __VA_ARGS__; } break; \
    default: { constexpr int E = 4; __VA_ARGS__; } break; \
  }

// part: B * H * max_chunks * (D + 2) floats of scratch, max_chunks =
// ceil(max_blocks * block_size / chunk) (unread when that is 1); tickets:
// B * H ints, zero on entry and left zero. chunk: tokens per work item,
// which the caller states so that its scratch and the kernel agree; it
// must be the kernel's 128.
extern "C" int paged_attention_fwd(const float* q, const float* k_pool,
                                   const float* v_pool, const int* tables,
                                   const int* lens, float* out, float* part,
                                   int* tickets, int B, int H, int D,
                                   int n_blocks, int block_size,
                                   int max_blocks, int chunk, float scale,
                                   void* stream) {
  if (D <= 0 || D > kMaxHeadDim || chunk != kChunk || block_size <= 0 ||
      n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  const long long span = (long long)(max_blocks > 0 ? max_blocks : 0) *
                         block_size;
  long long max_chunks = (span + kChunk - 1) / kChunk;
  if (max_chunks < 1) max_chunks = 1;
  const SplitArgs A{q, k_pool, v_pool, tables, lens, out, part, tickets,
                    B, H, D, n_blocks, block_size, max_blocks,
                    (int)max_chunks, scale};
  // the work list's bound from the shapes: every sequence's chunks
  const long long items = (long long)B * max_chunks;
  const bool vec = D % 4 == 0 && ((uintptr_t)k_pool % 16) == 0 &&
                   ((uintptr_t)v_pool % 16) == 0;
  cudaError_t err = cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    DISPATCH_E(D, err = (launch_split<E, true>(A, items, st)));
  } else {
    DISPATCH_E(D, err = (launch_split<E, false>(A, items, st)));
  }
  return (int)err;
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
