// Ragged paged attention over a block-paged KV pool, for Hopper (sm_90a),
// fp32. Two entry points over one kernel:
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
// valid token, the window's own included. Row qi of a window of q_len rows
// sits at ctx - q_len + qi and attends keys [0, ctx - q_len + qi]; padded
// rows (qi >= q_len) and the single query attend the whole context.
//
// What bounds them on the card: bytes. A query row reads ctx * H * D * 4
// bytes each of K and V and does 4 flops per K/V element pair, far below
// the ~20 flops per byte where fp32 arithmetic would take over. Both read
// only what the data needs: a sequence's table entries j < ceil(ctx / bs)
// (entries are clamped into the pool), so blocks past the context are
// never read and the cost tracks real tokens, not max_blocks. A token past
// a row's limit gets p = 0, which is what the TPU kernel's -1e30 mask
// amounts to; the output is acc / max(l, 1e-30) as there, so an empty row
// gives 0.
//
// The TPU kernel carries the online-softmax state (m, l, acc) in VMEM
// scratch across a sequential grid axis over one sequence's blocks. Blocks
// on the GPU run in no order, and one block per sequence would let the
// longest context set the pace while most SMs idle. So the kernel splits
// each context into chunks of 128 tokens, and a CUDA block owns one (head,
// sequence, chunk) with every query row of that sequence:
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
//   D = 64 (69-74 KB each), so one block's copies overlap another's
//   arithmetic. (A two-step ring per warp over chunks of 256 or 512
//   tokens measured slower on an H100: fewer blocks.)
// - The window shares each tile. The query rows go through in groups of G
//   (1 for the single-query entry, kRowGroup for the verify window; a wider
//   window takes more passes over the same tiles, so K and V cross device
//   memory once whatever Qmax is). A group's rows, pre-scaled, sit in
//   shared memory. Lane t forms q_r.k of token t for each row r from its K
//   row (no reduction per token); each row's tile max and sum take one warp
//   reduction each, not an online rescale per token. Then lanes run over D
//   for acc_r += P V, p broadcast by shuffle and each V value read once for
//   the group. Tokens past a row's limit, and zero-filled rows past the
//   context, get p = 0 explicitly: a tile or chunk wholly past a row's
//   limit leaves that row the exact empty state (m = -1e30, l = 0, acc = 0).
// - The merges, all in a fixed order. The 4 warps' per-row states merge
//   through shared memory (M = max m_w, L = sum l_w e^(m_w - M), acc = sum
//   acc_w e^(m_w - M)). A one-chunk sequence writes acc / max(L, 1e-30).
//   Else the block writes each row's (acc, M, L) for its chunk to the
//   scratch `part` and takes a ticket (an atomic add on tickets[b * H + h],
//   the only atomic); the block that draws the last ticket merges every
//   row's chunks in chunk order and puts the ticket back to 0, so the
//   tickets stay zeroed between calls. Every row with a key sees key 0, in
//   chunk 0, so its merged M is finite and the empty partials add 0. Which
//   block merges varies, the order of the sums does not: the output is
//   bitwise equal from run to run. One launch does it all.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // tf32::cp_async16 / cp_async4

namespace {

constexpr int kMaxHeadDim = 128;  // 4 output dims per lane
constexpr float kNegInf = -1e30f;

// 4 warps of one 32-token tile each, so a chunk of 128 tokens
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kTile = 32;
constexpr int kChunk = kSplitWarps * kTile;
// window rows the verify entry takes in one pass over a chunk's tiles;
// a group of 1 is the single-query entry
constexpr int kRowGroup = 4;
static_assert(kRowGroup > 1, "G == 1 is the single-query entry");

// Everything one launch needs.
struct SplitArgs {
  const float* q;       // [B, Qmax, H, D]
  const int* q_lens;    // [B] window rows (the verify entry's)
  const float* k_pool;
  const float* v_pool;
  const int* tables;
  const int* lens;
  float* out;           // as q
  float* part;   // [B * H * max_chunks * Qmax][D + 2]: a row's acc, M, L
  int* tickets;  // [B * H], zero between calls
  int B, Qmax, H, D, n_blocks, block_size, max_blocks, max_chunks;
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

// Keys [0, limit) that window row qi of sequence b attends.
__device__ __forceinline__ int row_limit(const SplitArgs& A, int b, int qi,
                                         int n_tok) {
  const int ql = A.q_lens[b];
  const int lim = qi < ql ? A.lens[b] - ql + qi + 1 : n_tok;
  return lim < n_tok ? lim : n_tok;
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
// or past t_end are zero-filled. Lane t reads token t0 + t's table entry
// once and the copies take each row's offset by shuffle. kVec: 16-byte
// copies (D % 4 == 0).
template <int E, bool kVec>
__device__ __forceinline__ void copy_tile(const SplitArgs& A, int b, int h,
                                          int t0, int t_end, float* Ks,
                                          float* Vs, int LDK) {
  const int lane = threadIdx.x & 31;
  constexpr int kW = kVec ? 4 : 1;  // floats per copy
  long long mine = -1;
  const int t = t0 + lane;
  if (t < t_end) {
    int blk = A.tables[(long long)b * A.max_blocks + t / A.block_size];
    blk = blk < 0 ? 0 : (blk >= A.n_blocks ? A.n_blocks - 1 : blk);
    mine = (((long long)blk * A.block_size + t % A.block_size) * A.H + h) *
           A.D;
  }
  const int per_row = A.D / kW;
#pragma unroll
  for (int i = 0; i < 32 * E / kW; ++i) {  // kTile * per_row / 32 at most
    const int idx = lane + 32 * i;
    if (idx >= kTile * per_row) break;
    const int r = idx / per_row, col = (idx % per_row) * kW;
    const long long row = __shfl_sync(0xffffffffu, mine, r);
    const bool ok = row >= 0;
    const long long at = ok ? row + col : 0;
    if constexpr (kVec) {
      tf32::cp_async16(Ks + r * LDK + col, A.k_pool + at, ok);
      tf32::cp_async16(Vs + r * A.D + col, A.v_pool + at, ok);
    } else {
      tf32::cp_async4(Ks + r * LDK + col, A.k_pool + at, ok);
      tf32::cp_async4(Vs + r * A.D + col, A.v_pool + at, ok);
    }
  }
}

// Shared memory, in floats: the group's q rows (G x 32 E), the warps'
// per-row merge states (m, l: kSplitWarps x G each; acc: kSplitWarps x G
// x 32 E), then each warp's K tile (kTile x LDK) and V tile (kTile x D).
__host__ __device__ constexpr int split_ldk(int D, bool vec) {
  return vec ? D + 4 : (D | 1);  // float4 rows / odd stride: no conflicts
}
__host__ __device__ constexpr int split_head(int E, int G) {
  return G * 32 * E + 2 * kSplitWarps * G + kSplitWarps * G * 32 * E;
}
__host__ __device__ constexpr int split_tile(int D, bool vec) {
  return kTile * (split_ldk(D, vec) + D);
}

// Row group G; G == 1 is the single-query entry (one row, the whole
// context), where Qmax, the row limits and a (row, dim) pair's row fold
// to constants.
template <int E, bool kVec, int G>
__global__ void __launch_bounds__(kSplitThreads)
    paged_attention_split_kernel(SplitArgs A) {
  constexpr bool kSingle = G == 1;
  const int Qmax = kSingle ? 1 : A.Qmax;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [G][32 E]
  float* m_s = q_s + G * 32 * E;         // [kSplitWarps][G]
  float* l_s = m_s + kSplitWarps * G;    // [kSplitWarps][G]
  float* acc_s = l_s + kSplitWarps * G;  // [kSplitWarps][G][32 E]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = A.D, LDK = split_ldk(D, kVec);
  float* Ks = smem + split_head(E, G) + warp * split_tile(D, kVec);
  float* Vs = Ks + kTile * LDK;
  __shared__ int last_s;

  const int h = blockIdx.x;
  int b, c;
  const int total = locate(A, 0, b, c);

  // Barriers: each group writes q_s, then one barrier before the tiles
  // and q_s are read, and one before the warps' states are merged; the
  // next group's (or item's) writes to q_s, the tiles and the states
  // come after one of those barriers that follows every read of them.
  for (int w = blockIdx.y; w < total; w += gridDim.y) {
    locate(A, w, b, c);
    const int n_tok = seq_tokens(A, b), n_ch = seq_chunks(A, b);
    const int t_end = min((c + 1) * kChunk, n_tok);
    // this warp's tile: tokens [t0, t0 + n) of the chunk
    const int t0 = c * kChunk + warp * kTile;
    const int n = max(0, min(kTile, t_end - t0));
    if (n > 0) copy_tile<E, kVec>(A, b, h, t0, t_end, Ks, Vs, LDK);
    tf32::cp_async_commit();
    const long long bh = (long long)b * A.H + h;

    for (int r0 = 0; r0 < Qmax; r0 += G) {
      const int nr = min(G, Qmax - r0);
      for (int i = threadIdx.x; i < G * 32 * E; i += kSplitThreads) {
        const int r = i / (32 * E), d = i % (32 * E);
        q_s[i] = r < nr && d < D
                     ? A.q[((b * (long long)Qmax + r0 + r) * A.H + h) * D +
                           d] * A.scale
                     : 0.f;
      }
      tf32::cp_async_wait<0>();
      __syncthreads();  // q_s is written; each warp's tile has landed

      // each row's limit: the tile's tokens t0 + lane < lim[r] count
      // (lim <= n_tok, so those are inside the tile's [t0, t0 + n))
      int lim[G];
      float m[G], l[G], acc[G][E];
#pragma unroll
      for (int r = 0; r < G; ++r) {
        lim[r] = kSingle ? n_tok
                 : r < nr ? row_limit(A, b, r0 + r, n_tok) : 0;
        m[r] = kNegInf;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
      }
      if (n > 0) {
        // q_r.k of token t0 + lane from its K row, for every row r
        float s[G];
#pragma unroll
        for (int r = 0; r < G; ++r) s[r] = 0.f;
        const float* kr = Ks + lane * LDK;
        if constexpr (kVec) {
#pragma unroll
          for (int d = 0; d < 32 * E; d += 4) {
            if (d < D) {
              const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
              for (int r = 0; r < G; ++r) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(q_s + r * 32 * E + d);
                s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
              }
            }
          }
        } else {
          for (int d = 0; d < D; ++d) {
            const float kd = kr[d];
#pragma unroll
            for (int r = 0; r < G; ++r) s[r] += q_s[r * 32 * E + d] * kd;
          }
        }
        // one max and one sum per row for the tile; p = 0 past the row's
        // limit
        float p[G];
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const bool ok = t0 + lane < lim[r];
          float mr = ok ? s[r] : kNegInf;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, o));
          p[r] = ok ? expf(s[r] - mr) : 0.f;
          float lr = p[r];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            lr += __shfl_xor_sync(0xffffffffu, lr, o);
          m[r] = mr;
          l[r] = lr;
        }
        // acc_r += P V, lanes over D; zero-filled rows add 0
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) {
          float v[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int d = lane + 32 * e;
            v[e] = d < D ? Vs[t * D + d] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < G; ++r) {
            const float pt = __shfl_sync(0xffffffffu, p[r], t);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] += pt * v[e];
          }
        }
      }

      // merge the warps' states through shared memory, in warp order
#pragma unroll
      for (int r = 0; r < G; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc_s[(warp * G + r) * 32 * E + lane + 32 * e] = acc[r][e];
        if (lane == 0) {
          m_s[warp * G + r] = m[r];
          l_s[warp * G + r] = l[r];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nr * D; i += kSplitThreads) {
        const int r = kSingle ? 0 : i / D, d = kSingle ? i : i % D;
        float M = kNegInf, L = 0.f, o = 0.f;
#pragma unroll
        for (int v = 0; v < kSplitWarps; ++v) M = fmaxf(M, m_s[v * G + r]);
#pragma unroll
        for (int v = 0; v < kSplitWarps; ++v) {
          const float cw = expf(m_s[v * G + r] - M);
          L += l_s[v * G + r] * cw;
          o += acc_s[(v * G + r) * 32 * E + d] * cw;
        }
        const int qi = r0 + r;
        if (n_ch == 1) {
          A.out[((b * (long long)Qmax + qi) * A.H + h) * D + d] =
              o / fmaxf(L, 1e-30f);
        } else {
          // a sequence of several chunks: publish this row's (acc, M, L)
          float* mine =
              A.part + ((bh * A.max_chunks + c) * Qmax + qi) * (D + 2);
          mine[d] = o;
          if (d == 0) {
            mine[D] = M;
            mine[D + 1] = L;
          }
        }
      }
    }
    if (n_ch == 1) continue;

    // take a ticket; the last chunk to finish merges every row's chunks
    // in chunk order
    __syncthreads();
    if (threadIdx.x == 0) last_s = ticket(A.tickets + bh) == n_ch - 1;
    __syncthreads();
    if (!last_s) continue;
    const long long cs = (long long)Qmax * (D + 2);  // a chunk's rows
    for (int i = threadIdx.x; i < Qmax * D; i += kSplitThreads) {
      const int qi = kSingle ? 0 : i / D, d = kSingle ? i : i % D;
      // the first 8 chunks' (M, L, acc) in one round of loads, then the
      // merge in chunk order: M = max, then L and acc under M
      const float* pc = A.part + (bh * A.max_chunks * Qmax + qi) * (D + 2);
      float mk[8], lk[8], ak[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= n_ch) break;
        const float* pk = pc + k * cs;
        mk[k] = __ldcg(pk + D);
        lk[k] = __ldcg(pk + D + 1);
        ak[k] = __ldcg(pk + d);
      }
      float Mx = kNegInf;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n_ch) Mx = fmaxf(Mx, mk[k]);
      for (int k = 8; k < n_ch; ++k) Mx = fmaxf(Mx, __ldcg(pc + k * cs + D));
      float Lx = 0.f, ox = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= n_ch) break;
        const float cw = expf(mk[k] - Mx);
        Lx += lk[k] * cw;
        ox += ak[k] * cw;
      }
      for (int k = 8; k < n_ch; ++k) {
        const float* pk = pc + k * cs;
        const float cw = expf(__ldcg(pk + D) - Mx);
        Lx += __ldcg(pk + D + 1) * cw;
        ox += __ldcg(pk + d) * cw;
      }
      A.out[((b * (long long)Qmax + qi) * A.H + h) * D + d] =
          ox / fmaxf(Lx, 1e-30f);
    }
    if (threadIdx.x == 0) A.tickets[bh] = 0;
  }
}

// Launch at E = ceil(D / 32), row group G: G_y = min(items, 16 x SMs / H)
// blocks per head walk the work list (a block past its items exits at
// once; with more items, each block takes several in turn).
template <int E, bool kVec, int G>
cudaError_t launch_split(const SplitArgs& A, cudaStream_t st) {
  const size_t smem =
      (size_t)(split_head(E, G) + kSplitWarps * split_tile(A.D, kVec)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_split_kernel<E, kVec, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the work list's bound from the shapes: every sequence's chunks
  const long long items = (long long)A.B * A.max_chunks;
  long long g = (16LL * sms + A.H - 1) / A.H;
  if (g > items) g = items;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  paged_attention_split_kernel<E, kVec, G>
      <<<dim3(A.H, (unsigned)g), kSplitThreads, smem, st>>>(A);
  return cudaGetLastError();
}

#define DISPATCH_E(D, ...)          \
  switch ((D + 31) / 32) {          \
    case 1: { constexpr int E = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int E = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int E = 3; __VA_ARGS__; } break; \
    default: { constexpr int E = 4; __VA_ARGS__; } break; \
  }

// Check the shapes, fill in max_chunks and launch with row group G,
// 16-byte copies when D and the pools allow them.
template <int G>
int launch(SplitArgs A, int chunk, void* stream) {
  if (A.D <= 0 || A.D > kMaxHeadDim || chunk != kChunk ||
      A.block_size <= 0 || A.n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (A.B <= 0 || A.H <= 0 || A.Qmax <= 0) return (int)cudaGetLastError();
  const long long span = (long long)(A.max_blocks > 0 ? A.max_blocks : 0) *
                         A.block_size;
  long long max_chunks = (span + kChunk - 1) / kChunk;
  A.max_chunks = max_chunks < 1 ? 1 : (int)max_chunks;
  const bool vec = A.D % 4 == 0 && ((uintptr_t)A.k_pool % 16) == 0 &&
                   ((uintptr_t)A.v_pool % 16) == 0;
  cudaError_t err = cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    DISPATCH_E(A.D, err = (launch_split<E, true, G>(A, st)));
  } else {
    DISPATCH_E(A.D, err = (launch_split<E, false, G>(A, st)));
  }
  return (int)err;
}

}  // namespace

// part: B * H * max_chunks * Qmax * (D + 2) floats of scratch, max_chunks
// = ceil(max_blocks * block_size / chunk) (unread when that is 1); tickets:
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
  const SplitArgs A{q, nullptr, k_pool, v_pool, tables, lens, out, part,
                    tickets, B, 1, H, D, n_blocks, block_size, max_blocks,
                    1, scale};
  return launch<1>(A, chunk, stream);
}

extern "C" int paged_attention_mq_fwd(const float* q, const int* q_lens,
                                      const float* k_pool,
                                      const float* v_pool, const int* tables,
                                      const int* lens, float* out,
                                      float* part, int* tickets, int B,
                                      int Qmax, int H, int D, int n_blocks,
                                      int block_size, int max_blocks,
                                      int chunk, float scale, void* stream) {
  const SplitArgs A{q, q_lens, k_pool, v_pool, tables, lens, out, part,
                    tickets, B, Qmax, H, D, n_blocks, block_size, max_blocks,
                    1, scale};
  return launch<kRowGroup>(A, chunk, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
