// Fused linear projection + softmax cross-entropy for Hopper (sm_90a), fp32.
//
// Three entry points, replacing the Pallas kernels of
// paddle_tpu/kernels/fused_softmax_xent.py:
//
//   fused_xent_fwd     _fwd_kernel: per row n, the logsumexp of
//                      logits[n, :] = h[n] . W[v] + b[v] over the vocabulary
//                      and the label's logit, streamed over vocab tiles, so
//                      the [N, V] logits never exist in device memory;
//                      loss = lse - picked, exactly 0 at ignore_index.
//                      Two launches: partial (m, s, picked) per (row tile,
//                      vocab split), then a merge per row.
//   fused_xent_bwd_dh  _bwd_dh_kernel: dh = dlog . W with
//                      dlog = g (exp(logit - lse) - onehot), the logits
//                      recomputed tile by tile.
//   fused_xent_bwd_dw  _bwd_dw_kernel: dW = dlog^T . h and db = colsum(dlog),
//                      the same recompute with the vocabulary outer.
//
// Semantics (the Pallas kernels'): reductions in fp32; bias may be null
// (zeros); a label equal to ignore_index gives loss 0 and gradient 0 (its
// g is zeroed); other labels are clamped into [0, V) before they pick, as
// the plain version's gather does. The TPU's padding (a -1e30 bias on
// padded vocab columns, lse = +1e30 on padded rows, 128-lane hidden
// padding) is not ported: tails are masked by bounds here, so W is read in
// place and never copied. The running max starts at -1e30, never -inf.
//
// What bounds them on the card: operations. The forward does 2 N V H flops
// (1.9e11 at BERT-base's N = 4096, V = 30522, H = 768) against ~100 MB
// read; dh and dW each recompute the logits (2 N V H) and contract dlog
// (2 N V H more). All run on the fp32 FMA units (67 TFLOP/s; TF32 stays
// off for parity), as simple SIMT tiles: 256 threads, each owning a
// micro-tile of a logits tile that accumulates over H in 32-wide chunks
// staged through shared memory (rows padded to 36 floats, so the float4
// reads of a quarter-warp hit distinct banks).
// - Forward: a block owns a 64-row tile and a contiguous split of the
//   vocab tiles (64 columns each) and folds each 64 x 64 logits tile into a
//   running (max, sum, picked) per row held in registers; the vocabulary is
//   split over ~16 blocks per SM, so that N / 64 row tiles still fill the
//   card and the last wave is short, and a merge kernel combines the
//   splits' partials.
// - Staging: the operands' 32-column chunks pass through two shared
//   buffers, the next chunk's global loads (float4 where H % 4 == 0) in
//   flight in registers while the current chunk is multiplied; one barrier
//   per chunk.
// - dh: a block owns 32 rows and keeps their [32, H] gradient in shared
//   memory (98 KB at H = 768); it streams every vocab tile once: logits
//   [32 x 64], dlog into shared memory, then dh += dlog . W_tile in 64-column
//   chunks of W. Recompute factor 1 (each logit is computed once in dh).
// - dW/db: the same kernel with the roles swapped: a block owns 32 vocab
//   rows ([32, H] of dW in shared memory, db in registers) and streams
//   every 64-row tile of h. No atomics: every output element is summed by
//   one thread in a fixed order, so results are deterministic.
// Simple first: no tensor cores, no cp.async/TMA, and h (or W) tiles are
// re-read from L2 for every tile of the other operand.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kKC = 32;        // H chunk staged per step
constexpr int kLdk = kKC + 4;  // padded row stride of a staged chunk
constexpr int kVT = 64;        // columns of a logits tile (vocab or rows)
constexpr int kOwn = 32;       // rows a backward block owns
constexpr int kLdt = kVT + 4;  // padded row stride of a 64-wide tile
constexpr float kNeg = -1e30f;

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

// Staging of an R x W tile of a row-major [n, H] matrix (rows x0.., columns
// c0..) through registers into shared memory (row stride W + 4): fetch()
// issues a thread's loads, stash() stores them, so the next tile's loads
// are in flight while the current one is computed on. With `vec` (H % 4
// == 0 and 16-byte aligned data) a thread moves float4s, else floats;
// rows past n and columns past H read as 0.
template <int R, int W>
struct Stage {
  static constexpr int kPer = R * W / kThreads;  // floats per thread
  float r[kPer];

  __device__ __forceinline__ void fetch(const float* __restrict__ X, int x0,
                                        int n, int H, int c0, bool vec) {
    if (vec) {
#pragma unroll
      for (int u = 0; u < kPer / 4; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        const int row = idx / (W / 4), col = (idx % (W / 4)) * 4;
        const int gr = x0 + row, gc = c0 + col;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < n && gc < H)
          v = *reinterpret_cast<const float4*>(X + (long long)gr * H + gc);
        r[4 * u] = v.x; r[4 * u + 1] = v.y; r[4 * u + 2] = v.z;
        r[4 * u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        const int row = idx / W, col = idx % W;
        const int gr = x0 + row, gc = c0 + col;
        r[u] = (gr < n && gc < H) ? X[(long long)gr * H + gc] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void stash(float* S, bool vec) const {
    constexpr int LD = W + 4;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kPer / 4; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        const int row = idx / (W / 4), col = (idx % (W / 4)) * 4;
        *reinterpret_cast<float4*>(S + row * LD + col) =
            make_float4(r[4 * u], r[4 * u + 1], r[4 * u + 2], r[4 * u + 3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        S[(idx / W) * LD + idx % W] = r[u];
      }
    }
  }
};

// acc[i][j] += A[a0 + ty + 16 i] . B[b0 + tx + 16 j] over the H columns of
// row-major A [na, H] and B [nb, H]; rows past na / nb read as 0. Streams
// 32-column chunks of the 16 MA rows of A and 16 MB rows of B through two
// buffers each of shared memory (As: 2 x 16 MA rows, Bs: 2 x 16 MB rows,
// row stride kLdk), the next chunk's loads in flight while the current
// one is multiplied. Begins with a barrier (the caller's earlier use of
// As/Bs is over) and ends with one.
template <int MA, int MB>
__device__ __forceinline__ void tile_dot(float (&acc)[MA][MB],
                                         const float* __restrict__ A, int a0,
                                         int na, const float* __restrict__ B,
                                         int b0, int nb, int H, bool vec,
                                         float* As, float* Bs) {
  constexpr int RA = 16 * MA, RB = 16 * MB;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int chunks = (H + kKC - 1) / kKC;
  Stage<RA, kKC> sa;
  Stage<RB, kKC> sb;
  __syncthreads();
  sa.fetch(A, a0, na, H, 0, vec);
  sb.fetch(B, b0, nb, H, 0, vec);
  sa.stash(As, vec);
  sb.stash(Bs, vec);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const float* Ac = As + (ch & 1) * RA * kLdk;
    const float* Bc = Bs + (ch & 1) * RB * kLdk;
    const bool more = ch + 1 < chunks;
    if (more) {
      sa.fetch(A, a0, na, H, (ch + 1) * kKC, vec);
      sb.fetch(B, b0, nb, H, (ch + 1) * kKC, vec);
    }
#pragma unroll 4
    for (int c = 0; c < kKC; c += 4) {
      float4 a[MA], b[MB];
#pragma unroll
      for (int i = 0; i < MA; ++i)
        a[i] = *reinterpret_cast<const float4*>(Ac + (ty + 16 * i) * kLdk + c);
#pragma unroll
      for (int j = 0; j < MB; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bc + (tx + 16 * j) * kLdk + c);
#pragma unroll
      for (int i = 0; i < MA; ++i)
#pragma unroll
        for (int j = 0; j < MB; ++j)
          acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                       a[i].w * b[j].w;
    }
    if (more) {
      sa.stash(As + ((ch + 1) & 1) * RA * kLdk, vec);
      sb.stash(Bs + ((ch + 1) & 1) * RB * kLdk, vec);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ long long clamp_label(long long lab, int V) {
  return lab < 0 ? 0 : (lab >= V ? V - 1 : lab);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Partial (m, s, picked) of rows [64 bx, 64 bx + 64) over the vocab tiles
// of split by: part[0|1|2][by * N + n].
__global__ void __launch_bounds__(kThreads)
    xent_fwd_partial_kernel(const float* __restrict__ h,
                            const float* __restrict__ w,
                            const float* __restrict__ bias,
                            const long long* __restrict__ labels, int N,
                            int V, int H, bool vec,
                            float* __restrict__ part) {
  __shared__ __align__(16) float As[2 * 64 * kLdk];
  __shared__ __align__(16) float Bs[2 * kVT * kLdk];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int r0 = blockIdx.x * 64;
  const int tiles = (V + kVT - 1) / kVT;
  const int per = (tiles + gridDim.y - 1) / gridDim.y;
  const int t0 = blockIdx.y * per;
  const int t1 = min(tiles, t0 + per);

  long long lab[4];
  float m[4], s[4], pk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = r0 + ty + 16 * i;
    lab[i] = n < N ? clamp_label(labels[n], V) : -1;
    m[i] = kNeg;
    s[i] = 0.f;
    pk[i] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kVT;
    float acc[4][4] = {};
    tile_dot<4, 4>(acc, h, r0, N, w, v0, V, H, vec, As, Bs);
    float bj[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      ok[j] = v < V;
      bj[j] = (ok[j] && bias) ? bias[v] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = ok[j] ? acc[i][j] + bj[j] : kNeg;
        acc[i][j] = x;
        mt = fmaxf(mt, x);
        if (ok[j] && v0 + tx + 16 * j == lab[i]) pk[i] += x;
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps += ok[j] ? expf(acc[i][j] - m_new) : 0.f;
      s[i] = s[i] * expf(m[i] - m_new) + row_sum16(ps);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p = row_sum16(pk[i]);  // one lane holds the picked logit
    const int n = r0 + ty + 16 * i;
    if (tx == 0 && n < N) {
      const long long at = (long long)blockIdx.y * N + n;
      part[at] = m[i];
      part[(long long)gridDim.y * N + at] = s[i];
      part[2LL * gridDim.y * N + at] = p;
    }
  }
}

// lse and loss of each row from its splits' partials.
__global__ void xent_fwd_merge_kernel(const float* __restrict__ part,
                                      const long long* __restrict__ labels,
                                      int N, int splits,
                                      long long ignore_index,
                                      float* __restrict__ loss,
                                      float* __restrict__ lse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long sn = (long long)splits * N;
  float mx = kNeg;
  for (int k = 0; k < splits; ++k)
    mx = fmaxf(mx, part[(long long)k * N + n]);
  float sum = 0.f, picked = 0.f;
  for (int k = 0; k < splits; ++k) {
    const long long at = (long long)k * N + n;
    sum += part[sn + at] * expf(part[at] - mx);
    picked += part[2 * sn + at];
  }
  const float l = mx + logf(sum);
  lse[n] = l;
  loss[n] = labels[n] == ignore_index ? 0.f : l - picked;
}

// ---------------------------------------------------------------------------
// backward: dh (kDW false) and dW/db (kDW true)
// ---------------------------------------------------------------------------

// A block owns rows [32 bx, 32 bx + 32) of X (h for dh, W for dW) and
// streams 64-row tiles of Y (W for dh, h for dW): for each, the logits tile
// [32 x 64] (rows of X against rows of Y), dlog into shared memory, then
// out[own] += dlog . Y_tile in 64-column chunks. out is [32, H] in shared
// memory until the end.
template <bool kDW>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const long long* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, int N, int V, int H,
                    long long ignore_index, bool vec,
                    float* __restrict__ out, float* __restrict__ db) {
  extern __shared__ __align__(16) float smem[];
  float* acc_s = smem;                // [32][H]
  float* As = acc_s + kOwn * H;       // 2 x [32][kLdk]
  float* Bs = As + 2 * kOwn * kLdk;   // 2 x [64][kLdk]
  float* Ds = Bs + 2 * kVT * kLdk;    // [32][kLdt] dlog, own rows x tile
  float* Ys = Ds + kOwn * kLdt;       // 2 x [64][kLdt] 64 x 64 chunks of Y

  const float* X = kDW ? w : h;
  const float* Y = kDW ? h : w;
  const int nx = kDW ? V : N, ny = kDW ? N : V;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int x0 = blockIdx.x * kOwn;

  for (int i = threadIdx.x; i < kOwn * H; i += kThreads) acc_s[i] = 0.f;

  // what depends only on the owned row: (g, lse, label) of an h row for dh,
  // the bias of a vocab row for dW
  float own_g[2], own_lse[2], own_b[2];
  long long own_lab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = x0 + ty + 16 * i;
    own_g[i] = own_lse[i] = own_b[i] = 0.f;
    own_lab[i] = -1;
    if (x < nx) {
      if (kDW) {
        own_b[i] = bias ? bias[x] : 0.f;
      } else {
        const long long lab = labels[x];
        own_g[i] = lab == ignore_index ? 0.f : g[x];
        own_lse[i] = lse[x];
        own_lab[i] = clamp_label(lab, V);
      }
    }
  }
  float db_acc[2] = {0.f, 0.f};

  for (int y0 = 0; y0 < ny; y0 += kVT) {
    float s[2][4] = {};
    tile_dot<2, 4>(s, X, x0, nx, Y, y0, ny, H, vec, As, Bs);
    float col_g[4], col_lse[4], col_b[4];
    long long col_lab[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = y0 + tx + 16 * j;
      col_g[j] = col_lse[j] = col_b[j] = 0.f;
      col_lab[j] = -1;
      if (y < ny) {
        if (kDW) {
          const long long lab = labels[y];
          col_g[j] = lab == ignore_index ? 0.f : g[y];
          col_lse[j] = lse[y];
          col_lab[j] = clamp_label(lab, V);
        } else {
          col_b[j] = bias ? bias[y] : 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = x0 + ty + 16 * i;
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int y = y0 + tx + 16 * j;
        // (g, lse, label) belong to the h row, bias and the onehot column
        // to the vocab row
        const float gn = kDW ? col_g[j] : own_g[i];
        const float ln = kDW ? col_lse[j] : own_lse[i];
        const long long lab = kDW ? col_lab[j] : own_lab[i];
        const int v = kDW ? x : y;
        const float bv = kDW ? own_b[i] : col_b[j];
        float d = 0.f;
        if (gn != 0.f && x < nx && y < ny)
          d = gn * (expf(s[i][j] + bv - ln) - (v == lab ? 1.f : 0.f));
        Ds[(ty + 16 * i) * kLdt + tx + 16 * j] = d;
        row += d;
      }
      if (kDW) db_acc[i] += row_sum16(row);
    }
    // out[own] += dlog . Y[y0 : y0 + 64] in 64-column chunks, double
    // buffered like tile_dot (the first barrier also publishes Ds)
    Stage<kVT, kVT> sy;
    const int chunks = (H + kVT - 1) / kVT;
    sy.fetch(Y, y0, ny, H, 0, vec);
    sy.stash(Ys, vec);
    __syncthreads();
    for (int ch = 0; ch < chunks; ++ch) {
      const float* Yc = Ys + (ch & 1) * kVT * kLdt;
      const bool more = ch + 1 < chunks;
      if (more) sy.fetch(Y, y0, ny, H, (ch + 1) * kVT, vec);
      float a[2][4] = {};
#pragma unroll 2
      for (int k = 0; k < kVT; k += 4) {
        float4 d[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          d[i] = *reinterpret_cast<const float4*>(Ds + (ty + 16 * i) * kLdt +
                                                  k);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 yv =
              *reinterpret_cast<const float4*>(Yc + (k + u) * kLdt + tx * 4);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float dv = u == 0 ? d[i].x : u == 1 ? d[i].y
                             : u == 2 ? d[i].z : d[i].w;
            a[i][0] += dv * yv.x;
            a[i][1] += dv * yv.y;
            a[i][2] += dv * yv.z;
            a[i][3] += dv * yv.w;
          }
        }
      }
      // each thread owns its (row, column) entries of the accumulator
      const int c0 = ch * kVT;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = c0 + tx * 4 + u;
          if (col < H) acc_s[(ty + 16 * i) * H + col] += a[i][u];
        }
      if (more) sy.stash(Ys + ((ch + 1) & 1) * kVT * kLdt, vec);
      __syncthreads();
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kOwn * H; idx += kThreads) {
    const int r = idx / H;
    if (x0 + r < nx) out[(long long)(x0 + r) * H + idx % H] = acc_s[idx];
  }
  if (kDW && db && tx == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = x0 + ty + 16 * i;
      if (x < nx) db[x] = db_acc[i];
    }
  }
}

// Dynamic shared memory of a backward block: 170 KB at H = 768; H <= 1260
// fits the 227 KB a block may have (kernels/fused_softmax_xent.py checks).
size_t bwd_smem(int H) {
  return (size_t)(kOwn * H + 2 * kOwn * kLdk + 2 * kVT * kLdk +
                  kOwn * kLdt + 2 * kVT * kLdt) * sizeof(float);
}

// float4 staging needs H % 4 == 0 and 16-byte aligned h and W.
bool vec_ok(const float* h, const float* w, int H) {
  return H % 4 == 0 && ((uintptr_t)h & 15) == 0 && ((uintptr_t)w & 15) == 0;
}

bool bad_dims(int N, int V, int H) { return N <= 0 || V <= 0 || H <= 0; }

template <bool kDW>
cudaError_t launch_bwd(const float* h, const float* w, const float* bias,
                       const long long* labels, const float* lse,
                       const float* g, int N, int V, int H,
                       long long ignore_index, float* out, float* db,
                       void* stream) {
  const size_t smem = bwd_smem(H);
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel<kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int nx = kDW ? V : N;
  xent_bwd_kernel<kDW><<<(nx + kOwn - 1) / kOwn, kThreads, smem,
                         (cudaStream_t)stream>>>(
      h, w, bias, labels, lse, g, N, V, H, ignore_index, vec_ok(h, w, H),
      out, db);
  return cudaGetLastError();
}

}  // namespace

// part: [3, splits, N] scratch; loss, lse: [N].
extern "C" int fused_xent_fwd(const float* h, const float* w,
                              const float* bias, const long long* labels,
                              float* part, float* loss, float* lse, int N,
                              int V, int H, int splits,
                              long long ignore_index, void* stream) {
  if (bad_dims(N, V, H) || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + 63) / 64, splits);
  xent_fwd_partial_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      h, w, bias, labels, N, V, H, vec_ok(h, w, H), part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, labels, N, splits, ignore_index, loss, lse);
  return (int)cudaGetLastError();
}

// dh: [N, H].
extern "C" int fused_xent_bwd_dh(const float* h, const float* w,
                                 const float* bias, const long long* labels,
                                 const float* lse, const float* g, float* dh,
                                 int N, int V, int H, long long ignore_index,
                                 void* stream) {
  if (bad_dims(N, V, H)) return (int)cudaErrorInvalidValue;
  return (int)launch_bwd<false>(h, w, bias, labels, lse, g, N, V, H,
                                ignore_index, dh, nullptr, stream);
}

// dw: [V, H]; db: [V] or null (no bias).
extern "C" int fused_xent_bwd_dw(const float* h, const float* w,
                                 const float* bias, const long long* labels,
                                 const float* lse, const float* g, float* dw,
                                 float* db, int N, int V, int H,
                                 long long ignore_index, void* stream) {
  if (bad_dims(N, V, H)) return (int)cudaErrorInvalidValue;
  return (int)launch_bwd<true>(h, w, bias, labels, lse, g, N, V, H,
                               ignore_index, dw, db, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
