// Fused linear projection + softmax cross-entropy for Hopper (sm_90a), fp32.
//
// Entry points, replacing the Pallas kernels of
// paddle_tpu/kernels/fused_softmax_xent.py:
//
//   fused_xent_fwd       _fwd_kernel: per row n, the logsumexp of
//                        logits[n, :] = h[n] . W[v] + b[v] over the
//                        vocabulary and the label's logit, streamed over
//                        vocab tiles, so the [N, V] logits never exist in
//                        device memory; loss = lse - picked, exactly 0 at
//                        ignore_index. Two launches: partial (m, s, picked)
//                        per (row tile, vocab split), then a merge per row.
//   fused_xent_bwd_dlog  the recompute that _backward's two kernels
//                        (_bwd_dh_kernel, _bwd_dw_kernel) each repeat, done
//                        once: for one chunk of vocabulary columns
//                        [v0, v0 + vc), D[n, v] = g_n (exp(h_n . W_v + b_v -
//                        lse_n) - onehot) into an [N, Vc] scratch.
//   fused_xent_bwd_dw    _bwd_dw_kernel: dW[v0 + v] = (D^T h)[v] and
//                        db[v0 + v] = colsum(D)[v] of the chunk.
//   fused_xent_bwd_dh    _bwd_dh_kernel: dh (+)= D . W[v0 : v0 + vc], the
//                        chunks added in order.
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
// read; the backward 6 N V H (logits once, then dW and dh).
//
// Forward: fp32 SIMT tiles on the FMA units (67 TFLOP/s): 256 threads,
// each owning a 4 x 4 micro-tile of a 64 x 64 logits tile that accumulates
// over H in 32-wide chunks staged through shared memory (rows padded to 36
// floats, so the float4 reads of a quarter-warp hit distinct banks), the
// next chunk's float4 loads in flight in registers while the current one
// is multiplied. A block owns a 64-row tile and a contiguous split of the
// vocab tiles, folding each logits tile into a running (max, sum, picked)
// per row in registers; the vocabulary is split over ~16 blocks per SM so
// that N / 64 row tiles fill the card, and a merge kernel combines the
// splits' partials.
//
// Backward: three products of one template per vocabulary chunk, on the
// tensor cores in 3xTF32 (mma.sync.aligned.m16n8k8, .tf32 operands): each
// operand is split in registers as hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), and lo.hi + hi.lo + hi.hi accumulate in fp32, which
// keeps about fp32's accuracy (plain TF32 keeps ~3 digits) at a third of
// the TF32 rate: 165 of 495 TFLOP/s, against 67 for the FMA units.
// - One recompute: the logits of a chunk are computed once and their
//   gradient D stored ([N, Vc], 32 MB at N = 4096, Vc = 2048, which stays
//   in the 50 MB L2 between the product that writes it and the two that
//   read it). The pair does 6 N V H flops where the TPU's does 8.
// - The template: a block computes a 128 x BN output tile with 8 warps,
//   each owning 64 x BN / 4 (4 x BN / 32 fragments of 16 x 8); operands
//   pass through shared memory in stages of depth 32, a ring of 4 filled by
//   cp.async (16 bytes a thread where H % 4 == 0 and the data is 16-byte
//   aligned, else 4), zero-filled past every edge (src-size 0). Fragments
//   are loaded by hand, so an operand may be K-major (h and W in the
//   logits, D in dh) or MN-major (D and h in dW, W in dh): wgmma takes tf32
//   operands only K-major, which the dW product's are not. Shared rows are
//   padded (K-major: 36 floats; MN-major: width + 8) so that each fragment
//   load of a warp hits 32 distinct banks. Each k-step of 8 splits all of
//   a warp's fragments first, then runs the lo.hi, hi.lo and hi.hi passes,
//   each of 4 x BN / 32 independent products.
// - Accuracy: the tensor cores' fp32 sums are not rounded to nearest, and
//   their error grows with the number of products summed into one
//   register (K / 8 x 3). So each stage's products go into a fresh
//   register tile, which is then added into the output tile with fp32
//   adds: 12 tensor-core sums per register, whatever K is (K = N = 4096 in
//   dW). The two tiles take ~200 registers: one 256-thread block per SM.
// - Waves on 132 SMs: logits tiles are 128 x 128 (512 per chunk at
//   N = 4096: 3.9 waves), dW and dh tiles 128 x 96 (H = 768 is 8 x 96: dW
//   16 x 8 = 128 tiles at Vc = 2048, one wave; dh 32 x 8 = 256, two).
// - Deterministic: no atomics. Each output element is summed by one thread
//   in a fixed order; db by one thread per column (the first H tile's
//   blocks) in row order; dh is read, added to and written once per chunk,
//   in chunk order.
// - Ignored rows and columns past V get D exactly 0 (no exp is evaluated
//   there); they are not compacted away, so the backward needs no
//   device-to-host sync. No hidden-size cap: H is only a loop bound.
// Not yet: wgmma, TMA, warp specialisation, a persistent grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kKC = 32;        // H chunk staged per step
constexpr int kLdk = kKC + 4;  // padded row stride of a staged chunk
constexpr int kVT = 64;        // columns of a logits tile (vocab or rows)
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
// backward: 3xTF32 tensor-core products over vocabulary chunks
// ---------------------------------------------------------------------------

constexpr int kBM = 128;    // rows of a block's output tile
constexpr int kBKd = 32;    // reduction depth of a pipeline stage
constexpr int kStages = 4;  // cp.async ring
constexpr int kWarpsN = 4;  // 8 warps: 2 along M (64 rows each) x 4 along N

enum Product { kDlog = 0, kDw = 1, kDh = 2 };

// A row-major global matrix: rows x cols valid, row stride ld floats.
struct Mat {
  const float* p;
  long long ld;
  int rows, cols;
};

struct BwdArgs {
  const float* h;
  const float* w;  // the chunk's first row: W + v0 * H
  const float* bias;
  const long long* labels;
  const float* lse;
  const float* g;
  float* dlog;  // [N, Vc]
  float* dw;    // the chunk's first row: dW + v0 * H
  float* db;    // the chunk's first entry, or null
  float* dh;
  int N, V, H, v0, vc, Vc;
  long long ignore_index;
  int accumulate;  // dh: add to what the earlier chunks wrote
  bool vec;        // 16-byte copies of h and W
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of m into shared memory of row
// stride LD; what lies outside m's rows x cols reads as 0. With vec, cols
// is a multiple of 4 and every row 16-byte aligned.
template <int R, int C, int LD>
__device__ __forceinline__ void load_tile(float* s, const Mat& m, int r0,
                                          int c0, bool vec) {
  if (vec) {
    constexpr int kPer = R * C / 4 / kThreads;
    static_assert(kPer * 4 * kThreads == R * C, "tile / threads");
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / (C / 4), c = (i % (C / 4)) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < m.rows && gc < m.cols;
      cp_async16(s + r * LD + c, ok ? m.p + gr * m.ld + gc : m.p, ok);
    }
  } else {
    constexpr int kPer = R * C / kThreads;
#pragma unroll 4
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / C, c = i % C;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < m.rows && gc < m.cols;
      cp_async4(s + r * LD + c, ok ? m.p + gr * m.ld + gc : m.p, ok);
    }
  }
}

// Element (mn, k) of a staged operand: K-major tiles are stored [mn][k],
// MN-major ones [k][mn].
template <bool kKMajor, int LD>
__device__ __forceinline__ float frag(const float* s, int mn, int k) {
  return kKMajor ? s[mn * LD + k] : s[k * LD + mn];
}

// x = hi + lo, both tf32 (the low 13 mantissa bits 0), rounded to nearest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// c += a . b on a 16 x 8 x 8 tile (PTX fragment layouts: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4,
// n g); c0/c1 (g, 2t / 2t + 1), c2/c3 (g + 8, ...), g = lane / 4,
// t = lane % 4); with kZero, c = a . b.
template <bool kZero>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (kZero) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

template <int P>
struct ProductCfg {
  static constexpr bool kAK = P != kDw;    // A K-major (h; D in dh)
  static constexpr bool kBK = P == kDlog;  // B K-major (W in the logits)
  static constexpr int BN = P == kDlog ? 128 : 96;
  static constexpr int LDA = kAK ? kBKd + 4 : kBM + 8;
  static constexpr int LDB = kBK ? kBKd + 4 : BN + 8;
  static constexpr int A_SZ = kAK ? kBM * LDA : kBKd * LDA;
  static constexpr int B_SZ = kBK ? BN * LDB : kBKd * LDB;
  static constexpr size_t kSmem = (size_t)kStages * (A_SZ + B_SZ) *
                                  sizeof(float);
};

// One 128 x BN tile of product P (blockIdx.y: M tile, blockIdx.x: N tile):
//   kDlog  C[n, v] = h[n] . W[v0 + v]           (M = N, N = vc, K = H)
//   kDw    C[v, j] = sum_n D[n, v] h[n, j]      (M = vc, N = H, K = N)
//   kDh    C[n, j] = sum_v D[n, v] W[v0 + v, j] (M = N, N = H, K = vc)
// and its epilogue.
template <int P>
__device__ __forceinline__ void xent_bwd_product(const BwdArgs& a) {
  using Cfg = ProductCfg<P>;
  constexpr int BN = Cfg::BN, LDA = Cfg::LDA, LDB = Cfg::LDB;
  constexpr int WN = BN / kWarpsN, NT = WN / 8, MT = 4;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + kStages * Cfg::A_SZ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp / kWarpsN) * 64, wn = (warp % kWarpsN) * WN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;

  Mat A, B;
  int K;
  bool vecA = true;
  if constexpr (P == kDlog) {
    A = {a.h, a.H, a.N, a.H};
    B = {a.w, a.H, a.vc, a.H};
    K = a.H;
    vecA = a.vec;
  } else if constexpr (P == kDw) {
    A = {a.dlog, a.Vc, a.N, a.Vc};  // [n][v]: k rows, m columns
    B = {a.h, a.H, a.N, a.H};       // [n][j]: k rows, n columns
    K = a.N;
  } else {
    A = {a.dlog, a.Vc, a.N, a.Vc};  // [n][v]: m rows, k columns
    B = {a.w, a.H, a.vc, a.H};      // [v][j]: k rows, n columns
    K = a.vc;
  }
  const bool vecB = a.vec;

  auto load_stage = [&](int stage, int k0) {
    float* as = As + stage * Cfg::A_SZ;
    float* bs = Bs + stage * Cfg::B_SZ;
    if constexpr (Cfg::kAK)
      load_tile<kBM, kBKd, LDA>(as, A, m0, k0, vecA);
    else
      load_tile<kBKd, kBM, LDA>(as, A, k0, m0, vecA);
    if constexpr (Cfg::kBK)
      load_tile<BN, kBKd, LDB>(bs, B, n0, k0, vecB);
    else
      load_tile<kBKd, BN, LDB>(bs, B, k0, n0, vecB);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // db: the first N tile's threads 0..127 each sum one column of D
  const bool do_db = P == kDw && a.db != nullptr && blockIdx.x == 0 &&
                     threadIdx.x < kBM;
  float colsum = 0.f;

  const int KT = (K + kBKd - 1) / kBKd;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * kBKd);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is consumed
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk * kBKd);
    cp_async_commit();
    const float* as = As + (kt % kStages) * Cfg::A_SZ;
    const float* bs = Bs + (kt % kStages) * Cfg::B_SZ;
    if (do_db) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < kBKd; ++r) s += as[r * LDA + threadIdx.x];
      colsum += s;
    }
    // the stage's products accumulate on the tensor cores (whose fp32
    // sums are not rounded to nearest), then into acc with fp32 adds
    float part[MT][NT][4];
#pragma unroll
    for (int kk = 0; kk < kBKd; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + j * 8 + gid;
        split_tf32(frag<Cfg::kBK, LDB>(bs, n, kk + tig), bh[j][0], bl[j][0]);
        split_tf32(frag<Cfg::kBK, LDB>(bs, n, kk + tig + 4), bh[j][1],
                   bl[j][1]);
      }
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = wm + i * 16 + gid;
        split_tf32(frag<Cfg::kAK, LDA>(as, m, kk + tig), ah[i][0], al[i][0]);
        split_tf32(frag<Cfg::kAK, LDA>(as, m + 8, kk + tig), ah[i][1],
                   al[i][1]);
        split_tf32(frag<Cfg::kAK, LDA>(as, m, kk + tig + 4), ah[i][2],
                   al[i][2]);
        split_tf32(frag<Cfg::kAK, LDA>(as, m + 8, kk + tig + 4), ah[i][3],
                   al[i][3]);
      }
      // small terms first; each pass runs MT x NT independent products
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (kk == 0)
            mma_tf32<true>(part[i][j], al[i], bh[j]);
          else
            mma_tf32<false>(part[i][j], al[i], bh[j]);
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32<false>(part[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32<false>(part[i][j], ah[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // epilogue: a thread holds rows m0 + wm + 16 i + gid (+ 8) and columns
  // n0 + wn + 8 j + 2 tig (+ 1)
  if constexpr (P == kDlog) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = m0 + wm + i * 16 + gid + 8 * half;
        if (n >= a.N) continue;
        const long long lab = a.labels[n];
        const float gn = lab == a.ignore_index ? 0.f : a.g[n];
        const float ln = a.lse[n];
        const long long hot = clamp_label(lab, a.V) - a.v0;
        float* drow = a.dlog + (long long)n * a.Vc;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + wn + j * 8 + 2 * tig;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            d[e] = 0.f;
            if (gn != 0.f && c + e < a.vc) {
              const float bv = a.bias ? a.bias[a.v0 + c + e] : 0.f;
              d[e] = gn * (expf(acc[i][j][2 * half + e] + bv - ln) -
                           (c + e == hot ? 1.f : 0.f));
            }
          }
          *reinterpret_cast<float2*>(drow + c) = make_float2(d[0], d[1]);
        }
      }
  } else {
    float* out = P == kDw ? a.dw : a.dh;
    const int rows = P == kDw ? a.vc : a.N;
    const bool pair = (a.H & 1) == 0;  // float2 stores stay aligned
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + i * 16 + gid + 8 * half;
        if (r >= rows) continue;
        float* orow = out + (long long)r * a.H;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + wn + j * 8 + 2 * tig;
          float x0 = acc[i][j][2 * half], x1 = acc[i][j][2 * half + 1];
          if (pair && c + 1 < a.H) {
            float2* at = reinterpret_cast<float2*>(orow + c);
            if (P == kDh && a.accumulate) {
              const float2 old = *at;
              x0 += old.x;
              x1 += old.y;
            }
            *at = make_float2(x0, x1);
          } else {
            if (c < a.H) {
              if (P == kDh && a.accumulate) x0 += orow[c];
              orow[c] = x0;
            }
            if (c + 1 < a.H) {
              if (P == kDh && a.accumulate) x1 += orow[c + 1];
              orow[c + 1] = x1;
            }
          }
        }
      }
    if (do_db && m0 + (int)threadIdx.x < a.vc)
      a.db[m0 + threadIdx.x] = colsum;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_dlog_kernel(BwdArgs a) {
  xent_bwd_product<kDlog>(a);
}

__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_dw_kernel(BwdArgs a) {
  xent_bwd_product<kDw>(a);
}

__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_dh_kernel(BwdArgs a) {
  xent_bwd_product<kDh>(a);
}

// float4 staging needs H % 4 == 0 and 16-byte aligned h and W.
bool vec_ok(const float* h, const float* w, int H) {
  return H % 4 == 0 && ((uintptr_t)h & 15) == 0 && ((uintptr_t)w & 15) == 0;
}

bool bad_dims(int N, int V, int H) { return N <= 0 || V <= 0 || H <= 0; }

// A chunk: 0 < vc <= Vc, Vc a multiple of the 128-row tile (the products
// read whole tiles of the [N, Vc] scratch), the grid within its limits.
bool bad_chunk(int N, int H, int vc, int Vc) {
  return N <= 0 || H <= 0 || vc <= 0 || vc > Vc || Vc % kBM != 0 ||
         (N + kBM - 1) / kBM > 65535 || (vc + kBM - 1) / kBM > 65535;
}

template <int P, typename Kernel>
cudaError_t launch_product(Kernel kernel, dim3 grid, const BwdArgs& a,
                           void* stream) {
  constexpr size_t smem = ProductCfg<P>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
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

// The gradient of the logits of vocabulary columns [v0, v0 + vc) into
// dlog [N, Vc] (columns past vc written 0). h [N, H], w [V, H], bias [V] or
// null, labels, lse, g [N].
extern "C" int fused_xent_bwd_dlog(const float* h, const float* w,
                                   const float* bias,
                                   const long long* labels,
                                   const float* lse, const float* g,
                                   float* dlog, int N, int V, int H, int v0,
                                   int vc, int Vc, long long ignore_index,
                                   void* stream) {
  if (bad_dims(N, V, H) || bad_chunk(N, H, vc, Vc) || v0 < 0 ||
      v0 > V - vc)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.h = h;
  a.w = w + (long long)v0 * H;
  a.bias = bias;
  a.labels = labels;
  a.lse = lse;
  a.g = g;
  a.dlog = dlog;
  a.N = N; a.V = V; a.H = H; a.v0 = v0; a.vc = vc; a.Vc = Vc;
  a.ignore_index = ignore_index;
  a.vec = vec_ok(h, w, H);
  dim3 grid((vc + 127) / 128, (N + kBM - 1) / kBM);
  return (int)launch_product<kDlog>(xent_bwd_dlog_kernel, grid, a, stream);
}

// dW rows [v0, v0 + vc) = dlog^T h, and db[v0 : v0 + vc] its column sums
// (db null: no bias). dlog [N, Vc], h [N, H], dw [V, H].
extern "C" int fused_xent_bwd_dw(const float* dlog, const float* h,
                                 float* dw, float* db, int N, int H, int v0,
                                 int vc, int Vc, void* stream) {
  if (bad_chunk(N, H, vc, Vc) || v0 < 0) return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.dlog = const_cast<float*>(dlog);
  a.h = h;
  a.dw = dw + (long long)v0 * H;
  a.db = db ? db + v0 : nullptr;
  a.N = N; a.H = H; a.v0 = v0; a.vc = vc; a.Vc = Vc;
  a.vec = vec_ok(h, h, H);
  constexpr int BN = ProductCfg<kDw>::BN;
  dim3 grid((H + BN - 1) / BN, (vc + kBM - 1) / kBM);
  return (int)launch_product<kDw>(xent_bwd_dw_kernel, grid, a, stream);
}

// dh [N, H] = dlog . W[v0 : v0 + vc] (accumulate 0), or += it (1).
extern "C" int fused_xent_bwd_dh(const float* dlog, const float* w,
                                 float* dh, int N, int H, int v0, int vc,
                                 int Vc, int accumulate, void* stream) {
  if (bad_chunk(N, H, vc, Vc) || v0 < 0) return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.dlog = const_cast<float*>(dlog);
  a.w = w + (long long)v0 * H;
  a.dh = dh;
  a.N = N; a.H = H; a.v0 = v0; a.vc = vc; a.Vc = Vc;
  a.accumulate = accumulate;
  a.vec = vec_ok(w + (long long)v0 * H, w, H);
  constexpr int BN = ProductCfg<kDh>::BN;
  dim3 grid((H + BN - 1) / BN, (N + kBM - 1) / kBM);
  return (int)launch_product<kDh>(xent_bwd_dh_kernel, grid, a, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
