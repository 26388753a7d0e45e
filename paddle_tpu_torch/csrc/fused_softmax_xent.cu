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
// read; the backward 6 N V H (logits once, then dW and dh). All four
// products run on the tensor cores in 3xTF32 (tf32_mma.cuh): about fp32's
// accuracy at a third of the dense TF32 rate, 165 of 495 TFLOP/s, against
// 67 for the FP32 FMA units. The tensor cores' fp32 sums are not rounded
// to nearest and their error grows with the number of products summed into
// one register, so every product sums a stage of K into a fresh register
// tile and adds it to its output tile with fp32 adds.
//
// Forward: the logits h . W^T are K-major x K-major (H contiguous in both),
// the one layout wgmma takes for tf32, so they run on wgmma. A 256-thread
// block (two warpgroups, 64 rows each) owns a 128-row tile of h and a
// contiguous split of the 128-column vocab tiles (the wrapper picks the
// split count so that the (row tile, split) blocks fill whole waves of one
// block per SM), and walks (tile, 64-deep k-block) stages through a
// two-stage cp.async ring of raw h and W. Per stage, the block splits W's
// tile once into hi and lo tiles in wgmma's unswizzled K-major layout (the
// B operand must sit in shared memory), each warp splits its A fragments of
// h in registers, and each warpgroup runs 8 k-steps x (lo.hi, hi.lo,
// hi.hi) wgmma m64n128k8 products into a fresh 64-register tile, waited
// for and added with fp32 adds (24 tensor-core sums per register). When a
// tile's last stage is in, each thread folds its 2 rows x 32 columns of
// logits (plus bias, masked past V) into a running (max, sum of exp,
// picked logit) per row, in registers; a warp owns its 16 rows across all
// 128 columns, so at the end the four lanes of a row combine by shuffles
// and one writes the split's partial, and the merge kernel combines the
// splits. The logits never leave the registers.
//
// Backward: one mma.sync product template serves its three products:
// - A block computes a 128 x BN output tile with 8 warps, each owning
//   64 x BN / 4 (4 x BN / 32 fragments of 16 x 8); operands pass through
//   shared memory in stages of depth 32, a ring of 4 filled by cp.async (16
//   bytes a thread where H % 4 == 0 and the data is 16-byte aligned, else
//   4), zero-filled past every edge (src-size 0). Fragments are loaded by
//   hand, so an operand may be K-major (h and W in the logits, D in dh) or
//   MN-major (D and h in dW, W in dh): wgmma takes tf32 operands only
//   K-major, which the dW product's are not. Shared rows are padded
//   (K-major: 36 floats; MN-major: width + 8) so that each fragment load of
//   a warp hits 32 distinct banks. Each k-step of 8 splits all of a warp's
//   fragments first, then runs the lo.hi, hi.lo and hi.hi passes, each of
//   4 x BN / 32 independent products, 12 tensor-core sums per register of
//   a stage's fresh tile, whatever K is (K = N = 4096 in dW). The two tiles
//   take ~200 registers: one 256-thread block per SM.
// - One recompute: the logits of a chunk are computed once and their
//   gradient D stored ([N, Vc], 32 MB at N = 4096, Vc = 2048, which stays
//   in the 50 MB L2 between the product that writes it and the two that
//   read it). The pair does 6 N V H flops where the TPU's does 8.
// - Waves on 132 SMs: logits tiles are 128 x 128 (512 per chunk at
//   N = 4096: 3.9 waves), dW and dh tiles 128 x 96 (H = 768 is 8 x 96: dW
//   16 x 8 = 128 tiles at Vc = 2048, one wave; dh 32 x 8 = 256, two).
// - Ignored rows and columns past V get D exactly 0 (no exp is evaluated
//   there); they are not compacted away, so the backward needs no
//   device-to-host sync. No hidden-size cap: H is only a loop bound.
//
// Deterministic: no atomics. Each output element is summed by one thread
// in a fixed order; db by one thread per column (the first H tile's
// blocks) in row order; dh is read, added to and written once per chunk,
// in chunk order; the forward's partials are combined in a fixed order.
// Not yet: TMA, warp specialisation, a persistent grid, wgmma in the
// backward.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ long long clamp_label(long long lab, int V) {
  return lab < 0 ? 0 : (lab >= V ? V - 1 : lab);
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
      tf32::cp_async16(s + r * LD + c, ok ? m.p + gr * m.ld + gc : m.p, ok);
    }
  } else {
    constexpr int kPer = R * C / kThreads;
#pragma unroll 4
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / C, c = i % C;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < m.rows && gc < m.cols;
      tf32::cp_async4(s + r * LD + c, ok ? m.p + gr * m.ld + gc : m.p, ok);
    }
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
    tf32::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tf32::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is consumed
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk * kBKd);
    tf32::cp_async_commit();
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
      for (int j = 0; j < NT; ++j)
        tf32::frag_b<Cfg::kBK, LDB>(bs, wn + j * 8, kk, bh[j], bl[j]);
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        tf32::frag_a<Cfg::kAK, LDA>(as, wm + i * 16, kk, ah[i], al[i]);
      // small terms first; each pass runs MT x NT independent products
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (kk == 0)
            tf32::mma<true>(part[i][j], al[i], bh[j]);
          else
            tf32::mma(part[i][j], al[i], bh[j]);
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) tf32::mma(part[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) tf32::mma(part[i][j], ah[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  tf32::cp_async_wait<0>();

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

// ---------------------------------------------------------------------------
// forward: 3xTF32 wgmma logits tiles folded into per-row partials
// ---------------------------------------------------------------------------

// d (+)= a . B on a 64 x 128 x 8 tile of one warpgroup (wgmma, sm_90a): a
// is the warp's A fragment (the mma.sync layout; the warp's 16 rows of the
// 64), B is read from shared memory through its descriptor, d holds
// (row g (+ 8), columns 8 j + 2 t (+ 1)) at d[4 j + 2 half + e]. kScaleD 0
// overwrites d. The product is asynchronous: wgmma.fence before it,
// commit and wait after.
template <int kScaleD>
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(kScaleD));
}

// The shared-memory descriptor of a K-major, unswizzled wgmma operand of
// 64 columns: core matrices of 8 rows x 16 bytes, 128 bytes apart along K
// (the leading byte offset) and 2048 bytes apart along N (the stride byte
// offset).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((s & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(2048 >> 4) << 32);
}

// Keeps the compiler from reading d before the products that write it have
// been waited for.
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct FwdArgs {
  const float* h;
  const float* w;
  const float* bias;
  const long long* labels;
  float* part;  // [3, splits, N]: max, sum of exp, picked logit
  int N, V, H;
  bool vec;  // 16-byte copies of h and W
};

// (m, s) <- the online-softmax union of (m, s) and (om, os).
__device__ __forceinline__ void merge_ms(float& m, float& s, float om,
                                         float os) {
  const float mn = fmaxf(m, om);
  s = s * expf(m - mn) + os * expf(om - mn);
  m = mn;
}

// The forward's stages are 64 deep (24 tensor-core sums per register of a
// fresh tile; 32 deep, the products drain the wgmma pipe twice as often:
// 3.1 ms against 2.9 at BERT-base's head on an H100), two in the ring.
constexpr int kFK = 64;
constexpr int kFS = 2;
constexpr int kFwdLd = kFK + 4;        // raw h and W rows in the ring
constexpr int kFwdRaw = kBM * kFwdLd;  // one operand's stage, floats
constexpr int kFwdB = kBM * kFK;       // one split W tile, words
constexpr size_t kFwdSmem =
    (size_t)(2 * kFS * kFwdRaw + 2 * kFwdB) * sizeof(float);

// Partial (m, s, picked) of rows [128 bx, 128 bx + 128) over the vocab tiles
// of split by: part[0|1|2][by * N + n].
__global__ void __launch_bounds__(kThreads, 1)
    xent_fwd_partial_kernel(FwdArgs a) {
  constexpr int BN = 128;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                 // kFS raw h stages [128][68]
  float* Bs = As + kFS * kFwdRaw;   // kFS raw W stages [128][68]
  uint32_t* Bh = reinterpret_cast<uint32_t*>(Bs + kFS * kFwdRaw);
  uint32_t* Bl = Bh + kFwdB;        // the stage's W, split, wgmma layout

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // warpgroup warp / 4 owns rows 64 (warp / 4) ..; its warp w % 4 the 16
  // rows wr .. wr + 15 of them, all 128 columns
  const int wr = (warp >> 2) * 64 + (warp & 3) * 16;
  const int m0 = blockIdx.x * kBM;
  const int tiles = (a.V + BN - 1) / BN;
  const int per = (tiles + gridDim.y - 1) / gridDim.y;
  const int t0 = blockIdx.y * per, t1 = min(tiles, t0 + per);
  const int KT = (a.H + kFK - 1) / kFK;
  const int iters = t1 > t0 ? (t1 - t0) * KT : 0;
  const Mat A{a.h, a.H, a.N, a.H}, B{a.w, a.H, a.V, a.H};
  const uint64_t desc_h = wgmma_desc(Bh), desc_l = wgmma_desc(Bl);

  // stage `it` of the ring: k-block it % KT of the split's tile it / KT
  auto load_stage = [&](int stage, int it) {
    const int n0 = (t0 + it / KT) * BN, k0 = (it % KT) * kFK;
    load_tile<kBM, kFK, kFwdLd>(As + stage * kFwdRaw, A, m0, k0, a.vec);
    load_tile<BN, kFK, kFwdLd>(Bs + stage * kFwdRaw, B, n0, k0, a.vec);
  };

  // the running (max, sum, picked) of the thread's rows m0 + wr + gid
  // (+ 8)
  float rm[2], rs[2], rp[2];
  int lab[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = m0 + wr + gid + 8 * half;
    lab[half] = n < a.N ? (int)clamp_label(a.labels[n], a.V) : -1;
    rm[half] = kNeg;
    rs[half] = 0.f;
    rp[half] = 0.f;
  }
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kFS - 1; ++s) {
    if (s < iters) load_stage(s, s);
    tf32::cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    tf32::cp_async_wait<kFS - 2>();
    __syncthreads();  // stage it landed; the last stage's products are done
    const int nk = it + kFS - 1;
    if (nk < iters) load_stage(nk % kFS, nk);
    tf32::cp_async_commit();
    const float* as = As + (it % kFS) * kFwdRaw;
    const float* bs = Bs + (it % kFS) * kFwdRaw;
    // W's tile split once for both warpgroups into hi and lo, element
    // (n, k) at word (n % 8) 4 + (n / 8) 512 + (k / 4) 32 + k % 4; eight
    // threads store one 128-byte core matrix
#pragma unroll
    for (int u = 0; u < kFwdB / 4 / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int n = (i & 7) + ((i >> 7) << 3), k4 = (i >> 3) & 15;
      const float4 v =
          *reinterpret_cast<const float4*>(bs + n * kFwdLd + k4 * 4);
      uint4 h, l;
      tf32::split(v.x, h.x, l.x);
      tf32::split(v.y, h.y, l.y);
      tf32::split(v.z, h.z, l.z);
      tf32::split(v.w, h.w, l.w);
      const int o = (n & 7) * 4 + (n >> 3) * 512 + k4 * 32;
      *reinterpret_cast<uint4*>(Bh + o) = h;
      *reinterpret_cast<uint4*>(Bl + o) = l;
    }
    // the generic-proxy stores become visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    uint32_t ah[kFK / 8][4], al[kFK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kFK / 8; ++kk)
      tf32::frag_a<true, kFwdLd>(as, wr, kk * 8, ah[kk], al[kk]);
    // the stage's 24 products per register into a fresh tile (part), small
    // terms first; k-step kk starts 2 core matrices (256 bytes) further
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kFK / 8; ++kk) {
      if (kk == 0)
        wgmma_m64n128k8<0>(part, al[kk], desc_h);
      else
        wgmma_m64n128k8<1>(part, al[kk], desc_h + 16 * kk);
      wgmma_m64n128k8<1>(part, ah[kk], desc_l + 16 * kk);
      wgmma_m64n128k8<1>(part, ah[kk], desc_h + 16 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_fence_operands(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    if (it % KT != KT - 1) continue;
    // the tile is complete: fold it into the rows' running state; a
    // thread holds columns n0 + 8 j + 2 tig (+ 1)
    const int c0 = (t0 + it / KT) * BN + 2 * tig;
    float bj[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        bj[j][e] = c < a.V && a.bias ? a.bias[c] : 0.f;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + e;
          float& x = acc[4 * j + 2 * half + e];
          x = c < a.V ? x + bj[j][e] : kNeg;
          mt = fmaxf(mt, x);
          if (c == lab[half]) rp[half] += x;
        }
      const float m_new = fmaxf(rm[half], mt);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = acc[4 * j + 2 * half + e];
          ps += c0 + 8 * j + e < a.V ? expf(x - m_new) : 0.f;
          x = 0.f;
        }
      rs[half] = rs[half] * expf(rm[half] - m_new) + ps;
      rm[half] = m_new;
    }
  }
  tf32::cp_async_wait<0>();

  // the four lanes that share a row, then one lane writes the partial
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, rm[half], o);
      const float os = __shfl_xor_sync(0xffffffffu, rs[half], o);
      rp[half] += __shfl_xor_sync(0xffffffffu, rp[half], o);
      merge_ms(rm[half], rs[half], om, os);
    }
    const int n = m0 + wr + gid + 8 * half;
    if (tig == 0 && n < a.N) {
      const long long at = (long long)blockIdx.y * a.N + n;
      const long long sn = (long long)gridDim.y * a.N;
      a.part[at] = rm[half];
      a.part[sn + at] = rs[half];
      a.part[2 * sn + at] = rp[half];
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

}  // namespace

// part: [3, splits, N] scratch; loss, lse: [N].
extern "C" int fused_xent_fwd(const float* h, const float* w,
                              const float* bias, const long long* labels,
                              float* part, float* loss, float* lse, int N,
                              int V, int H, int splits,
                              long long ignore_index, void* stream) {
  if (bad_dims(N, V, H) || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xent_fwd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a{h, w, bias, labels, part, N, V, H, vec_ok(h, w, H)};
  dim3 grid((N + kBM - 1) / kBM, splits);
  xent_fwd_partial_kernel<<<grid, kThreads, kFwdSmem,
                            (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
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
