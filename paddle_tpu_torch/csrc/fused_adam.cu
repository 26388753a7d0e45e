// Paddle's Adam update over every leaf of a step in one launch, for Hopper
// (sm_90a), fp32.
//
// One entry point, fused_adam_multi, with two variants of one device
// function, each replacing a Pallas kernel of
// paddle_tpu/kernels/fused_adam.py and keeping its order of operations:
//
//   variant 0 (leaf)  _adam_leaf_kernel, the unfused update as written:
//                     p - (lr_c m) / (sqrt(v) + eps)
//   variant 1 (flat)  _adam_kernel, the reciprocal form:
//                     p - lr_c (m (1 / (sqrt(v) + eps)) [+ wd p])
//
// with m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g^2 before either.
// AdamW's decoupled decay p_new - (lr wd) p_old is folded in for the leaves
// whose flag is set (a flag, not a zero coefficient: 0 * p is not an
// identity for a non-finite p).
//
// Bitwise equal to PyTorch's eager ops: each product, sum, quotient and
// square root is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn never contract into an FMA), as PyTorch's one-op-per-kernel
// evaluation rounds them; the host passes 1 - b1 and 1 - b2 already
// rounded to float32 from the double, as PyTorch's scalar ops see them.
//
// Launch: a table of leaves, int64 [L][8] = (p, g, m, v, numel, first
// chunk, decay flag, 0), in device memory; the grid has one block per
// 8192-element chunk of every leaf, and a block finds its leaf by binary
// search over the first-chunk column. lr_c (the bias-corrected rate), ok
// (the skip-step guard) and, where given, lr_wd (the decay coefficient of a
// scheduled rate) are read from device memory, so the step needs no host
// sync; with ok false the kernel writes nothing, which is what the unfused
// path's torch.where(ok, new, old) leaves.
//
// What bounds it on the card: bytes. Per element it reads p, g, m, v and
// writes p, m, v (28 bytes) for ~15 flops: 110 M elements of BERT-base move
// 3.1 GB, 0.92 ms at 3.35 TB/s. Loads are float4 where all four pointers of
// a leaf are 16-byte aligned, scalar for a leaf's tail and unaligned leaves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // elements per block
constexpr int kCols = 8;            // int64 columns of a leaf's table row

struct Scalars {
  float b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2 (float32)
  float lr_wd;                // decoupled decay coefficient lr * wd
  float wd;                   // the flat variant's weight_decay term
  int variant;                // 0 leaf, 1 flat
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     float lr, const Scalars& a,
                                     bool decay) {
  const float m2 = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.c1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.c2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(v2), a.eps);
  float pn;
  if (a.variant == 0) {
    pn = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, m2), den));
  } else {
    float upd = __fmul_rn(m2, __fdiv_rn(1.f, den));
    if (a.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(a.wd, p));
    pn = __fsub_rn(p, __fmul_rn(lr, upd));
  }
  if (decay) pn = __fsub_rn(pn, __fmul_rn(a.lr_wd, p));
  p = pn;
  m = m2;
  v = v2;
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const long long* __restrict__ table, int n_leaves,
                      const float* __restrict__ lr_c,
                      const bool* __restrict__ ok,
                      const float* __restrict__ lr_wd, Scalars a) {
  if (ok && !*ok) return;
  if (lr_wd) a.lr_wd = *lr_wd;
  const long long chunk = blockIdx.x;
  // the last leaf whose first chunk is <= this block's
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid * kCols + 5] <= chunk) lo = mid; else hi = mid - 1;
  }
  const long long* row = table + lo * kCols;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  float* m = reinterpret_cast<float*>(row[2]);
  float* v = reinterpret_cast<float*>(row[3]);
  const long long n = row[4];
  const bool decay = row[6] != 0;
  const long long begin = (chunk - row[5]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  const float lr = *lr_c;
  const bool vec = ((row[0] | row[1] | row[2] | row[3]) & 15) == 0;

  long long i = begin + 4LL * threadIdx.x;
  if (vec) {
    for (; i + 3 < end; i += 4LL * kThreads) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      const float4 gv = *reinterpret_cast<const float4*>(g + i);
      float4 mv = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      adam(pv.x, gv.x, mv.x, vv.x, lr, a, decay);
      adam(pv.y, gv.y, mv.y, vv.y, lr, a, decay);
      adam(pv.z, gv.z, mv.z, vv.z, lr, a, decay);
      adam(pv.w, gv.w, mv.w, vv.w, lr, a, decay);
      *reinterpret_cast<float4*>(p + i) = pv;
      *reinterpret_cast<float4*>(m + i) = mv;
      *reinterpret_cast<float4*>(v + i) = vv;
    }
  }
  // scalar: an unaligned leaf whole, else the last < 4 elements of the leaf
  for (; i < end; i += 4LL * kThreads) {
    for (long long e = i; e < i + 4 && e < end; ++e) {
      float pe = p[e], me = m[e], ve = v[e];
      adam(pe, g[e], me, ve, lr, a, decay);
      p[e] = pe;
      m[e] = me;
      v[e] = ve;
    }
  }
}

}  // namespace

// table: int64 [n_leaves][8] on the device (see the note above); n_chunks:
// the total number of 8192-element chunks; lr_c: a float on the device;
// ok: a bool on the device, or null (always update); lr_wd_dev: a float on
// the device that replaces lr_wd, or null.
extern "C" int fused_adam_multi(const long long* table, int n_leaves,
                                int n_chunks, const float* lr_c,
                                const bool* ok, const float* lr_wd_dev,
                                float b1, float c1, float b2, float c2,
                                float eps, float lr_wd, float wd,
                                int variant, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const Scalars a{b1, c1, b2, c2, eps, lr_wd, wd, variant};
  adam_multi_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      table, n_leaves, lr_c, ok, lr_wd_dev, a);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
