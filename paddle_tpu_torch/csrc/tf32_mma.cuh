// 3xTF32 tensor-core products and cp.async copies for sm_90a, shared by
// fused_softmax_xent.cu and flash_attention.cu.
//
// 3xTF32: each fp32 operand is split as hi = rna(x), lo = rna(x - hi)
// (cvt.rna.tf32.f32's rounding), and lo.hi + hi.lo + hi.hi accumulate in fp32
// on the tensor cores (mma.sync.aligned.m16n8k8, .tf32 operands). Only
// lo.lo (~2^-22 of a product) is dropped, so a product keeps about fp32's
// accuracy (plain TF32 keeps ~3 digits) at a third of the dense TF32 rate:
// 165 of 495 TFLOP/s on an H100, against 67 for the FP32 FMA units. The
// tensor cores' fp32 sums are not rounded to nearest and their error
// grows with the number of products summed into one register, so callers
// sum a short stretch of K into a fresh register tile and add it into
// their accumulator with fp32 adds.
//
// Fragment layouts (PTX, m16n8k8 .tf32; g = lane / 4, t = lane % 4):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, n g), b1 (k t + 4, n g); c0/c1 (g, 2t / 2t + 1), c2/c3 (g + 8,
// 2t / 2t + 1). Fragments are loaded by hand from shared memory, so an
// operand may be stored K-major ([mn][k]) or MN-major ([k][mn]): wgmma
// takes tf32 operands only K-major.

#pragma once

#include <stdint.h>

namespace tf32 {

// cvt.rna.tf32.f32 of a finite x, bit for bit, in two integer operations
// (the conversion instruction costs more on sm_90): half of the dropped 13
// bits' weight added to the magnitude, then the 13 bits cleared; a carry
// moves into the exponent, the sign is untouched.
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both tf32 (the low 13 mantissa bits 0), rounded to nearest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// c += a . b on a 16 x 8 x 8 tile; with kZero, c = a . b.
template <bool kZero = false>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
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

// The A fragment of rows [m0, m0 + 16) x k [k0, k0 + 8), split: from a
// K-major shared tile ([m][k], row stride LD) or an MN-major one ([k][m]).
template <bool kKMajor, int LD>
__device__ __forceinline__ void frag_a(const float* s, int m0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kKMajor) {
    const float* p = s + (m0 + g) * LD + k0 + t;
    split(p[0], hi[0], lo[0]);
    split(p[8 * LD], hi[1], lo[1]);
    split(p[4], hi[2], lo[2]);
    split(p[8 * LD + 4], hi[3], lo[3]);
  } else {
    const float* p = s + (k0 + t) * LD + m0 + g;
    split(p[0], hi[0], lo[0]);
    split(p[8], hi[1], lo[1]);
    split(p[4 * LD], hi[2], lo[2]);
    split(p[4 * LD + 8], hi[3], lo[3]);
  }
}

// The B fragment of k [k0, k0 + 8) x n [n0, n0 + 8), split: from a K-major
// shared tile ([n][k], row stride LD) or an MN-major one ([k][n]).
template <bool kKMajor, int LD>
__device__ __forceinline__ void frag_b(const float* s, int n0, int k0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kKMajor) {
    const float* p = s + (n0 + g) * LD + k0 + t;
    split(p[0], hi[0], lo[0]);
    split(p[4], hi[1], lo[1]);
  } else {
    const float* p = s + (k0 + t) * LD + n0 + g;
    split(p[0], hi[0], lo[0]);
    split(p[4 * LD], hi[1], lo[1]);
  }
}

// cp.async of 16 or 4 bytes; with ok false the destination is zero-filled
// (src-size 0) and src is not read.
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

}  // namespace tf32
