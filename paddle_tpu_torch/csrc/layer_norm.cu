// Row LayerNorm forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas kernel paddle_tpu/kernels/layer_norm.py
// (_ln_kernel, launched by _ln_forward through layer_norm_pallas):
// y = (x - mean) * rsqrt(var + eps) * w + b over the last dim, with the
// population variance and fp32 math.
//
// What bounds it on the card: bytes. Each row is read once from device
// memory and written once (2 * rows * cols * 4 bytes plus w and b); the
// ~8 flops per element are nothing next to 3.35 TB/s. At serving's few
// rows ([16, 768]) there is nothing to stream: the call is the launch and
// the round trips to device memory it waits on.
//
// The design: one warp per row, 4 rows a block, the whole row in
// registers (cols / 32 values a lane, up to kMaxCols columns). Each lane
// issues its loads of x, w and b together, before the first reduction, so
// a call waits on one round trip to device memory; float4 loads and
// stores where cols % 4 == 0 and the pointers are 16-byte aligned, else
// scalar ones. The mean is a warp shuffle sum, then the centred sum of
// squares from the registers (the two passes of the reference, not E[x^2]
// - mean^2), and no __syncthreads anywhere. Rows wider than kMaxCols go
// to a block per row (layer_norm_block_kernel: block reductions through
// shared memory, the row re-read from L1). Any cols and any row count are
// taken (the TPU kernel's cols % 128 and rows >= 8 limits are tiling
// limits of the TPU, not of these kernels).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the block-per-row kernel's threads
constexpr int kThreads = 256;
// rows (one warp each) per block of the warp-per-row kernel
constexpr int kRowWarps = 4;
// float4s a lane holds of a row: rows of up to 32 x 4 x kMaxVec columns
// stay in registers
constexpr int kMaxVec = 8;
constexpr int kMaxCols = 32 * 4 * kMaxVec;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void put4(float* a, float4 v) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// One warp per row, the row in registers: 4 V values a lane. kVec: lane
// holds float4 i at columns 4 (32 i + lane) .. + 3; else value k at
// column 32 k + lane.
template <int V, bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
    layer_norm_warp_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ y, int rows, int cols,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * cols;
  float* yr = y + row * cols;
  auto col = [&](int k) {
    return kVec ? 4 * (32 * (k / 4) + lane) + k % 4 : 32 * k + lane;
  };

  // x, w and b in one round of loads
  float xv[4 * V], wv[4 * V], bv[4 * V];
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = col(4 * i);
      float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), wa = xa, ba = xa;
      if (c < cols) {
        xa = *reinterpret_cast<const float4*>(xr + c);
        wa = *reinterpret_cast<const float4*>(w + c);
        ba = *reinterpret_cast<const float4*>(b + c);
      }
      put4(xv + 4 * i, xa);
      put4(wv + 4 * i, wa);
      put4(bv + 4 * i, ba);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4 * V; ++k) {
      const int c = col(k);
      const bool ok = c < cols;
      xv[k] = ok ? xr[c] : 0.f;
      wv[k] = ok ? w[c] : 0.f;
      bv[k] = ok ? b[c] : 0.f;
    }
  }

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4 * V; ++k) s += xv[k];
  const float mean = warp_sum(s) / cols;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < 4 * V; ++k) {
    const float d = col(k) < cols ? xv[k] - mean : 0.f;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / cols + eps);

#pragma unroll
  for (int k = 0; k < 4 * V; ++k)
    xv[k] = (xv[k] - mean) * rstd * wv[k] + bv[k];
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = col(4 * i);
      if (c < cols)
        *reinterpret_cast<float4*>(yr + c) = make_float4(
            xv[4 * i], xv[4 * i + 1], xv[4 * i + 2], xv[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4 * V; ++k)
      if (col(k) < cols) yr[col(k)] = xv[k];
  }
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? scratch[lane] : 0.f;
  return warp_sum(t);
}

// A block per row, for rows wider than kMaxCols: the mean, the centred sum
// of squares and the output in three passes over the row (L1 holds it).
__global__ void layer_norm_block_kernel(const float* __restrict__ x,
                                        const float* __restrict__ w,
                                        const float* __restrict__ b,
                                        float* __restrict__ y, int cols,
                                        float eps) {
  __shared__ float scratch[32];
  const long long row = blockIdx.x;
  const float* xr = x + row * cols;
  float* yr = y + row * cols;

  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) s += xr[c];
  const float mean = block_sum(s, scratch) / cols;

  float ss = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float d = xr[c] - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, scratch) / cols;
  const float rstd = rsqrtf(var + eps);

  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    yr[c] = (xr[c] - mean) * rstd * w[c] + b[c];
}

template <int V, bool kVec>
void launch_warp(const float* x, const float* w, const float* b, float* y,
                 int rows, int cols, float eps, cudaStream_t st) {
  const unsigned grid = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
  layer_norm_warp_kernel<V, kVec>
      <<<grid, kRowWarps * 32, 0, st>>>(x, w, b, y, rows, cols, eps);
}

template <bool kVec>
void dispatch_warp(const float* x, const float* w, const float* b, float* y,
                   int rows, int cols, float eps, cudaStream_t st) {
  switch ((cols + 127) / 128) {  // float4s (or 4 values) a lane
    case 1: launch_warp<1, kVec>(x, w, b, y, rows, cols, eps, st); break;
    case 2: launch_warp<2, kVec>(x, w, b, y, rows, cols, eps, st); break;
    case 3: launch_warp<3, kVec>(x, w, b, y, rows, cols, eps, st); break;
    case 4: launch_warp<4, kVec>(x, w, b, y, rows, cols, eps, st); break;
    case 5: launch_warp<5, kVec>(x, w, b, y, rows, cols, eps, st); break;
    case 6: launch_warp<6, kVec>(x, w, b, y, rows, cols, eps, st); break;
    case 7: launch_warp<7, kVec>(x, w, b, y, rows, cols, eps, st); break;
    default: launch_warp<kMaxVec, kVec>(x, w, b, y, rows, cols, eps, st);
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" int layer_norm_fwd(const float* x, const float* w, const float* b,
                              float* y, int rows, int cols, float eps,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows > 0 && cols > 0 && cols <= kMaxCols) {
    if (cols % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(b) &&
        aligned16(y))
      dispatch_warp<true>(x, w, b, y, rows, cols, eps, st);
    else
      dispatch_warp<false>(x, w, b, y, rows, cols, eps, st);
  } else if (rows > 0 && cols > 0) {
    layer_norm_block_kernel<<<rows, kThreads, 0, st>>>(x, w, b, y, cols,
                                                       eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
