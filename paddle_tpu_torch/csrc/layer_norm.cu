// Row LayerNorm forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas kernel paddle_tpu/kernels/layer_norm.py
// (_ln_kernel, launched by _ln_forward through layer_norm_pallas):
// y = (x - mean) * rsqrt(var + eps) * w + b over the last dim, with the
// population variance and fp32 math.
//
// What bounds it on the card: bytes. Each row is read once from device
// memory and written once (2 * rows * cols * 4 bytes plus w and b); the
// ~8 flops per element are nothing next to 3.35 TB/s. The design keeps
// the row on chip: one block per row, the two passes (mean, then the
// centred sum of squares) re-read the row from L1, and the block
// reductions go through warp shuffles and 32 floats of shared memory.
// Any cols and any row count are taken (the TPU kernel's cols % 128 and
// rows >= 8 limits are tiling limits of the TPU, not of this kernel).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

__global__ void layer_norm_kernel(const float* __restrict__ x,
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

}  // namespace

extern "C" int layer_norm_fwd(const float* x, const float* w, const float* b,
                              float* y, int rows, int cols, float eps,
                              void* stream) {
  if (rows > 0 && cols > 0) {
    int threads = cols < kThreads ? ((cols + 31) / 32) * 32 : kThreads;
    layer_norm_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
        x, w, b, y, cols, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
