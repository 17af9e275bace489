// Fused eval-path passport epilogue for Hopper (sm_90a).
//
// Replaces deepipr_tpu/ops/pallas_fused.py::passport_epilogue_pallas (the
// Pallas TPU kernel _epilogue_kernel). After the one convolution over
// [x; key; skey] of a passport block, per channel c:
//
//     scale[c] = mean_HW(skey_out[0, c])      bias[c] = mean_HW(key_out[0, c])
//     out[n, c] = [relu](scale[c] * ((y[n, c] - mean[c]) * rsqrt(var[c] + eps))
//                        + bias[c])
//
// in the Pallas kernel's order of operations (pallas_fused.py:42-46).
//
// Bound: memory. Each output element costs one read of y and one write of
// out and about five flops, so the pass moves 2*N*C*H*W*4 bytes plus
// 2*C*H*W*4 for the passport rows; at the main path's (256, 512, 4, 4) that
// is about 17 MB, some 5 us at 3.35 TB/s.
//
// Design (first, simple version): one block per channel. The block reduces
// the two H*W passport planes of its channel in registers and shared memory,
// in a fixed-order tree (no atomics, so scale/bias are deterministic), then
// streams that channel's N planes of y. In NCHW a plane is contiguous, so
// neighbouring threads touch neighbouring addresses. At H*W = 16 one warp
// covers two planes per step; the per-channel blocks give 512 blocks at
// C = 512, enough to cover the 132 SMs.
//
// Plain C interface for ctypes; the caller allocates every output and passes
// PyTorch's current stream. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Sum of one value per thread, in a fixed order.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();  // red is reused by the next call
  return total;
}

__global__ void __launch_bounds__(kThreads) passport_epilogue_kernel(
    const float* __restrict__ y, const float* __restrict__ key_out,
    const float* __restrict__ skey_out, const float* __restrict__ mean,
    const float* __restrict__ var, float* __restrict__ out,
    float* __restrict__ scale, float* __restrict__ bias, int n, int c, int hw,
    float eps, int relu) {
  __shared__ float red[kThreads];
  const int ch = blockIdx.x;

  const float* kplane = key_out + static_cast<size_t>(ch) * hw;
  const float* splane = skey_out + static_cast<size_t>(ch) * hw;
  float ks = 0.f, ss = 0.f;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    ks += kplane[p];
    ss += splane[p];
  }
  const float s = block_sum(ss, red) / static_cast<float>(hw);
  const float b = block_sum(ks, red) / static_cast<float>(hw);
  if (threadIdx.x == 0) {
    scale[ch] = s;
    bias[ch] = b;
  }

  const float m = mean[ch];
  const float inv = rsqrtf(var[ch] + eps);
  const size_t total = static_cast<size_t>(n) * hw;
  for (size_t j = threadIdx.x; j < total; j += kThreads) {
    const size_t row = j / hw;
    const size_t i = (row * c + ch) * hw + (j - row * hw);
    float v = s * ((y[i] - m) * inv) + b;
    if (relu && v < 0.f) v = 0.f;  // NaN passes through, as in jnp.maximum
    out[i] = v;
  }
}

}  // namespace

extern "C" int passport_epilogue_f32(const float* y, const float* key_out,
                                     const float* skey_out, const float* mean,
                                     const float* var, float* out,
                                     float* scale, float* bias, int n, int c,
                                     int hw, float eps, int relu, int device,
                                     void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  passport_epilogue_kernel<<<c, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, key_out, skey_out, mean, var, out, scale, bias, n, c, hw, eps, relu);
  return static_cast<int>(cudaGetLastError());
}
