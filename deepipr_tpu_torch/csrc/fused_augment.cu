// Fused training input stage for Hopper (sm_90a): gather + zero-pad crop +
// horizontal flip + normalize, written straight in NCHW.
//
// Replaces deepipr_tpu/ops/pallas_augment.py::make_pallas_augment (the Pallas
// TPU kernel `kernel`, launched by `augment` through pl.pallas_call). For
// every output element
//
//     xs = flip[b] ? W-1-x : x
//     sy = y  + oy[b] - pad        sx = xs + ox[b] - pad
//     v  = (0 <= sy < H && 0 <= sx < W) ? set[idx[b], sy, sx, c] : 0
//     out[b, c, y, x] = (v - mean255[c]) / std255[c]
//
// with a true IEEE division, as the Pallas kernel divides (nvcc's default
// -prec-div=true; this file must not be built with --use_fast_math). The
// draws (oy, ox, flip) are made outside the kernel and passed in.
//
// What the TPU kernel needed and this one does not: the 128-lane row padding
// of the resident set (prepare_rows), the batch-of-8 grid blocks, and the
// iota selection matmuls that stood in for an unaligned lane slice. Here each
// thread computes its own source address.
//
// Bound: memory, and at the training batch the launch. One output element
// reads one byte and writes four, so a batch moves B*H*W*C*(1 + 4) bytes
// plus 16*B bytes of indices and draws: 3.93 MB at B = 256, 32x32x3, about
// 1.2 us at 3.35 TB/s, less than a launch costs.
//
// Design (first, simple version): one thread per output element, the flat
// NCHW index in a grid-stride loop, so neighbouring threads write
// neighbouring x and the stores coalesce. The gathered bytes of one row of
// one image lie within W*C bytes, so the uint8 reads stay in a few cache
// lines per warp. An index outside [0, n_set) traps, as PyTorch's own
// device-side index check does.
//
// Plain C interface for ctypes; the caller allocates the output and passes
// PyTorch's current stream. Returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) fused_augment_kernel(
    const uint8_t* __restrict__ set, const int* __restrict__ idx,
    const int* __restrict__ oy, const int* __restrict__ ox,
    const int* __restrict__ flip, const float* __restrict__ mean255,
    const float* __restrict__ std255, float* __restrict__ out, int n_set,
    int b, int h, int w, int c, int pad) {
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t total = static_cast<size_t>(b) * c * hw;
  for (size_t o = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       o < total; o += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t plane = o / hw;  // b * c + ch
    const int p = static_cast<int>(o - plane * hw);
    const int ch = static_cast<int>(plane % c);
    const int bi = static_cast<int>(plane / c);
    const int y = p / w;
    const int x = p - y * w;

    const int row = idx[bi];
    if (row < 0 || row >= n_set) __trap();
    const int xs = flip[bi] ? w - 1 - x : x;
    const int sy = y + oy[bi] - pad;
    const int sx = xs + ox[bi] - pad;
    float v = 0.f;
    if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
      v = static_cast<float>(
          set[((static_cast<size_t>(row) * h + sy) * w + sx) * c + ch]);
    }
    out[o] = (v - mean255[ch]) / std255[ch];
  }
}

}  // namespace

extern "C" int fused_augment_f32(const uint8_t* set, const int* idx,
                                 const int* oy, const int* ox, const int* flip,
                                 const float* mean255, const float* std255,
                                 float* out, int n_set, int b, int h, int w,
                                 int c, int pad, int device, void* stream) {
  if (n_set <= 0 || b <= 0 || h <= 0 || w <= 0 || c <= 0 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(b) * c * h * w;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535u * 16u) blocks = 65535u * 16u;  // grid-stride beyond
  fused_augment_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      set, idx, oy, ox, flip, mean255, std255, out, n_set, b, h, w, c, pad);
  return static_cast<int>(cudaGetLastError());
}
