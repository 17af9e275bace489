// Fused training input stage for Hopper (sm_90a): gather + zero-pad crop +
// horizontal flip + normalize, written straight in NCHW as f32
// (fused_augment_f32) or bf16 (fused_augment_bf16).
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
// -prec-div=true; this file must not be built with --use_fast_math). The bf16
// form rounds that f32 value to nearest even (__float2bfloat16_rn), as the
// Pallas kernel's astype(out_dtype) and torch's .to(torch.bfloat16) do, so
// both forms agree bit for bit with their plain version. The draws (oy, ox,
// flip) are made outside the kernel and passed in.
//
// What the TPU kernel needed and this one does not: the 128-lane row padding
// of the resident set (prepare_rows), the batch-of-8 grid blocks, and the
// iota selection matmuls that stood in for an unaligned lane slice.
//
// Bound: memory. One output element reads one byte and writes four (two in
// bf16), so a batch moves B*H*W*C*(1 + 4) bytes plus 16*B bytes of indices
// and draws: 3.93 MB at B = 256, 32x32x3, about 1.2 us at 3.35 TB/s (2.36 MB,
// 0.70 us, in bf16). What stands in the
// way is latency: the source address depends on idx[b], so every gathered
// byte sits behind two dependent memory round trips.
//
// Design: one block per (image, tile of output rows); at 32x32x3 a tile is
// the whole image, so the training batch is B blocks, one wave.
//   1. Every thread reads the image's draws (one broadcast load each), and
//      the (C,) statistics go to shared memory in the same round trip.
//   2. The block copies the source rows its tile reads (at most H*W*C bytes,
//      3,072 at 32x32x3) into shared memory in one go: 16-byte loads when a
//      source row is a multiple of 16 bytes and the set is 16-byte aligned,
//      byte loads otherwise. So the idx -> pixel chain is paid once per
//      block, not once per element.
//   3. Each thread owns pieces of 4 consecutive x of one output row (1 x
//      when W is not a multiple of 4) and writes that piece in every channel
//      as one store of 4 elements (a float4, or 8 bytes of bf16). Padding and
//      flip act on the shared-memory index.
//      A piece's row and column cost one 32-bit division, once per piece,
//      not per element; all other index arithmetic is 32-bit within an image.
// The launch geometry (rows per tile, threads, shared memory, which load
// and store width) is chosen by ops/fused_augment.py::augment_geometry and
// checked here again.
//
// An index outside [0, n_set) traps, as PyTorch's own device-side index
// check does.
//
// Plain C interface for ctypes; the caller allocates the output and passes
// PyTorch's current stream. Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 48 * 1024;

// Bytes of shared memory before the image rows: the (C,) mean and std.
__host__ __device__ inline int stats_bytes(int c) { return (8 * c + 15) / 16 * 16; }

__device__ inline void store(float* dst, float v) { *dst = v; }

__device__ inline void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// four consecutive elements, 4 * sizeof(T) bytes aligned
__device__ inline void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ inline void store4(__nv_bfloat16* dst, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  memcpy(&packed.x, &lo, 4);
  memcpy(&packed.y, &hi, 4);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename T, bool kVecLoad, bool kVecStore>
__global__ void __launch_bounds__(kMaxThreads) fused_augment_kernel(
    const uint8_t* __restrict__ set, const int* __restrict__ idx,
    const int* __restrict__ oy, const int* __restrict__ ox,
    const int* __restrict__ flip, const float* __restrict__ mean255,
    const float* __restrict__ std255, T* __restrict__ out, int n_set,
    int h, int w, int c, int pad, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_mean = reinterpret_cast<float*>(smem);
  float* s_std = s_mean + c;
  uint8_t* s_img = smem + stats_bytes(c);

  const int bi = blockIdx.x;
  const int y0 = blockIdx.y * tile_rows;
  const int rows = min(tile_rows, h - y0);
  const int row = __ldg(idx + bi);
  const int dy = __ldg(oy + bi) - pad;
  const int dx = __ldg(ox + bi) - pad;
  const bool flipped = __ldg(flip + bi) != 0;
  // the statistics travel with the draws, not behind the image
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    s_mean[i] = __ldg(mean255 + i);
    s_std[i] = __ldg(std255 + i);
  }
  if (row < 0 || row >= n_set) __trap();

  // source rows [r0, r1) feed output rows [y0, y0 + rows)
  const int r0 = max(0, y0 + dy);
  const int r1 = min(h, y0 + rows + dy);
  const int wc = w * c;
  const int nbytes = max(0, r1 - r0) * wc;
  const uint8_t* src = set + (static_cast<size_t>(row) * h + r0) * wc;
  if constexpr (kVecLoad) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(s_img);
    for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x)
      d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x)
      s_img[i] = __ldg(src + i);
  }
  __syncthreads();

  constexpr int kVw = kVecStore ? 4 : 1;
  const int pieces_per_row = w / kVw;
  const int hw = h * w;
  T* img_out = out + static_cast<size_t>(bi) * c * hw;
  for (int piece = threadIdx.x; piece < rows * pieces_per_row;
       piece += blockDim.x) {
    const int yl = piece / pieces_per_row;
    const int x0 = (piece - yl * pieces_per_row) * kVw;
    const int y = y0 + yl;
    const int sy = y + dy;
    const bool row_in = sy >= 0 && sy < h;
    const int src_row = (sy - r0) * wc;  // used only where row_in
    int sx[kVw];
#pragma unroll
    for (int k = 0; k < kVw; ++k)
      sx[k] = (flipped ? w - 1 - (x0 + k) : x0 + k) + dx;
    T* dst = img_out + y * w + x0;
    for (int ch = 0; ch < c; ++ch) {
      const float m = s_mean[ch];
      const float s = s_std[ch];
      float v[kVw];
#pragma unroll
      for (int k = 0; k < kVw; ++k) {
        float p = 0.f;
        if (row_in && sx[k] >= 0 && sx[k] < w)
          p = static_cast<float>(s_img[src_row + sx[k] * c + ch]);
        v[k] = (p - m) / s;
      }
      if constexpr (kVecStore) {
        store4(dst, v);
      } else {
        store(dst, v[0]);
      }
      dst += hw;
    }
  }
}

template <typename T, bool kVecLoad, bool kVecStore>
void launch_kernel(dim3 grid, int threads, int smem, cudaStream_t stream,
                   const uint8_t* set, const int* idx, const int* oy,
                   const int* ox, const int* flip, const float* mean255,
                   const float* std255, T* out, int n_set, int h, int w,
                   int c, int pad, int tile_rows) {
  fused_augment_kernel<T, kVecLoad, kVecStore>
      <<<grid, threads, smem, stream>>>(set, idx, oy, ox, flip, mean255,
                                        std255, out, n_set, h, w, c, pad,
                                        tile_rows);
}

// tile_rows, threads, smem_bytes, vector_load and vector_store come from
// ops/fused_augment.py::augment_geometry; a geometry the kernel cannot run
// is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const uint8_t* set, const int* idx, const int* oy, const int* ox,
           const int* flip, const float* mean255, const float* std255, T* out,
           int n_set, int b, int h, int w, int c, int pad, int tile_rows,
           int threads, int smem_bytes, int vector_load, int vector_store,
           int device, void* stream) {
  const bool bad_shape = n_set <= 0 || b <= 0 || h <= 0 || w <= 0 || c <= 0 ||
                         pad < 0 || tile_rows <= 0 || tile_rows > h;
  const bool bad_block = threads < 32 || threads > kMaxThreads ||
                         threads % 32 != 0;
  const bool bad_smem =
      smem_bytes > kMaxSmem ||
      static_cast<long long>(smem_bytes) <
          stats_bytes(c) + static_cast<long long>(tile_rows) * w * c;
  const bool bad_load = vector_load &&
                        (reinterpret_cast<uintptr_t>(set) % 16 != 0 ||
                         (static_cast<long long>(w) * c) % 16 != 0);
  const bool bad_store =
      vector_store &&
      (reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) != 0 || w % 4 != 0);
  if (bad_shape || bad_block || bad_smem || bad_load || bad_store)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b, (h + tile_rows - 1) / tile_rows);
  const auto s = static_cast<cudaStream_t>(stream);
  auto fn = vector_load ? (vector_store ? &launch_kernel<T, true, true>
                                        : &launch_kernel<T, true, false>)
                        : (vector_store ? &launch_kernel<T, false, true>
                                        : &launch_kernel<T, false, false>);
  fn(grid, threads, smem_bytes, s, set, idx, oy, ox, flip, mean255, std255,
     out, n_set, h, w, c, pad, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_augment_f32(const uint8_t* set, const int* idx,
                                 const int* oy, const int* ox, const int* flip,
                                 const float* mean255, const float* std255,
                                 float* out, int n_set, int b, int h, int w,
                                 int c, int pad, int tile_rows, int threads,
                                 int smem_bytes, int vector_load,
                                 int vector_store, int device, void* stream) {
  return launch<float>(set, idx, oy, ox, flip, mean255, std255, out, n_set, b,
                       h, w, c, pad, tile_rows, threads, smem_bytes,
                       vector_load, vector_store, device, stream);
}

extern "C" int fused_augment_bf16(const uint8_t* set, const int* idx,
                                  const int* oy, const int* ox,
                                  const int* flip, const float* mean255,
                                  const float* std255, __nv_bfloat16* out,
                                  int n_set, int b, int h, int w, int c,
                                  int pad, int tile_rows, int threads,
                                  int smem_bytes, int vector_load,
                                  int vector_store, int device, void* stream) {
  return launch<__nv_bfloat16>(set, idx, oy, ox, flip, mean255, std255, out,
                               n_set, b, h, w, c, pad, tile_rows, threads,
                               smem_bytes, vector_load, vector_store, device,
                               stream);
}
