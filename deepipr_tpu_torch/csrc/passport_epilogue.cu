// Fused eval-path passport epilogue for Hopper (sm_90a), f32 and bf16 forms.
//
// Replaces deepipr_tpu/ops/pallas_fused.py::passport_epilogue_pallas (the
// Pallas TPU kernel _epilogue_kernel). After the one convolution over
// [x; key; skey] of a passport block, per channel c:
//
//     scale[c] = mean_HW(skey_out[0, c])      bias[c] = mean_HW(key_out[0, c])
//     out[n, c] = [relu](scale[c] * ((y[n, c] - mean[c]) * rsqrt(var[c] + eps))
//                        + bias[c])
//
// key_out, skey_out, mean, var, scale and bias are f32 in both forms; y and
// out are f32 (passport_epilogue_f32) or bf16 (passport_epilogue_bf16).
//
// Rounding. The f32 form computes in the Pallas kernel's order of operations
// (pallas_fused.py:42-46). Both forms take rsqrt(var + eps) as the correctly
// rounded 1 / sqrt(var + eps), as the plain version does (torch.sqrt and an
// IEEE division, on the card and on the CPU), not as the approximate rsqrtf:
// in bf16 the normalize is then bit-identical to the plain version's, which
// matters where scale * yn and bias cancel and one ulp of yn would move the
// small result by many of its own. The bf16 form rounds where its plain version
// (ops/passport_epilogue.py::passport_epilogue_reference) rounds, which is
// where the JAX package's XLA path of a bf16 PassportPrivateBlock rounds
// (layers.py:177-186, flax BatchNorm(dtype=bf16)):
//   1. yn = bf16((y - mean) * rsqrt(var + eps)), the normalize in f32;
//   2. scale and bias are cast to bf16;
//   3. bf16(bf16(scale * yn) + bias): each op in f32 on bf16 operands,
//      rounded to nearest even, as torch's bf16 ops are; then the ReLU.
// The GAP and the returned scale/bias are the f32 form's, bit for bit.
//
// Bound: memory. Each output element costs one read of y and one write of
// out and about five flops, so the pass moves 2*N*C*H*W*sizeof(y) bytes plus
// 2*C*H*W*4 for the passport rows; at the main path's (256, 512, 4, 4) that
// is about 17 MB in f32 (some 5 us at 3.35 TB/s), 8.5 MB in bf16. Reaching it
// takes enough loads in flight (Little's law: about 2 MB at HBM3's latency),
// so the design is about memory-level parallelism and wide accesses.
//
// Design: y is walked in its memory order. A block owns a tile of tile_c
// channels and a range of tile_rows batch rows; for each row n its span
// y[n, c0:c0+tile_c] is tile_c*H*W contiguous elements.
//   - A thread owns a fixed position in the span (16 bytes, 4 f32 or 8 bf16,
//     when H*W is a multiple of that and y and out are 16-byte aligned, else
//     one element), so its channel is the same in every row: one 32-bit
//     division per position, and its coefficients stay in registers for the
//     whole row loop.
//   - It issues the loads of kUnroll rows before it uses the first, and the
//     first of those during the passport reduction, so the prologue overlaps
//     memory. The passport loads go first: queued behind 8 MB of y, the
//     coefficients that every store waits for would come last.
//   - GAP: the block stages the tile's key and skey planes in shared memory
//     (coalesced loads, at most kStage a thread per stage; after the first
//     block they come from L2). A group of G lanes sums each channel, every
//     channel of the tile at once where the block has G lanes for each: lane
//     g adds positions g, g+G, ... in order, then a shuffle tree over the
//     group. G is a power of two taken from the staged length alone (4 at
//     H*W = 16), so every block derives bit-identical coefficients for a
//     channel, and only the blocks of row range 0 write scale/bias. No
//     atomics: signature detection needs sign-for-sign determinism.
// The launch geometry (tile_c, tile_rows, threads, staging length, vector or
// scalar path) is chosen by ops/passport_epilogue.py::epilogue_geometry and
// checked here again.
//
// Plain C interface for ctypes; the caller allocates every output and passes
// PyTorch's current stream. Returns cudaGetLastError() after the launch.

#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 48 * 1024;
constexpr int kUnroll = 8;  // rows of y in flight per thread
constexpr int kStage = 4;  // passport elements per thread and plane a stage

// Shared floats: the tile's four coefficient rows, then the staged key and
// skey planes of tile_c channels x gap_len positions each.
inline long long smem_floats(int tile_c, int gap_len) {
  return 4LL * tile_c + 2LL * tile_c * gap_len;
}

__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One channel's coefficients as a thread applies them.
struct Coef {
  float s, b, m, inv;
};

__device__ inline float epilogue(float x, const Coef& k, int relu) {
  float v = k.s * ((x - k.m) * k.inv) + k.b;
  if (relu && v < 0.f) v = 0.f;  // NaN passes through, as in jnp.maximum
  return v;
}

// k.s and k.b already rounded to bf16 (make_coef)
__device__ inline __nv_bfloat16 epilogue(__nv_bfloat16 x, const Coef& k,
                                         int relu) {
  const float yn = round_bf16((__bfloat162float(x) - k.m) * k.inv);
  float v = round_bf16(round_bf16(k.s * yn) + k.b);
  if (relu && v < 0.f) v = 0.f;
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ inline Coef make_coef(float s, float b, float m, float inv) {
  if constexpr (std::is_same_v<T, float>) {
    return {s, b, m, inv};
  } else {
    return {round_bf16(s), round_bf16(b), m, inv};
  }
}

// 16 bytes of y: float4 for f32, uint4 (8 bf16) for bf16
template <typename T>
using Vec16 = std::conditional_t<std::is_same_v<T, float>, float4, uint4>;

template <typename T>
__device__ inline T apply(T x, const Coef& k, int relu) {
  return epilogue(x, k, relu);
}

template <typename T>
__device__ inline Vec16<T> apply(Vec16<T> x, const Coef& k, int relu) {
  constexpr int kN = 16 / sizeof(T);
  T e[kN];
  memcpy(e, &x, 16);
#pragma unroll
  for (int i = 0; i < kN; ++i) e[i] = epilogue(e[i], k, relu);
  Vec16<T> out;
  memcpy(&out, e, 16);
  return out;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) passport_epilogue_kernel(
    const T* __restrict__ y, const float* __restrict__ key_out,
    const float* __restrict__ skey_out, const float* __restrict__ mean,
    const float* __restrict__ var, T* __restrict__ out,
    float* __restrict__ scale, float* __restrict__ bias, int n, int c, int hw,
    int tile_c, int tile_rows, int gap_len, float eps, int relu) {
  using V = std::conditional_t<kVec, Vec16<T>, T>;
  constexpr int kVw = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  extern __shared__ __align__(16) float smem[];
  float* s_scale = smem;  // the skey sums, then scale
  float* s_bias = s_scale + tile_c;  // the key sums, then bias
  float* s_mean = s_bias + tile_c;
  float* s_inv = s_mean + tile_c;
  float* s_key = s_inv + tile_c;
  float* s_skey = s_key + tile_c * gap_len;

  const int c0 = blockIdx.y * tile_c;
  const int tc = min(tile_c, c - c0);
  const int n0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - n0);
  const int positions = tc * hw / kVw;
  const size_t row_v = static_cast<size_t>(c) * hw / kVw;  // V per batch row
  const size_t base = (static_cast<size_t>(n0) * c + c0) * hw / kVw;
  const V* yv = reinterpret_cast<const V*>(y) + base;
  V* ov = reinterpret_cast<V*>(out) + base;

  // GAP of the tile's passport planes, gap_len positions of each channel at
  // a time (gap_len == hw unless the tile is one large channel); either way
  // the staged piece is contiguous in key_out and skey_out, and at most
  // kStage * blockDim.x floats long
  V buf[kUnroll];
  int shift = 0;  // log2 of the lanes that sum one channel, at most 32
  while (shift < 5 && (kStage << shift) < gap_len) ++shift;
  const int group = 1 << shift;
  const int lane = threadIdx.x & (group - 1);
  const int groups = blockDim.x >> shift;  // channels reduced at once
  for (int off = 0; off < hw; off += gap_len) {
    const int len = min(gap_len, hw - off);
    const size_t src = static_cast<size_t>(c0) * hw + off;
    float kr[kStage], sr[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < tc * len) {
        kr[k] = __ldg(key_out + src + i);
        sr[k] = __ldg(skey_out + src + i);
      }
    }
    if (off == 0) {
      // the first kUnroll rows of this thread's first position, and the
      // tile's BN statistics, in flight during the reduction
      if (threadIdx.x < positions) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (u < rows) buf[u] = __ldg(yv + u * row_v + threadIdx.x);
      }
      for (int i = threadIdx.x; i < tc; i += blockDim.x) {
        s_mean[i] = __ldg(mean + c0 + i);
        s_inv[i] = __frcp_rn(__fsqrt_rn(__ldg(var + c0 + i) + eps));
      }
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < tc * len) {
        s_key[i] = kr[k];
        s_skey[i] = sr[k];
      }
    }
    __syncthreads();
    // lane g of a group sums positions g, g+G, ... of its channel in
    // order, then a shuffle tree over the group's G lanes
    for (int first = 0; first < tc; first += groups) {
      const int ch = first + static_cast<int>(threadIdx.x >> shift);
      float ks = 0.f, ss = 0.f;
      if (ch < tc) {
        for (int j = lane; j < len; j += group) {
          ks += s_key[ch * len + j];
          ss += s_skey[ch * len + j];
        }
      }
      for (int o = group / 2; o > 0; o >>= 1) {
        ks += __shfl_down_sync(0xffffffffu, ks, o, group);
        ss += __shfl_down_sync(0xffffffffu, ss, o, group);
      }
      if (ch < tc && lane == 0) {
        if (off > 0) {
          ks += s_bias[ch];
          ss += s_scale[ch];
        }
        const bool last = off + len >= hw;
        s_bias[ch] = last ? ks / static_cast<float>(hw) : ks;
        s_scale[ch] = last ? ss / static_cast<float>(hw) : ss;
        if (last && blockIdx.x == 0) {
          scale[c0 + ch] = s_scale[ch];
          bias[c0 + ch] = s_bias[ch];
        }
      }
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < positions; p += blockDim.x) {
    const int ch = p * kVw / hw;
    const Coef k =
        make_coef<T>(s_scale[ch], s_bias[ch], s_mean[ch], s_inv[ch]);
    for (int r = 0; r < rows; r += kUnroll) {
      if (p != threadIdx.x || r > 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (r + u < rows) buf[u] = __ldg(yv + (r + u) * row_v + p);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u < rows) ov[(r + u) * row_v + p] = apply<T>(buf[u], k, relu);
    }
  }
}

// tile_c, tile_rows, threads, gap_len, smem_bytes and vector come from
// ops/passport_epilogue.py::epilogue_geometry; a geometry the kernel cannot
// run is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const T* y, const float* key_out, const float* skey_out,
           const float* mean, const float* var, T* out, float* scale,
           float* bias, int n, int c, int hw, int tile_c, int tile_rows,
           int threads, int gap_len, int smem_bytes, int vector, float eps,
           int relu, int device, void* stream) {
  constexpr int kVw = 16 / static_cast<int>(sizeof(T));
  const bool bad_shape = n <= 0 || c <= 0 || hw <= 0 || tile_c <= 0 ||
                         tile_c > c || tile_rows <= 0 || gap_len <= 0 ||
                         gap_len > hw || (tile_c > 1 && gap_len != hw) ||
                         static_cast<long long>(tile_c) * gap_len >
                             static_cast<long long>(kStage) * threads;
  const bool bad_block = threads < 32 || threads > kMaxThreads ||
                         threads % 32 != 0;
  const bool bad_smem =
      smem_bytes > kMaxSmem ||
      smem_bytes < 4 * smem_floats(tile_c, gap_len);
  const bool bad_vector =
      vector && (hw % kVw != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(out) % 16 != 0);
  const long long c_tiles = (static_cast<long long>(c) + tile_c - 1) / tile_c;
  if (bad_shape || bad_block || bad_smem || bad_vector || c_tiles > 65535 ||
      static_cast<long long>(tile_c) * hw > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + tile_rows - 1) / tile_rows, c_tiles);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vector) {
    passport_epilogue_kernel<T, true><<<grid, threads, smem_bytes, s>>>(
        y, key_out, skey_out, mean, var, out, scale, bias, n, c, hw, tile_c,
        tile_rows, gap_len, eps, relu);
  } else {
    passport_epilogue_kernel<T, false><<<grid, threads, smem_bytes, s>>>(
        y, key_out, skey_out, mean, var, out, scale, bias, n, c, hw, tile_c,
        tile_rows, gap_len, eps, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int passport_epilogue_f32(
    const float* y, const float* key_out, const float* skey_out,
    const float* mean, const float* var, float* out, float* scale, float* bias,
    int n, int c, int hw, int tile_c, int tile_rows, int threads, int gap_len,
    int smem_bytes, int vector, float eps, int relu, int device,
    void* stream) {
  return launch<float>(y, key_out, skey_out, mean, var, out, scale, bias, n,
                       c, hw, tile_c, tile_rows, threads, gap_len, smem_bytes,
                       vector, eps, relu, device, stream);
}

extern "C" int passport_epilogue_bf16(
    const __nv_bfloat16* y, const float* key_out, const float* skey_out,
    const float* mean, const float* var, __nv_bfloat16* out, float* scale,
    float* bias, int n, int c, int hw, int tile_c, int tile_rows, int threads,
    int gap_len, int smem_bytes, int vector, float eps, int relu, int device,
    void* stream) {
  return launch<__nv_bfloat16>(y, key_out, skey_out, mean, var, out, scale,
                               bias, n, c, hw, tile_c, tile_rows, threads,
                               gap_len, smem_bytes, vector, eps, relu, device,
                               stream);
}
