// Fused eval-path passport epilogue for Hopper (sm_90a), f32 and bf16 forms,
// and the f32 form's gradient (K2-bwd, below the forward).
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
// y[n, c0:c0+tile_c] is tile_c*H*W contiguous elements (512 at the main
// shape).
//   - A thread owns a fixed position in the span (16 bytes, 4 f32 or 8 bf16,
//     when H*W is a multiple of that and y and out are 16-byte aligned, else
//     one element), so its channel is the same in every row: one 32-bit
//     division per position, and its coefficients stay in registers for the
//     whole row loop. The block has a thread per position or per kStage
//     passport floats (the GAP's lanes for every channel of the tile at
//     once), whichever is more. Where that is row_split times the
//     positions (bf16's 8-element vectors: 128 threads, 64 positions), the
//     threads form row_split groups over the whole span and group g takes
//     rows g, g + row_split, ...: every thread carries y, each with half
//     the rows and half the bf16 arithmetic of a thread of one group.
//   - It issues the loads of kUnroll rows before it uses the first, and the
//     first of those during the passport reduction, so the prologue overlaps
//     memory. The passport loads go first: queued behind 8 MB of y, the
//     coefficients that every store waits for would come last.
//   - GAP: a group of G lanes sums each channel's key and skey planes
//     straight from memory (after the first block of a tile, from L2), as
//     many channels at once as the block has groups, in stages of gap_len =
//     min(H*W, kStage * kMaxThreads) positions: lane g adds positions g,
//     g+G, ... of a stage in order, then a shuffle tree over the group, and
//     the stage's sum is added to the earlier ones' (no shared-memory
//     staging: the coefficients, which every store waits for, are one
//     barrier from the loads). G
//     is the least power of two with kStage * G >= gap_len, at most 32 (4 at
//     H*W = 16), so the order is a function of H*W alone: every block
//     derives bit-identical coefficients for a channel, in both forms, and
//     only the blocks of row range 0 write scale/bias. No atomics: signature
//     detection needs sign-for-sign determinism.
// The launch geometry (tile_c, tile_rows, threads, GAP stage length, vector or
// scalar path) is chosen by ops/passport_epilogue.py::epilogue_geometry and
// checked here again.
//
// K2-bwd (passport_epilogue_backward_f32), f32 only: the gradient of the f32
// form, which the JAX package takes by differentiating its XLA path (the
// Pallas kernel has no backward). With yn = (y - mean) * invstd, the ReLU
// mask m = out > 0 (1 without ReLU), and g, gs, gb the gradients of out,
// scale and bias:
//
//     dy[n, c]          = (g * m) * (scale[c] * invstd[c])
//     dscale[c]         = sum_{n,h,w} g * m * yn + gs[c]
//     dbias[c]          = sum_{n,h,w} g * m + gb[c]
//     dskey_out[0, c]   = dscale[c] / (H*W)      dkey_out[0, c] = dbias[c] / (H*W)
//
// The mask is recomputed from y, scale and bias through the forward's own
// device function (epilogue(float, Coef, relu)), so it is K2's out > 0 bit
// for bit (0 at exactly 0, as jax.nn.relu's derivative, and for NaN).
// Bound: memory. g and y are read once and dy written once, 12 bytes an
// element: 6.3 MB at (64, 512, 4, 4), 1.9 us at 3.35 TB/s.
// Design: one kernel, no float atomics, so the gradient is bit-identical
// from call to call (as the forward's GAP is). A block owns tile_c channels
// x tile_rows rows, a thread a fixed 16-byte position of the span with
// kBwdUnroll rows of g and y in flight (the geometry gives each block at
// least that many rows). It writes dy and sums its channel's two terms in
// row order; the block adds a channel's threads (a shuffle tree over the
// channel's lanes, or through shared memory where they do not divide a
// warp) into one partial per (channel, row block). The block then counts
// its arrival on its channel tile's int32 counter; the block that arrives
// last adds the tile's partials over row blocks 0..R-1 in a fixed order
// (read through L2, past L1; every channel at once, a few lanes each, so
// the finish costs one round trip), adds gs and gb, writes the quotient
// over the channel's H*W positions of dskey_out and dkey_out, and sets the
// counter back to 0 for the next call on the stream.
//
// Plain C interface for ctypes; the caller allocates every output and passes
// PyTorch's current stream. Returns cudaGetLastError() after the launch.

#include <algorithm>
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
// a GAP lane adds at most kStage positions of a stage where the group's 32
// lanes allow it, which fixes the GAP's summation order
// (ops/passport_epilogue.py::fixed_order_gap); also the positions a lane
// loads per round
constexpr int kStage = 4;
constexpr int kMaxGap = kStage * kMaxThreads;  // positions of a channel a stage
constexpr int kBwdUnroll = 4;  // K2-bwd: rows of g and y in flight

// Shared floats: the tile's four coefficient rows.
inline long long smem_floats(int tile_c) { return 4LL * tile_c; }

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
    int tile_c, int tile_rows, int gap_len, int row_split, float eps,
    int relu) {
  using V = std::conditional_t<kVec, Vec16<T>, T>;
  constexpr int kVw = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  extern __shared__ __align__(16) float smem[];
  float* s_scale = smem;
  float* s_bias = s_scale + tile_c;
  float* s_mean = s_bias + tile_c;
  float* s_inv = s_mean + tile_c;

  const int c0 = blockIdx.y * tile_c;
  const int tc = min(tile_c, c - c0);
  const int n0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - n0);
  const int positions = tc * hw / kVw;
  const size_t row_v = static_cast<size_t>(c) * hw / kVw;  // V per batch row
  const size_t base = (static_cast<size_t>(n0) * c + c0) * hw / kVw;
  // the block's threads in row_split groups of span_threads: group rg
  // takes rows rg, rg + row_split, ... of the positions its threads own
  const int span_threads = blockDim.x / row_split;
  const int rg = threadIdx.x / span_threads;
  const int first_p = threadIdx.x - rg * span_threads;
  const int my_rows =
      rg < min(row_split, rows) ? (rows - rg + row_split - 1) / row_split : 0;
  const size_t stride = static_cast<size_t>(row_split) * row_v;
  const V* yv = reinterpret_cast<const V*>(y) + base + rg * row_v;
  V* ov = reinterpret_cast<V*>(out) + base + rg * row_v;

  // GAP of the tile's passport planes, read straight from memory (L2 after
  // the first block of a tile) in stages of gap_len positions of a channel
  // (gap_len == hw unless the tile is one channel of more than kMaxGap
  // positions). A lane's first kStage values of each plane are loaded
  // before the y prefetch: every store waits for the coefficients.
  V buf[kUnroll];
  int shift = 0;  // log2 of the lanes that sum one channel, at most 32
  while (shift < 5 && (kStage << shift) < gap_len) ++shift;
  const int group = 1 << shift;
  const int lane = threadIdx.x & (group - 1);
  const int groups = blockDim.x >> shift;  // channels reduced at once
  for (int first = 0; first < tc; first += groups) {
    const int ch = first + static_cast<int>(threadIdx.x >> shift);
    const size_t src = static_cast<size_t>(c0 + min(ch, tc - 1)) * hw;
    float ks = 0.f, ss = 0.f;
    for (int off = 0; off < hw; off += gap_len) {
      const int len = min(gap_len, hw - off);
      float ka = 0.f, sa = 0.f;
      // lane g adds positions g, g+G, ... of the stage in order, kStage
      // a round; then a shuffle tree over the group's G lanes, and the
      // stage's sum is added to the earlier stages'
      for (int j0 = lane; j0 - lane < len; j0 += kStage * group) {
        float kv[kStage], sv[kStage];
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
          const int j = j0 + k * group;
          if (ch < tc && j < len) {
            kv[k] = __ldg(key_out + src + off + j);
            sv[k] = __ldg(skey_out + src + off + j);
          }
        }
        if (first == 0 && off == 0 && j0 == lane) {
          // the first kUnroll rows of this thread's first position, and the
          // tile's BN statistics, in flight during the reduction
          if (first_p < positions) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              if (u < my_rows)
                buf[u] = __ldg(yv + u * stride + first_p);
          }
          for (int i = threadIdx.x; i < tc; i += blockDim.x) {
            s_mean[i] = __ldg(mean + c0 + i);
            s_inv[i] = __frcp_rn(__fsqrt_rn(__ldg(var + c0 + i) + eps));
          }
        }
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
          const int j = j0 + k * group;
          if (ch < tc && j < len) {
            ka += kv[k];
            sa += sv[k];
          }
        }
      }
      for (int o = group / 2; o > 0; o >>= 1) {
        ka += __shfl_down_sync(0xffffffffu, ka, o, group);
        sa += __shfl_down_sync(0xffffffffu, sa, o, group);
      }
      ks = off > 0 ? ka + ks : ka;
      ss = off > 0 ? sa + ss : sa;
    }
    if (ch < tc && lane == 0) {
      s_bias[ch] = ks / static_cast<float>(hw);
      s_scale[ch] = ss / static_cast<float>(hw);
      if (blockIdx.x == 0) {
        scale[c0 + ch] = s_scale[ch];
        bias[c0 + ch] = s_bias[ch];
      }
    }
  }
  __syncthreads();

  for (int p = first_p; my_rows > 0 && p < positions; p += span_threads) {
    const int ch = p * kVw / hw;
    const Coef k =
        make_coef<T>(s_scale[ch], s_bias[ch], s_mean[ch], s_inv[ch]);
    for (int i = 0; i < my_rows; i += kUnroll) {
      if (p != first_p || i > 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i + u < my_rows) buf[u] = __ldg(yv + (i + u) * stride + p);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i + u < my_rows)
          ov[(i + u) * stride + p] = apply<T>(buf[u], k, relu);
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
           int threads, int gap_len, int smem_bytes, int vector,
           int row_split, float eps, int relu, int device, void* stream) {
  constexpr int kVw = 16 / static_cast<int>(sizeof(T));
  // gap_len fixes the GAP's summation order: min(hw, kMaxGap), a function
  // of hw alone
  const bool bad_shape = n <= 0 || c <= 0 || hw <= 0 || tile_c <= 0 ||
                         tile_c > c || tile_rows <= 0 ||
                         gap_len != std::min(hw, kMaxGap) ||
                         (tile_c > 1 && gap_len != hw);
  // a group of threads / row_split covers a row's span in one pass
  const long long span = static_cast<long long>(tile_c) * hw /
                         (vector ? kVw : 1);
  const bool bad_block =
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      row_split < 1 || (row_split > 1 && threads / row_split < span);
  const bool bad_smem =
      smem_bytes > kMaxSmem ||
      smem_bytes < 4 * smem_floats(tile_c);
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
        tile_rows, gap_len, row_split, eps, relu);
  } else {
    passport_epilogue_kernel<T, false><<<grid, threads, smem_bytes, s>>>(
        y, key_out, skey_out, mean, var, out, scale, bias, n, c, hw, tile_c,
        tile_rows, gap_len, row_split, eps, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

// One element of K2-bwd: returns dy, adds the channel's two sums. The mask
// is K2's own out > 0: the forward's device function on the same operands.
__device__ inline float backward_element(float g, float y, const Coef& k,
                                         float dk, int relu, float& a,
                                         float& b) {
  const float gm = (!relu || epilogue(y, k, relu) > 0.f) ? g : 0.f;
  a += gm * ((y - k.m) * k.inv);
  b += gm;
  return gm * dk;
}

// the four elements in memory order (one statement each: the order in which
// the arguments of one call are evaluated is unspecified)
__device__ inline float4 backward_element(float4 g, float4 y, const Coef& k,
                                          float dk, int relu, float& a,
                                          float& b) {
  float4 d;
  d.x = backward_element(g.x, y.x, k, dk, relu, a, b);
  d.y = backward_element(g.y, y.y, k, dk, relu, a, b);
  d.z = backward_element(g.z, y.z, k, dk, relu, a, b);
  d.w = backward_element(g.w, y.w, k, dk, relu, a, b);
  return d;
}

// part_scale, part_bias: (C, gridDim.x) partials, written here and read by
// the tile's last block, so neither const nor __restrict__ and read past
// L1; arrivals: one counter per channel tile, 0 before and after a launch
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads) passport_epilogue_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ y,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ g_scale, const float* __restrict__ g_bias,
    float* __restrict__ dy, float* __restrict__ dkey_out,
    float* __restrict__ dskey_out, float* part_scale, float* part_bias,
    int* arrivals, int n, int c, int hw, int tile_c, int tile_rows,
    float eps, int relu) {
  using V = std::conditional_t<kVec, float4, float>;
  constexpr int kVw = kVec ? 4 : 1;
  __shared__ float s_a[kMaxThreads];
  __shared__ float s_b[kMaxThreads];
  __shared__ int s_last;

  const int c0 = blockIdx.y * tile_c;
  const int tc = min(tile_c, c - c0);
  const int n0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - n0);
  const int positions = tc * hw / kVw;
  const int row_blocks = gridDim.x;
  const size_t row_v = static_cast<size_t>(c) * hw / kVw;
  const size_t base = (static_cast<size_t>(n0) * c + c0) * hw / kVw;
  const V* gv = reinterpret_cast<const V*>(g) + base;
  const V* yv = reinterpret_cast<const V*>(y) + base;
  V* dv = reinterpret_cast<V*>(dy) + base;

  // a thread's positions are all of one channel: one position when the tile
  // has several channels (the geometry gives it a thread for each), any
  // number when the tile is one channel
  float a = 0.f, b = 0.f;
  // a thread's last round of dy is stored after its block's arrival is
  // counted, so that the fence before the count does not wait for it
  V pend[kBwdUnroll];
  size_t pend_i = 0;
  int pend_n = 0;
  for (int p = threadIdx.x; p < positions; p += blockDim.x) {
    const int ch = p * kVw / hw;
    const float s = __ldg(scale + c0 + ch);
    const float inv = __frcp_rn(__fsqrt_rn(__ldg(var + c0 + ch) + eps));
    const Coef k = make_coef<float>(s, __ldg(bias + c0 + ch),
                                    __ldg(mean + c0 + ch), inv);
    const float dk = s * inv;
    for (int r = 0; r < rows; r += kBwdUnroll) {
      V gb[kBwdUnroll], yb[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (r + u < rows) {
          const size_t i = (r + u) * row_v + p;
          gb[u] = __ldg(gv + i);
          yb[u] = __ldg(yv + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (u < pend_n) dv[pend_i + u * row_v] = pend[u];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (r + u < rows)
          pend[u] = backward_element(gb[u], yb[u], k, dk, relu, a, b);
      pend_i = r * row_v + p;
      pend_n = min(kBwdUnroll, rows - r);
    }
  }

  // channel ch's threads are [ch * per, (ch + 1) * per): their sums become
  // the channel's partial of this row block
  const int per = min(hw / kVw, static_cast<int>(blockDim.x));
  const size_t column = blockIdx.x;
  if (32 % per == 0) {
    // per neighbouring lanes of one warp: a shuffle tree over them
    for (int o = per / 2; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o, per);
      b += __shfl_down_sync(0xffffffffu, b, o, per);
    }
    const int ch = threadIdx.x / per;
    if (threadIdx.x % per == 0 && ch < tc) {
      const size_t i = static_cast<size_t>(c0 + ch) * row_blocks + column;
      part_scale[i] = a;
      part_bias[i] = b;
    }
  } else {
    // through shared memory: warp w adds the threads of channels w,
    // w + warps, ... (lanes in order, then a shuffle tree)
    s_a[threadIdx.x] = a;
    s_b[threadIdx.x] = b;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    for (int ch = threadIdx.x >> 5; ch < tc; ch += warps) {
      float sa = 0.f, sb = 0.f;
      for (int j = lane; j < per; j += 32) {
        sa += s_a[ch * per + j];
        sb += s_b[ch * per + j];
      }
      for (int o = 16; o > 0; o >>= 1) {
        sa += __shfl_down_sync(0xffffffffu, sa, o);
        sb += __shfl_down_sync(0xffffffffu, sb, o);
      }
      if (lane == 0) {
        const size_t i = static_cast<size_t>(c0 + ch) * row_blocks + column;
        part_scale[i] = sa;
        part_bias[i] = sb;
      }
    }
  }

  // the block's partials reach L2 before its arrival is counted (one
  // thread fences after the barrier, as a grid barrier does); the block
  // that arrives last at its channel tile finishes the tile
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(arrivals + blockIdx.y, 1) == row_blocks - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u)
    if (u < pend_n) dv[pend_i + u * row_v] = pend[u];
  if (!s_last) return;

  // every channel of the tile at once, L lanes each (the largest power of
  // two with L * tc <= blockDim.x, at most 32, so a channel's lanes lie in
  // one warp): lane l adds the channel's partials of row blocks l, l + L,
  // ... in order, a shuffle tree adds the L lanes, and the lanes write the
  // channel's H*W positions of dskey_out and dkey_out
  int lanes = 32;
  while (lanes > 1 && lanes * tc > static_cast<int>(blockDim.x)) lanes >>= 1;
  const int ch = threadIdx.x / lanes;
  const int l = threadIdx.x & (lanes - 1);
  float sa = 0.f, sb = 0.f;
  if (ch < tc) {
    const size_t row = static_cast<size_t>(c0 + ch) * row_blocks;
#pragma unroll 4
    for (int r = l; r < row_blocks; r += lanes) {
      sa += __ldcg(part_scale + row + r);
      sb += __ldcg(part_bias + row + r);
    }
  }
  for (int o = lanes / 2; o > 0; o >>= 1) {
    sa += __shfl_down_sync(0xffffffffu, sa, o, lanes);
    sb += __shfl_down_sync(0xffffffffu, sb, o, lanes);
  }
  sa = __shfl_sync(0xffffffffu, sa, 0, lanes);
  sb = __shfl_sync(0xffffffffu, sb, 0, lanes);
  if (ch < tc) {
    const float ds = (sa + __ldg(g_scale + c0 + ch)) / static_cast<float>(hw);
    const float db = (sb + __ldg(g_bias + c0 + ch)) / static_cast<float>(hw);
    const size_t plane = static_cast<size_t>(c0 + ch) * hw;
    for (int j = l; j < hw; j += lanes) {
      dskey_out[plane + j] = ds;
      dkey_out[plane + j] = db;
    }
  }
  if (threadIdx.x == 0) arrivals[blockIdx.y] = 0;
}

}  // namespace

// tile_c, tile_rows, threads and vector come from
// ops/passport_epilogue.py::backward_geometry; part_scale and part_bias hold
// (C, row blocks) floats each; arrivals holds one int32 a channel tile, all 0
// (and 0 again when the launch ends).
extern "C" int passport_epilogue_backward_f32(
    const float* g, const float* y, const float* bias, const float* scale,
    const float* mean, const float* var, const float* g_scale,
    const float* g_bias, float* dy, float* dkey_out, float* dskey_out,
    float* part_scale, float* part_bias, int* arrivals, int n, int c, int hw,
    int tile_c, int tile_rows, int threads, int vector, float eps, int relu,
    int device, void* stream) {
  const int vw = vector ? 4 : 1;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool bad_shape = n <= 0 || c <= 0 || hw <= 0 || tile_c <= 0 ||
                         tile_c > c || tile_rows <= 0 ||
                         static_cast<long long>(tile_c) * hw > INT_MAX;
  // a tile of several channels needs a thread for each of its positions
  const bool bad_block =
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (tile_c > 1 && static_cast<long long>(tile_c) * hw / vw > threads);
  const bool bad_vector =
      vector && (hw % 4 != 0 || !aligned(g) || !aligned(y) || !aligned(dy));
  const long long c_tiles = (static_cast<long long>(c) + tile_c - 1) / tile_c;
  if (bad_shape || bad_block || bad_vector || c_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + tile_rows - 1) / tile_rows, c_tiles);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vector) {
    passport_epilogue_bwd_kernel<true><<<grid, threads, 0, s>>>(
        g, y, bias, scale, mean, var, g_scale, g_bias, dy, dkey_out,
        dskey_out, part_scale, part_bias, arrivals, n, c, hw, tile_c,
        tile_rows, eps, relu);
  } else {
    passport_epilogue_bwd_kernel<false><<<grid, threads, 0, s>>>(
        g, y, bias, scale, mean, var, g_scale, g_bias, dy, dkey_out,
        dskey_out, part_scale, part_bias, arrivals, n, c, hw, tile_c,
        tile_rows, eps, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int passport_epilogue_f32(
    const float* y, const float* key_out, const float* skey_out,
    const float* mean, const float* var, float* out, float* scale, float* bias,
    int n, int c, int hw, int tile_c, int tile_rows, int threads, int gap_len,
    int smem_bytes, int vector, int row_split, float eps, int relu,
    int device, void* stream) {
  return launch<float>(y, key_out, skey_out, mean, var, out, scale, bias, n,
                       c, hw, tile_c, tile_rows, threads, gap_len, smem_bytes,
                       vector, row_split, eps, relu, device, stream);
}

extern "C" int passport_epilogue_bf16(
    const __nv_bfloat16* y, const float* key_out, const float* skey_out,
    const float* mean, const float* var, __nv_bfloat16* out, float* scale,
    float* bias, int n, int c, int hw, int tile_c, int tile_rows, int threads,
    int gap_len, int smem_bytes, int vector, int row_split, float eps,
    int relu, int device, void* stream) {
  return launch<__nv_bfloat16>(y, key_out, skey_out, mean, var, out, scale,
                               bias, n, c, hw, tile_c, tile_rows, threads,
                               gap_len, smem_bytes, vector, row_split, eps,
                               relu, device, stream);
}
