// Host training-augmentation kernel: zero-pad + random crop + horizontal
// flip + ImageNet-stat normalization, uint8 NHWC -> float32 NHWC, in one
// sweep over the batch.
//
// The port's copy of the JAX package's native/augment.cpp: the same entry
// points and the same arithmetic in the same order, built with the same g++
// flags (ops/host_build.py), so that a host batch is the same bytes in both
// packages on one machine. Called through ctypes from
// deepipr_tpu_torch/data/native.py; the crop offsets and flip decisions are
// drawn on the Python side, so one RNG owns determinism. The per-channel
// tables hold 16 entries: the caller refuses more channels.

#include <cstdint>

extern "C" {

// in:    (n, h, w, c) uint8
// out:   (n, h, w, c) float32
// ys/xs: (n,) crop offsets in [0, 2*pad]
// flips: (n,) 0/1 horizontal flip
// mean/std: (c,) normalization stats in [0,1] scale
void augment_u8_to_f32(const uint8_t* in, float* out, int n, int h, int w,
                       int c, int pad, const int32_t* ys, const int32_t* xs,
                       const uint8_t* flips, const float* mean,
                       const float* stdv) {
  // precompute per-channel affine: f(v) = v * scale_c + bias_c
  float scale[16], bias[16], zero[16];
  for (int ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stdv[ch]);
    bias[ch] = -mean[ch] / stdv[ch];
    zero[ch] = bias[ch];  // padded (black) pixel: value 0
  }

  const long img = (long)h * w * c;
  for (int i = 0; i < n; ++i) {
    const uint8_t* src = in + i * img;
    float* dst = out + i * img;
    const int dy = ys[i] - pad;
    const int dx = xs[i] - pad;
    const bool flip = flips[i] != 0;
    for (int y = 0; y < h; ++y) {
      const int sy = y + dy;
      const bool yin = (0 <= sy) && (sy < h);
      for (int x = 0; x < w; ++x) {
        const int ox = flip ? (w - 1 - x) : x;
        const int sx = x + dx;
        float* d = dst + ((long)y * w + ox) * c;
        if (yin && 0 <= sx && sx < w) {
          const uint8_t* s = src + ((long)sy * w + sx) * c;
          for (int ch = 0; ch < c; ++ch)
            d[ch] = (float)s[ch] * scale[ch] + bias[ch];
        } else {
          for (int ch = 0; ch < c; ++ch) d[ch] = zero[ch];
        }
      }
    }
  }
}

// eval path: normalize only
void normalize_u8_to_f32(const uint8_t* in, float* out, long num_pixels,
                         int c, const float* mean, const float* stdv) {
  float scale[16], bias[16];
  for (int ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stdv[ch]);
    bias[ch] = -mean[ch] / stdv[ch];
  }
  for (long p = 0; p < num_pixels; ++p) {
    const uint8_t* s = in + p * c;
    float* d = out + p * c;
    for (int ch = 0; ch < c; ++ch)
      d[ch] = (float)s[ch] * scale[ch] + bias[ch];
  }
}

}  // extern "C"
