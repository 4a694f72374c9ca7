// The arithmetic of the BT.601 YUV -> RGBA conversion, shared by yuv.cu,
// present.cu and a host build (g++) used by the CPU tests.  Studio swing to
// full range in exact 16.16 integers (bt601.rs:25-29), clamped to [0, 255],
// alpha 255:
//   Y' = (Y - 16) * 76309, Cb' = Cb - 128, Cr' = Cr - 128
//   R = (Y' + 104597 Cr' + 32768) >> 16
//   G = (Y' - 53279 Cr' - 25675 Cb' + 32768) >> 16
//   B = (Y' + 132201 Cb' + 32768) >> 16

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define YUV_HD __host__ __device__ __forceinline__
#else
#define YUV_HD inline
#endif

namespace h263 {

YUV_HD uint32_t yuv_clamp255(int v) {
  return (uint32_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// What a chroma sample pair (cb, cr as stored, 0..255) adds to R, G and B,
// rounding term included; shared by the luma samples that take the pair.
struct YuvChroma {
  int r, g, b;
};

YUV_HD YuvChroma yuv_chroma(int cb, int cr) {
  YuvChroma c;
  c.r = cr * 104597 + (32768 - 128 * 104597);
  c.g = cr * -53279 + cb * -25675 + (32768 + 128 * 53279 + 128 * 25675);
  c.b = cb * 132201 + (32768 - 128 * 132201);
  return c;
}

// One pixel as R | G << 8 | B << 16 | 255 << 24 (bytes R, G, B, A in
// memory) from a luma sample as stored and its chroma terms.
YUV_HD uint32_t yuv_rgba(int yv, const YuvChroma& c) {
  const int gray = yv * 76309 - 16 * 76309;
  return yuv_clamp255((gray + c.r) >> 16) |
         (yuv_clamp255((gray + c.g) >> 16) << 8) |
         (yuv_clamp255((gray + c.b) >> 16) << 16) | (255u << 24);
}

}  // namespace h263
