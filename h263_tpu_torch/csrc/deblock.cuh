// The arithmetic of the Annex-J deblocking filter, shared by the CUDA kernel
// (deblock.cu, built by nvcc) and a host build (g++, used by the CPU tests
// against h263_tpu/ops/deblock.py::golden_deblock).  Without __CUDACC__ the
// function qualifiers below are empty.
//
// One quartet A, B, C, D (four samples across an edge) is updated as the
// reference does (deblock.rs:29-42 / :99-127):
//   num = A - 4B + 4C - D,  diff = A - D
//   floor zone: d = num >> 3, d2in = diff >> 2, lim = |d1 >> 1|
//   trunc zone: d = num / 8,  d2in = diff / 4,  lim = |d1 / 2|   (C `/`)
//   d1 = sign(d) * max(0, |d| - max(0, 2 (|d| - strength)))
//   d2 = clip(d2in, -lim, lim)
//   A' = (A - d2) & 0xFF, D' = (D + d2) & 0xFF   (wrapping u8 casts)
//   B' = clamp(B + d1, 0, 255), C' = clamp(C - d1, 0, 255)
// `>>` on a negative int is an arithmetic shift (floor) with both g++ and
// nvcc, and `/` truncates toward zero: the two zones differ exactly where
// the reference's SIMD and scalar paths differ.
//
// Plane geometry (h x w, any size):
//   horizontal edges at rows ey = 8, 16, ... while ey <= h - 2; quartet rows
//     ey-2 .. ey+1; columns < 8*(w/8) floor zone, the rest trunc;
//   vertical edges, only when w >= 10: chunks k < (w-2)/8, quartet columns
//     8k+6 .. 8k+9; rows < 8*(h/8) floor zone, the rest trunc;
//   the vertical pass reads the horizontal pass's output.
// Quartets of one pass never overlap, so each pass is parallel over them.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define DEBLOCK_HD __host__ __device__ __forceinline__
#else
#define DEBLOCK_HD inline
#endif

namespace h263 {

DEBLOCK_HD int deblock_clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

DEBLOCK_HD int deblock_abs(int v) { return v < 0 ? -v : v; }

// A lane filters with its strength only when its apply flag is set; a
// strength <= 0 copies the lane.
DEBLOCK_HD int deblock_lane_strength(const int32_t* strength,
                                     const uint8_t* apply, int s) {
  return apply[s] ? strength[s] : 0;
}

// Updates the quartet in place.
DEBLOCK_HD void deblock_quartet(int& a, int& b, int& c, int& d, int strength,
                                bool floor_mode) {
  const int num = a - 4 * b + 4 * c - d;
  const int diff = a - d;
  const int dd = floor_mode ? (num >> 3) : (num / 8);
  const int d2_in = floor_mode ? (diff >> 2) : (diff / 4);
  const int ax = deblock_abs(dd);
  int ramp = 2 * (ax - strength);
  ramp = ramp > 0 ? ramp : 0;
  int mag = ax - ramp;
  mag = mag > 0 ? mag : 0;
  const int d1 = dd > 0 ? mag : (dd < 0 ? -mag : 0);
  const int lim = deblock_abs(floor_mode ? (d1 >> 1) : (d1 / 2));
  const int d2 = d2_in < -lim ? -lim : (d2_in > lim ? lim : d2_in);
  const int na = (a - d2) & 0xFF;
  const int nb = deblock_clamp255(b + d1);
  const int nc = deblock_clamp255(c - d1);
  const int nd = (d + d2) & 0xFF;
  a = na;
  b = nb;
  c = nc;
  d = nd;
}

// Rows of horizontal band `band`: [8*band - 2, 8*band + 6) cut to [0, h).
// The band's first four rows are the quartet of edge ey = 8*band when that
// edge exists; the others are copied.
DEBLOCK_HD int deblock_n_bands(int h) { return (h + 2 + 7) / 8; }

// Horizontal pass of one column x of one band: reads `src`, writes `dst`
// (both h x w, row pitch w).  strength <= 0 copies.
DEBLOCK_HD void deblock_h_band_column(const uint8_t* src, uint8_t* dst,
                                      int h, int w, int band, int x,
                                      int strength) {
  const int ey = 8 * band;
  const int y0 = ey - 2 < 0 ? 0 : ey - 2;
  const int y1 = ey + 6 > h ? h : ey + 6;
  const bool edge = strength > 0 && ey >= 8 && ey <= h - 2;
  int first_copy = y0;
  if (edge) {
    int a = src[(int64_t)(ey - 2) * w + x];
    int b = src[(int64_t)(ey - 1) * w + x];
    int c = src[(int64_t)ey * w + x];
    int d = src[(int64_t)(ey + 1) * w + x];
    deblock_quartet(a, b, c, d, strength, x < (w / 8) * 8);
    dst[(int64_t)(ey - 2) * w + x] = (uint8_t)a;
    dst[(int64_t)(ey - 1) * w + x] = (uint8_t)b;
    dst[(int64_t)ey * w + x] = (uint8_t)c;
    dst[(int64_t)(ey + 1) * w + x] = (uint8_t)d;
    first_copy = ey + 2;
  }
  for (int y = first_copy; y < y1; ++y)
    dst[(int64_t)y * w + x] = src[(int64_t)y * w + x];
}

DEBLOCK_HD int deblock_n_chunks(int w) { return w >= 10 ? (w - 2) / 8 : 0; }

// Vertical pass of one row y of one chunk k, in place on `p` (h x w).
DEBLOCK_HD void deblock_v_row_chunk(uint8_t* p, int h, int w, int y, int k,
                                    int strength) {
  uint8_t* q = p + (int64_t)y * w + 8 * k + 6;
  int a = q[0], b = q[1], c = q[2], d = q[3];
  deblock_quartet(a, b, c, d, strength, y < (h / 8) * 8);
  q[0] = (uint8_t)a;
  q[1] = (uint8_t)b;
  q[2] = (uint8_t)c;
  q[3] = (uint8_t)d;
}

}  // namespace h263
