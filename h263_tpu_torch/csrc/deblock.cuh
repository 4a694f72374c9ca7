// The arithmetic of the Annex-J deblocking filter, shared by the CUDA kernels
// (deblock.cu and present.cu through deblock_tile.cuh, built by nvcc) and a
// host build (g++, used by the CPU tests against h263_tpu/ops/deblock.py::
// golden_deblock).  Without __CUDACC__ the function qualifiers below are
// empty.
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
// Quartets of one pass never overlap, so each pass is parallel over them;
// deblock_tile.cuh cuts the plane into tiles that no quartet crosses.

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

}  // namespace h263
