// The Annex-J deblocking filter of one tile of a plane, and the tile grid
// that makes a tile self-contained.  Shared by deblock.cu, present.cu and a
// host build (g++) that walks the same tiles in the same order on the CPU.
//
// The grid.  Horizontal-edge quartets occupy rows 8m-2 .. 8m+1 (m >= 1),
// vertical-edge quartets columns 8k+6 .. 8k+9 = 8(k+1)-2 .. 8(k+1)+1, and the
// vertical pass of a row reads only that row's horizontal-pass output.  A
// boundary b between two tiles cuts a quartet only if b mod 8 is 7, 0 or 1.
// So with every boundary at step*t + shift, step a multiple of 8 and shift in
// 2..6, the whole two-pass filter of a tile reads and writes no byte outside
// it: no halo, no second pass over device memory, no hazard between thread
// blocks.  Tile 0 starts at 0 and the last tile ends at the plane's edge.
// For a 4:2:0 picture, luma tiles at (32t + 4, 512t + 4) and chroma tiles at
// (16t + 2, 256t + 2) cover the same picture area.  Whether a quartet lies in the floor or the
// trunc zone, and whether its edge exists, depends on its place in the plane
// and the plane's size (deblock.cuh), never on the tile.
//
// The tile's bytes.  Row y of the tile lies at buf + (y - y0) * pitch + the
// low four bits of that row's address in device memory, so a 16-byte access
// that is aligned in device memory is aligned in the tile too, whatever the
// plane's width.  Device memory is walked in aligned 16-byte slots; a slot
// that a row fills only partly (ragged starts and ends, odd widths) is
// copied byte by byte.  pitch >= tile width + 15, a multiple of 16.
//
// Every function takes (tid, nthreads), nthreads a multiple of 32: the kernel
// passes its thread index and block size, with __syncthreads() between the
// functions; the host build runs tid = 0 .. nthreads-1 of one function before
// the next.
//
// What the walk costs.  On the card these kernels are bound by the
// instructions they execute as much as by their bytes, so the walk keeps the
// count per sample low: a warp copies one row at a time (the row's pointers
// and alignment are computed once; the loads of a tile are asynchronous
// copies, cp.async, all in flight together), the horizontal pass takes four columns
// as one aligned word from each of its four rows whenever the plane's width
// is a multiple of four, the vertical pass takes a quartet as two aligned
// halves, and a quartet's rounding zone is a branch that a warp takes
// together, not a select between both results.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#endif

#include "deblock.cuh"

namespace h263 {

// Tile grids (step, shift) of luma and chroma, rows and columns.  The column
// step bounds a tile's width, and so the shared memory of a block, for any
// plane width.
constexpr int kLumaRowStep = 32, kLumaColStep = 512, kLumaShift = 4;
constexpr int kChromaRowStep = 16, kChromaColStep = 256, kChromaShift = 2;

constexpr int tile_pitch(int col_step, int shift) {
  return (col_step + shift + 15 + 15) / 16 * 16;
}

// Number of tiles along a dimension of n samples.
DEBLOCK_HD int tile_count(int n, int step, int shift) {
  return n <= shift ? 1 : (n - shift + step - 1) / step;
}
DEBLOCK_HD int tile_lo(int t, int step, int shift) {
  return t == 0 ? 0 : t * step + shift;
}
DEBLOCK_HD int tile_hi(int t, int step, int shift, int n) {
  const int e = (t + 1) * step + shift;
  return e < n ? e : n;
}

DEBLOCK_HD uint32_t low_address_bits(const void* p) {
  return (uint32_t)(uintptr_t)p;
}

struct DeblockTile {
  uint8_t* buf;        // the tile's bytes (shared memory in a kernel)
  int pitch;
  const uint8_t* src;  // the plane in device memory, row pitch w
  int h, w;            // the plane
  int y0, y1, x0, x1;  // the tile: rows [y0, y1), columns [x0, x1)
  uint32_t a0;         // low bits of the address of sample (y0, x0)

  DEBLOCK_HD int width() const { return x1 - x0; }
  DEBLOCK_HD int rows() const { return y1 - y0; }
  // Sample (y, x0) of the tile.
  DEBLOCK_HD uint8_t* row(int y) const {
    return buf + (y - y0) * pitch + ((a0 + (uint32_t)((y - y0) * w)) & 15u);
  }
};

// Tile (ty, tx) of the grid (row_step, col_step, shift) over the plane
// `src` (h x w, row pitch w).
DEBLOCK_HD DeblockTile deblock_tile(uint8_t* buf, int pitch,
                                    const uint8_t* src, int h, int w, int ty,
                                    int tx, int row_step, int col_step,
                                    int shift) {
  DeblockTile t;
  t.buf = buf;
  t.pitch = pitch;
  t.src = src;
  t.h = h;
  t.w = w;
  t.y0 = tile_lo(ty, row_step, shift);
  t.y1 = tile_hi(ty, row_step, shift, h);
  t.x0 = tile_lo(tx, col_step, shift);
  t.x1 = tile_hi(tx, col_step, shift, w);
  t.a0 = low_address_bits(src + (int64_t)t.y0 * w + t.x0);
  return t;
}

DEBLOCK_HD void copy16(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// Aligned loads and stores of 2 and 4 bytes, little-endian.
DEBLOCK_HD uint32_t load16(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint16_t*>(p);
#else
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
#endif
}
DEBLOCK_HD void store16(uint8_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)v;
#else
  const uint16_t h = (uint16_t)v;
  memcpy(p, &h, 2);
#endif
}
DEBLOCK_HD uint32_t load32(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}
DEBLOCK_HD void store32(uint8_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint32_t*>(p) = v;
#else
  memcpy(p, &v, 4);
#endif
}

constexpr int kWarp = 32;

// floor(i / d) for the small counts of one tile (0 <= i < 2^16, d < 2^10)
// without an integer division: (i + 0.5) / d lies at least 0.5 / d from an
// integer, far more than the float product's error.
struct SmallDivisor {
  float inv;
};
DEBLOCK_HD SmallDivisor small_divisor(int d) {
  return SmallDivisor{1.0f / (float)d};
}
DEBLOCK_HD int small_div(int i, SmallDivisor d) {
  return (int)(((float)i + 0.5f) * d.inv);
}

// One warp copies a row of n bytes, lane by lane in the aligned 16-byte
// slots of `mem`, the row's start in device memory (`dst` or `src`; the
// other is the row's start in the tile).  A slot that the row fills only
// partly, or whose other side is not aligned, goes byte by byte.  With
// kAsync (device memory -> shared memory) the wide copies are cp.async,
// complete after deblock_tile_load_wait().
template <bool kAsync>
DEBLOCK_HD void copy_row(uint8_t* dst, const uint8_t* src, int n,
                         const uint8_t* mem, int lane) {
  const int lead = (int)(low_address_bits(mem) & 15u);
  const bool wide =
      ((low_address_bits(dst) ^ low_address_bits(src)) & 15u) == 0;
  for (int b0 = 16 * lane - lead; b0 < n; b0 += 16 * kWarp) {
    if (wide && b0 >= 0 && b0 + 16 <= n) {
#ifdef __CUDA_ARCH__
      if (kAsync) {
        __pipeline_memcpy_async(dst + b0, src + b0, 16);
        continue;
      }
#endif
      copy16(dst + b0, src + b0);
    } else {
      const int hi = b0 + 16 > n ? n : b0 + 16;
      for (int j = b0 < 0 ? 0 : b0; j < hi; ++j) dst[j] = src[j];
    }
  }
}

// The plane -> the tile; the thread's copies are complete after
// deblock_tile_load_wait().
DEBLOCK_HD void deblock_tile_load(const DeblockTile& t, int tid,
                                  int nthreads) {
  for (int r = tid / kWarp; r < t.rows(); r += nthreads / kWarp) {
    const uint8_t* g = t.src + (int64_t)(t.y0 + r) * t.w + t.x0;
    copy_row<true>(t.row(t.y0 + r), g, t.width(), g, tid % kWarp);
  }
}

// Waits for the calling thread's loads of every tile (nothing to wait for on
// the host).
DEBLOCK_HD void deblock_tile_load_wait() {
#ifdef __CUDA_ARCH__
  __pipeline_commit();
  __pipeline_wait_prior(0);
#endif
}

// Tile -> the same place of the plane `dst` (h x w), each byte once.
DEBLOCK_HD void deblock_tile_store(const DeblockTile& t, uint8_t* dst,
                                   int tid, int nthreads) {
  for (int r = tid / kWarp; r < t.rows(); r += nthreads / kWarp) {
    uint8_t* g = dst + (int64_t)(t.y0 + r) * t.w + t.x0;
    copy_row<false>(g, t.row(t.y0 + r), t.width(), g, tid % kWarp);
  }
}

// The quartet with its rounding zone as a branch.
DEBLOCK_HD void deblock_quartet_zone(int& a, int& b, int& c, int& d,
                                     int strength, bool floor_mode) {
  if (floor_mode) {
    deblock_quartet(a, b, c, d, strength, true);
  } else {
    deblock_quartet(a, b, c, d, strength, false);
  }
}

// Four neighbouring quartets across a horizontal edge, one little-endian
// word from each row; the first `floor_cols` columns lie in the floor zone.
DEBLOCK_HD void deblock_quartet_word(uint32_t& wa, uint32_t& wb, uint32_t& wc,
                                     uint32_t& wd, int strength,
                                     int floor_cols) {
  uint32_t na = 0, nb = 0, nc = 0, nd = 0;
  for (int j = 0; j < 4; ++j) {
    const int sh = 8 * j;
    int a = (wa >> sh) & 255, b = (wb >> sh) & 255, c = (wc >> sh) & 255,
        d = (wd >> sh) & 255;
    deblock_quartet(a, b, c, d, strength, j < floor_cols);
    na |= (uint32_t)a << sh;
    nb |= (uint32_t)b << sh;
    nc |= (uint32_t)c << sh;
    nd |= (uint32_t)d << sh;
  }
  wa = na;
  wb = nb;
  wc = nc;
  wd = nd;
}

// Horizontal edges of the tile, in place.
DEBLOCK_HD void deblock_tile_h(const DeblockTile& t, int strength, int tid,
                               int nthreads) {
  // Edges ey = 8m whose rows ey-2 .. ey+1 lie in [y0, y1); y1 <= h then
  // gives ey <= h - 2.
  int m0 = (t.y0 + 2 + 7) / 8;
  if (m0 < 1) m0 = 1;
  const int m1 = t.y1 >= 2 ? (t.y1 - 2) / 8 : -1;
  if (m1 < m0) return;
  const int tw = t.width();
  const int floor_w = (t.w / 8) * 8 - t.x0;
  // With w a multiple of four, every row of the tile has the same address
  // modulo four: one item per (edge, aligned word of four columns); the
  // ragged ends of a row, and every other width, column by column.
  const int lead = (t.w & 3) == 0 ? (int)(low_address_bits(t.row(t.y0)) & 3u)
                                  : 0;
  const int step = (t.w & 3) == 0 ? 4 : 1;
  const int per_edge = (lead + tw + step - 1) / step;
  const SmallDivisor dv = small_divisor(per_edge);
  const int n = (m1 - m0 + 1) * per_edge;
  for (int i = tid; i < n; i += nthreads) {
    const int e = small_div(i, dv);
    const int x = step * (i - e * per_edge) - lead;
    const int ey = 8 * (m0 + e);
    uint8_t* pa = t.row(ey - 2) + x;
    uint8_t* pb = t.row(ey - 1) + x;
    uint8_t* pc = t.row(ey) + x;
    uint8_t* pd = t.row(ey + 1) + x;
    if (step == 4 && x >= 0 && x + 4 <= tw) {
      uint32_t wa = load32(pa), wb = load32(pb), wc = load32(pc),
               wd = load32(pd);
      const int floor_cols = floor_w - x;
      if (floor_cols >= 4) {
        deblock_quartet_word(wa, wb, wc, wd, strength, 4);
      } else if (floor_cols <= 0) {
        deblock_quartet_word(wa, wb, wc, wd, strength, 0);
      } else {
        deblock_quartet_word(wa, wb, wc, wd, strength, floor_cols);
      }
      store32(pa, wa);
      store32(pb, wb);
      store32(pc, wc);
      store32(pd, wd);
    } else {
      for (int j = 0; j < step; ++j) {
        if (x + j < 0 || x + j >= tw) continue;
        int a = pa[j], b = pb[j], c = pc[j], d = pd[j];
        deblock_quartet_zone(a, b, c, d, strength, x + j < floor_w);
        pa[j] = (uint8_t)a;
        pb[j] = (uint8_t)b;
        pc[j] = (uint8_t)c;
        pd[j] = (uint8_t)d;
      }
    }
  }
}

// Vertical edges of the tile, in place on the horizontal pass's output: one
// item per (row, chunk).
DEBLOCK_HD void deblock_tile_v(const DeblockTile& t, int strength, int tid,
                               int nthreads) {
  // Chunks k whose columns 8k+6 .. 8k+9 lie in [x0, x1); x1 <= w then gives
  // w >= 10 and k < (w - 2) / 8.
  const int k0 = t.x0 <= 6 ? 0 : (t.x0 - 6 + 7) / 8;
  const int k1 = t.x1 >= 10 ? (t.x1 - 10) / 8 : -1;
  const int nk = k1 - k0 + 1;
  if (nk <= 0) return;
  const SmallDivisor dv = small_divisor(nk);
  const int n = t.rows() * nk;
  const int floor_h = (t.h / 8) * 8;
  for (int i = tid; i < n; i += nthreads) {
    const int r = small_div(i, dv), k = k0 + i - r * nk;
    uint8_t* q = t.row(t.y0 + r) + (8 * k + 6 - t.x0);
    const bool floor_mode = t.y0 + r < floor_h;
    if ((low_address_bits(q) & 1u) == 0) {
      const uint32_t ab = load16(q), cd = load16(q + 2);
      int a = ab & 255, b = ab >> 8, c = cd & 255, d = cd >> 8;
      deblock_quartet_zone(a, b, c, d, strength, floor_mode);
      store16(q, (uint32_t)(a | (b << 8)));
      store16(q + 2, (uint32_t)(c | (d << 8)));
    } else {
      int a = q[0], b = q[1], c = q[2], d = q[3];
      deblock_quartet_zone(a, b, c, d, strength, floor_mode);
      q[0] = (uint8_t)a;
      q[1] = (uint8_t)b;
      q[2] = (uint8_t)c;
      q[3] = (uint8_t)d;
    }
  }
}

}  // namespace h263
