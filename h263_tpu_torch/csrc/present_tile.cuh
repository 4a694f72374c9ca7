// Presentation of one tile of a 4:2:0 picture: the deblocked luma tile and
// its Cb and Cr tiles (deblock_tile.cuh) converted to interleaved RGBA
// (yuv.cuh) and written to device memory.  Shared by present.cu and a host
// build (g++) that walks the same tiles on the CPU.
//
// The RGBA row of the tile is walked in aligned 16-byte slots of four pixels;
// a slot that the row fills only partly (ragged starts and ends, widths that
// are no multiple of four) is written pixel by pixel.  Luma column 16j+4 is
// RGBA byte 64j+16 of its row, so a tile's rows start on a slot whenever the
// row pitch 4W is a multiple of 16.

#pragma once

#include <stdint.h>
#include <string.h>

#include "deblock_tile.cuh"
#include "yuv.cuh"

namespace h263 {

DEBLOCK_HD void store_pixels4(uint8_t* dst, const uint32_t* px) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(px[0], px[1], px[2], px[3]);
#else
  memcpy(dst, px, 16);
#endif
}

// The three tiles of one picture area -> `out`, the picture's RGBA
// [h, w, 4] (4-byte aligned).  Luma sample (y, x) takes chroma sample
// (y / 2, x / 2), which the chroma tiles of the same grid position hold.
// A warp converts one luma row at a time, a lane four neighbouring pixels.
DEBLOCK_HD void present_tile_store(const DeblockTile& ty,
                                   const DeblockTile& tcb,
                                   const DeblockTile& tcr, uint8_t* out,
                                   int tid, int nthreads) {
  const int tw = ty.width();
  for (int r = tid / kWarp; r < ty.rows(); r += nthreads / kWarp) {
    const int y = ty.y0 + r;
    uint8_t* g = out + 4 * ((int64_t)y * ty.w + ty.x0);
    const int lead = (int)((low_address_bits(g) & 15u) >> 2);
    const uint8_t* yr = ty.row(y);
    // Indexed by the chroma column itself.
    const uint8_t* cbr = tcb.row(y >> 1) - tcb.x0;
    const uint8_t* crr = tcr.row(y >> 1) - tcr.x0;
    // A slot takes its luma as one aligned word and each chroma row's two
    // samples as one aligned half when the row allows it: slots start at
    // columns x_slot0 + 4c.
    const int x_slot0 = ty.x0 - lead;
    const bool fast =
        ((low_address_bits(yr) - (uint32_t)lead) & 3u) == 0 &&
        (x_slot0 & 1) == 0 &&
        ((low_address_bits(cbr) + (uint32_t)(x_slot0 >> 1)) & 1u) == 0 &&
        ((low_address_bits(crr) + (uint32_t)(x_slot0 >> 1)) & 1u) == 0;
    for (int p0 = 4 * (tid % kWarp) - lead; p0 < tw; p0 += 4 * kWarp) {
      uint32_t px[4];
      if (fast && p0 >= 0 && p0 + 4 <= tw) {
        const uint32_t yw = load32(yr + p0);
        const int cx = (ty.x0 + p0) >> 1;
        const uint32_t cbw = load16(cbr + cx), crw = load16(crr + cx);
        const YuvChroma c0 = yuv_chroma(cbw & 255, crw & 255);
        const YuvChroma c1 = yuv_chroma(cbw >> 8, crw >> 8);
        px[0] = yuv_rgba(yw & 255, c0);
        px[1] = yuv_rgba((yw >> 8) & 255, c0);
        px[2] = yuv_rgba((yw >> 16) & 255, c1);
        px[3] = yuv_rgba(yw >> 24, c1);
        store_pixels4(g + 4 * p0, px);
        continue;
      }
      const bool full = p0 >= 0 && p0 + 4 <= tw;
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + j;
        if (p < 0 || p >= tw) continue;
        const int cx = (ty.x0 + p) >> 1;
        px[j] = yuv_rgba(yr[p], yuv_chroma(cbr[cx], crr[cx]));
        if (!full) store32(g + 4 * p, px[j]);
      }
      if (full) store_pixels4(g + 4 * p0, px);
    }
  }
}

}  // namespace h263
