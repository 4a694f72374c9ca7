// Host (g++) walk of the fused presentation kernel: the same headers the
// CUDA kernel runs (h263_tpu_torch/csrc/present_tile.cuh over
// deblock_tile.cuh, deblock.cuh and yuv.cuh), driven tile by tile as
// present.cu drives them (the luma grid and the chroma grid of the same
// picture area; load, horizontal edges, vertical edges, convert and store,
// each function over every thread index before the next, which is what
// __syncthreads() orders on the card).  Arguments and layouts are those of
// the kernel's entry point h263_present_rgba, plus the number of threads a
// block is walked with.

#include "../h263_tpu_torch/csrc/present_tile.cuh"

namespace {

constexpr int kPitchY = h263::tile_pitch(h263::kLumaColStep, h263::kLumaShift);
constexpr int kRowsY = h263::kLumaRowStep + h263::kLumaShift;
constexpr int kPitchC =
    h263::tile_pitch(h263::kChromaColStep, h263::kChromaShift);
constexpr int kRowsC = h263::kChromaRowStep + h263::kChromaShift;

bool fits(const h263::DeblockTile& t, int rows, int pitch) {
  return t.rows() >= 1 && t.rows() <= rows && t.width() >= 1 &&
         t.width() + 15 <= pitch;
}

}  // namespace

extern "C" int h263_present_host(const uint8_t* y, const uint8_t* cb,
                                 const uint8_t* cr, uint8_t* out, int S,
                                 int h, int w, const int32_t* strength,
                                 const uint8_t* apply, int nthreads) {
  alignas(16) static uint8_t buf_y[kRowsY * kPitchY];
  alignas(16) static uint8_t buf_cb[kRowsC * kPitchC];
  alignas(16) static uint8_t buf_cr[kRowsC * kPitchC];
  if (nthreads <= 0 || nthreads % h263::kWarp != 0) return 2;
  if (S <= 0 || h <= 0 || w <= 0) return 0;   // as the launcher: no launch
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const int n_row_tiles =
      h263::tile_count(h, h263::kLumaRowStep, h263::kLumaShift);
  const int n_col_tiles =
      h263::tile_count(w, h263::kLumaColStep, h263::kLumaShift);
  for (int s = 0; s < S; ++s) {
    const int st = h263::deblock_lane_strength(strength, apply, s);
    const int64_t off = (int64_t)s * h * w, coff = (int64_t)s * ch * cw;
    for (int ty = 0; ty < n_row_tiles; ++ty) {
      for (int tx = 0; tx < n_col_tiles; ++tx) {
        memset(buf_y, 0xA5, sizeof buf_y);
        memset(buf_cb, 0xA5, sizeof buf_cb);
        memset(buf_cr, 0xA5, sizeof buf_cr);
        const h263::DeblockTile tiles[3] = {
            h263::deblock_tile(buf_y, kPitchY, y + off, h, w, ty, tx,
                               h263::kLumaRowStep, h263::kLumaColStep,
                               h263::kLumaShift),
            h263::deblock_tile(buf_cb, kPitchC, cb + coff, ch, cw, ty, tx,
                               h263::kChromaRowStep, h263::kChromaColStep,
                               h263::kChromaShift),
            h263::deblock_tile(buf_cr, kPitchC, cr + coff, ch, cw, ty, tx,
                               h263::kChromaRowStep, h263::kChromaColStep,
                               h263::kChromaShift)};
        if (!fits(tiles[0], kRowsY, kPitchY) ||
            !fits(tiles[1], kRowsC, kPitchC) ||
            !fits(tiles[2], kRowsC, kPitchC))
          return 1;
        for (const auto& t : tiles)
          for (int tid = 0; tid < nthreads; ++tid)
            h263::deblock_tile_load(t, tid, nthreads);
        if (st > 0) {
          for (const auto& t : tiles)
            for (int tid = 0; tid < nthreads; ++tid)
              h263::deblock_tile_h(t, st, tid, nthreads);
          for (const auto& t : tiles)
            for (int tid = 0; tid < nthreads; ++tid)
              h263::deblock_tile_v(t, st, tid, nthreads);
        }
        for (int tid = 0; tid < nthreads; ++tid)
          h263::present_tile_store(tiles[0], tiles[1], tiles[2],
                                   out + 4 * off, tid, nthreads);
      }
    }
  }
  return 0;
}
