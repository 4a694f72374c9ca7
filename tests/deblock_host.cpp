// Host (g++) walk of the one-pass deblocking kernel: the same headers the
// CUDA kernel runs (h263_tpu_torch/csrc/deblock_tile.cuh over deblock.cuh),
// driven tile by tile as deblock.cu drives them (the same tile grid; load,
// horizontal edges, vertical edges, store, each function over every thread
// index before the next, which is what __syncthreads() orders on the card),
// so the tests can hold the kernel's source against the reference on the
// CPU.  Arguments and layouts are those of the kernel's entry point
// h263_deblock, plus the number of threads a block is walked with.

#include "../h263_tpu_torch/csrc/deblock_tile.cuh"

namespace {

constexpr int kRowStep = h263::kLumaRowStep;
constexpr int kColStep = h263::kLumaColStep;
constexpr int kShift = h263::kLumaShift;
constexpr int kPitch = h263::tile_pitch(kColStep, kShift);
constexpr int kRows = kRowStep + kShift;

}  // namespace

extern "C" int h263_deblock_host(const uint8_t* planes, uint8_t* out, int S,
                                 int h, int w, const int32_t* strength,
                                 const uint8_t* apply, int nthreads) {
  alignas(16) static uint8_t buf[kRows * kPitch];
  if (nthreads <= 0 || nthreads % h263::kWarp != 0) return 2;
  if (S <= 0 || h <= 0 || w <= 0) return 0;   // as the launcher: no launch
  const int n_row_tiles = h263::tile_count(h, kRowStep, kShift);
  const int n_col_tiles = h263::tile_count(w, kColStep, kShift);
  for (int s = 0; s < S; ++s) {
    const int st = h263::deblock_lane_strength(strength, apply, s);
    const int64_t off = (int64_t)s * h * w;
    for (int ty = 0; ty < n_row_tiles; ++ty) {
      for (int tx = 0; tx < n_col_tiles; ++tx) {
        memset(buf, 0xA5, sizeof buf);   // nothing carries over between tiles
        const h263::DeblockTile t = h263::deblock_tile(
            buf, kPitch, planes + off, h, w, ty, tx, kRowStep, kColStep,
            kShift);
        if (t.rows() > kRows || t.width() + 15 > kPitch) return 1;
        for (int tid = 0; tid < nthreads; ++tid)
          h263::deblock_tile_load(t, tid, nthreads);
        if (st > 0) {
          for (int tid = 0; tid < nthreads; ++tid)
            h263::deblock_tile_h(t, st, tid, nthreads);
          for (int tid = 0; tid < nthreads; ++tid)
            h263::deblock_tile_v(t, st, tid, nthreads);
        }
        for (int tid = 0; tid < nthreads; ++tid)
          h263::deblock_tile_store(t, out + off, tid, nthreads);
      }
    }
  }
  return 0;
}
