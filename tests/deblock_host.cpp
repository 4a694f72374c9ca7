// Host (g++) loop over the deblocking filter's arithmetic: the same header
// the CUDA kernel runs (h263_tpu_torch/csrc/deblock.cuh), driven pass by
// pass as deblock.cu drives it (horizontal bands out of place, then
// vertical chunks in place on the output), so the tests can hold the
// kernel's source against the reference on the CPU.  Arguments and
// layouts are those of the kernel's entry point h263_deblock.

#include "../h263_tpu_torch/csrc/deblock.cuh"

extern "C" int h263_deblock_host(const uint8_t* planes, uint8_t* out, int S,
                                 int h, int w, const int32_t* strength,
                                 const uint8_t* apply) {
  for (int s = 0; s < S; ++s) {
    const int st = h263::deblock_lane_strength(strength, apply, s);
    const int64_t off = (int64_t)s * h * w;
    for (int band = 0; band < h263::deblock_n_bands(h); ++band)
      for (int x = 0; x < w; ++x)
        h263::deblock_h_band_column(planes + off, out + off, h, w, band, x,
                                    st);
    if (st <= 0) continue;
    for (int y = 0; y < h; ++y)
      for (int k = 0; k < h263::deblock_n_chunks(w); ++k)
        h263::deblock_v_row_chunk(out + off, h, w, y, k, st);
  }
  return 0;
}
