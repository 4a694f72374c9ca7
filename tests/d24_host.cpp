// Host (g++) loop over the fused transport unpack's per-entry pieces: the
// header the CUDA kernel runs (h263_tpu_torch/csrc/d24.cuh), driven entry by
// entry over whole rows, so the tests can hold the kernel's arithmetic
// against the reference on the CPU.  Arguments and layouts are those of the
// kernel's entry point h263_d24_unpack in d24.cu; the kernel's block-wide
// prefix sum is the running sum here.

#include <string.h>

#include "../h263_tpu_torch/csrc/d24.cuh"

extern "C" int h263_d24_unpack_host(const uint8_t* rows, int64_t pitch,
                                    int n_entries, int mv_stride, int S,
                                    int mbh, int mbw, const uint8_t* zigzag,
                                    int16_t* dense, int16_t* mvs,
                                    uint8_t* inter) {
  const int nmb = mbh * mbw, limit = 6 * nmb * 64;
  for (int64_t s = 0; s < S; ++s) {
    const uint8_t* row = rows + s * pitch;
    int16_t* out = dense + s * limit;
    memset(out, 0, sizeof(int16_t) * limit);
    const uint8_t* entries = row;
    if (mv_stride) {
      for (int j = 0; j < nmb * 8; ++j) {
        mvs[s * nmb * 8 + j] = h263::d24_mv(row, mv_stride, j);
      }
      const uint8_t* bits = row + nmb * mv_stride;
      for (int j = 0; j < nmb; ++j) inter[s * nmb + j] = h263::d24_flag(bits, j);
      entries = bits + (nmb + 7) / 8;
    }
    int sum = 0;
    for (int k = 0; k < n_entries; ++k) {
      int delta, val;
      h263::d24_entry(entries + 3 * k, &delta, &val);
      sum += delta;
      const int pos = h263::d24_position(sum - 1, mbh, mbw, zigzag);
      if (val == 0 || pos < 0) continue;
      // The kernel's word update, on the aligned word that holds `pos`.
      uint32_t word;
      int16_t* w = out + (pos & ~1);
      memcpy(&word, w, 4);
      word = h263::d24_add_half(word, (pos & 1) * 16u, val);
      memcpy(w, &word, 4);
    }
  }
  return 0;
}
