// Per-entry pieces of the fused transport's unpack, shared by the CUDA
// kernel (d24.cu, built by nvcc) and a host build (g++, used by the CPU
// tests to check this very source, tests/d24_host.cpp): one 24-bit entry,
// the dense position of an ordinal cursor, the add of a value into one
// int16 half of a 32-bit word, and the MVs and INTER flags of a row.
// Semantics are those of h263_tpu/decoder/reconstruct.py::d24_to_posval and
// reconstruct_frame_packed_d24_fused.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define H263_HD __host__ __device__
#define H263_INLINE __forceinline__
#else
#define H263_HD
#define H263_INLINE inline
#endif

namespace h263 {

// A big-endian entry (delta << 12) | (value & 0xFFF): its delta and its
// value sign-extended from 12 bits.
H263_HD H263_INLINE void d24_entry(const uint8_t* e, int* delta, int* val) {
  const unsigned int w = ((unsigned int)e[0] << 16) |
                         ((unsigned int)e[1] << 8) | e[2];
  *delta = (int)(w >> 12);
  const int v = (int)(w & 0xFFFu);
  *val = v - ((v & 0x800) << 1);
}

// The position in a stream's dense [6*nmb, 64] coefficients of ordinal
// cursor `cursor` (macroblock, block, zigzag index), or -1 where the entry
// is dropped: cursor < 0, or a position at or past 6*nmb*64.  Luma blocks
// lie on the row-major 2mbh x 2mbw grid, then Cb, then Cr; `rowmajor` maps
// a zigzag index to the row-major one.
H263_HD H263_INLINE int d24_position(int cursor, int mbh, int mbw,
                                     const uint8_t* rowmajor) {
  if (cursor < 0) return -1;
  const int nmb = mbh * mbw;
  const int mb = cursor / 384;
  const int rem = cursor - mb * 384;
  const int b = rem >> 6;
  const int r = mb / mbw, c = mb - r * mbw;
  const int blk = b < 4 ? (2 * r + (b >> 1)) * (2 * mbw) + 2 * c + (b & 1)
                        : 4 * nmb + (b - 4) * nmb + r * mbw + c;
  const int pos = blk * 64 + rowmajor[rem & 63];
  return pos < 6 * nmb * 64 ? pos : -1;
}

// `word` with v added, modulo 2^16, to its int16 half at bit `shift` (0 or
// 16, the half at the lower address on a little-endian card being 0).
H263_HD H263_INLINE unsigned int d24_add_half(unsigned int word,
                                              unsigned int shift, int v) {
  const unsigned int half = ((word >> shift) + (unsigned int)v) & 0xFFFFu;
  return (word & ~(0xFFFFu << shift)) | (half << shift);
}

// Element j of a stream's int16 MVs [nmb, 4, 2] from its row's int8 MVs:
// 8 B/MB hold all four blocks' MVs, 2 B/MB the one MV of all four.
H263_HD H263_INLINE int16_t d24_mv(const uint8_t* row, int mv_stride, int j) {
  const int src = mv_stride == 8 ? j : (j >> 3) * 2 + (j & 1);
  return (int16_t)(int8_t)row[src];
}

// INTER flag of macroblock j from the MSB-first bitmask.
H263_HD H263_INLINE uint8_t d24_flag(const uint8_t* bits, int j) {
  return (bits[j >> 3] >> (7 - (j & 7))) & 1;
}

}  // namespace h263
