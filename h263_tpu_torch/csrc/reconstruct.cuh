// Per-block pieces of the fused reconstruction, shared by the CUDA kernel
// (reconstruct.cu, built by nvcc) and a host build (g++, used by the CPU
// tests to check this very source): where a block of the dense coefficient
// tensor lies in the picture, its motion vector, the half-pel predictor of
// one row of it, and the add-clamp store.  Semantics are those of
// h263_tpu/ops/mocomp.py (gather_plane_jnp, chroma_mv_jnp) and
// h263_tpu/decoder/reconstruct.py::reconstruct_from_residuals_single.
//
// Dense layout (int16 [6*nmb, 64] per stream): the luma block grid
// [2*mbh, 2*mbw] row-major, then Cb [mbh, mbw], then Cr [mbh, mbw].

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define H263_HD __host__ __device__
#define H263_INLINE __forceinline__
#define H263_UNROLL _Pragma("unroll")
#else
#define H263_HD
#define H263_INLINE inline
#define H263_UNROLL
#endif

namespace h263 {

struct FrameGeometry {
  int mbh, mbw;  // macroblock grid
  int h, w;      // luma plane; chroma is ((h+1)/2, (w+1)/2)
};

// Where block k (0 .. 6*nmb-1) of a stream lies.
struct BlockPlace {
  int plane;   // 0 luma, 1 Cb, 2 Cr
  int by, bx;  // block coordinates inside the plane's block grid
  int mb;      // macroblock index (row-major)
  int sub;     // luma: which of the macroblock's four MVs; chroma: 0
};

H263_HD H263_INLINE BlockPlace locate_block(int k, const FrameGeometry& g) {
  const int nmb = g.mbh * g.mbw;
  BlockPlace p;
  if (k < 4 * nmb) {
    p.plane = 0;
    p.by = k / (2 * g.mbw);
    p.bx = k - p.by * (2 * g.mbw);
    p.mb = (p.by >> 1) * g.mbw + (p.bx >> 1);
    p.sub = ((p.by & 1) << 1) | (p.bx & 1);
  } else {
    const int c = k - 4 * nmb;
    p.plane = c < nmb ? 1 : 2;
    p.mb = c < nmb ? c : c - nmb;
    p.by = p.mb / g.mbw;
    p.bx = p.mb - p.by * g.mbw;
    p.sub = 0;
  }
  return p;
}

// One component of the chroma MV from the sum of the four luma MVs:
// divided by 8 with H.263 rounding to full-pel units, in half-pel units.
H263_HD H263_INLINE int chroma_mv_component(int sum) {
  const int whole = (sum >> 4) << 1;
  const int frac = sum & 0x0F;
  return whole + (frac <= 2 ? 0 : (frac >= 14 ? 2 : 1));
}

// The half-pel MV of a block from its macroblock's four luma MVs
// (mb_mvs: int16 [4][2], x then y).
H263_HD H263_INLINE void block_mv(const int16_t* mb_mvs, const BlockPlace& p,
                                  int* mvx, int* mvy) {
  if (p.plane == 0) {
    *mvx = mb_mvs[p.sub * 2];
    *mvy = mb_mvs[p.sub * 2 + 1];
  } else {
    *mvx = chroma_mv_component(mb_mvs[0] + mb_mvs[2] + mb_mvs[4] + mb_mvs[6]);
    *mvy = chroma_mv_component(mb_mvs[1] + mb_mvs[3] + mb_mvs[5] + mb_mvs[7]);
  }
}

H263_HD H263_INLINE int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- Eight samples as the bytes of one 64-bit word, sample i in bits
// 8i .. 8i+7 (the byte order of the card and of every little-endian host).

H263_HD H263_INLINE int ref_sample(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);  // the read-only path: the reference is never written
#else
  return *p;
#endif
}

H263_HD H263_INLINE uint64_t load_aligned8(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return (uint64_t)v.x | ((uint64_t)v.y << 32);
#else
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
#endif
}

// Bytes k .. k+7 of the 16 bytes (lo, hi), k in 0 .. 8, without a branch
// (the threads of a warp differ in k).  (hi << 1) << (63 - s) is hi << (64 -
// s) with no shift by 64 at s = 0.
H263_HD H263_INLINE uint64_t window8(uint64_t lo, uint64_t hi, int k) {
  const int s = (8 * k) & 63;
  const uint64_t v = (lo >> s) | ((hi << 1) << (63 - s));
  return k == 8 ? hi : v;
}

// The 8 samples at p (*s0) and, with `nine`, the 8 at p + 1 (*s1), from the
// one or two aligned words that hold them.  `room` is how many bytes from p
// on belong to the plane; false when the aligned words would reach past
// them.  Needs a plane that starts on an 8-byte boundary.
H263_HD H263_INLINE bool load_row_wide(const uint8_t* p, int room, bool nine,
                                       uint64_t* s0, uint64_t* s1) {
  const int off = (int)(reinterpret_cast<uintptr_t>(p) & 7);
  const bool two = off != 0 || nine;
  if (room + off < (two ? 16 : 8)) return false;
  const uint64_t lo = load_aligned8(p - off);
  const uint64_t hi = two ? load_aligned8(p - off + 8) : 0;
  *s0 = window8(lo, hi, off);
  *s1 = nine ? window8(lo, hi, off + 1) : 0;
  return true;
}

// The same from single samples, every column clamped to [0, w - 1].
H263_HD H263_INLINE void load_row_clamped(const uint8_t* row, int w, int sx,
                                          bool nine, uint64_t* s0,
                                          uint64_t* s1) {
  uint64_t v = 0;
H263_UNROLL
  for (int i = 0; i < 8; ++i)
    v |= (uint64_t)ref_sample(row + clampi(sx + i, 0, w - 1)) << (8 * i);
  *s0 = v;
  *s1 = 0;
  if (nine)
    *s1 = (v >> 8) |
          ((uint64_t)ref_sample(row + clampi(sx + 8, 0, w - 1)) << 56);
}

// Per byte (a + b + c + d + 2) >> 2: even and odd bytes in 16-bit lanes.
H263_HD H263_INLINE uint64_t avg4_bytes(uint64_t a, uint64_t b, uint64_t c,
                                        uint64_t d) {
  const uint64_t m = 0x00FF00FF00FF00FFull, two = 0x0002000200020002ull;
  const uint64_t even =
      (((a & m) + (b & m) + (c & m) + (d & m) + two) >> 2) & m;
  const uint64_t odd = ((((a >> 8) & m) + ((b >> 8) & m) + ((c >> 8) & m) +
                         ((d >> 8) & m) + two) >> 2) & m;
  return even | (odd << 8);
}

// The prediction of the 8 samples (x0 .. x0+7, y) of a plane [h, w] from the
// reference plane `ref` and the half-pel MV: floor(mv / 2) whole samples,
// (a+b+1)>>1 and (a+b+c+d+2)>>2 at half positions, every source coordinate
// clamped to the picture edge on its own; 0 for a block that is not INTER.
// With `wide` (a reference that starts on an 8-byte boundary) a row whose
// samples lie inside the picture comes as aligned 8-byte words.
//
// One formula serves all four half-pel cases, so that the threads of a warp
// (32 blocks with 32 MVs) run one instruction stream: with b = a where y is
// whole and the right neighbours = the samples where x is whole,
// (a0+a1+b0+b1+2)>>2 is (2(a0+a1)+2)>>2 = (a0+a1+1)>>1, (2(a0+b0)+2)>>2 =
// (a0+b0+1)>>1 and (4 a0+2)>>2 = a0.
H263_HD H263_INLINE uint64_t predict_row(const uint8_t* ref, int h, int w,
                                         int x0, int y, int mvx, int mvy,
                                         bool inter, bool wide) {
  if (!inter) return 0;
  const int sx = x0 + (mvx >> 1), sy = y + (mvy >> 1);
  const bool xi = (mvx & 1) != 0, yi = (mvy & 1) != 0;
  const uint8_t* r0 = ref + (int64_t)clampi(sy, 0, h - 1) * w;
  const uint8_t* r1 = ref + (int64_t)clampi(sy + 1, 0, h - 1) * w;
  // Inside the row: columns sx .. sx+7 (and sx+8 at a half position).
  const bool inside = wide && sx >= 0 && sx + (xi ? 9 : 8) <= w;
  uint64_t a0, a1, b0, b1;
  if (!(inside && load_row_wide(r0 + sx, w - sx, xi, &a0, &a1)))
    load_row_clamped(r0, w, sx, xi, &a0, &a1);
  if (!yi) {
    b0 = a0;
    b1 = a1;
  } else if (!(inside && load_row_wide(r1 + sx, w - sx, xi, &b0, &b1))) {
    load_row_clamped(r1, w, sx, xi, &b0, &b1);
  }
  if (!xi && !yi) return a0;
  if (!xi) {
    a1 = a0;
    b1 = b0;
  }
  return avg4_bytes(a0, a1, b0, b1);
}

H263_HD H263_INLINE uint8_t add_clamp(int pred, int res) {
  return (uint8_t)clampi(pred + res, 0, 255);
}

// Row `row` (0..7) of one block: predict, add the residuals `res[8]` (not
// read when `res_zero` says the block has none), clamp and store into the
// plane `out` [h, w], cropped where the block grid overhangs the picture.
// `wide_load`: see predict_row.  `wide_store`: an 8-sample row is 8-byte
// aligned in `out` (w % 8 == 0 and an aligned plane) and goes out as one
// store.
template <class Res>
H263_HD H263_INLINE void reconstruct_block_row(
    const uint8_t* ref, uint8_t* out, int h, int w, int bx, int by, int row,
    int mvx, int mvy, bool inter, const Res* res, bool res_zero,
    bool wide_load, bool wide_store) {
  const int x0 = bx * 8, y = by * 8 + row;
  if (y >= h || x0 >= w) return;
  uint64_t px = predict_row(ref, h, w, x0, y, mvx, mvy, inter, wide_load);
  if (!res_zero) {
    uint64_t sum = 0;
H263_UNROLL
    for (int i = 0; i < 8; ++i)
      sum |= (uint64_t)add_clamp((int)((px >> (8 * i)) & 0xFF), (int)res[i])
             << (8 * i);
    px = sum;
  }
  uint8_t* dst = out + (int64_t)y * w + x0;
  if (wide_store) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint2*>(dst) =
        make_uint2((uint32_t)px, (uint32_t)(px >> 32));
#else
    memcpy(dst, &px, 8);
#endif
    return;
  }
H263_UNROLL
  for (int i = 0; i < 8; ++i)
    if (x0 + i < w) dst[i] = (uint8_t)(px >> (8 * i));
}

}  // namespace h263
