// The arithmetic of the sparse-class 8x8 IDCT residual, the one copy of it:
// shared by idct.cu (one thread per block), reconstruct.cu (eight threads
// per block) and a host build (g++ -ffp-contract=off, used by the CPU tests
// to check this very source).  Without __CUDACC__ the qualifiers are empty.
//
// The block's class comes from its nonzero pattern:
//   ZERO  no nonzero coefficient             -> 0
//   DC    only (0,0)                         -> trunc(dc*0.5/4 +- 0.5)
//   VERT  nonzeros in column 0 only, row>0   -> 1-D IDCT of column 0, then
//                                               scaled by B00 AFTER the sum
//   FULL  anything else                      -> two 1-D passes
// every class rounding as trunc(v/4 +- 0.5) clipped to [-256, 255].
//
// Bit-exactness: the reference sums in f32 over frequency 0..7 in order,
// rounding every product.  On the device each product and sum is
// __fmul_rn / __fadd_rn (never contracted into an FMA; the library is built
// with -fmad=false as well); on the host the build forbids contraction.
// The block {735, -555, 215} gives 28 at (0,2); an FMA gives 27.

#pragma once

#include <math.h>
#include <stdint.h>

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

enum { IDCT_ZERO = 0, IDCT_DC = 1, IDCT_VERT = 2, IDCT_FULL = 3 };

H263_HD H263_INLINE float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

H263_HD H263_INLINE float fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

// trunc(v/4 +- 0.5) clipped to [-256, 255] (v/4 is exact).
H263_HD H263_INLINE int idct_round_clip(float v) {
  float biased = fadd(v / 4.0f, v < 0.0f ? -0.5f : 0.5f);
  return (int)fminf(fmaxf(truncf(biased), -256.0f), 255.0f);
}

// The class from three facts about the block's nonzero pattern: any nonzero
// at all, any outside row 0, any outside column 0.
H263_HD H263_INLINE int idct_class(bool any, bool off_row0, bool off_col0) {
  if (!any) return IDCT_ZERO;
  if (!off_row0 && !off_col0) return IDCT_DC;
  return off_col0 ? IDCT_FULL : IDCT_VERT;
}

// One output of a 1-D pass: the sum over f = 0..7, in order, of
// in[f] * B[f][i] (basis is BASIS_F32, 64 floats, [freq][x]).
H263_HD H263_INLINE float idct_dot(const float* in, const float* basis,
                                   int i) {
  float acc = fmul(in[0], basis[i]);
H263_UNROLL
  for (int f = 1; f < 8; ++f) acc = fadd(acc, fmul(in[f], basis[f * 8 + i]));
  return acc;
}

// One 1-D pass.  Rows first (in = the coefficients of row r, out =
// stage_a[r][.]), then columns (in = stage_a[.][x], out[y] before rounding).
H263_HD H263_INLINE void idct_1d(const float* in, const float* basis,
                                 float* out) {
H263_UNROLL
  for (int i = 0; i < 8; ++i) out[i] = idct_dot(in, basis, i);
}

// DC: exact power-of-two scaling, the same value at all 64 positions.
H263_HD H263_INLINE int idct_dc_value(float dc) {
  return idct_round_clip(fmul(dc, 0.5f));
}

// VERT: the value of row y from the 1-D pass over column 0 (col_pass[y]).
H263_HD H263_INLINE int idct_vert_value(float col_pass_y, const float* basis) {
  return idct_round_clip(fmul(col_pass_y, basis[0]));
}

// One whole block: int16 coefficients [64] row-major -> int residuals [64];
// returns the block's class.
H263_HD H263_INLINE int idct_block(const int16_t* coeffs, const float* basis,
                                   int* res) {
  float c[64];
  bool off_row0 = false, off_col0 = false, any = false;
H263_UNROLL
  for (int p = 0; p < 64; ++p) {
    const int16_t x = coeffs[p];
    c[p] = (float)x;
    const bool nz = x != 0;
    any |= nz;
    if (p >= 8) off_row0 |= nz;
    if ((p & 7) != 0) off_col0 |= nz;
  }
  const int cls = idct_class(any, off_row0, off_col0);
  if (cls == IDCT_ZERO) {
H263_UNROLL
    for (int p = 0; p < 64; ++p) res[p] = 0;
  } else if (cls == IDCT_DC) {
    const int r = idct_dc_value(c[0]);
H263_UNROLL
    for (int p = 0; p < 64; ++p) res[p] = r;
  } else if (cls == IDCT_VERT) {
    float col[8], o[8];
H263_UNROLL
    for (int f = 0; f < 8; ++f) col[f] = c[f * 8];
    idct_1d(col, basis, o);
H263_UNROLL
    for (int y = 0; y < 8; ++y) {
      const int r = idct_vert_value(o[y], basis);
H263_UNROLL
      for (int x = 0; x < 8; ++x) res[y * 8 + x] = r;
    }
  } else {
    float a[64];
H263_UNROLL
    for (int r = 0; r < 8; ++r) idct_1d(c + r * 8, basis, a + r * 8);
H263_UNROLL
    for (int x = 0; x < 8; ++x) {
      float col[8], o[8];
H263_UNROLL
      for (int f = 0; f < 8; ++f) col[f] = a[f * 8 + x];
      idct_1d(col, basis, o);
H263_UNROLL
      for (int y = 0; y < 8; ++y) res[y * 8 + x] = idct_round_clip(o[y]);
    }
  }
  return cls;
}

}  // namespace h263
