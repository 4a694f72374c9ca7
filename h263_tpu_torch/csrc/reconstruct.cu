// Fused reconstruction, hand-written for Hopper (sm_90a): dense coefficients
// -> IDCT residual -> half-pel prediction from the reference planes ->
// add-clamp -> the three uint8 planes, in one kernel.
//
// Replaces the Pallas TPU kernel h263_tpu/ops/idct_pallas.py::_kernel
// together with the XLA tail the JAX package left around it
// (h263_tpu/decoder/reconstruct.py::reconstruct_from_dense, Pallas branch,
// over reconstruct_from_residuals_single and h263_tpu/ops/mocomp.py).
// Neither the int32 residual nor the int32 prediction reaches device memory.
//
// Inputs per stream: dense int16 [6*nmb, 64], MVs int16 [mbh, mbw, 4, 2],
// INTER flags uint8 [mbh, mbw], reference planes uint8 [h, w] and two
// [ch, cw].  Outputs: three fresh planes of the same shapes (never in place:
// a neighbouring block's predictor reads the reference).
//
// What bounds it: bytes.  Per CIF frame 304 KB of coefficients, 152 KB of
// reference read and 152 KB of planes written, against ~2k f32 operations
// for each FULL block and none for most blocks of a P-frame.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), 1024 CIF frames of a
// P-step: 0.50 ms against 0.19 ms for the bytes; 0.35 ms with every MV zero
// and 0.28 ms with zero coefficients too.  What the MVs cost is the gather:
// the 32 blocks of a warp read 32 places of the reference, a cache line or
// two each, where a still picture reads two lines in all.
//
// Design.  A thread block owns a chunk of kBlocks = 32 consecutive 8x8
// blocks of the dense tensor (4 KB of coefficients, contiguous whatever the
// picture size) and runs two phases with 8 threads per 8x8 block:
//   A. thread (block b, row r) loads row r of b's coefficients as one
//      16-byte vector: the whole warp reads 512 contiguous bytes.  (With it
//      go the loads phase B needs that hang on no other load, the block's
//      MVs and INTER flag: a thread block lives for a few latencies of
//      device memory, so what can be in flight together is.)  A warp
//      ballot gives each block's class.  Only FULL blocks transform: the row
//      pass goes through shared memory to the same 8 threads' column pass
//      (idct.cuh's idct_1d, the reference's order of summation), VERT blocks
//      pass column 0 only, DC and ZERO blocks none.  The int16 residual of
//      the 32 blocks stays in shared memory (4.5 KB).
//   B. the threads regroup as (row y, block b) with b fastest, so that
//      neighbouring threads own neighbouring 8-sample segments of one
//      picture row: each predicts its 8 samples from the reference through
//      the read-only path (reconstruct.cuh), adds its residual row and
//      stores 8 bytes; a warp's stores are contiguous along the row.  A row
//      that lies inside the picture comes as one or two aligned 8-byte
//      words and is averaged bytewise in 64-bit registers; at the edges
//      every coordinate is clamped on its own, sample by sample.  A ZERO
//      block's row (most of a P-frame) is stored as predicted: a copy.  Odd
//      widths store byte by byte, cropped.
// The grid is (chunk, stream), so no thread divides by the blocks of a
// stream; six thread blocks are resident on an SM (40 registers).
// Errored lanes need no case of their own: the automaton hands them zero
// coefficients, INTER everywhere and zero MVs, the identity frame.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"
#include "reconstruct.cuh"

namespace {

constexpr int kBlocks = 32;             // 8x8 blocks per thread block
constexpr int kThreads = kBlocks * 8;
constexpr int kBlocksPerSm = 6;         // resident thread blocks (<= 42 registers)
constexpr int kRowStride = 9;           // floats per row of the row pass and
constexpr int kStageStride = 72;        // per block of it: a warp's 32 stores,
                                        // and its 32 loads, hit 32 banks
constexpr int kResStride = 72;          // int16 per block of residuals (144 B)

struct Planes {
  const uint8_t* ref[3];
  uint8_t* out[3];
  bool wide_load;      // the references start on 8-byte boundaries
  bool wide_store[2];  // luma, chroma: an 8-sample row is one aligned store
};

// What a thread loads for one chunk of kBlocks blocks before it can work on
// it: none of these addresses hangs on another load.
struct ChunkLoads {
  int4 coeffs;         // phase A: row r of block ba
  int4 mvs;            // phase B: the four MVs of block bb's macroblock
  h263::BlockPlace p;  //          its place in the picture
  bool inter, live;    //          its INTER flag; the block exists
};

// Chunk `chunk` of stream `stream`: blocks chunk * kBlocks .. of its
// 6 * nmb (the last chunk of a stream may be short).
__device__ __forceinline__ ChunkLoads start_loads(
    int chunk, int stream, int t, const int16_t* __restrict__ dense,
    const int16_t* __restrict__ mvs, const uint8_t* __restrict__ inter,
    const h263::FrameGeometry& g) {
  const int nmb = g.mbh * g.mbw;
  const int ka = chunk * kBlocks + (t >> 3);
  const int kb = chunk * kBlocks + (t & (kBlocks - 1));
  ChunkLoads l;
  l.coeffs = make_int4(0, 0, 0, 0);
  if (ka < 6 * nmb)
    l.coeffs = __ldg(reinterpret_cast<const int4*>(dense) +
                     ((int64_t)stream * 6 * nmb + ka) * 8 + (t & 7));
  l.live = kb < 6 * nmb;
  l.p = h263::locate_block(l.live ? kb : 0, g);
  const int64_t mb = (int64_t)stream * nmb + l.p.mb;
  l.mvs = __ldg(reinterpret_cast<const int4*>(mvs) + mb);
  l.inter = __ldg(inter + mb) != 0;
  return l;
}

// The half-pel MV of the block at `p` from its macroblock's four MVs, two
// int16 to a word (x low, y high): selects, so that they stay in registers.
__device__ __forceinline__ void select_mv(const int4& m,
                                          const h263::BlockPlace& p, int* mvx,
                                          int* mvy) {
  if (p.plane == 0) {
    const int word = p.sub == 0 ? m.x : (p.sub == 1 ? m.y
                                                    : (p.sub == 2 ? m.z : m.w));
    *mvx = (int16_t)(word & 0xFFFF);
    *mvy = word >> 16;
  } else {
    const int16_t v[8] = {
        (int16_t)(m.x & 0xFFFF), (int16_t)(m.x >> 16), (int16_t)(m.y & 0xFFFF),
        (int16_t)(m.y >> 16),    (int16_t)(m.z & 0xFFFF), (int16_t)(m.z >> 16),
        (int16_t)(m.w & 0xFFFF), (int16_t)(m.w >> 16)};
    h263::block_mv(v, p, mvx, mvy);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
reconstruct_kernel(const int16_t* __restrict__ dense,
                   const int16_t* __restrict__ mvs,
                   const uint8_t* __restrict__ inter, Planes planes,
                   const float* __restrict__ basis, h263::FrameGeometry g) {
  __shared__ float s_basis[64];
  __shared__ float s_stage[kBlocks * kStageStride];
  __shared__ __align__(16) int16_t s_res[kBlocks * kResStride];
  __shared__ bool s_zero[kBlocks];  // the block's class is ZERO

  const int t = threadIdx.x;
  const int ba = t >> 3, r = t & 7;                    // phase A: (block, row)
  const int bb = t & (kBlocks - 1), y = t / kBlocks;   // phase B: (row, block)
  const int stream = blockIdx.y;
  const ChunkLoads cur =
      start_loads(blockIdx.x, stream, t, dense, mvs, inter, g);
  if (t < 64) s_basis[t] = __ldg(basis + t);

  // Phase A: thread (block ba, row r).
  {
    __align__(16) int16_t c[8];
    *reinterpret_cast<int4*>(c) = cur.coeffs;
    // Nonzeros of the row, and of it without column 0 (the low half of the
    // first word).
    const int rest = cur.coeffs.y | cur.coeffs.z | cur.coeffs.w;
    const bool row_any = (cur.coeffs.x | rest) != 0;
    const bool row_off_col0 = ((cur.coeffs.x & 0xFFFF0000) | rest) != 0;
    const int shift = (t & 31) & ~7;
    const unsigned rows_any = (__ballot_sync(0xffffffffu, row_any) >> shift) &
                              0xFFu;
    const unsigned rows_off = (__ballot_sync(0xffffffffu, row_off_col0) >>
                               shift) & 0xFFu;
    const int cls = h263::idct_class(rows_any != 0, (rows_any & 0xFEu) != 0,
                                     rows_off != 0);
    // The DC coefficient, from the thread that holds row 0.
    const float dc = __shfl_sync(0xffffffffu, (float)c[0], shift);
    if (r == 0) s_zero[ba] = cls == h263::IDCT_ZERO;
    __syncthreads();  // the basis is in shared memory

    float* stage = s_stage + ba * kStageStride;
    if (cls == h263::IDCT_FULL) {
      float in[8], a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) in[i] = (float)c[i];
      h263::idct_1d(in, s_basis, a);
#pragma unroll
      for (int i = 0; i < 8; ++i) stage[r * kRowStride + i] = a[i];
    } else if (cls == h263::IDCT_VERT) {
      stage[r * kRowStride] = (float)c[0];
    }
    __syncwarp();

    // Column pass: this thread now owns column x = r of a FULL block, or
    // row y = r of a VERT or DC block.
    int16_t* res = s_res + ba * kResStride;
    if (cls == h263::IDCT_FULL) {
      float col[8], o[8];
#pragma unroll
      for (int f = 0; f < 8; ++f) col[f] = stage[f * kRowStride + r];
      h263::idct_1d(col, s_basis, o);
#pragma unroll
      for (int yy = 0; yy < 8; ++yy)
        res[yy * 8 + r] = (int16_t)h263::idct_round_clip(o[yy]);
    } else if (cls != h263::IDCT_ZERO) {
      int v;
      if (cls == h263::IDCT_VERT) {
        float col[8];
#pragma unroll
        for (int f = 0; f < 8; ++f) col[f] = stage[f * kRowStride];
        v = h263::idct_vert_value(h263::idct_dot(col, s_basis, r), s_basis);
      } else {
        v = h263::idct_dc_value(dc);
      }
      const int pair = (int)((uint32_t)(v & 0xFFFF) * 0x10001u);
      *reinterpret_cast<int4*>(res + r * 8) = make_int4(pair, pair, pair, pair);
    }
  }
  __syncthreads();

  // Phase B: thread (row y, block bb), bb fastest.
  if (!cur.live) return;
  const h263::BlockPlace p = cur.p;
  int mvx, mvy;
  select_mv(cur.mvs, p, &mvx, &mvy);
  const int ph = p.plane == 0 ? g.h : (g.h + 1) / 2;
  const int pw = p.plane == 0 ? g.w : (g.w + 1) / 2;
  const int64_t plane_off = (int64_t)stream * ph * pw;
  const bool res_zero = s_zero[bb];
  __align__(16) int16_t res[8];
  if (!res_zero)
    *reinterpret_cast<int4*>(res) =
        *reinterpret_cast<const int4*>(s_res + bb * kResStride + y * 8);
  // Selects, not an index: a kernel parameter indexed at run time would be
  // copied to local memory.
  const int pl = p.plane;
  const uint8_t* ref = pl == 0 ? planes.ref[0]
                               : (pl == 1 ? planes.ref[1] : planes.ref[2]);
  uint8_t* out = pl == 0 ? planes.out[0]
                         : (pl == 1 ? planes.out[1] : planes.out[2]);
  const bool wide_store = pl == 0 ? planes.wide_store[0] : planes.wide_store[1];
  h263::reconstruct_block_row(ref + plane_off, out + plane_off, ph, pw, p.bx,
                              p.by, y, mvx, mvy, cur.inter, res, res_zero,
                              planes.wide_load, wide_store);
}

}  // namespace

// dense int16 [S, 6*nmb, 64]; mvs int16 [S, mbh, mbw, 4, 2]; inter uint8
// [S, mbh, mbw]; ref_* and out_* uint8 [S, h, w] and [S, ch, cw] twice;
// basis: device pointer to BASIS_F32 (64 floats).
extern "C" int h263_reconstruct(const void* dense, const void* mvs,
                                const void* inter, const void* ref_y,
                                const void* ref_cb, const void* ref_cr,
                                void* out_y, void* out_cb, void* out_cr, int S,
                                int mbh, int mbw, int h, int w,
                                const void* basis, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 0 || mbh <= 0 || mbw <= 0 || h <= 0 || w <= 0)
    return (int)cudaGetLastError();
  Planes planes;
  planes.ref[0] = reinterpret_cast<const uint8_t*>(ref_y);
  planes.ref[1] = reinterpret_cast<const uint8_t*>(ref_cb);
  planes.ref[2] = reinterpret_cast<const uint8_t*>(ref_cr);
  planes.out[0] = reinterpret_cast<uint8_t*>(out_y);
  planes.out[1] = reinterpret_cast<uint8_t*>(out_cb);
  planes.out[2] = reinterpret_cast<uint8_t*>(out_cr);
  auto aligned8 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 8 == 0;
  };
  planes.wide_load = aligned8(ref_y) && aligned8(ref_cb) && aligned8(ref_cr);
  planes.wide_store[0] = w % 8 == 0 && aligned8(out_y);
  planes.wide_store[1] = ((w + 1) / 2) % 8 == 0 && aligned8(out_cb) &&
                         aligned8(out_cr);
  // Thread block (chunk, stream): no thread divides by the blocks of a
  // stream to find its own.
  if (S > 65535 || (int64_t)6 * mbh * mbw > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((6 * mbh * mbw + kBlocks - 1) / kBlocks, S);
  h263::FrameGeometry g{mbh, mbw, h, w};
  reconstruct_kernel<<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const int16_t*>(dense),
      reinterpret_cast<const int16_t*>(mvs),
      reinterpret_cast<const uint8_t*>(inter), planes,
      reinterpret_cast<const float*>(basis), g);
  return (int)cudaGetLastError();
}
