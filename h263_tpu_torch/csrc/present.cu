// Batched presentation, hand-written for Hopper (sm_90a): the per-stream
// Annex-J deblock of the three planes and the BT.601 conversion to
// interleaved RGBA as one kernel.
//
// Replaces, on the presentation path, the composition of the Pallas TPU
// kernels h263_tpu/ops/deblock_pallas.py::_make_kernel.kernel (three calls)
// and h263_tpu/ops/yuv_pallas.py::_kernel that
// h263_tpu/decoder/reconstruct.py::present_rgba_batched runs, which wrote the
// deblocked planes to device memory for the conversion to read back.  Here
// they never reach device memory.  A thread block owns one picture area of
// one stream, a luma tile on the (32t + 4, 512t + 4) grid and the Cb and Cr
// tiles on the (16t + 2, 256t + 2) grid that cover the same area, and no
// deblock quartet of any plane crosses such a tile (deblock_tile.cuh).  It
//   1. loads the three tiles into shared memory with asynchronous copies, 16
//      bytes each wherever a row's address allows, all in flight together;
//   2. if the stream is deblocked (apply[s] != 0 and strength[s] > 0, uniform
//      over the block), filters the horizontal edges of all three, then,
//      after a __syncthreads(), their vertical edges;
//   3. converts: each thread takes four neighbouring pixels of one luma row
//      from shared memory and stores their 16 bytes of RGBA at once, so a
//      warp writes 512 contiguous bytes of one picture row, four full
//      128-byte lines (RGBA byte 64t + 16 of a row is aligned whenever the
//      row pitch 4W is; other widths and the ragged ends of a row go pixel by
//      pixel).
// Odd H and W: chroma is ceil(H/2) x ceil(W/2) and the last luma row and
// column share the last chroma sample.  Arithmetic and tile walk are
// deblock.cuh, deblock_tile.cuh, yuv.cuh and present_tile.cuh, shared with
// deblock.cu, yuv.cu and the g++ build of the CPU tests.
//
// Inputs: y uint8 [S, H, W], cb/cr uint8 [S, ceil(H/2), ceil(W/2)], strength
// int32 [S], apply uint8 [S].  Output: uint8 [S, H, W, 4], allocated by the
// wrapper.
//
// What bounds it: bytes.  Per CIF frame it reads 152,064 B and writes
// 405,504 B (571 MB at S = 1024, 0.170 ms at 3.35 TB/s), 71% of them
// stores.  A kernel that only reads the planes and writes 16 bytes of RGBA a
// thread, with no arithmetic worth the name, takes 0.20 ms on this card, so
// that is what the design aims at; beyond it come the instructions of ~30
// integer operations per filtered sample and ~17 per pixel, which the tile
// walk keeps few (a slot's luma as one word, a chroma pair's terms shared by
// its pixels: present_tile.cuh, yuv.cuh).  Shared memory is 29,952 B a
// block whatever W is, and __launch_bounds__(256, 6) keeps the kernel at 40
// registers or fewer, so six blocks (1536 threads, 180 KB) are resident per
// SM and other blocks' loads and stores overlap a block's filter passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "present_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 6;
constexpr int kPitchY = h263::tile_pitch(h263::kLumaColStep, h263::kLumaShift);
constexpr int kRowsY = h263::kLumaRowStep + h263::kLumaShift;
constexpr int kPitchC =
    h263::tile_pitch(h263::kChromaColStep, h263::kChromaShift);
constexpr int kRowsC = h263::kChromaRowStep + h263::kChromaShift;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
present_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
               const uint8_t* __restrict__ cr, uint8_t* __restrict__ out,
               int h, int w, int n_col_tiles,
               const int32_t* __restrict__ strength,
               const uint8_t* __restrict__ apply) {
  __shared__ __align__(16) uint8_t buf_y[kRowsY * kPitchY];
  __shared__ __align__(16) uint8_t buf_cb[kRowsC * kPitchC];
  __shared__ __align__(16) uint8_t buf_cr[kRowsC * kPitchC];
  const int ty = blockIdx.x / n_col_tiles;
  const int tx = blockIdx.x - ty * n_col_tiles;
  const int s = blockIdx.y;
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const int64_t off = (int64_t)s * h * w, coff = (int64_t)s * ch * cw;
  const int st = h263::deblock_lane_strength(strength, apply, s);
  const int tid = threadIdx.x;
  const h263::DeblockTile t_y = h263::deblock_tile(
      buf_y, kPitchY, y + off, h, w, ty, tx, h263::kLumaRowStep,
      h263::kLumaColStep, h263::kLumaShift);
  const h263::DeblockTile t_cb = h263::deblock_tile(
      buf_cb, kPitchC, cb + coff, ch, cw, ty, tx, h263::kChromaRowStep,
      h263::kChromaColStep, h263::kChromaShift);
  const h263::DeblockTile t_cr = h263::deblock_tile(
      buf_cr, kPitchC, cr + coff, ch, cw, ty, tx, h263::kChromaRowStep,
      h263::kChromaColStep, h263::kChromaShift);
  h263::deblock_tile_load(t_y, tid, kThreads);
  h263::deblock_tile_load(t_cb, tid, kThreads);
  h263::deblock_tile_load(t_cr, tid, kThreads);
  h263::deblock_tile_load_wait();
  __syncthreads();
  if (st > 0) {
    h263::deblock_tile_h(t_y, st, tid, kThreads);
    h263::deblock_tile_h(t_cb, st, tid, kThreads);
    h263::deblock_tile_h(t_cr, st, tid, kThreads);
    __syncthreads();
    h263::deblock_tile_v(t_y, st, tid, kThreads);
    h263::deblock_tile_v(t_cb, st, tid, kThreads);
    h263::deblock_tile_v(t_cr, st, tid, kThreads);
    __syncthreads();
  }
  h263::present_tile_store(t_y, t_cb, t_cr, out + 4 * off, tid, kThreads);
}

}  // namespace

extern "C" int h263_present_rgba(const void* y, const void* cb,
                                 const void* cr, void* out, int S, int h,
                                 int w, const void* strength,
                                 const void* apply, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  const int n_col_tiles =
      h263::tile_count(w, h263::kLumaColStep, h263::kLumaShift);
  dim3 grid(
      h263::tile_count(h, h263::kLumaRowStep, h263::kLumaShift) * n_col_tiles,
      S);
  present_kernel<<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const uint8_t*>(y), reinterpret_cast<const uint8_t*>(cb),
      reinterpret_cast<const uint8_t*>(cr), reinterpret_cast<uint8_t*>(out), h,
      w, n_col_tiles, reinterpret_cast<const int32_t*>(strength),
      reinterpret_cast<const uint8_t*>(apply));
  return (int)cudaGetLastError();
}
