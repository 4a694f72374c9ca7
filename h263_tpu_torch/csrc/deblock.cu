// Batched Annex-J deblocking filter, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel h263_tpu/ops/deblock_pallas.py::
// _make_kernel.kernel (launched by _build_call, API deblock_pallas), which
// kept one whole plane in VMEM and filtered it with rolled copies.  A 720p
// luma plane (900 KB) does not fit a block's shared memory, and needs not:
// on the shifted tile grid of deblock_tile.cuh (boundaries at 32t + 4 down,
// 512t + 4 across) no quartet of either pass crosses a tile, so one launch
// does the whole filter.  A thread block owns one tile of one stream: it
//   1. loads the tile into shared memory with asynchronous copies, 16 bytes
//      each wherever the row's address allows (ragged starts and ends byte by
//      byte), all of a thread's copies in flight together;
//   2. filters the horizontal edges, then, after a __syncthreads(), the
//      vertical edges on that pass's output, both in shared memory;
//   3. stores the tile, each output byte once, as wide as it was loaded.
// Stream s filters only when apply[s] != 0 and strength[s] > 0; otherwise
// its blocks skip step 2 (the branch is uniform over a block).  Tiles and
// arithmetic are deblock_tile.cuh and deblock.cuh, shared with present.cu
// and with the g++ build the CPU tests hold against golden_deblock.
//
// Inputs: planes uint8 [S, H, W] (any H, W), strength int32 [S], apply
// uint8 [S].  Output: uint8 [S, H, W], allocated by the wrapper.
//
// What bounds it: bytes.  The filter reads each input byte and writes each
// output byte once (2 x 152,064 B per CIF frame, luma and both chroma: 311 MB
// at S = 1024, 0.093 ms at 3.35 TB/s), and now moves no more than that.
// The card's own copy of these planes (cudaMemcpy, device to device) takes
// 0.113 ms; what the kernel takes beyond that is the instructions of the
// walk and of ~30 integer operations per filtered sample, which the tile
// walk keeps few (deblock_tile.cuh), and the wait of a block's threads at its
// three barriers, which other resident blocks fill.  Shared memory is
// 19,584 B a block whatever W is, and __launch_bounds__(256, 8) keeps the
// kernel at 32 registers or fewer, so eight blocks (2048 threads, 157 KB)
// are resident per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "deblock_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kRowStep = h263::kLumaRowStep;
constexpr int kColStep = h263::kLumaColStep;
constexpr int kShift = h263::kLumaShift;
constexpr int kPitch = h263::tile_pitch(kColStep, kShift);
constexpr int kRows = kRowStep + kShift;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
deblock_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
               int h, int w, int n_col_tiles,
               const int32_t* __restrict__ strength,
               const uint8_t* __restrict__ apply) {
  __shared__ __align__(16) uint8_t buf[kRows * kPitch];
  const int ty = blockIdx.x / n_col_tiles;
  const int tx = blockIdx.x - ty * n_col_tiles;
  const int s = blockIdx.y;
  const int64_t off = (int64_t)s * h * w;
  const int st = h263::deblock_lane_strength(strength, apply, s);
  const h263::DeblockTile t = h263::deblock_tile(
      buf, kPitch, src + off, h, w, ty, tx, kRowStep, kColStep, kShift);
  h263::deblock_tile_load(t, threadIdx.x, kThreads);
  h263::deblock_tile_load_wait();
  __syncthreads();
  if (st > 0) {
    h263::deblock_tile_h(t, st, threadIdx.x, kThreads);
    __syncthreads();
    h263::deblock_tile_v(t, st, threadIdx.x, kThreads);
    __syncthreads();
  }
  h263::deblock_tile_store(t, dst + off, threadIdx.x, kThreads);
}

}  // namespace

extern "C" int h263_deblock(const void* planes, void* out, int S, int h,
                            int w, const void* strength, const void* apply,
                            void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  const int n_col_tiles = h263::tile_count(w, kColStep, kShift);
  dim3 grid(h263::tile_count(h, kRowStep, kShift) * n_col_tiles, S);
  deblock_kernel<<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const uint8_t*>(planes),
      reinterpret_cast<uint8_t*>(out), h, w, n_col_tiles,
      reinterpret_cast<const int32_t*>(strength),
      reinterpret_cast<const uint8_t*>(apply));
  return (int)cudaGetLastError();
}
