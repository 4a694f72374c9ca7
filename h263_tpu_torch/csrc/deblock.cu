// Batched Annex-J deblocking filter, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel h263_tpu/ops/deblock_pallas.py::
// _make_kernel.kernel (launched by _build_call, API deblock_pallas), which
// kept one whole plane in VMEM and filtered it with rolled copies.  Here a
// 720p luma plane (900 KB) does not fit a block's shared memory, so the
// filter runs as two launches over device memory instead:
//   1. horizontal edges, out of place: one thread per (lane, band of 8 rows,
//      column); it filters its column's quartet of the band's edge and
//      copies the band's other rows, so every output byte is written once;
//   2. vertical edges, in place on the output: one thread per (lane, row,
//      8-column chunk), reading what pass 1 wrote.
// Lane s filters only when apply[s] != 0 and strength[s] > 0; otherwise
// pass 1 copies it and pass 2 leaves it.  The arithmetic is deblock.cuh,
// shared with the g++ build the CPU tests hold against golden_deblock.
//
// Inputs: planes uint8 [S, H, W] (any H, W), strength int32 [S], apply
// uint8 [S].  Output: uint8 [S, H, W], allocated by the wrapper.
//
// What bounds it: bytes.  The filter reads each input byte and writes each
// output byte once (2 x 152,064 B per CIF frame, luma and both chroma: 311 MB
// at S = 1024, 0.093 ms at 3.35 TB/s); its ~20 integer operations per
// filtered sample are far below the card's integer rate.  Pass 1's loads
// and stores are coalesced across the threads of a row; pass 2 touches the
// ~4/8 of the plane's columns it filters a second time (through the L2,
// which holds the whole batch of one plane only at small S).  A fused
// one-pass version with a halo in shared memory, and fusion with the
// BT.601 conversion (yuv.cu), are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "deblock.cuh"

namespace {

constexpr int kThreadsH = 128;
constexpr int kThreadsV = 64;

__global__ void deblock_h_kernel(const uint8_t* __restrict__ src,
                                 uint8_t* __restrict__ dst, int h, int w,
                                 const int32_t* __restrict__ strength,
                                 const uint8_t* __restrict__ apply) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int band = blockIdx.y;
  const int s = blockIdx.z;
  if (x >= w) return;
  const int64_t off = (int64_t)s * h * w;
  const int st = h263::deblock_lane_strength(strength, apply, s);
  h263::deblock_h_band_column(src + off, dst + off, h, w, band, x, st);
}

__global__ void deblock_v_kernel(uint8_t* __restrict__ p, int h, int w,
                                 int n_chunks,
                                 const int32_t* __restrict__ strength,
                                 const uint8_t* __restrict__ apply) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int s = blockIdx.z;
  if (k >= n_chunks) return;
  const int st = h263::deblock_lane_strength(strength, apply, s);
  if (st <= 0) return;
  h263::deblock_v_row_chunk(p + (int64_t)s * h * w, h, w, y, k, st);
}

}  // namespace

extern "C" int h263_deblock(const void* planes, void* out, int S, int h,
                            int w, const void* strength, const void* apply,
                            void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  const auto* src = reinterpret_cast<const uint8_t*>(planes);
  auto* dst = reinterpret_cast<uint8_t*>(out);
  const auto* str = reinterpret_cast<const int32_t*>(strength);
  const auto* app = reinterpret_cast<const uint8_t*>(apply);

  dim3 grid_h((w + kThreadsH - 1) / kThreadsH, h263::deblock_n_bands(h), S);
  deblock_h_kernel<<<grid_h, kThreadsH, 0, st>>>(src, dst, h, w, str, app);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_chunks = h263::deblock_n_chunks(w);
  if (n_chunks > 0) {
    dim3 grid_v((n_chunks + kThreadsV - 1) / kThreadsV, h, S);
    deblock_v_kernel<<<grid_v, kThreadsV, 0, st>>>(dst, h, w, n_chunks, str,
                                                    app);
  }
  return (int)cudaGetLastError();
}
