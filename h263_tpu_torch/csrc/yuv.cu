// Batched BT.601 YUV 4:2:0 -> interleaved RGBA, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel h263_tpu/ops/yuv_pallas.py::_kernel
// (launched by _build_call, API yuv420_to_rgba_pallas), which took chroma
// already replicated to luma size and wrote planar R, G, B that XLA then
// stacked into RGBA.  Here one thread owns a 2x2 luma quad: it fetches its
// Cb and Cr sample once, converts the four pixels and writes them straight
// into the interleaved RGBA output, 8-byte stores when W is even (both
// pixels of a quad row are then 8-byte aligned), 4-byte stores otherwise.
// Odd H and W: the last quad row / column holds one luma row / column.
//
// The arithmetic is yuv.cuh (exact 16.16 integers), shared with present.cu.
//
// Inputs: y uint8 [S, H, W], cb/cr uint8 [S, ceil(H/2), ceil(W/2)].
// Output: uint8 [S, H, W, 4], allocated by the wrapper.
//
// What bounds it: bytes.  Per CIF frame it reads 152,064 B and writes
// 405,504 B (571 MB at S = 1024, 0.170 ms at 3.35 TB/s); ~12 integer
// operations per pixel are far below the card's rate.  present.cu fuses it
// with the deblock, so that the deblocked planes never go to device memory;
// this kernel serves a caller that converts planes as they are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "yuv.cuh"

namespace {

using h263::yuv_rgba;
using h263::YuvChroma;

constexpr int kThreads = 256;

__global__ void yuv_rgba_kernel(const uint8_t* __restrict__ y,
                                const uint8_t* __restrict__ cb,
                                const uint8_t* __restrict__ cr,
                                uint32_t* __restrict__ out, int h, int w,
                                int ch, int cw) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (q >= ch * cw) return;
  const int qy = q / cw, qx = q % cw;
  const int64_t coff = (int64_t)s * ch * cw + q;
  const YuvChroma c = h263::yuv_chroma(cb[coff], cr[coff]);
  const int x0 = 2 * qx;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = 2 * qy + dy;
    if (yy >= h) break;
    const int64_t row = ((int64_t)s * h + yy) * w;
    const uint32_t p0 = yuv_rgba(y[row + x0], c);
    if ((w & 1) == 0) {
      const uint32_t p1 = yuv_rgba(y[row + x0 + 1], c);
      *reinterpret_cast<uint2*>(out + row + x0) = make_uint2(p0, p1);
    } else {
      out[row + x0] = p0;
      if (x0 + 1 < w) out[row + x0 + 1] = yuv_rgba(y[row + x0 + 1], c);
    }
  }
}

}  // namespace

extern "C" int h263_yuv_rgba(const void* y, const void* cb, const void* cr,
                             void* out, int S, int h, int w, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  dim3 grid((ch * cw + kThreads - 1) / kThreads, S);
  yuv_rgba_kernel<<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const uint8_t*>(y), reinterpret_cast<const uint8_t*>(cb),
      reinterpret_cast<const uint8_t*>(cr), reinterpret_cast<uint32_t*>(out),
      h, w, ch, cw);
  return (int)cudaGetLastError();
}
