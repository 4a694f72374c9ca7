// Sparse-class 8x8 IDCT residual, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel h263_tpu/ops/idct_pallas.py::_kernel
// (launched by _build_call, API idct_residual_pallas).  Contract: int16
// coefficients [n, 64] (row-major 8x8 blocks) -> int32 clipped residuals
// [n, 64].  The arithmetic (classes, strict f32 order, rounding) is
// idct.cuh's idct_block; this kernel only moves the data.
//
// Cost: one thread per block; it reads 128 bytes and writes 256 bytes
// (about 384 bytes per block), against ~1.2k f32 operations, so the kernel
// is bound by memory bandwidth.  Loads and stores are 16-byte vectors.
// The decoder's main path does not write the residual to device memory at
// all: reconstruct.cu fuses this transform with the predictor and the
// add-clamp.  This kernel stays as the counterpart of idct_residual_pallas.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"

constexpr int kThreads = 128;  // threads per block (>= 64: see the basis load)

__global__ void idct_residual_kernel(const int16_t* __restrict__ coeffs,
                                     const float* __restrict__ basis,
                                     int32_t* __restrict__ out, int64_t n) {
  // BASIS_F32[freq][x], read by every thread of the block.
  __shared__ float c_basis[64];
  if (threadIdx.x < 64) c_basis[threadIdx.x] = basis[threadIdx.x];
  __syncthreads();
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;

  __align__(16) int16_t c[64];
  const int4* src = reinterpret_cast<const int4*>(coeffs + b * 64);
#pragma unroll
  for (int v = 0; v < 8; ++v) *reinterpret_cast<int4*>(c + v * 8) = src[v];
  int res[64];
  h263::idct_block(c, c_basis, res);

  int4* dst = reinterpret_cast<int4*>(out + b * 64);
#pragma unroll
  for (int v = 0; v < 16; ++v)
    dst[v] = make_int4(res[v * 4], res[v * 4 + 1], res[v * 4 + 2],
                       res[v * 4 + 3]);
}

// basis: device pointer to BASIS_F32 (64 floats, [freq][x]), uploaded once
// by the wrapper, so the kernel uses the reference's exact f32 values.
extern "C" int h263_idct_residual(const void* coeffs, void* out, int64_t n,
                                  const void* basis, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  int64_t blocks = (n + kThreads - 1) / kThreads;
  idct_residual_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      reinterpret_cast<const int16_t*>(coeffs),
      reinterpret_cast<const float*>(basis),
      reinterpret_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}
