// The device half of the host front-end's fused transport, hand-written for
// Hopper (sm_90a): each stream's staging row [int8 MVs | INTER bitmask |
// delta24 coefficient entries] unpacked into the inputs of the fused
// reconstruct kernel (reconstruct.cu): dense int16 coefficients, full int16
// MVs and byte INTER flags.
//
// No TPU kernel: the JAX package did this step in XLA ops,
// h263_tpu/decoder/reconstruct.py::reconstruct_frame_packed_d24_fused (the
// bitcast of the MVs, the bit unpack of the flags) with d24_to_posval (the
// cumulative sum of the deltas, the scatter positions) and the scatter-add
// into a zeroed dense tensor, then the broadcast of the slim MVs
// (reconstruct_from_dense).  Its plain PyTorch version is ops/d24.py.
//
// Row layout (entropy.cpp h263_sorenson_decode_batch_fused), nmb = mbh*mbw:
//   [0, nmb*mv_stride)            int8 MVs, 2 B/MB (the first block's MV,
//                                 all four blocks share it) or 8 B/MB
//   [.., + ceil(nmb/8))           INTER flags, 1 bit/MB, MSB-first
//   [.., + 3*n_entries)           24-bit big-endian entries (delta << 12) |
//                                 (value & 0xFFF)
// With mv_stride 0 the row holds the entries alone and the kernel writes
// the dense coefficients only (the MV-flip step, whose MVs and flags ship
// as int16 and bytes already).
//
// Semantics of one row, those of d24_to_posval + .at[pos].add(mode="drop")
// (the per-entry arithmetic is d24.cuh, which the CPU tests build too): the
// value is sign-extended from 12 bits; the ordinal cursor of entry k is
// (sum of deltas 0..k) - 1; macroblock mb = cursor / 384, block
// b = (cursor % 384) >> 6, zigzag index cursor & 63 -> row-major through
// the 64-entry table; luma blocks lie on the row-major 2mbh x 2mbw grid,
// then the Cb blocks, then the Cr blocks.  An entry with cursor < 0 or a
// position at or past 6*nmb*64 is dropped; entries that meet at one
// position add modulo 2^16 (the native emitter never makes two real
// coefficients meet, but the function is defined on any row); a zero value
// changes nothing.
//
// Design: one thread block per stream.
//   1. The block zeroes its stream's dense row (6*nmb*128 bytes, a multiple
//      of 16) with 16-byte stores, and in fused mode writes the stream's
//      MVs (broadcast to four blocks from slim rows) and flags;
//   2. __syncthreads(), so that no scatter lands before the fill;
//   3. walks the entries 256 at a time: each thread reads one entry, the
//      block takes an inclusive prefix sum of the deltas (warp shuffles,
//      then one pass over the eight warps' totals in shared memory), adds
//      the total of the tiles before, and adds its value at its position
//      with a 32-bit atomicCAS on the aligned word that holds it.
//
// What bounds it: bytes.  At S = 1024 CIF P-frames (cut 1584 entries) it
// reads 5.7 MB of rows and writes 311 MB of coefficients, 6.5 MB of MVs and
// 0.4 MB of flags: 0.097 ms at 3.35 TB/s (chip_smoke.py phase 11).  The
// fill is 96% of that; the scan and the scatter touch a few hundred
// entries a stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d24.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Adds v to the int16 at p, modulo 2^16, atomically.
__device__ __forceinline__ void atomic_add_i16(int16_t* p, int v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~uintptr_t(3));
  const unsigned int shift = (unsigned int)(a & 2) * 8u;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    old = atomicCAS(word, assumed, h263::d24_add_half(assumed, shift, v));
  } while (old != assumed);
}

__global__ void __launch_bounds__(kThreads)
d24_unpack_kernel(const uint8_t* __restrict__ rows, int64_t pitch,
                  int n_entries, int mv_stride, int mbh, int mbw,
                  const uint8_t* __restrict__ zigzag,
                  int16_t* __restrict__ dense, int16_t* __restrict__ mvs,
                  uint8_t* __restrict__ inter) {
  __shared__ uint8_t rowmajor[64];
  __shared__ int warp_incl[kWarps];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nmb = mbh * mbw;
  const int limit = 6 * nmb * 64;
  const uint8_t* row = rows + (int64_t)s * pitch;
  int16_t* out = dense + (int64_t)s * limit;
  if (tid < 64) rowmajor[tid] = zigzag[tid];

  int4* out16 = reinterpret_cast<int4*>(out);
  for (int i = tid; i < limit / 8; i += kThreads) {
    out16[i] = make_int4(0, 0, 0, 0);
  }

  const uint8_t* entries = row;
  if (mv_stride) {
    int16_t* m = mvs + (int64_t)s * nmb * 8;
    for (int j = tid; j < nmb * 8; j += kThreads) {
      m[j] = h263::d24_mv(row, mv_stride, j);
    }
    const uint8_t* bits = row + nmb * mv_stride;
    uint8_t* f = inter + (int64_t)s * nmb;
    for (int j = tid; j < nmb; j += kThreads) {
      f[j] = h263::d24_flag(bits, j);
    }
    entries = bits + (nmb + 7) / 8;
  }
  __syncthreads();

  int before = 0;  // the sum of the deltas of the tiles already walked
  for (int base = 0; base < n_entries; base += kThreads) {
    const int k = base + tid;
    int delta = 0, val = 0;
    if (k < n_entries) {
      h263::d24_entry(entries + 3 * (int64_t)k, &delta, &val);
    }
    int incl = delta;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int t = lane < kWarps ? warp_incl[lane] : 0;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += y;
      }
      if (lane < kWarps) warp_incl[lane] = t;
    }
    __syncthreads();
    const int cursor = before + incl + (warp ? warp_incl[warp - 1] : 0) - 1;
    before += warp_incl[kWarps - 1];
    if (k < n_entries && val != 0) {
      const int pos = h263::d24_position(cursor, mbh, mbw, rowmajor);
      if (pos >= 0) atomic_add_i16(out + pos, val);
    }
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
}

}  // namespace

extern "C" int h263_d24_unpack(const void* rows, int64_t pitch, int n_entries,
                               int mv_stride, int S, int mbh, int mbw,
                               const void* zigzag, void* dense, void* mvs,
                               void* inter, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 0 || mbh <= 0 || mbw <= 0) return (int)cudaGetLastError();
  d24_unpack_kernel<<<S, kThreads, 0, st>>>(
      reinterpret_cast<const uint8_t*>(rows), pitch, n_entries, mv_stride,
      mbh, mbw, reinterpret_cast<const uint8_t*>(zigzag),
      reinterpret_cast<int16_t*>(dense), reinterpret_cast<int16_t*>(mvs),
      reinterpret_cast<uint8_t*>(inter));
  return (int)cudaGetLastError();
}
