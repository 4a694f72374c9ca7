// Launch shapes of the one-pass deblock and of the fused present kernel, and
// what the card takes for the bare data movement, at S = 1024 CIF frames.
// A program of its own (built and run by present_sweep.py), not part of the
// kernel library: it instantiates the tile walk of csrc/present_tile.cuh at
// several tile heights, block sizes and resident blocks per SM, where
// csrc/deblock.cu and csrc/present.cu fix one shape.
//
// Yardsticks: the card's own device-to-device copy of the three planes; a
// kernel that only writes the RGBA, 16 bytes a thread; a kernel that reads
// the planes and writes the RGBA with next to no arithmetic; the same with
// the BT.601 arithmetic, no deblock and no shared memory.
// Every shape's output must have the first shape's checksum.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include <vector>

#include "../csrc/present_tile.cuh"

using namespace h263;

constexpr int kPitchY = tile_pitch(kLumaColStep, kLumaShift);
constexpr int kPitchC = tile_pitch(kChromaColStep, kChromaShift);

#define CK(x)                                                        \
  do {                                                               \
    cudaError_t e_ = (x);                                            \
    if (e_ != cudaSuccess) {                                         \
      printf("CUDA error %s at line %d\n", cudaGetErrorString(e_),   \
             __LINE__);                                              \
      exit(1);                                                       \
    }                                                                \
  } while (0)

template <int kRows, int kThreads, int kBlocksPerSm>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
deblock_shape(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
              int h, int w, int n_col_tiles,
              const int32_t* __restrict__ strength,
              const uint8_t* __restrict__ apply) {
  __shared__ __align__(16) uint8_t buf[(kRows + kLumaShift) * kPitchY];
  const int ty = blockIdx.x / n_col_tiles, tx = blockIdx.x - ty * n_col_tiles;
  const int s = blockIdx.y;
  const int64_t off = (int64_t)s * h * w;
  const int st = deblock_lane_strength(strength, apply, s);
  const DeblockTile t = deblock_tile(buf, kPitchY, src + off, h, w, ty, tx,
                                     kRows, kLumaColStep, kLumaShift);
  deblock_tile_load(t, threadIdx.x, kThreads);
  deblock_tile_load_wait();
  __syncthreads();
  if (st > 0) {
    deblock_tile_h(t, st, threadIdx.x, kThreads);
    __syncthreads();
    deblock_tile_v(t, st, threadIdx.x, kThreads);
    __syncthreads();
  }
  deblock_tile_store(t, dst + off, threadIdx.x, kThreads);
}

template <int kRows, int kThreads, int kBlocksPerSm>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
present_shape(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
              const uint8_t* __restrict__ cr, uint8_t* __restrict__ out,
              int h, int w, int n_col_tiles,
              const int32_t* __restrict__ strength,
              const uint8_t* __restrict__ apply) {
  __shared__ __align__(16) uint8_t buf_y[(kRows + kLumaShift) * kPitchY];
  __shared__ __align__(16)
      uint8_t buf_cb[(kRows / 2 + kChromaShift) * kPitchC];
  __shared__ __align__(16)
      uint8_t buf_cr[(kRows / 2 + kChromaShift) * kPitchC];
  const int ty = blockIdx.x / n_col_tiles, tx = blockIdx.x - ty * n_col_tiles;
  const int s = blockIdx.y, tid = threadIdx.x;
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const int64_t off = (int64_t)s * h * w, coff = (int64_t)s * ch * cw;
  const int st = deblock_lane_strength(strength, apply, s);
  const DeblockTile t_y = deblock_tile(buf_y, kPitchY, y + off, h, w, ty, tx,
                                       kRows, kLumaColStep, kLumaShift);
  const DeblockTile t_cb =
      deblock_tile(buf_cb, kPitchC, cb + coff, ch, cw, ty, tx, kRows / 2,
                   kChromaColStep, kChromaShift);
  const DeblockTile t_cr =
      deblock_tile(buf_cr, kPitchC, cr + coff, ch, cw, ty, tx, kRows / 2,
                   kChromaColStep, kChromaShift);
  deblock_tile_load(t_y, tid, kThreads);
  deblock_tile_load(t_cb, tid, kThreads);
  deblock_tile_load(t_cr, tid, kThreads);
  deblock_tile_load_wait();
  __syncthreads();
  if (st > 0) {
    deblock_tile_h(t_y, st, tid, kThreads);
    deblock_tile_h(t_cb, st, tid, kThreads);
    deblock_tile_h(t_cr, st, tid, kThreads);
    __syncthreads();
    deblock_tile_v(t_y, st, tid, kThreads);
    deblock_tile_v(t_cb, st, tid, kThreads);
    deblock_tile_v(t_cr, st, tid, kThreads);
    __syncthreads();
  }
  present_tile_store(t_y, t_cb, t_cr, out + 4 * off, tid, kThreads);
}

__global__ void write_only(uint4* out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t v = (uint32_t)i * 2654435761u;
  out[i] = make_uint4(v, v ^ 0x55u, v + 7, v >> 3);
}

// Four pixels a thread straight from device memory (w a multiple of 4, h
// even); kConvert chooses the BT.601 arithmetic or next to none.
template <bool kConvert>
__global__ void planes_to_rgba(const uint32_t* y, const uint16_t* cb,
                               const uint16_t* cr, uint4* out, int h, int w,
                               size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int wq = w / 4;
  const size_t row = i / wq;
  const int q = (int)(i - row * wq);
  const size_t s = row / h;
  const int yy = (int)(row - s * h);
  const size_t ci = (s * (h / 2) + yy / 2) * wq + q;
  const uint32_t yw = y[i], cbw = cb[ci], crw = cr[ci];
  if (kConvert) {
    const YuvChroma c0 = yuv_chroma(cbw & 255, crw & 255);
    const YuvChroma c1 = yuv_chroma(cbw >> 8, crw >> 8);
    out[i] = make_uint4(yuv_rgba(yw & 255, c0), yuv_rgba((yw >> 8) & 255, c0),
                        yuv_rgba((yw >> 16) & 255, c1), yuv_rgba(yw >> 24, c1));
  } else {
    const uint32_t c = cbw | (crw << 16);
    out[i] = make_uint4(yw ^ c, yw + c, yw | c, yw & c);
  }
}

__global__ void checksum(const uint32_t* p, size_t n,
                         unsigned long long* sum) {
  unsigned long long acc = 0;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    acc += (unsigned long long)p[i] * (unsigned long long)(i % 8191 + 1);
  atomicAdd(sum, acc);
}

struct Frames {
  uint8_t *y, *cb, *cr, *out_y, *out_cb, *out_cr, *rgba, *apply, *apply_none;
  int32_t* strength;
  unsigned long long* sum;
  int S, h, w;
};

unsigned long long checksum_of(const Frames& f, const void* p, size_t bytes) {
  CK(cudaMemset(f.sum, 0, 8));
  checksum<<<1024, 256>>>((const uint32_t*)p, bytes / 4, f.sum);
  unsigned long long v;
  CK(cudaMemcpy(&v, f.sum, 8, cudaMemcpyDeviceToHost));
  return v;
}

template <class F>
float time_ms(F launch, int reps = 20) {
  launch();
  CK(cudaDeviceSynchronize());
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  CK(cudaEventRecord(a));
  for (int i = 0; i < reps; ++i) launch();
  CK(cudaEventRecord(b));
  CK(cudaEventSynchronize(b));
  CK(cudaGetLastError());
  float ms;
  CK(cudaEventElapsedTime(&ms, a, b));
  return ms / reps;
}

unsigned long long want_planes = 0, want_rgba = 0;

template <int kRows, int kThreads, int kBlocksPerSm>
void shape(const Frames& f) {
  const int ch = (f.h + 1) / 2, cw = (f.w + 1) / 2;
  auto deblock3 = [&](const uint8_t* apply) {
    int nct = tile_count(f.w, kLumaColStep, kLumaShift);
    dim3 g(tile_count(f.h, kRows, kLumaShift) * nct, f.S);
    deblock_shape<kRows, kThreads, kBlocksPerSm><<<g, kThreads>>>(
        f.y, f.out_y, f.h, f.w, nct, f.strength, apply);
    nct = tile_count(cw, kLumaColStep, kLumaShift);
    dim3 gc(tile_count(ch, kRows, kLumaShift) * nct, f.S);
    deblock_shape<kRows, kThreads, kBlocksPerSm><<<gc, kThreads>>>(
        f.cb, f.out_cb, ch, cw, nct, f.strength, apply);
    deblock_shape<kRows, kThreads, kBlocksPerSm><<<gc, kThreads>>>(
        f.cr, f.out_cr, ch, cw, nct, f.strength, apply);
  };
  auto present = [&](const uint8_t* apply) {
    const int nct = tile_count(f.w, kLumaColStep, kLumaShift);
    dim3 g(tile_count(f.h, kRows, kLumaShift) * nct, f.S);
    present_shape<kRows, kThreads, kBlocksPerSm><<<g, kThreads>>>(
        f.y, f.cb, f.cr, f.rgba, f.h, f.w, nct, f.strength, apply);
  };
  const float d0 = time_ms([&] { deblock3(f.apply_none); });
  const float d1 = time_ms([&] { deblock3(f.apply); });
  const float p0 = time_ms([&] { present(f.apply_none); });
  const float p1 = time_ms([&] { present(f.apply); });
  const size_t ny = (size_t)f.S * f.h * f.w;
  const unsigned long long planes =
      checksum_of(f, f.out_y, ny) ^ checksum_of(f, f.out_cb, ny / 4) * 3 ^
      checksum_of(f, f.out_cr, ny / 4) * 5;
  const unsigned long long rgba = checksum_of(f, f.rgba, ny * 4);
  if (want_planes == 0) {
    want_planes = planes;
    want_rgba = rgba;
  }
  const bool same = planes == want_planes && rgba == want_rgba;
  printf("tile rows %2d, %3d threads, %2d blocks/SM: deblock of the three "
         "planes %.3f ms (%.3f ms with no stream filtered), present %.3f ms "
         "(%.3f ms), equal to the first shape: %s\n",
         kRows, kThreads, kBlocksPerSm, d1, d0, p1, p0, same ? "yes" : "NO");
  if (!same) exit(1);
}

int main() {
  Frames f;
  f.S = 1024;
  f.h = 288;
  f.w = 352;
  const int ch = f.h / 2, cw = f.w / 2;
  const size_t ny = (size_t)f.S * f.h * f.w, nc = (size_t)f.S * ch * cw;
  // Blocky planes with a little noise, from a fixed seed.
  std::vector<uint8_t> hy(ny), hc(nc);
  srand(7);
  for (size_t i = 0; i < ny; ++i) {
    const size_t x = i % f.w, yy = (i / f.w) % f.h, s = i / (f.w * f.h);
    hy[i] = (uint8_t)(((x / 8) * 37 + (yy / 8) * 91 + s * 13) % 251 +
                      rand() % 5);
  }
  for (size_t i = 0; i < nc; ++i) {
    const size_t x = i % cw, yy = (i / cw) % ch;
    hc[i] = (uint8_t)(((x / 8) * 53 + (yy / 8) * 29) % 251 + rand() % 5);
  }
  std::vector<int32_t> strength(f.S);
  std::vector<uint8_t> apply(f.S), none(f.S, 0);
  for (int i = 0; i < f.S; ++i) {
    strength[i] = i % 13;
    apply[i] = i % 4 != 3;
  }
  CK(cudaMalloc(&f.y, ny));
  CK(cudaMalloc(&f.cb, nc));
  CK(cudaMalloc(&f.cr, nc));
  CK(cudaMalloc(&f.out_y, ny));
  CK(cudaMalloc(&f.out_cb, nc));
  CK(cudaMalloc(&f.out_cr, nc));
  CK(cudaMalloc(&f.rgba, ny * 4));
  CK(cudaMalloc(&f.strength, 4 * f.S));
  CK(cudaMalloc(&f.apply, f.S));
  CK(cudaMalloc(&f.apply_none, f.S));
  CK(cudaMalloc(&f.sum, 8));
  CK(cudaMemcpy(f.y, hy.data(), ny, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(f.cb, hc.data(), nc, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(f.cr, hc.data(), nc, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(f.strength, strength.data(), 4 * f.S, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(f.apply, apply.data(), f.S, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(f.apply_none, none.data(), f.S, cudaMemcpyHostToDevice));

  printf("S = %d frames of %d x %d\n", f.S, f.w, f.h);
  float ms = time_ms([&] {
    cudaMemcpyAsync(f.out_y, f.y, ny, cudaMemcpyDeviceToDevice);
    cudaMemcpyAsync(f.out_cb, f.cb, nc, cudaMemcpyDeviceToDevice);
    cudaMemcpyAsync(f.out_cr, f.cr, nc, cudaMemcpyDeviceToDevice);
  });
  printf("cudaMemcpy, device to device, of the three planes: %.3f ms\n", ms);
  const size_t n4 = ny / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256);
  ms = time_ms([&] { write_only<<<blocks, 256>>>((uint4*)f.rgba, n4); });
  printf("a kernel that only writes the RGBA, 16 B a thread: %.3f ms\n", ms);
  ms = time_ms([&] {
    planes_to_rgba<false><<<blocks, 256>>>(
        (const uint32_t*)f.y, (const uint16_t*)f.cb, (const uint16_t*)f.cr,
        (uint4*)f.rgba, f.h, f.w, n4);
  });
  printf("planes -> RGBA with next to no arithmetic: %.3f ms\n", ms);
  ms = time_ms([&] {
    planes_to_rgba<true><<<blocks, 256>>>(
        (const uint32_t*)f.y, (const uint16_t*)f.cb, (const uint16_t*)f.cr,
        (uint4*)f.rgba, f.h, f.w, n4);
  });
  printf("planes -> RGBA with the BT.601 arithmetic, no deblock: %.3f ms\n",
         ms);

  shape<kLumaRowStep, 256, 6>(f);   // csrc/present.cu's shape
  shape<kLumaRowStep, 256, 8>(f);   // csrc/deblock.cu's shape
  shape<16, 256, 8>(f);
  shape<16, 128, 12>(f);
  shape<32, 256, 4>(f);
  shape<32, 512, 3>(f);
  shape<48, 256, 4>(f);
  return 0;
}
