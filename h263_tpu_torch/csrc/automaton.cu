// The entropy automaton, hand-written for Hopper (sm_90a): each lane
// (stream) decodes its frame's macroblock layer to completion, run by a team
// of threads of one warp.
//
// Replaces the TPU kernel docs/retired/parse_pallas.py::parse_frames_pallas
// (kernel body `kernel`, around h263_tpu/parser/device_frontend.py::
// make_step), which never lowered through Mosaic, and the XLA while_loop +
// `assemble` scatters that ran in its place.  The lane body is
// automaton_lane.cuh (shared with a g++ build for the CPU tests).
//
// Inputs: the flat ragged uint8 payload exactly as it was copied to the
// card, int32 meta [6, S] (start_bit, nbits, quant0, ptype, v1, base word)
// and the packed VLC tables + dezigzag map (25,216 int32 = 98.5 KB).
// Outputs, written straight into each lane's slice (no tapes): dense int16
// [S, 6*nmb, 64] and int16 MVs [S, mbh, mbw, 4, 2] (zeroed by the wrapper),
// INTER uint8 [S, mbh, mbw] (set to 1 by the wrapper) and int32 [2, S]:
// each lane's status, then the steps it took.
//
// What bounds it: a lane is a serial chain of dependent steps (each symbol's
// position depends on the last), so the latency of one lane's chain, not
// the card's bandwidth or arithmetic, bounds a launch.  Idle threads cost
// nothing, a diverged warp costs every lane in it the sum of the phases.
//
// Design.
//   * Teams.  A warp runs LPW lanes (a template parameter: 1, 2, 4, 8, 32),
//     each by a team of 32 / LPW threads.  Every thread of a team executes
//     the lane's steps with the same state (the hardware runs them as one),
//     so at LPW = 1 a warp never diverges, and at any point of a step the
//     whole team is there to load or store together.  Only the team's first
//     thread writes the outputs.  The launcher spreads the lanes over the
//     SMs (one thread block per SM where they fit at 1 lane per warp, in
//     the warps the registers allow), and past that pairs lanes in a warp
//     (see h263_automaton below).
//   * The bitstream comes through a 1 KB window per lane in shared memory
//     that the team refills with 16-byte loads, byte-swapped once; a refill
//     of the lane's two-word bit window reads shared memory.
//   * The tables stay in device memory and come through the L1.  A copy in
//     shared memory (dynamic, 98.5 KB, made by the whole block before any
//     lane starts; the SHARED_TABLES template flag) pays at 8 and 32 lanes
//     per warp and not at 1, where the copy costs what its loads save:
//     kernels/automaton_sweep.py measures both, the launcher takes the L1.
//   * The MV ring of a lane ((mbw + 2) x 8 int16) lives in shared memory.
//   * An errored lane becomes the identity frame in a second launch, in
//     which whole thread blocks clear its slices with 16-byte stores; lanes
//     without an error cost that launch one load.  A zigzag overflow clears
//     its block with 16-byte stores from the team.
//   * No step divides: automaton_lane.cuh keeps the macroblock's column, row
//     and ring slot in step with its index, and indexes no register array
//     at run time (the kernel has no stack frame).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py and
// kernels/automaton_sweep.py), S = 1024 CIF lanes: 0.72 ms on clean
// P-frames, 0.10 ms of it the wrapper zeroing the outputs, ~500 ns per step
// of the longest lane (1253 steps); 1.30 ms on all the frames of a GOP with
// one lane in four cut or flipped, ~320 ns per step (3796 steps; the
// one-thread-per-lane kernel took 8.55 ms there, 5.5 ms of it errored lanes
// zeroing their slices from one thread).  Which suspect it was: divergence
// first (32 lanes per warp take 2.19 ms where 1 takes 0.72 ms, all else
// equal), then the divisions and the local-memory arrays of the step (0.85
// -> 0.72 ms); the tables' place does not matter at 1 lane per warp.  A
// lane's chain is bound by the latency of its own instructions: S = 2048
// costs 1.4x S = 1024.

#include <cuda_runtime.h>
#include <stdint.h>

#include "automaton_lane.cuh"

namespace {

constexpr int kWindowWords = 256;  // a lane's bitstream window (1 KB)
constexpr int kTableBytes = h263::TABLES_LEN * 4;
constexpr int kIdentityChunks = 8;  // thread blocks that clear one lane
constexpr int kIdentityThreads = 256;
static_assert(kTableBytes % 16 == 0, "tables are copied as 16-byte vectors");

// A lane's IO when a team of threads runs it: every thread calls every
// method with the same arguments.
struct TeamIO : h263::LaneIO {
  uint32_t* win;  // shared memory, kWindowWords big-endian words of the lane
  int win_w0;     // the lane word that win[0] holds
  int rank;       // this thread's place in its team
  int team;       // threads in the team
  unsigned mask;  // the team's threads within the warp

  // Move the window so that it holds word `wcur`: win[j] becomes what
  // word_from_payload(win_w0 + j) returns.  The window starts on a 16-byte
  // boundary of the payload, so whole groups of four words inside the
  // payload are one vector load.
  H263_HD H263_INLINE void fill(int wcur) {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);  // every thread has read what it needed of the old one
    const int64_t a0 = (base + wcur) & ~(int64_t)3;
    const int w0 = (int)(a0 - base);
    for (int grp = rank; grp < kWindowWords / 4; grp += team) {
      const int64_t a = a0 + 4 * grp;
      const int w = w0 + 4 * grp;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (w < lane_words) {
        if (w >= 0 && a >= 0 && a + 3 <= n_words - 1) {
          const int4 q = __ldg(reinterpret_cast<const int4*>(payload) + a / 4);
          v[0] = __byte_perm((uint32_t)q.x, 0u, 0x0123);
          v[1] = __byte_perm((uint32_t)q.y, 0u, 0x0123);
          v[2] = __byte_perm((uint32_t)q.z, 0u, 0x0123);
          v[3] = __byte_perm((uint32_t)q.w, 0u, 0x0123);
          for (int k = 1; k < 4; ++k)
            if (w + k >= lane_words) v[k] = 0u;
        } else {
          for (int k = 0; k < 4; ++k) v[k] = word_from_payload(w + k);
        }
      }
      reinterpret_cast<uint4*>(win)[grp] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    win_w0 = w0;
    __syncwarp(mask);
#else
    (void)wcur;
#endif
  }

  H263_HD H263_INLINE uint32_t fetch_word(int wcur) {
    if (wcur >= lane_words) return 0u;
    if (wcur < win_w0 || wcur - win_w0 >= kWindowWords) fill(wcur);
    return win[wcur - win_w0];
  }
  H263_HD H263_INLINE void store_coef(int64_t off, int val) {
    if (rank == 0) dense[off] = (int16_t)val;
  }
  H263_HD H263_INLINE void zero_block(int64_t off) {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);  // after the first thread's earlier stores to the block
    for (int i = rank; i < 8; i += team)
      reinterpret_cast<int4*>(dense + off)[i] = make_int4(0, 0, 0, 0);
#else
    (void)off;
#endif
  }
  H263_HD H263_INLINE void write_mb_mvs(int mb, bool is_inter, const int* q) {
#ifdef __CUDA_ARCH__
    if (rank != 0) return;
    inter[mb] = is_inter ? 1 : 0;
    auto pair = [](int lo, int hi) {
      return (int)(((uint32_t)lo & 0xFFFFu) | ((uint32_t)hi << 16));
    };
    reinterpret_cast<int4*>(mvs)[mb] = make_int4(
        pair(q[0], q[1]), pair(q[2], q[3]), pair(q[4], q[5]), pair(q[6], q[7]));
#else
    (void)mb; (void)is_inter; (void)q;
#endif
  }
};

// Shared memory of a thread block: the tables (when SHARED_TABLES), then for
// each lane of the block its window and its MV ring.
__host__ __device__ inline int lane_shared_bytes(int mbw) {
  return kWindowWords * 4 + (mbw + 2) * 16;
}

template <int LPW, bool SHARED_TABLES>
__global__ void automaton_kernel(const uint8_t* __restrict__ payload,
                                 int64_t n_words,
                                 const int32_t* __restrict__ meta, int S,
                                 int frame_lanes, int lanes_per_block,
                                 h263::LaneGeometry g,
                                 const int32_t* __restrict__ tables,
                                 int16_t* __restrict__ dense,
                                 int16_t* __restrict__ mvs,
                                 uint8_t* __restrict__ inter,
                                 int32_t* __restrict__ status) {
  constexpr int T = 32 / LPW;
  extern __shared__ int4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int32_t* tab = tables;
  if (SHARED_TABLES) {
    const int4* src = reinterpret_cast<const int4*>(tables);
    for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x)
      smem4[i] = __ldg(src + i);
    tab = reinterpret_cast<const int32_t*>(smem);
    smem += kTableBytes;
  }
  const int slot = threadIdx.x / T, rank = threadIdx.x % T;
  const int lane = blockIdx.x * lanes_per_block + slot;
  const bool live = slot < lanes_per_block && lane < S;
  uint32_t* win = reinterpret_cast<uint32_t*>(
      smem + (size_t)(live ? slot : 0) * lane_shared_bytes(g.mbw));
  int16_t* ring = reinterpret_cast<int16_t*>(win + kWindowWords);
  if (live)
    for (int i = rank; i < g.mbw + 2; i += T)
      reinterpret_cast<int4*>(ring)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  if (!live) return;

  const int64_t nmb = (int64_t)g.mbh * g.mbw;
  // Lane t * frame_lanes + s reads row k of its meta at meta[t][k][s].
  const int frame = lane / frame_lanes;
  const int32_t* m = meta + (int64_t)frame * 6 * frame_lanes +
                     (lane - frame * frame_lanes);
  TeamIO io;
  io.payload = payload;
  io.n_words = n_words;
  io.base = m[5 * frame_lanes];
  io.nbits = m[1 * frame_lanes];
  io.lane_words = (int)((io.nbits + 31) / 32);
  io.ptype = m[3 * frame_lanes];
  io.v1 = m[4 * frame_lanes];
  io.tables = tab;
  io.dense = dense + (int64_t)lane * 6 * nmb * 64;
  io.mvs = mvs + (int64_t)lane * nmb * 8;
  io.inter = inter + (int64_t)lane * nmb;
  io.win = win;
  io.win_w0 = -kWindowWords;  // holds nothing yet: the first fetch fills it
  io.rank = rank;
  io.team = T;
  const int in_warp = threadIdx.x & 31;
  io.mask = T == 32 ? 0xffffffffu : ((1u << T) - 1u) << (in_warp / T * T);
  int steps;
  const int st = h263::run_lane(io, g, m[0], m[2 * frame_lanes], ring,
                                &steps);
  if (rank == 0) {
    status[lane] = st;
    status[S + lane] = steps;
  }
}

// The identity frame for every lane whose status is not 0: zero
// coefficients, zero MVs, all INTER.  Block (lane, chunk).
__global__ void identity_kernel(const int32_t* __restrict__ status,
                                int64_t nmb, int16_t* __restrict__ dense,
                                int16_t* __restrict__ mvs,
                                uint8_t* __restrict__ inter) {
  const int lane = blockIdx.x;
  if (status[lane] == 0) return;
  const int first = blockIdx.y * blockDim.x + threadIdx.x;
  const int step = gridDim.y * blockDim.x;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4* d = reinterpret_cast<int4*>(dense + (int64_t)lane * 6 * nmb * 64);
  for (int64_t i = first; i < 6 * nmb * 8; i += step) d[i] = zero;
  int4* m = reinterpret_cast<int4*>(mvs + (int64_t)lane * nmb * 8);
  for (int64_t i = first; i < nmb; i += step) m[i] = zero;
  uint8_t* f = inter + (int64_t)lane * nmb;
  for (int64_t i = first; i < nmb; i += step) f[i] = 1;
}

struct Args {
  const uint8_t* payload;
  int64_t n_words;
  const int32_t* meta;
  int S;
  int frame_lanes;
  h263::LaneGeometry g;
  const int32_t* tables;
  int16_t* dense;
  int16_t* mvs;
  uint8_t* inter;
  int32_t* status;
  cudaStream_t stream;
};

template <int LPW, bool SHARED_TABLES>
cudaError_t launch(const Args& a, int lanes_per_block) {
  const int threads = (lanes_per_block * (32 / LPW) + 31) / 32 * 32;
  const int shared = (SHARED_TABLES ? kTableBytes : 0) +
                     lanes_per_block * lane_shared_bytes(a.g.mbw);
  if (threads > 1024) return cudaErrorInvalidConfiguration;
  auto kernel = automaton_kernel<LPW, SHARED_TABLES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  const int blocks = (a.S + lanes_per_block - 1) / lanes_per_block;
  kernel<<<blocks, threads, shared, a.stream>>>(
      a.payload, a.n_words, a.meta, a.S, a.frame_lanes, lanes_per_block, a.g,
      a.tables,
      a.dense, a.mvs, a.inter, a.status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  identity_kernel<<<dim3(a.S, kIdentityChunks), kIdentityThreads, 0,
                    a.stream>>>(a.status, (int64_t)a.g.mbh * a.g.mbw, a.dense,
                                a.mvs, a.inter);
  return cudaGetLastError();
}

template <bool SHARED_TABLES>
cudaError_t launch_lpw(const Args& a, int lanes_per_warp,
                       int lanes_per_block) {
  switch (lanes_per_warp) {
    case 1: return launch<1, SHARED_TABLES>(a, lanes_per_block);
    case 2: return launch<2, SHARED_TABLES>(a, lanes_per_block);
    case 4: return launch<4, SHARED_TABLES>(a, lanes_per_block);
    case 8: return launch<8, SHARED_TABLES>(a, lanes_per_block);
    case 32: return launch<32, SHARED_TABLES>(a, lanes_per_block);
  }
  return cudaErrorInvalidValue;
}

// The launch shape's inputs are kept per card (by the current device's
// ordinal): each card of a mesh sizes its own launches.
constexpr int kMaxCards = 64;

int current_card() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxCards)
    dev = 0;
  return dev;
}

int sm_count() {
  static int sms_by_card[kMaxCards] = {};
  const int dev = current_card();
  int& sms = sms_by_card[dev];
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

// Warps of the 1-lane kernel that an SM holds at once.  Its registers bound
// them: at 69-71 a thread (ptxas, kernels/ptxas_report.py) 28 warps, so a
// block of more than 28 lanes at 1 lane per warp (896 threads) is refused.
int resident_warps() {
  static int warps_by_card[kMaxCards] = {};
  const int dev = current_card();
  int& warps = warps_by_card[dev];
  if (warps == 0) {
    int per_sm = 65536, regs = 72;
    cudaFuncAttributes attr;
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxRegistersPerMultiprocessor,
                           dev);
    if (cudaFuncGetAttributes(&attr, automaton_kernel<1, false>) ==
            cudaSuccess && attr.numRegs > 0)
      regs = (attr.numRegs + 7) / 8 * 8;
    const int w = per_sm / (32 * regs);
    warps = w < 1 ? 1 : (w > 64 ? 64 : w);
  }
  return warps;
}

// Lanes of a block at 2 lanes per warp: 7 warps, 4 blocks on an SM.
constexpr int kPairBlockLanes = 14;

}  // namespace

// The launch shape is chosen here from S (all the frames of a window
// together): the lanes are spread over the SMs, and while an SM holds its
// share at 1 lane per warp, each lane gets a warp, in one block per SM.
// Beyond that (more than 28 x 132 = 3696 lanes), 2 lanes share a warp, in
// blocks of 14 lanes.  Measured on the window's 8192 CIF lanes (8 frames of
// a GOP; kernels/automaton_sweep.py, NVIDIA H100 80GB HBM3, 700 W), ms per
// call with 0.763 ms of output fills (lanes per warp / per block): 2/14
// 3.650, 4/32 3.768, 1/14 4.046, 2/28 4.052, 1/7 4.120, 4/63 4.158 (the rule
// before: 4 lanes per warp over 32 lanes an SM), 1/28 4.492, 8/63 4.677, 2/56
// 4.801, 4/112 5.811, 32/63 6.389; 8 launches of 1024 lanes 6.281.  Small
// blocks win: a block frees its SM's room only when its longest lane ends.
// lanes_per_warp (1, 2, 4, 8, 32), lanes_per_block and shared_tables (0, 1)
// override that choice for measurements when lanes_per_warp is not 0; the
// port's wrapper passes 0.
extern "C" int h263_automaton(const void* payload, int64_t payload_bytes,
                              const void* meta, int S, int frame_lanes,
                              int mbh, int mbw,
                              int ext_x, int ext_y, const void* tables,
                              void* dense, void* mvs, void* inter,
                              void* status, int lanes_per_warp,
                              int lanes_per_block, int shared_tables,
                              void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (frame_lanes <= 0 || S % frame_lanes) return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const uint8_t*>(payload), payload_bytes / 4,
         reinterpret_cast<const int32_t*>(meta), S, frame_lanes,
         h263::LaneGeometry{mbh, mbw, ext_x, ext_y},
         reinterpret_cast<const int32_t*>(tables),
         reinterpret_cast<int16_t*>(dense), reinterpret_cast<int16_t*>(mvs),
         reinterpret_cast<uint8_t*>(inter), reinterpret_cast<int32_t*>(status),
         reinterpret_cast<cudaStream_t>(stream)};
  if (lanes_per_warp == 0) {
    const int spread = (S + sm_count() - 1) / sm_count();
    const bool alone = spread <= resident_warps();
    lanes_per_warp = alone ? 1 : 2;
    lanes_per_block = alone ? spread : kPairBlockLanes;
    shared_tables = 0;
  }
  if (lanes_per_block <= 0) return (int)cudaErrorInvalidValue;
  return (int)(shared_tables
                   ? launch_lpw<true>(a, lanes_per_warp, lanes_per_block)
                   : launch_lpw<false>(a, lanes_per_warp, lanes_per_block));
}
