#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (h263_tpu_torch) on the GPUs of one
machine (one is enough; phase 14 also meshes every card when there are
more).

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit, before the last line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles h263_tpu_torch/csrc/*.cu (one process per source,
     all at once) and g++ the port's native library (the host entropy
     decoder and header prep), from the checkout;
  3. IDCT kernel vs its plain PyTorch version on the card, 1024*6*396 random
     blocks of every class plus the FMA block (must give 28): exact;
  4. automaton kernel vs its plain version on the card at the main path's
     shapes, 1024 CIF lanes (every frame of the 16 corpora), one lane in
     eight truncated and one in eight byte-flipped: equal dense, MVs, INTER
     and status on every lane.  Timed on that set and on a clean set of
     P-frames, at S=1024 and at S=2048 (each set twice over, whose halves
     must equal the S=1024 outputs);
  5. the single-frame path: DeviceFrontendDecoder(1024, 352, 288) over an
     8-frame GOP (1 I + 7 P) of 16 synthetic corpora cycled over the lanes,
     plus lanes on the FMA sequence (pixel 156) and on the ffmpeg CIF fixture
     (vs its golden luma); sampled lanes' planes and RGBA equal the reference
     digests; every kernel's launch counter rises.  On one P-step the fused
     reconstruct kernel's planes must equal the plain reconstruction over
     the IDCT kernel's residuals, and one present's RGBA (the fused present
     kernel) must equal the YUV kernel's over the deblock kernel's planes.
     Then, per P-step, host prep, H2D copy, automaton, reconstruct and the
     remainder, and a profile of one step;
  5b. reconstruct kernel vs its plain version on the card, on that P-step's
     own dense coefficients, MVs, flags and reference planes (S=1024 CIF)
     and on random inputs at 177x145: exact;
  6. deblock kernel vs its plain version on the card: the three CIF planes
     at S=1024, an odd-sized 177x145 picture and a few 1280x720 pictures
     (wider than a column tile), strengths 0-12 and apply flags mixed: exact;
  7. YUV->RGBA kernel vs its plain version, the same way: exact;
  7b. fused present kernel vs its plain version (deblock of the three planes,
     then RGBA) at the same three sizes, and on the planes, strengths and
     flags the decoder path ended with: exact;
  8. the pool path, this slice's main path: StreamPool(frontend="device")
     over an 8-frame GOP with a CIF bucket of 1024 streams and a QCIF bucket
     of 64; after frame 3, 32 CIF streams leave and 32 join (recycled slots,
     starting on an I-frame); one stream is absent for a frame; one
     rebuckets CIF->QCIF on an I-frame (the QCIF bucket grows); one rebucket
     attempt on a P-frame raises PictureFormatInvalid; present_rgba after
     every step.  Sampled streams' planes and RGBA equal the reference
     digests every frame; FMA pixel 156; fixture within +-1 of ffmpeg; all
     six kernels' launch counters rise (the IDCT kernel's, and the deblock
     and YUV kernels', through the same one-step cross-checks as in phase 5:
     the main path itself writes no residual and no deblocked plane);
  9. the K-frame window on the decoder path: DeviceFrontendDecoder(1024, 352,
     288) over phase 5's GOP as one window of 8, two of 4 and eight of 1,
     planes and statuses equal (torch.equal) at every frame to sequential
     decode_step calls, with one automaton launch per window and one
     reconstruct launch per frame; the window's one automaton launch over
     8192 lanes equal to its 8 per-frame launches (on the GOP and on a set
     with one lane in four cut or flipped).  Printed: the automaton at 8192
     lanes for every launch shape of kernels/automaton_sweep.py, the output
     fills, a window's split (host prep, H2D, automaton, each reconstruct),
     a window against 8 steps, frames/s of back-to-back loops of windows
     and of steps, the device idle share of those loops (torch.profiler),
     the stage timers of utils/trace.py, peak memory;
  10. the pool path in windows of 4 (phase 8's traffic): churn between the
     windows, a stream absent inside one, a refused P-frame rebucket, and a
     window that holds the CIF->QCIF I-frame rebucket, which falls back to
     decode_step calls (counted); sampled streams equal the reference
     digests every frame; then frames/s of a GOP of the pool's traffic back
     to back, in windows and in steps;
  11. the host-front-end path: BatchedStreamDecoder(1024, 352, 288) over
     phase 5's GOP and lanes, every frame's planes and the RGBA equal
     (torch.equal) to DeviceFrontendDecoder's on the same bytes, sampled
     lanes equal to the reference digests, FMA 156, the fixture within +-1;
     the d24 unpack kernel held exact against its plain version on every
     step's rows (slim, full and the flip step's entries) and on hand-made
     rows (collisions, cursor -1, escapes, tails past the end) at CIF and
     177x145; a lane set whose block MVs vary from frame 2 on (the MV-row
     flip) and a decoder with a small pack_cap (PackOverflow -> the dense
     transport), both equal to the device front-end; then a P-step's split,
     the prefix copy against whole rows, back-to-back frames/s of
     decode_step, decode_stream_pipelined and the device front-end, the
     stage timers, peak memory; then phase 8's traffic through
     StreamPool(frontend="host"), digests every frame.

  12. standard H.263 (DecoderOption.NONE) at S=1024 CIF: (a)
     DeviceFrontendDecoder(1024, 352, 288, DecoderOption.NONE) over an
     8-frame GOP of 16 standard corpora, u0 lanes (a PLUSPTYPE I-picture
     whose UMV the plain-PTYPE P-frames carry), MQ lanes (a PLUSPTYPE
     MODIFIED_QUANTIZATION I-picture: UNIMPLEMENTED, then identity frames)
     and one lane in eight cut or byte-flipped in every P-frame: every
     step's automaton outputs (dense, MVs, INTER, status) equal its plain
     version on every lane, sampled lanes equal the reference digests
     (planes every frame, RGBA); (b) BatchedStreamDecoder(1024, 352, 288,
     DecoderOption.NONE) on the same bytes: each step with a failed lane
     raises the automaton's error class with nothing committed, then with
     the failed lanes masked every frame's planes and RGBA equal the device
     front-end's, the PLUSPTYPE steps replay through the Python headers
     (counted), the unpack kernel equals d24_to_dense on every step's rows;
     the standard automaton on clean P-frames against the Sorenson lanes'
     in this run, a step's split by the stage timers and kernel events for
     both front-ends, back-to-back frames/s, peak memory; (c)
     StreamPool(DecoderOption.NONE) on each front-end with 1024 CIF + 64
     QCIF standard streams: churn, an absent stream, a joiner moving CIF ->
     QCIF on a plain-PTYPE I-frame (the probe says "changed"), a u0
     stream's QCIF I-frame refused (the reference's format-change rule), a
     P-frame rebucket refused, digests every frame; (d) a Sorenson host pool
     on phase 8's streams switched to the device front-end after step 3,
     digests every frame, and the H2D readings its rate trigger reads.

  13. the single-stream decoder, H263Decoder on the card (the reconstruct
     kernel at S=1, its output at the picture's dims and its reference at
     the previous picture's; the present kernel at S=1): (a) every stream
     with reference digests (the fixture, FMA, c*, q*, and the standard
     s*, sq0, u0, d0 with DecoderOption.NONE), planes and
     last_picture_rgba(deblock=True) every frame; (b) every ffmpeg fixture
     (QCIF to 1408x1152) within the repo's documented tolerances of
     ffmpeg's luma, and every frame torch.equal to
     DeviceFrontendDecoder(1, w, h) and BatchedStreamDecoder(1, w, h);
     (c) a stream through every kind of size change (testing/corpora.py
     `resize_sequence`), each reconstruction held against its plain
     version on the card and the planes against the CPU decoder's, and
     hand-made reconstructions across size changes up and down; (d) the
     decoder saved mid-GOP and resumed, a device and a host pool on phase
     8's streams saved after three steps and stepped once more, and
     decode_stream over the CIF fixture in odd-sized chunks, each equal to
     the uninterrupted decode; (e) `python -m h263_tpu_torch decode`,
     `info` and `selftest` as subprocesses, the PPMs equal to
     last_picture_rgba's RGB; (f) per-frame splits, present times,
     frames/s with and without presentation, the kernel at S=1 against its
     bytes bound, and peak memory, for the CIF, 720p and 1408x1152
     fixtures.

  14. stream sharding over a mesh (`parallel/sharding.py`, `mesh=`): (a) a
     mesh of two shards on cuda:0 (`make_stream_mesh(["cuda:0"] * 2)`)
     and, with two cards or more, one over every card
     (`make_stream_mesh()`), 1024 CIF streams a shard; (b)
     DeviceFrontendDecoder(1024 * n, 352, 288, mesh=...) over the GOP
     with every shard's first lane cut and last lane byte-flipped and a
     header reject in the last shard: at every frame the gathered planes,
     statuses and raised error (class and global stream) torch.equal to
     an unsharded DeviceFrontendDecoder on cuda:0 over the same S, in
     windows of 4 too, present_rgba equal, sampled lanes equal the
     reference digests; (c) BatchedStreamDecoder over the same mesh equal
     at every frame to the device front-end over the mesh on clean lanes,
     with a forced MV-row flip and a PackOverflow replay; (d) a standard
     H.263 GOP on both mesh decoders equal to the unsharded device
     front-end; (e) with two cards or more, DeviceFrontendDecoder,
     BatchedStreamDecoder and H263Decoder on cuda:1 equal to cuda:0's at
     every frame, and every kernel on cuda:1 equal to its plain version;
     (f) a mesh P-step's split (each shard's prep and copy, each shard's
     dispatch; the host front-end's one parse, then each shard's
     dispatch) and back-to-back frames/s of each mesh and of the unsharded
     decoders at the same S, in turns.

  15. the differential fuzz library (`h263_tpu_torch/testing/fuzz.py`) on
     the card: (a) `run_campaign(device="cuda")` for all eight flavors
     (sorenson, standard, umv: native vs Python parser; d24: the unpack
     kernel; device, device_std, device_umv: the automaton; fused: the
     packed and dense host decoders and the device front-end, step by
     step), 1100 cases a flavor (the seeds of the JAX tests), 80 fused
     scenarios; any mismatch fails, and each flavor's cases, skips and
     cases/s are printed; (b) fuzzed CIF lanes (device and device_std
     bases, 16 cases a base) as one automaton launch of 1024 lanes and one
     of 4224 (past the 1-lane / 2-lane-per-warp switch), every lane equal
     to the native host parse of its case (the Python parse under carried
     MODIFIED_QUANTIZATION), the first 1024 lanes of both launches equal,
     ok lanes and errored lanes of at least 5 classes; and the "device"
     campaign's 1100 lanes at 96x80 in one launch equal to the plain
     automaton on the card; (c) the d24 rows of 1024 of those CIF cases
     in one unpack launch, equal to the plain unpack on the card and to
     the Python dense front-end.

The kernels line's launch counts are those of phases 8-12, of phase 13's
(a)-(c) decoder runs (each run with the counts set to 0 just before it),
of phase 14's mesh decoders' runs (each with the counts set to 0
just before it and read just after it, every card synchronised at both
ends; the unsharded references left out), and of phase 15's campaigns
and its CIF automaton and d24 launches (counted the same way).

    python3 chip_smoke.py --split-ab DIR...

instead splits the one-card main path's P-step in each checkout DIR in
turn (`split_ab`), for an A/B of two commits on one card.

The oracle is `h263_tpu_torch/testdata/reference_digests.json`: SHA-256
digests of the numpy reference decoder's planes and deblocked RGBA, which
`tests/test_torch_digests.py` recomputes from the reference.

Output: progress lines; a JSON line of the kernels; the nvidia-smi line; and
as the last line {"ok": true, "device": {...}}.  Imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

S_MAIN = 1024
S_QCIF = 64
S_ODD = 64
S_WIDE = 8
N_LEAVE = 32
ODD = (145, 177)          # luma rows, columns of the odd-sized check
WIDE = (720, 1280)        # wider than one column tile of the present kernels
W, H = 352, 288
GOP = 8
N_CORPORA = 16
N_QCIF_CORPORA = 4
SEED = 7
PROBE_STEP = 3            # the P-step whose reconstruction is cross-checked
WINDOW = 4                # frames per window on the pool's window path
N_LOOP = 8                # GOPs of a back-to-back loop
N_PROFILE = 3             # GOPs of a profiled loop
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12          # H100 SXM, outside the tensor cores


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def host_cpus() -> str:
    """The host cores this process may run on, and its cgroup's CPU quota
    (the native parse's threads share them)."""
    quota = []
    for path in ("/sys/fs/cgroup/cpu.max",
                 "/sys/fs/cgroup/cpu/cpu.cfs_quota_us",
                 "/sys/fs/cgroup/cpu/cpu.cfs_period_us"):
        if os.path.exists(path):
            with open(path) as fh:
                quota.append(f"{path}: {fh.read().strip()}")
    quota = ", ".join(quota) or "no cgroup quota file"
    return (f"{len(os.sched_getaffinity(0))} of {os.cpu_count()} cores in "
            f"the affinity mask; {quota}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() over reps calls, CUDA events."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_err(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/"
             f"{want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def idct_blocks(n: int, rng) -> np.ndarray:
    """n int16 [64] blocks: ZERO / DC / VERT / row-0-only / FULL / sparse,
    and the FMA block at index 0."""
    c = np.zeros((n, 8, 8), dtype=np.int16)
    kind = rng.integers(0, 6, n)
    m = kind == 1
    c[m, 0, 0] = rng.integers(-2048, 2048, int(m.sum()))
    m = kind == 2
    c[m, :, 0] = rng.integers(-2048, 2048, (int(m.sum()), 8))
    m = kind == 3
    c[m, 0, :] = rng.integers(-2048, 2048, (int(m.sum()), 8))
    m = kind == 4
    c[m] = rng.integers(-2048, 2048, (int(m.sum()), 8, 8))
    m = np.flatnonzero(kind == 5)
    pos = rng.integers(0, 64, (m.size, 3))
    for j in range(3):
        c.reshape(n, 64)[m, pos[:, j]] = rng.integers(-300, 300, m.size)
    c[0] = 0
    c[0, 0, 2], c[0, 0, 3], c[0, 2, 2] = 735, -555, 215
    return c.reshape(n, 64)


def phase_idct(torch, rng):
    from h263_tpu_torch.ops import idct_cuda
    from h263_tpu_torch.ops.idct import derive_classes, idct_residual_fused
    from h263_tpu_torch.types import BLOCK_CLASS_DC, BLOCK_CLASS_FULL, \
        BLOCK_CLASS_VERT

    n = S_MAIN * 6 * 396
    blocks = torch.as_tensor(idct_blocks(n, rng)).to(DEVICE)
    got = idct_cuda.idct_residual_cuda(blocks)
    want = idct_residual_fused(blocks)
    torch.cuda.synchronize()
    err = max_err(torch, got, want)
    fma_k = int(got[0].view(8, 8)[0, 2])
    fma_p = int(want[0].view(8, 8)[0, 2])
    log(f"idct: n={n} blocks, max_abs_err={err}, FMA block (0,2): kernel "
        f"{fma_k} plain {fma_p} (28 = strict rounding)")
    if err != 0 or fma_k != 28 or fma_p != 28:
        fail("IDCT kernel disagrees with its plain version")
    ms = cuda_ms(lambda: idct_cuda.idct_residual_cuda(blocks), 20)
    plain_ms = cuda_ms(lambda: idct_residual_fused(blocks), 3)
    # Bytes: int16 in, int32 out.  Operations: the f32 multiply-adds each
    # block's class needs (FULL two 8x8x8 passes, VERT one column pass and
    # a scale, DC one product).
    cls = torch.bincount(derive_classes(blocks).to(torch.int64),
                         minlength=4).tolist()
    flops = (2048 * cls[BLOCK_CLASS_FULL] + 192 * cls[BLOCK_CLASS_VERT]
             + cls[BLOCK_CLASS_DC])
    b_ms = bytes_bound_ms(n * 64 * (2 + 4))
    o_ms = flops / FP32_FLOPS * 1e3
    log(f"idct: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call "
        f"({n} blocks); bound: bytes {b_ms:.4f} ms, f32 operations "
        f"{o_ms:.4f} ms (classes by code {cls})")
    return dict(name="idct_residual", route="cuda",
                source="h263_tpu_torch/csrc/idct.cu",
                replaces="h263_tpu/ops/idct_pallas.py:34",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                library_ms=None)


def automaton_inputs(torch, bufs):
    """The ragged payload and meta of one frame per lane, on the card."""
    from h263_tpu_torch.native import DevicePrepBatch

    S = len(bufs)
    prep = DevicePrepBatch(S, W, H)
    total = sum(((len(b) + 3) // 4) * 4 for b in bufs)
    stage = np.zeros((total // 4 + 1, 4), dtype=np.uint8)
    meta = np.zeros((6, S), dtype=np.int32)
    prep.prepare_ragged(bufs, stage, meta)
    return (torch.as_tensor(stage).to(DEVICE), torch.as_tensor(meta).to(DEVICE),
            stage.nbytes + meta.nbytes)


def phase_automaton(torch, corpora, rng):
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.parser.device_frontend import (
        assemble,
        parse_frames_device,
        payload_words,
    )

    S = S_MAIN
    check, clean_p = [], []
    for i in range(S):
        f = corpora[i % N_CORPORA][(i // N_CORPORA) % GOP]
        if i % 8 == 5:                          # truncated in the MB layer
            f = f[:int(rng.integers(40, len(f)))]
        elif i % 8 == 6:                        # one flipped byte
            b = bytearray(f)
            b[int(rng.integers(20, len(b)))] ^= int(rng.integers(1, 256))
            f = bytes(b)
        check.append(f)
        clean_p.append(corpora[i % N_CORPORA][1 + (i // N_CORPORA) % (GOP - 1)])
    payload, dmeta, in_bytes = automaton_inputs(torch, check)
    mbh, mbw = H // 16, W // 16
    kw = dict(mbh=mbh, mbw=mbw, width=W, height=H)

    def run(payload, dmeta):
        # With the steps each lane took, which the public wrapper drops.
        return automaton_cuda._parse_assemble(payload, dmeta, mbh, mbw, W, H,
                                              (0, 0, 0))

    got = run(payload, dmeta)
    # The plain version, as parse_assemble runs it, keeping the number of
    # lockstep steps: the longest lane's serial symbol chain.
    t0 = time.perf_counter()
    tapes = parse_frames_device(
        payload_words(payload), dmeta[0], dmeta[1], dmeta[2], dmeta[3],
        dmeta[4], mbh=mbh, mbw=mbw, base=dmeta[5], width=W, height=H)
    dense, mvs, inter, _ = assemble(tapes, mbh=mbh, mbw=mbw)
    want = (dense, mvs, inter, tapes["status"])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    chain = int(tapes["coe_ord"].shape[1])
    names = ("dense", "mvs", "inter", "status")
    err = 0
    bad = torch.zeros(S, dtype=torch.bool, device=DEVICE)
    for name, a, b in zip(names, got, want):
        err = max(err, max_err(torch, a, b))
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().reshape(S, -1)
        bad |= (d != 0).any(dim=1)
    status = got[3].cpu().numpy()
    log(f"automaton: S={S} CIF lanes, statuses {np.bincount(status).tolist()}"
        f" (by code), max_abs_err={err}, lanes that differ "
        f"{torch.nonzero(bad).flatten()[:8].tolist()} "
        f"({int(bad.sum())} of {S}); longest lane: kernel "
        f"{int(got[4].max())} steps, plain {chain}")
    if err != 0:
        fail("automaton kernel disagrees with its plain version")
    if not (status != 0).any() or not (status == 0).any():
        fail("automaton comparison must hold both ok and errored lanes")
    if int(got[4].max()) != chain:
        fail("the kernel's longest lane took other steps than the plain one")
    del tapes, dense, mvs, inter, want

    nmb = mbh * mbw
    out_bytes = 6 * nmb * 64 * 2 + nmb * 8 * 2 + nmb + 8
    ms = b_ms = None
    for tag, bufs in (("1 lane in 4 cut or flipped, all GOP frames", check),
                      ("clean P-frames", clean_p)):
        ref = None
        for mult in (1, 2):
            p, m, nbytes = automaton_inputs(torch, bufs * mult)
            out = run(p, m)
            torch.cuda.synchronize()
            if mult == 1:
                ref = out
            else:
                for a, b in zip(out, ref):
                    if not (torch.equal(a[:S], b) and torch.equal(a[S:], b)):
                        fail(f"automaton at S={2 * S} ({tag}) differs from "
                             f"S={S}")
            t = cuda_ms(lambda: automaton_cuda.parse_assemble_cuda(p, m, **kw),
                        10)
            zero = cuda_ms(lambda: torch.zeros_like(out[0]), 10)
            steps = int(out[4].max())
            bound = bytes_bound_ms(nbytes + mult * S * out_bytes)
            log(f"automaton: S={mult * S}, {tag}: {t:.3f} ms per call "
                f"({zero:.3f} ms of it zeroing the coefficients), "
                f"{int((out[3] != 0).sum())} errored lanes, longest lane "
                f"{steps} steps, {(t - zero) * 1e6 / steps:.0f} ns per step;"
                f" bound: bytes {bound:.4f} ms")
            if bufs is check and mult == 1:
                ms, b_ms = t, bound
            del p, m, out
    log(f"automaton: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms per call "
        f"(S={S}, the compared set); bound: bytes {b_ms:.4f} ms "
        f"({in_bytes + S * out_bytes} B)")
    return dict(name="entropy_automaton", route="cuda",
                source="h263_tpu_torch/csrc/automaton.cu",
                replaces="docs/retired/parse_pallas.py:91",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by="bytes", library_ms=None)


# The kernels the device front-end's paths launch (phases 5 and 8, with
# their cross-checks), and those of the host front-end's (phase 11).
DEVICE_PATH = ("idct_residual", "entropy_automaton", "deblock",
               "yuv420_to_rgba", "reconstruct", "present_rgba")
HOST_PATH = ("d24_unpack", "reconstruct", "present_rgba")


def kernel_modules():
    from h263_tpu_torch.ops import (
        d24_cuda,
        deblock_cuda,
        idct_cuda,
        present_cuda,
        reconstruct_cuda,
        yuv_cuda,
    )
    from h263_tpu_torch.parser import automaton_cuda

    return {"idct_residual": idct_cuda, "entropy_automaton": automaton_cuda,
            "deblock": deblock_cuda, "yuv420_to_rgba": yuv_cuda,
            "reconstruct": reconstruct_cuda, "present_rgba": present_cuda,
            "d24_unpack": d24_cuda}


class ReconstructProbe:
    """Stands in for `automaton_cuda.reconstruct_from_dense` (the device
    front-end's reconstruction, in `whole_step`) while installed:
    passes every call on, and on the first call with `n_streams` streams
    keeps the call's inputs and holds its planes against the earlier design
    on the same inputs, the plain reconstruction over the IDCT kernel's
    residuals (which keeps csrc/idct.cu on real main-path data)."""

    def __init__(self, torch, n_streams):
        from h263_tpu_torch.parser import automaton_cuda

        self.torch, self.n, self.mod = torch, n_streams, automaton_cuda
        self.fn = automaton_cuda.reconstruct_from_dense
        self.inputs = None

    def __enter__(self):
        self.mod.reconstruct_from_dense = self
        return self

    def __exit__(self, *exc):
        self.mod.reconstruct_from_dense = self.fn

    def __call__(self, *args):
        from h263_tpu_torch.ops.idct_cuda import idct_residual_cuda
        from h263_tpu_torch.ops.reconstruct import reconstruct_from_dense_plain

        out = self.fn(*args)
        if self.inputs is None and args[0].shape[0] == self.n:
            self.inputs = args
            want = reconstruct_from_dense_plain(*args, idct=idct_residual_cuda)
            for name, a, b in zip(("y", "cb", "cr"), out, want):
                if not self.torch.equal(a, b):
                    fail(f"reconstruct kernel: plane {name} differs from the "
                         f"plain reconstruction over the IDCT kernel")
        return out


class PresentProbe:
    """Stands in for `decoder.reconstruct.present_rgba_batched` (the
    batched decoders' present, through `shard_present_fn`) while installed:
    passes every call on, and on the first call with `n_streams` streams
    holds its RGBA against the YUV kernel's over the deblock kernel's planes
    on the same inputs (which keeps csrc/deblock.cu and csrc/yuv.cu on real
    main-path data).  With `keep` it keeps that call's inputs."""

    def __init__(self, torch, n_streams, keep=False):
        from h263_tpu_torch.decoder import reconstruct as recon_mod

        self.torch, self.n, self.mod = torch, n_streams, recon_mod
        self.fn = recon_mod.present_rgba_batched
        self.keep, self.checked, self.inputs = keep, False, None

    def __enter__(self):
        self.mod.present_rgba_batched = self
        return self

    def __exit__(self, *exc):
        self.mod.present_rgba_batched = self.fn

    def __call__(self, y, cb, cr, strength, apply):
        from h263_tpu_torch.ops.deblock_cuda import deblock_batched_cuda
        from h263_tpu_torch.ops.yuv_cuda import yuv420_to_rgba_cuda

        out = self.fn(y, cb, cr, strength, apply)
        if not self.checked and y.shape[0] == self.n:
            self.checked = True
            if self.keep:
                self.inputs = (y, cb, cr, strength, apply)
            want = yuv420_to_rgba_cuda(*(
                deblock_batched_cuda(p, strength, apply) for p in (y, cb, cr)))
            if not self.torch.equal(out, want):
                fail("present kernel: RGBA differs from the YUV kernel's over "
                     "the deblock kernel's planes")
        return out


def reset_launches():
    for m in kernel_modules().values():
        m.launches = 0


def read_launches() -> dict:
    return {k: m.launches for k, m in kernel_modules().items()}


def check_fixture_luma(y, golden_t, tag):
    d = np.abs(y.astype(np.int32) - golden_t.astype(np.int32))
    exact = float((d == 0).mean())
    # The repo's own ffmpeg tolerance (tests/test_real_corpus.py).
    if d.max() > 1 or exact < 0.98:
        fail(f"{tag}: CIF fixture luma outside the golden's tolerance "
             f"(max |dY| {int(d.max())}, exact {exact:.4f})")
    return int(d.max()), exact


def phase_decoder(torch, streams, golden, digests):
    """The single-frame path of PR 1: DeviceFrontendDecoder at S=1024."""
    from h263_tpu_torch import DeviceFrontendDecoder
    from h263_tpu_torch.testing.corpora import planes_digest, rgba_digest

    # Lane -> stream: 0-3 the ffmpeg fixture, 4-7 the FMA sequence, the
    # rest the 16 corpora cycled.
    lane_stream = (["fixture"] * 4 + ["fma"] * 4
                   + [f"c{i % N_CORPORA}" for i in range(8, S_MAIN)])
    sampled = [0, 4, *range(8, 8 + N_CORPORA), S_MAIN - 1]
    idx = torch.tensor(sampled, device=DEVICE)

    dec = DeviceFrontendDecoder(S_MAIN, W, H, device=DEVICE)
    torch.cuda.synchronize()
    reset_launches()
    step_s, peaks = [], []
    probe = ReconstructProbe(torch, S_MAIN)
    for t in range(GOP):
        bufs = [streams[s][t] for s in lane_stream]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if t == PROBE_STEP:
            with probe:
                y, cb, cr = dec.decode_step(bufs)
        else:
            y, cb, cr = dec.decode_step(bufs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        st = dec.fetch_status()
        if (st != 0).any():
            fail(f"frame {t}: {int((st != 0).sum())} lanes errored")
        kept = [p.index_select(0, idx).cpu().numpy() for p in (y, cb, cr)]
        for j, lane in enumerate(sampled):
            if planes_digest(*(k[j] for k in kept)) != \
                    digests[lane_stream[lane]]["planes"][t]:
                fail(f"decoder: lane {lane} frame {t} planes differ from the"
                     f" reference digest")
        if int(kept[0][1][0, 2]) != (156 if t else 128):
            fail(f"decoder: FMA lane pixel (0,2) is {int(kept[0][1][0, 2])}")
        check_fixture_luma(kept[0][0], golden[t], f"decoder frame {t}")
    with PresentProbe(torch, S_MAIN, keep=True) as present_probe:
        dec.present_rgba(deblock=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgba = dec.present_rgba(deblock=True)
    torch.cuda.synchronize()
    present_s = time.perf_counter() - t0
    launches = read_launches()
    rgba_s = rgba.index_select(0, idx).cpu().numpy()
    for j, lane in enumerate(sampled):
        if rgba_digest(rgba_s[j]) != digests[lane_stream[lane]]["rgba"][-1]:
            fail(f"decoder: lane {lane} RGBA differs from the reference "
                 f"digest")
    log(f"decoder path: launches during the GOP and two presents {launches} "
        f"(the IDCT kernel's is step {PROBE_STEP}'s cross-check, the deblock "
        f"and YUV kernels' the first present's)")
    if (min(launches[k] for k in DEVICE_PATH) < 1 or probe.inputs is None
            or not present_probe.checked):
        fail("a kernel of the decoder path was not launched")
    if launches["present_rgba"] != 2:
        fail("a present must launch the present kernel once")
    # Frames/s over the steps without the cross-check, which costs its
    # step a second, plain reconstruction.
    plain_steps = [s for t, s in enumerate(step_s) if t != PROBE_STEP]
    p_steps = [s for t, s in enumerate(step_s) if t not in (0, PROBE_STEP)]
    peak = max(p for t, p in enumerate(peaks) if t != PROBE_STEP)
    log(f"decoder path: S={S_MAIN} CIF x {GOP} frames, decode_step "
        f"{S_MAIN * len(plain_steps) / sum(plain_steps):.1f} frames/s over "
        f"the GOP ({S_MAIN * len(p_steps) / sum(p_steps):.1f} over the "
        f"P-frames; step ms {[round(s * 1e3, 2) for s in step_s]}, step "
        f"{PROBE_STEP} with the cross-check); present_rgba "
        f"{S_MAIN / present_s:.1f} frames/s ({present_s * 1e3:.2f} ms); peak "
        f"device memory of a step {peak / 2**30:.2f} GiB "
        f"({peaks[PROBE_STEP] / 2**30:.2f} GiB with the cross-check's plain "
        f"reconstruction); {len(sampled)} sampled lanes "
        f"x {GOP} frames equal the reference digests (planes) and the last "
        f"frame's RGBA; FMA 156; fixture within +-1")
    bufs = [streams[s][GOP - 1] for s in lane_stream]
    split_calls(torch, dec, lambda: dec.decode_step(bufs),
                "one P-frame step")
    profile_step(torch, dec, bufs)
    return probe.inputs, present_probe.inputs


def split_calls(torch, dec, call, tag, n=3):
    """Where a decode call's time goes, layer by layer: host prep (host
    clock around the native header prep, summed over a window's frames),
    the host-to-device copies (CUDA events: from the prep's end to the
    automaton's start on the stream), the automaton with its wrapper and
    each reconstruct launch (CUDA events), and what remains of the call's
    wall time (buffer handling, Python, launches, the final synchronise)."""
    from h263_tpu_torch.parser import automaton_cuda

    marks, recon_ev = {}, []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    shard = dec._shards[0]
    prep, parse, recon = (shard.prep, automaton_cuda.parse_assemble_cuda,
                          automaton_cuda.reconstruct_from_dense)

    class TimedPrep:
        def __getattr__(self, name):
            return getattr(prep, name)

        def prepare_ragged(self, *args):
            t0 = time.perf_counter()
            out = prep.prepare_ragged(*args)
            marks["prep_ms"] += (time.perf_counter() - t0) * 1e3
            marks["prep_end"] = event()
            return out

    def timed_parse(*args, **kwargs):
        marks["parse_start"] = event()
        out = parse(*args, **kwargs)
        marks["parse_end"] = event()
        return out

    def timed_recon(*args, **kwargs):
        out = recon(*args, **kwargs)
        recon_ev.append(event())
        return out

    shard.prep = TimedPrep()
    automaton_cuda.parse_assemble_cuda = timed_parse
    automaton_cuda.reconstruct_from_dense = timed_recon
    try:
        for _ in range(n):
            marks["prep_ms"] = 0.0
            recon_ev.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            h2d = marks["prep_end"].elapsed_time(marks["parse_start"])
            auto = marks["parse_start"].elapsed_time(marks["parse_end"])
            recs = [a.elapsed_time(b) for a, b in
                    zip([marks["parse_end"]] + recon_ev[:-1], recon_ev)]
            rest = wall - marks["prep_ms"] - h2d - auto - sum(recs)
            rec = " + ".join(f"{r:.3f}" for r in recs)
            log(f"split: {tag} {wall:.2f} ms wall: host prep "
                f"{marks['prep_ms']:.2f} ms, H2D {h2d:.2f} ms, automaton "
                f"{auto:.2f} ms, reconstruct {rec} ms, remainder "
                f"{rest:.2f} ms")
    finally:
        shard.prep = prep
        automaton_cuda.parse_assemble_cuda = parse
        automaton_cuda.reconstruct_from_dense = recon


def profile_step(torch, dec, bufs):
    """Where one P-frame step's time goes: torch.profiler over one more
    decode_step (run after the checks; its planes are not used)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.decode_step(bufs)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.decode_step(bufs)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Kernels only: CPU-side ops also carry the device time of what they
    # launched.
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    log(f"profile: one P-frame step {step_ms:.2f} ms wall (unprofiled); "
        f"kernels under the profiler {busy_ms:.2f} ms "
        f"({100 * busy_ms / step_ms:.1f}% of the step)")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        log(f"profile:   {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    int64 = [e.key for e in events
             if "elementwise" in e.key and "long" in e.key]
    log(f"profile: {len(events)} kernels by name, elementwise kernels on "
        f"int64: {len(int64)}")
    if int64:
        fail(f"a P-frame step still runs int64 elementwise kernels: "
             f"{int64[:3]}")


def phase_reconstruct(torch, rng, real):
    """The fused reconstruct kernel against its plain version: on a real
    P-step's inputs (`real`, kept by the decoder phase's probe) and on
    random inputs at an odd size."""
    from h263_tpu_torch.ops import reconstruct_cuda
    from h263_tpu_torch.ops.idct import derive_classes
    from h263_tpu_torch.ops.reconstruct import reconstruct_from_dense_plain
    from h263_tpu_torch.types import BLOCK_CLASS_DC, BLOCK_CLASS_FULL, \
        BLOCK_CLASS_VERT

    h, w = ODD
    mbh, mbw = -(-h // 16), -(-w // 16)
    nblk = 6 * mbh * mbw
    dense = idct_blocks(S_ODD * nblk, rng).reshape(S_ODD, nblk, 64)
    mvs = rng.integers(-2 * w, 2 * w, (S_ODD, mbh, mbw, 4, 2)).astype(np.int16)
    mvs[::2] = rng.integers(-9, 10, mvs[::2].shape)
    inter = rng.random((S_ODD, mbh, mbw)) < 0.8
    refs = [rng.integers(0, 256, (S_ODD, *hw), dtype=np.uint8)
            for hw in plane_shapes(h, w)]
    odd = [torch.as_tensor(a).to(DEVICE) for a in (dense, mvs, inter, *refs)]

    err = 0
    for tag, args in ((f"S={S_MAIN} CIF, a P-step's own inputs", real),
                      (f"S={S_ODD} {w}x{h}, random", odd)):
        got = reconstruct_cuda.reconstruct_from_dense_cuda(*args)
        want = reconstruct_from_dense_plain(*args)
        torch.cuda.synchronize()
        e = max(max_err(torch, a, b) for a, b in zip(got, want))
        err = max(err, e)
        moved = int((got[0] != args[3]).any(dim=(1, 2)).sum())
        log(f"reconstruct: {tag}: max_abs_err={e}, lanes whose luma changed "
            f"{moved} of {args[0].shape[0]}")
        if e != 0 or moved == 0:
            fail("reconstruct kernel disagrees with its plain version (or "
                 "changed nothing)")
        del got, want
    ms = cuda_ms(lambda: reconstruct_cuda.reconstruct_from_dense_cuda(*real),
                 20)
    plain_ms = cuda_ms(lambda: reconstruct_from_dense_plain(*real), 3)
    # What the MVs and the coefficients cost: the same call with every MV
    # zero (each row's samples then lie in one aligned word, a warp's in two
    # cache lines), and with zero coefficients as well (a copy).
    still = (real[0], torch.zeros_like(real[1]), *real[2:])
    copy = (torch.zeros_like(real[0]), *still[1:])
    still_ms, copy_ms = (cuda_ms(
        lambda: reconstruct_cuda.reconstruct_from_dense_cuda(*a), 20)
        for a in (still, copy))
    log(f"reconstruct: the same call with all MVs zero {still_ms:.3f} ms, "
        f"with zero coefficients too {copy_ms:.3f} ms")
    del still, copy
    # Bytes: coefficients, MVs, flags and reference planes in, planes out.
    # Operations: the f32 multiply-adds of each block's class, as the IDCT.
    cls = torch.bincount(derive_classes(real[0]).flatten().to(torch.int64),
                         minlength=4).tolist()
    flops = (2048 * cls[BLOCK_CLASS_FULL] + 192 * cls[BLOCK_CLASS_VERT]
             + cls[BLOCK_CLASS_DC])
    nbytes = (sum(t.numel() * t.element_size() for t in real)
              + sum(t.numel() for t in real[3:]))
    b_ms = bytes_bound_ms(nbytes)
    o_ms = flops / FP32_FLOPS * 1e3
    log(f"reconstruct: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call "
        f"({real[0].shape[0] * real[0].shape[1]} blocks, classes by code "
        f"{cls}); bound: bytes {b_ms:.4f} ms ({nbytes} B), f32 operations "
        f"{o_ms:.4f} ms")
    return dict(name="reconstruct", route="cuda",
                source="h263_tpu_torch/csrc/reconstruct.cu",
                replaces="h263_tpu/ops/idct_pallas.py:34",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                library_ms=None)


def blocky_planes(rng, s, h, w):
    """uint8 [s, h, w]: half the lanes 8x8-blocky with small noise (where
    the filter acts), half uniform noise (where it clamps and wraps)."""
    by, bx = -(-h // 8), -(-w // 8)
    base = rng.integers(0, 256, (s, by, bx)).repeat(8, 1).repeat(8, 2)
    base = base[:, :h, :w] + rng.integers(-3, 4, (s, h, w))
    noise = rng.integers(0, 256, (s, h, w))
    lanes = (np.arange(s) % 2 == 0)[:, None, None]
    return np.clip(np.where(lanes, base, noise), 0, 255).astype(np.uint8)


def plane_shapes(h, w):
    return [(h, w), ((h + 1) // 2, (w + 1) // 2), ((h + 1) // 2, (w + 1) // 2)]


def present_inputs(torch, rng, s, h, w):
    """Blocky planes of s 4:2:0 pictures, strengths 0-12 and ~75% of the
    apply flags set, on the card."""
    planes = [torch.as_tensor(blocky_planes(rng, s, *hw)).to(DEVICE)
              for hw in plane_shapes(h, w)]
    strength = torch.as_tensor(rng.integers(0, 13, s).astype(np.int32)
                               ).to(DEVICE)
    apply = torch.as_tensor(rng.random(s) < 0.75).to(DEVICE)
    return planes, strength, apply


def phase_deblock(torch, rng):
    from h263_tpu_torch.ops import deblock_cuda
    from h263_tpu_torch.ops.deblock import deblock_batched

    err = 0
    for s, (h, w) in ((S_MAIN, (H, W)), (S_ODD, ODD), (S_WIDE, WIDE)):
        planes, strength, apply = present_inputs(torch, rng, s, h, w)
        for p in planes:
            got = deblock_cuda.deblock_batched_cuda(p, strength, apply)
            want = deblock_batched(p, strength, apply)
            e = max_err(torch, got, want)
            err = max(err, e)
            changed = int((got != p).any(dim=(1, 2)).sum())
            log(f"deblock: S={s} plane {tuple(p.shape[1:])}: max_abs_err={e}"
                f", lanes changed {changed} of {s}")
            if e != 0 or changed == 0:
                fail("deblock kernel disagrees with its plain version (or "
                     "changed nothing)")
    planes, strength, apply = present_inputs(torch, rng, S_MAIN, H, W)

    def kernel():
        for p in planes:
            deblock_cuda.deblock_batched_cuda(p, strength, apply)

    def plain():
        for p in planes:
            deblock_batched(p, strength, apply)

    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    nbytes = 2 * sum(p.numel() for p in planes) + S_MAIN * 5
    b_ms = bytes_bound_ms(nbytes)
    log(f"deblock: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms for the three "
        f"CIF planes of {S_MAIN} frames; bound: bytes {b_ms:.4f} ms")
    return dict(name="deblock", route="cuda",
                source="h263_tpu_torch/csrc/deblock.cu",
                replaces="h263_tpu/ops/deblock_pallas.py:75",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by="bytes", library_ms=None)


def phase_yuv(torch, rng):
    from h263_tpu_torch.ops import yuv_cuda
    from h263_tpu_torch.ops.yuv import yuv420_to_rgba

    def inputs(s, h, w):
        return [torch.as_tensor(rng.integers(0, 256, (s, *hw), dtype=np.uint8)
                                ).to(DEVICE) for hw in plane_shapes(h, w)]

    err = 0
    for s, (h, w) in ((S_MAIN, (H, W)), (S_ODD, ODD)):
        y, cb, cr = inputs(s, h, w)
        got = yuv_cuda.yuv420_to_rgba_cuda(y, cb, cr)
        want = yuv420_to_rgba(y, cb, cr)
        e = max_err(torch, got, want)
        err = max(err, e)
        log(f"yuv420_to_rgba: S={s} luma {(h, w)}: max_abs_err={e}")
        if e != 0:
            fail("YUV->RGBA kernel disagrees with its plain version")
    y, cb, cr = inputs(S_MAIN, H, W)
    ms = cuda_ms(lambda: yuv_cuda.yuv420_to_rgba_cuda(y, cb, cr), 20)
    plain_ms = cuda_ms(lambda: yuv420_to_rgba(y, cb, cr), 3)
    nbytes = y.numel() + cb.numel() + cr.numel() + 4 * y.numel()
    b_ms = bytes_bound_ms(nbytes)
    log(f"yuv420_to_rgba: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms for "
        f"{S_MAIN} CIF frames; bound: bytes {b_ms:.4f} ms")
    return dict(name="yuv420_to_rgba", route="cuda",
                source="h263_tpu_torch/csrc/yuv.cu",
                replaces="h263_tpu/ops/yuv_pallas.py:23",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by="bytes", library_ms=None)


def phase_present(torch, rng, real):
    """The fused present kernel against its plain version: on blocky planes
    at three sizes and on the planes, strengths and flags the decoder path
    ended with (`real`, kept by its present probe)."""
    from h263_tpu_torch.ops import present_cuda
    from h263_tpu_torch.ops.present import present_rgba_plain

    err = 0
    cases = [(f"S={s} luma {hw}, blocky", present_inputs(torch, rng, s, *hw))
             for s, hw in ((S_MAIN, (H, W)), (S_ODD, ODD), (S_WIDE, WIDE))]
    cases.append((f"S={S_MAIN} CIF, the decoder path's last planes",
                  (real[:3], *real[3:])))
    for tag, (planes, strength, apply) in cases:
        got = present_cuda.present_rgba_cuda(*planes, strength, apply)
        want = present_rgba_plain(*planes, strength, apply)
        e = max_err(torch, got, want)
        err = max(err, e)
        off = present_rgba_plain(*planes, strength, torch.zeros_like(apply))
        changed = int((want != off).any(dim=(1, 2, 3)).sum())
        log(f"present_rgba: {tag}: max_abs_err={e}, lanes the deblock "
            f"changed {changed} of {planes[0].shape[0]}")
        if e != 0 or changed == 0:
            fail("present kernel disagrees with its plain version (or the "
                 "deblock changed nothing)")
        del got, want, off
    planes, strength, apply = cases[0][1]
    ms = cuda_ms(lambda: present_cuda.present_rgba_cuda(*planes, strength,
                                                        apply), 20)
    plain_ms = cuda_ms(lambda: present_rgba_plain(*planes, strength, apply), 3)
    # The same call with no stream deblocked: the loads, the conversion and
    # the stores alone.
    none = torch.zeros_like(apply)
    copy_ms = cuda_ms(lambda: present_cuda.present_rgba_cuda(*planes, strength,
                                                             none), 20)
    nbytes = (sum(p.numel() for p in planes) + 4 * planes[0].numel()
              + S_MAIN * 5)
    b_ms = bytes_bound_ms(nbytes)
    log(f"present_rgba: kernel {ms:.3f} ms ({copy_ms:.3f} ms with no stream "
        f"deblocked), plain {plain_ms:.3f} ms for {S_MAIN} CIF frames; bound: "
        f"bytes {b_ms:.4f} ms ({nbytes} B)")
    return dict(name="present_rgba", route="cuda",
                source="h263_tpu_torch/csrc/present.cu",
                replaces="h263_tpu/ops/deblock_pallas.py:75 + "
                         "h263_tpu/ops/yuv_pallas.py:23",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by="bytes", library_ms=None)


class _Timed:
    """Host wall time of a bound method, synchronised on both sides (or,
    with sync=False, the host time of the call alone)."""

    def __init__(self, torch, fn, sync=True):
        self.torch, self.fn, self.sync, self.seconds = torch, fn, sync, []

    def __call__(self, *args, **kwargs):
        if self.sync:
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self.sync:
            self.torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


class _StepSplit:
    """Host wall time, synchronised on both sides, of the pool's own calls
    inside each pool step: the rebucket frame's validation, a bucket's
    growth, and every bucket's decode_step (by its dims)."""

    def __init__(self, torch, pool):
        self.torch, self.steps = torch, []
        pool._validate_rebucket_frame = self.wrap(
            "validate", pool._validate_rebucket_frame)
        pool._grow = self.wrap("grow", pool._grow)
        make = pool._make_decoder

        def make_timed(n, w, h):
            dec = make(n, w, h)
            dec.decode_step = self.wrap(f"{w}x{h}", dec.decode_step)
            return dec
        pool._make_decoder = make_timed

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.torch.cuda.synchronize()
                step = self.steps[-1]
                step[name] = step.get(name, 0.0) + time.perf_counter() - t0
        return timed

    def begin(self):
        self.steps.append({})

    def table(self, pool_s):
        """Each step's parts in ms, and the rest of the pool step (the
        parts do not nest, so the rest is the step less their sum)."""
        out = []
        for step, total in zip(self.steps, pool_s):
            row = {k: round(v * 1e3, 2) for k, v in step.items()}
            row["rest"] = round((total - sum(step.values())) * 1e3, 2)
            out.append(row)
        return out


def phase_pool(torch, streams, golden, digests, frontend="device"):
    """The serving pool: two buckets, churn, absence, rebucketing, growth,
    with either entropy front-end.  The device pool's step PROBE_STEP also
    runs the one-step cross-checks of the IDCT, deblock and YUV kernels."""
    from h263_tpu_torch.parallel.pool import StreamPool
    from h263_tpu_torch.testing.corpora import planes_digest, rgba_digest
    from h263_tpu_torch.types import PictureFormatInvalid
    from h263_tpu_torch.utils.trace import get_counters

    seq_of = {}
    for i in range(S_MAIN):
        seq_of[f"cif{i}"] = ("fixture" if i < 4 else "fma" if i < 8
                             else f"c{i % N_CORPORA}")
    for j in range(S_QCIF):
        seq_of[f"qcif{j}"] = f"q{j % N_QCIF_CORPORA}"
    leavers = [f"cif{i}" for i in range(64, 64 + N_LEAVE)]
    joiners = {f"join{k}": f"c{k % N_CORPORA}" for k in range(N_LEAVE)}
    absent, absent_t = "cif17", 2                 # c1, sits out frame 2
    mover, move_t, move_to = "cif16", 5, "q0"     # c0 -> QCIF on an I-frame
    refused, refuse_t = "cif48", 6                # c0, a QCIF P-frame offered
    # Every corpus, the fixture and FMA; the absent, moved and refused
    # streams; joiners; the last CIF slot; every QCIF corpus.
    sampled = ["cif0", "cif4", *(f"cif{i}" for i in range(8, 8 + N_CORPORA)),
               "cif48", f"cif{S_MAIN - 1}", "join0", "join1", "join16",
               *(f"qcif{j}" for j in range(N_QCIF_CORPORA)), "qcif4"]

    torch.cuda.synchronize()
    reset_launches()
    tag = f"pool path ({frontend})"
    pool = StreamPool(frontend=frontend, device=DEVICE)
    split = _StepSplit(torch, pool)
    device = frontend == "device"
    probe_t = PROBE_STEP if device else None   # the step with cross-checks
    probe = ReconstructProbe(torch, S_MAIN) if device else \
        contextlib.nullcontext()
    present_probe = PresentProbe(torch, S_MAIN) if device else \
        contextlib.nullcontext()
    for sid, name in seq_of.items():
        pool.add_stream(sid, *streams[name][:2])
    cursor = {sid: 0 for sid in seq_of}
    cif_dec = qcif_n0 = None
    frames_done = 0
    pool_s, present_s, peaks = [], [], []
    for t in range(GOP):
        torch.cuda.reset_peak_memory_stats()
        if t == 4:
            for sid in leavers:
                pool.remove_stream(sid)
                del seq_of[sid], cursor[sid]
            for sid, name in joiners.items():
                pool.add_stream(sid, W, H)
                seq_of[sid], cursor[sid] = name, 0
        if t == move_t:
            seq_of[mover], cursor[mover] = move_to, 0
        if t == refuse_t:
            try:
                pool.decode_step({refused: streams["q1"][2][1]})
                fail("a rebucket on a P-frame was accepted")
            except PictureFormatInvalid as e:
                log(f"{tag}: a P-frame rebucket was refused ({e})")
            if pool._dims[refused] != (W, H):
                fail("the refused stream moved")
        feed = {sid: streams[name][2][cursor[sid]]
                for sid, name in seq_of.items()
                if not (sid == absent and t == absent_t)}
        split.begin()
        t0 = time.perf_counter()
        if t == probe_t:
            with probe:
                out = pool.decode_step(feed)
        else:
            out = pool.decode_step(feed)
        torch.cuda.synchronize()
        pool_s.append(time.perf_counter() - t0)
        frames_done += len(feed)
        if t == 0:
            cif_dec = pool._buckets[(W, H)].dec
            cif_dec.decode_step = _Timed(torch, cif_dec.decode_step)
            cif_dec.present_rgba = _Timed(torch, cif_dec.present_rgba)
            qcif_n0 = pool._buckets[(176, 144)].dec.n
        if set(out) != set(feed):
            fail(f"frame {t}: results for {len(out)} streams, fed "
                 f"{len(feed)}")
        for sid in sampled:
            if sid not in feed:
                continue
            name, k = seq_of[sid], cursor[sid]
            y, cb, cr = out[sid]
            if planes_digest(y, cb, cr) != digests[name]["planes"][k]:
                fail(f"{tag}: {sid} ({name} frame {k}) at step {t} differs "
                     f"from the reference digest")
            if name == "fma" and int(y[0, 2]) != (156 if k else 128):
                fail(f"{tag}: FMA pixel (0,2) is {int(y[0, 2])}")
            if name == "fixture":
                check_fixture_luma(y, golden[k], f"{tag} step {t}")
        for sid in feed:
            cursor[sid] += 1
        t0 = time.perf_counter()
        if t == probe_t:
            with present_probe:
                rgba = pool.present_rgba(deblock=True)
        else:
            rgba = pool.present_rgba(deblock=True)
        torch.cuda.synchronize()
        present_s.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        if set(rgba) != set(seq_of):
            fail("present_rgba does not cover every registered stream")
        for sid in sampled:
            if sid not in seq_of:                 # a joiner, not yet joined
                continue
            name, k = seq_of[sid], cursor[sid] - 1
            if rgba_digest(rgba[sid].cpu().numpy()) != digests[name]["rgba"][k]:
                fail(f"{tag}: {sid} RGBA ({name} frame {k}) at step {t} "
                     f"differs from the reference digest")
    launches = read_launches()
    peak = max(p for t, p in enumerate(peaks) if t != probe_t)
    counters = get_counters()
    qcif_n1 = pool._buckets[(176, 144)].dec.n
    log(f"{tag}: launches {launches}"
        + (f" (the IDCT kernel's, and the deblock and YUV kernels', are step "
           f"{PROBE_STEP}'s cross-checks of the CIF bucket)" if device else "")
        + f"; counters {counters}; QCIF bucket {qcif_n0} -> {qcif_n1} slots; "
        f"CIF bucket {cif_dec.n} slots")
    if device:
        if (min(launches[k] for k in DEVICE_PATH) < 1 or probe.inputs is None
                or not present_probe.checked):
            fail("a kernel of the pool path was not launched")
        # One automaton launch per bucket step; the rebucket frame is
        # validated by the host parse and launches none.
        if launches["entropy_automaton"] != 2 * GOP:
            fail("the device pool must launch the automaton once per bucket "
                 "step")
    elif (min(launches[k] for k in HOST_PATH) < 1
          or launches["entropy_automaton"] != 0):
        fail("the host pool must launch the unpack, reconstruct and present "
             "kernels, and never the automaton")
    if launches["present_rgba"] != 2 * GOP:
        fail("each bucket's present must launch the present kernel once")
    if qcif_n1 <= qcif_n0 or pool._dims[mover] != (176, 144):
        fail("the rebucketed stream did not grow the QCIF bucket")
    if cif_dec is not pool._buckets[(W, H)].dec:
        fail("the CIF bucket grew; its joiners should recycle slots")
    dec_s = cif_dec.decode_step.seconds
    pre_s = cif_dec.present_rgba.seconds
    # What the per-stream views of one bucket's batch cost on the host.
    batch = torch.empty((cif_dec.n, H, W, 4), dtype=torch.uint8, device=DEVICE)
    t0 = time.perf_counter()
    views = dict(zip(range(cif_dec.n), batch.unbind(0)))
    views_ms = (time.perf_counter() - t0) * 1e3
    del batch, views
    rest_ms = [round((p - d) * 1e3, 2) for p, d in zip(pool_s[1:], dec_s)]
    # A device pool's rates leave out the step that carries the
    # cross-check's second, plain reconstruction; a host pool runs none.
    own = [s for t, s in enumerate(dec_s, start=1) if t != probe_t]
    pre_own = [s for t, s in enumerate(pre_s) if t != probe_t]
    but = f" but {PROBE_STEP}" if device else ""
    log(f"{tag}: {frames_done} frames over {GOP} steps, "
        f"{frames_done / sum(pool_s):.1f} frames/s"
        + (f", step {PROBE_STEP}'s cross-check included" if device else "")
        + f" (step ms {[round(s * 1e3, 2) for s in pool_s]}); CIF bucket "
        f"({cif_dec.n} slots): decode over steps 1-{GOP - 1}{but} "
        f"{cif_dec.n * len(own) / sum(own):.1f} frames/s (ms "
        f"{[round(s * 1e3, 2) for s in dec_s]}), present over steps 0-"
        f"{GOP - 1}{but} "
        f"{cif_dec.n * len(pre_own) / sum(pre_own):.1f} frames/s (ms "
        f"{[round(s * 1e3, 2) for s in pre_s]}"
        + (f", step {PROBE_STEP} with the cross-check" if device else "")
        + f"); the rest of each pool step (QCIF bucket, headers, "
        f"rebucketing) ms {rest_ms}; present_rgba of the whole pool ms "
        f"{[round(s * 1e3, 2) for s in present_s]} (the views of "
        f"a {cif_dec.n}-frame batch alone: {views_ms:.2f} ms); peak device "
        f"memory of a step with its present {peak / 2**30:.2f} GiB"
        + (f" ({peaks[PROBE_STEP] / 2**30:.2f} GiB at step {PROBE_STEP}, "
           f"with the cross-check)" if device else "")
        + f"; {len(sampled)} sampled streams equal the reference digests "
        f"every frame (planes and RGBA)")
    # Where each step's time goes, the rebucket step above all: the frame's
    # host validation, the QCIF bucket's growth (a new decoder and the
    # planes' copy), each bucket's decode_step, and the rest (the pre-pass's
    # sniffing, masks, batches, result views).
    log(f"{tag}: split of each pool step in ms (rebucket at step {move_t}"
        + (f", cross-checks at step {PROBE_STEP}" if device else "")
        + f"): {split.table(pool_s)}")
    return launches


def device_busy_ms(prof) -> float:
    """Milliseconds in which the card ran anything (kernels, copies, fills)
    in a torch.profiler trace: the union of the device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_window(torch, streams, digests):
    """The K-frame window on the decoder path: DeviceFrontendDecoder(1024,
    352, 288) over the GOP as one T=8 window, as two T=4 windows and as
    eight T=1 windows, each equal at every frame to sequential decode_step
    calls; the window's one automaton launch over 8192 lanes against its 8
    per-frame launches; and where the window's time goes."""
    from h263_tpu_torch import DeviceFrontendDecoder
    from h263_tpu_torch.kernels.automaton_sweep import (WINDOW_SHAPES,
                                                        stage_window,
                                                        window_inputs)
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.testing.corpora import planes_digest
    from h263_tpu_torch.utils import trace

    lane_stream = (["fixture"] * 4 + ["fma"] * 4
                   + [f"c{i % N_CORPORA}" for i in range(8, S_MAIN)])
    sampled = [0, 4, *range(8, 8 + N_CORPORA), S_MAIN - 1]
    idx = torch.tensor(sampled, device=DEVICE)
    lists = [[streams[s][t] for s in lane_stream] for t in range(GOP)]

    seq = DeviceFrontendDecoder(S_MAIN, W, H, device=DEVICE)
    ref = []
    for bufs in lists:
        ref.append((*seq.decode_step(bufs), seq.last_status))
    del seq
    launches = {}
    for T in (GOP, GOP // 2, 1):
        dec = DeviceFrontendDecoder(S_MAIN, W, H, device=DEVICE)
        torch.cuda.synchronize()
        reset_launches()
        outs = [(*dec.decode_steps(lists[w0:w0 + T]), dec.last_status_steps)
                for w0 in range(0, GOP, T)]
        torch.cuda.synchronize()
        got = read_launches()
        if (got["entropy_automaton"] != GOP // T
                or got["reconstruct"] != GOP):
            fail(f"window T={T}: launches {got}: one automaton launch per "
                 f"window and one reconstruct launch per frame expected")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        for t in range(GOP):
            ys, cbs, crs, st = outs[t // T]
            y, cb, cr, s = ref[t]
            k = t % T
            if not (torch.equal(ys[k], y) and torch.equal(cbs[k], cb)
                    and torch.equal(crs[k], cr) and torch.equal(st[k], s)):
                fail(f"window T={T}: frame {t} differs from the sequential "
                     f"step")
            if T == GOP:
                kept = [p[k].index_select(0, idx).cpu().numpy()
                        for p in (ys, cbs, crs)]
                for j, lane in enumerate(sampled):
                    if planes_digest(*(q[j] for q in kept)) != \
                            digests[lane_stream[lane]]["planes"][t]:
                        fail(f"window: lane {lane} frame {t} differs from "
                             f"the reference digest")
        del outs, dec
    del ref
    log(f"window: S={S_MAIN} CIF x {GOP} frames as 1 window of {GOP}, 2 of "
        f"{GOP // 2} and {GOP} of 1: planes and statuses equal to sequential "
        f"decode_step at every frame, {len(sampled)} sampled lanes equal the "
        f"reference digests; launches {launches}")

    # The window's automaton launch against its per-frame launches (not
    # counted: the main path's counts were read above).
    mbh, mbw = H // 16, W // 16
    rng = np.random.default_rng(SEED + 1)
    for tag, (payload, meta) in (
            ("the GOP", stage_window(torch, lists, DEVICE)),
            ("1 lane in 4 cut or flipped",
             window_inputs(torch, GOP, S_MAIN, True, rng, DEVICE))):
        one = automaton_cuda._parse_assemble(payload, meta, mbh, mbw, W, H,
                                             (0, 0, 0))
        for t in range(GOP):
            per = automaton_cuda._parse_assemble(payload, meta[t], mbh, mbw,
                                                 W, H, (0, 0, 0))
            if not all(torch.equal(a[t], b) for a, b in zip(one, per)):
                fail(f"window automaton ({tag}): frame {t} of the launch over "
                     f"{GOP * S_MAIN} lanes differs from its own launch")
        log(f"window automaton ({tag}): one launch over {GOP * S_MAIN} lanes "
            f"equals {GOP} launches of {S_MAIN} (dense, MVs, INTER, status, "
            f"steps); {int((one[3] != 0).sum())} errored lanes, longest lane "
            f"{int(one[4].max())} steps")
        del one, per

    payload, meta = stage_window(torch, lists, DEVICE)
    per_frame_ms = cuda_ms(lambda: [automaton_cuda._parse_assemble(
        payload, meta[t], mbh, mbw, W, H, (0, 0, 0)) for t in range(GOP)], 5)
    nmb = mbh * mbw
    lanes = GOP * S_MAIN

    def fills():
        torch.zeros((lanes, 6 * nmb, 64), dtype=torch.int16, device=DEVICE)
        torch.zeros((lanes, mbh, mbw, 4, 2), dtype=torch.int16, device=DEVICE)
        torch.ones((lanes, mbh, mbw), dtype=torch.uint8, device=DEVICE)

    fill_ms = cuda_ms(fills, 5)
    shapes = []
    for shape in [(0, 0, 0)] + [(lpw, n, 0) for lpw, n in WINDOW_SHAPES]:
        try:
            ms = cuda_ms(lambda: automaton_cuda._parse_assemble(
                payload, meta, mbh, mbw, W, H, shape), 5)
        except RuntimeError:
            torch.cuda.synchronize()
            shapes.append(f"{shape[0]}/{shape[1]}: refused")
            continue
        shapes.append(f"{shape[0]}/{shape[1]}: {ms:.3f}")
    log(f"window automaton: {GOP} per-frame launches {per_frame_ms:.3f} ms; "
        f"one launch over {lanes} lanes by shape (lanes per warp/lanes per "
        f"block, 0/0 = the launcher's choice: ms) {shapes}; the output fills "
        f"of those lanes {fill_ms:.3f} ms")
    del payload, meta

    dec = DeviceFrontendDecoder(S_MAIN, W, H, device=DEVICE)
    for _ in range(2):          # both staging buffers grown to a window's
        dec.decode_steps(lists)
    split_calls(torch, dec, lambda: dec.decode_steps(lists),
                f"one T={GOP} window")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dec.decode_steps(lists)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # A window against eight steps, one call at a time, in turns.
    walls = {"steps": [], "window": []}
    for kind in ("steps", "window", "window", "steps", "steps", "window"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "window":
            dec.decode_steps(lists)
        else:
            for bufs in lists:
                dec.decode_step(bufs)
        torch.cuda.synchronize()
        walls[kind].append(round((time.perf_counter() - t0) * 1e3, 2))
    log(f"window: one T={GOP} window ms {walls['window']} against {GOP} "
        f"decode_step calls ms {walls['steps']} (each synchronised at its "
        f"end); peak device memory of a window {peak / 2**30:.2f} GiB")

    # Back to back: several GOPs, one synchronise at the end.
    def loop(kind, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if kind == "window":
                dec.decode_steps(lists)
            else:
                for bufs in lists:
                    dec.decode_step(bufs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rates = {"steps": [], "window": []}
    waits = trace.get_counters().get("staging_reclaim_waits", 0)
    for kind in ("steps", "window", "window", "steps"):
        s = loop(kind, N_LOOP)
        rates[kind].append(round(N_LOOP * GOP * S_MAIN / s, 1))
    waits = trace.get_counters().get("staging_reclaim_waits", 0) - waits
    idle = {}
    from torch.profiler import ProfilerActivity, profile
    for kind in ("window", "steps"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s = loop(kind, N_PROFILE)
        busy = device_busy_ms(prof)
        idle[kind] = (round(s * 1e3, 2), round(busy, 2),
                      round(1 - busy / (s * 1e3), 4))
    trace.reset_metrics()
    trace.trace_enabled(True)
    try:
        loop("window", N_PROFILE)
    finally:
        trace.trace_enabled(False)
    metrics = trace.get_metrics()
    log(f"window: back to back, {N_LOOP} GOPs of {S_MAIN} CIF streams, one "
        f"synchronise at the end: windows of {GOP} {rates['window']} "
        f"frames/s, decode_step {rates['steps']} frames/s; the host waited "
        f"for a staging buffer {waits} times")
    log(f"window: device idle share under torch.profiler, {N_PROFILE} GOPs "
        f"back to back (loop ms, device busy ms, idle share): windows "
        f"{idle['window']}, decode_step {idle['steps']}")
    log(f"window: stage timers (host clock) of {N_PROFILE} windows: "
        f"{json.dumps(metrics)}")
    del dec
    return launches


def phase_pool_window(torch, streams, golden, digests):
    """The pool path in windows of 4 frames: the pool phase's traffic with
    churn between the windows, a stream absent inside a window, a window
    that holds a CIF->QCIF I-frame rebucket (it falls back to decode_step
    calls) and a refused P-frame rebucket between windows."""
    from h263_tpu_torch.parallel.pool import StreamPool
    from h263_tpu_torch.testing.corpora import planes_digest, rgba_digest
    from h263_tpu_torch.types import PictureFormatInvalid
    from h263_tpu_torch.utils.trace import get_counters

    seq_of = {}
    for i in range(S_MAIN):
        seq_of[f"cif{i}"] = ("fixture" if i < 4 else "fma" if i < 8
                             else f"c{i % N_CORPORA}")
    for j in range(S_QCIF):
        seq_of[f"qcif{j}"] = f"q{j % N_QCIF_CORPORA}"
    leavers = [f"cif{i}" for i in range(64, 64 + N_LEAVE)]
    joiners = {f"join{k}": f"c{k % N_CORPORA}" for k in range(N_LEAVE)}
    absent, absent_t = "cif17", 6                 # inside the second window
    mover, move_t, move_to = "cif16", 2, "q0"     # the first window falls back
    refused = "cif48"                             # between the windows
    sampled = ["cif0", "cif4", *(f"cif{i}" for i in range(8, 8 + N_CORPORA)),
               "cif48", f"cif{S_MAIN - 1}", "join0", "join1", "join16",
               *(f"qcif{j}" for j in range(N_QCIF_CORPORA)), "qcif4"]

    torch.cuda.synchronize()
    reset_launches()
    fallbacks = get_counters().get("pool_window_fallbacks", 0)
    pool = StreamPool(device=DEVICE)
    for sid, name in seq_of.items():
        pool.add_stream(sid, *streams[name][:2])
    cursor = {sid: 0 for sid in seq_of}
    walls, frames_done, window_launches = [], 0, None
    cif_dec = None
    for w0 in range(0, GOP, WINDOW):
        if w0:
            for sid in leavers:
                pool.remove_stream(sid)
                del seq_of[sid], cursor[sid]
            for sid, name in joiners.items():
                pool.add_stream(sid, W, H)
                seq_of[sid], cursor[sid] = name, 0
            try:
                pool.decode_steps([{refused: streams["q1"][2][1]}])
                fail("a rebucket on a P-frame was accepted")
            except PictureFormatInvalid as e:
                log(f"pool window: a P-frame rebucket was refused ({e})")
            cif_dec = pool._buckets[(W, H)].dec
            cif_dec.decode_steps = _Timed(torch, cif_dec.decode_steps)
        dicts, names = [], []
        for t in range(w0, w0 + WINDOW):
            if t == move_t:
                seq_of[mover], cursor[mover] = move_to, 0
            feed = {sid: streams[name][2][cursor[sid]]
                    for sid, name in seq_of.items()
                    if not (sid == absent and t == absent_t)}
            names.append({sid: (seq_of[sid], cursor[sid]) for sid in feed})
            for sid in feed:
                cursor[sid] += 1
            dicts.append(feed)
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = pool.decode_steps(dicts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        frames_done += sum(len(d) for d in dicts)
        after = read_launches()
        if w0:
            window_launches = {k: after[k] - before[k] for k in after}
            if (window_launches["entropy_automaton"] != 2
                    or window_launches["reconstruct"] != 2 * WINDOW):
                fail(f"pool window: launches {window_launches}; one "
                     f"automaton launch per bucket and one reconstruct "
                     f"launch per frame and bucket expected")
        for k, (feed, named) in enumerate(zip(dicts, names)):
            if set(outs[k]) != set(feed):
                fail(f"pool window at {w0}: frame {k} has results for "
                     f"{len(outs[k])} streams, fed {len(feed)}")
            for sid in sampled:
                if sid not in feed:
                    continue
                name, c = named[sid]
                y, cb, cr = outs[k][sid]
                if planes_digest(y, cb, cr) != digests[name]["planes"][c]:
                    fail(f"pool window: {sid} ({name} frame {c}) at step "
                         f"{w0 + k} differs from the reference digest")
                if name == "fma" and int(y[0, 2]) != (156 if c else 128):
                    fail(f"pool window: FMA pixel (0,2) is {int(y[0, 2])}")
                if name == "fixture":
                    check_fixture_luma(y, golden[c], f"pool window {w0 + k}")
        rgba = pool.present_rgba(deblock=True)
        for sid in sampled:
            if sid not in seq_of:
                continue
            name, c = seq_of[sid], cursor[sid] - 1
            if rgba_digest(rgba[sid].cpu().numpy()) != digests[name]["rgba"][c]:
                fail(f"pool window: {sid} RGBA ({name} frame {c}) after the "
                     f"window at {w0} differs from the reference digest")
        del outs, rgba
    # Steady state, back to back: every stream restarts its sequence on
    # its I-frame, windows of 4 against decode_step calls, one synchronise
    # at the end of each round of a GOP.  The buckets' calls are timed on
    # the host clock alone (no synchronise), to split the host's time
    # between the buckets' calls and the pool's own work.
    dec_s = cif_dec.decode_steps.seconds
    del cif_dec.decode_steps                      # the synchronising timer
    timers = []
    for b in pool._buckets.values():
        for name in ("decode_step", "decode_steps"):
            t = _Timed(torch, getattr(b.dec, name), sync=False)
            setattr(b.dec, name, t)
            timers.append(t)
    gop = [{sid: streams[name][2][t] for sid, name in seq_of.items()}
           for t in range(GOP)]
    rounds = {"steps": [], "window": []}
    for kind in ("steps", "window", "window", "steps", "steps", "window"):
        for t in timers:
            t.seconds.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "window":
            for w0 in range(0, GOP, WINDOW):
                pool.decode_steps(gop[w0:w0 + WINDOW])
        else:
            for d in gop:
                pool.decode_step(d)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        inside = sum(sum(t.seconds) for t in timers)
        rounds[kind].append((round(GOP * len(seq_of) / wall, 1),
                             round(wall * 1e3, 2), round(host * 1e3, 2),
                             round(inside * 1e3, 2)))
    for b in pool._buckets.values():
        del b.dec.decode_step, b.dec.decode_steps
    launches = read_launches()
    fell_back = get_counters().get("pool_window_fallbacks", 0) - fallbacks
    log(f"pool window: launches {launches} (second window alone "
        f"{window_launches}); windows that fell back to decode_step "
        f"{fell_back}")
    if fell_back != 2:
        fail("the window with the rebucket and the one-frame window of the "
             "refused rebucket must fall back, and only they")
    if min(launches[k] for k in ("entropy_automaton", "reconstruct",
                                 "present_rgba")) < 1:
        fail("a kernel of the pool window path was not launched")
    cif_rate = cif_dec.n * WINDOW / dec_s[-1]
    log(f"pool window: {frames_done} frames in {len(walls)} windows of "
        f"{WINDOW}, window ms {[round(s * 1e3, 2) for s in walls]} (the "
        f"first by decode_step calls, for the rebucket), the second "
        f"{sum(len(d) for d in dicts) / walls[-1]:.1f} frames/s; its CIF "
        f"bucket's decode_steps ms {[round(s * 1e3, 2) for s in dec_s]} "
        f"({cif_rate:.1f} frames/s); {len(sampled)} "
        f"sampled streams equal the reference digests every frame (planes, "
        f"and RGBA after each window)")
    log(f"pool window: back to back, a GOP of the {len(seq_of)} streams "
        f"after the churn, one synchronise at its end (frames/s, wall ms, "
        f"host ms until the synchronise, of it inside the buckets' decode "
        f"calls): windows of {WINDOW} {rounds['window']}, decode_step "
        f"{rounds['steps']}")
    return launches


def fourv_corpus(seed: int, n_frames: int):
    """A CIF GOP whose block MVs vary from frame 2 on (INTER4V macroblocks
    among INTER ones): the host decoder's MV-row flip."""
    from h263_tpu_torch.testing.encoder import MBSpec, encode_sorenson_picture
    from h263_tpu_torch.types import PictureTypeCode

    rng = np.random.default_rng(seed)
    nmb = (W // 16) * (H // 16)
    frames = [encode_sorenson_picture(
        W, H, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6,
                blocks=[[(0, int(rng.integers(1, 9)))], [], [], [], [], []])
         for _ in range(nmb)])]
    for tr in range(1, n_frames):
        mbs = []
        for _ in range(nmb):
            r = rng.random()
            if r < 0.2:
                mbs.append(MBSpec(kind="uncoded"))
                continue
            four = tr >= 2 and r < 0.5
            mbs.append(MBSpec(
                kind="inter4v" if four else "inter",
                mvd=[(int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
                     for _ in range(4 if four else 1)],
                blocks=[[(int(rng.integers(0, 4)), int(rng.integers(1, 8)))],
                        [], [], [], [], []]))
        frames.append(encode_sorenson_picture(
            W, H, PictureTypeCode.P_FRAME, mbs, temporal_reference=tr))
    return frames


class D24Probe:
    """Stands in for the host decoder's two reconstructions from the fused
    transport (`decoder/reconstruct.py`, reached through
    `shard_reconstruct_fn`) while installed: passes every call on,
    after holding the unpack kernel against its plain version on the call's
    own rows (slim and full fused rows, and the flip step's entries).  The
    comparison's launch is not counted."""

    def __init__(self, torch):
        from h263_tpu_torch.decoder import reconstruct as recon_mod

        self.torch, self.mod = torch, recon_mod
        self.fns = (recon_mod.reconstruct_frame_packed_d24_fused,
                    recon_mod.reconstruct_frame_packed_d24)
        self.err, self.calls = 0, {"slim": 0, "full": 0, "entries": 0}

    def __enter__(self):
        self.mod.reconstruct_frame_packed_d24_fused = self.fused
        self.mod.reconstruct_frame_packed_d24 = self.entries
        return self

    def __exit__(self, *exc):
        (self.mod.reconstruct_frame_packed_d24_fused,
         self.mod.reconstruct_frame_packed_d24) = self.fns

    def hold(self, rows, mbh, mbw, mv_full, tag):
        """The kernel against the plain version on `rows` (fused rows, or
        entries alone when mv_full is None); returns max |error|."""
        from h263_tpu_torch.ops import d24_cuda
        from h263_tpu_torch.ops.d24 import d24_to_dense, unpack_fused

        n = d24_cuda.launches
        if mv_full is None:
            got = (d24_cuda.d24_to_dense_cuda(rows, mbh, mbw),)
            want = (d24_to_dense(rows, mbh, mbw),)
        else:
            got = d24_cuda.unpack_fused_cuda(rows, mbh, mbw, mv_full)
            want = unpack_fused(rows, mbh, mbw, mv_full)
        d24_cuda.launches = n
        e = max(max_err(self.torch, a, b) for a, b in zip(got, want))
        self.err = max(self.err, e)
        if e:
            fail(f"d24 kernel disagrees with its plain version ({tag}: max "
                 f"|error| {e})")
        return e

    def fused(self, buf, *refs, mv_full, mbh, mbw):
        self.hold(buf, mbh, mbw, mv_full, "fused rows")
        self.calls["full" if mv_full else "slim"] += 1
        return self.fns[0](buf, *refs, mv_full=mv_full, mbh=mbh, mbw=mbw)

    def entries(self, pack, mvs, inter, *refs):
        self.hold(pack, *inter.shape[1:], None, "the flip step's entries")
        self.calls["entries"] += 1
        return self.fns[1](pack, mvs, inter, *refs)


def split_host_step(torch, dec, bufs, n=3):
    """Where a host-front-end step's time goes: the native fused parse
    (host clock), the host-to-device copy of the rows (CUDA events: from
    the parse's end to the unpack's start on the stream, so the launch's
    host latency too), the unpack kernel and the reconstruct kernel (CUDA
    events), and what remains of the call's wall time."""
    from h263_tpu_torch.decoder import reconstruct as rec

    marks = {}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    parse = dec.parse_batch_packed
    unpack, recon = rec.unpack_fused_cuda, rec.reconstruct_from_dense

    def timed_parse(*args, **kwargs):
        t0 = time.perf_counter()
        parse(*args, **kwargs)
        marks["parse_ms"] = (time.perf_counter() - t0) * 1e3
        marks["parse_end"] = event()

    def timed_unpack(*args):
        marks["d24_start"] = event()
        out = unpack(*args)
        marks["d24_end"] = event()
        return out

    def timed_recon(*args, **kwargs):
        out = recon(*args, **kwargs)
        marks["rec_end"] = event()
        return out

    dec.parse_batch_packed = timed_parse
    rec.unpack_fused_cuda, rec.reconstruct_from_dense = timed_unpack, \
        timed_recon
    rows = []
    try:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.decode_step(bufs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            h2d = marks["parse_end"].elapsed_time(marks["d24_start"])
            d24 = marks["d24_start"].elapsed_time(marks["d24_end"])
            rc = marks["d24_end"].elapsed_time(marks["rec_end"])
            rest = wall - marks["parse_ms"] - h2d - d24 - rc
            rows.append((wall, marks["parse_ms"], h2d, d24, rc, rest))
            log(f"host split: one P-frame step {wall:.2f} ms wall: "
                f"host_parse (native fused parse) {marks['parse_ms']:.2f} ms, "
                f"H2D of the whole rows {h2d:.3f} ms, d24 unpack {d24:.3f} "
                f"ms, reconstruct {rc:.3f} ms, remainder {rest:.2f} ms")
    finally:
        del dec.parse_batch_packed
        rec.unpack_fused_cuda, rec.reconstruct_from_dense = unpack, recon
    return rows


def phase_host(torch, streams, golden, digests):
    """The host-front-end path: BatchedStreamDecoder(1024, 352, 288) over
    phase 5's GOP and lanes, each frame equal to DeviceFrontendDecoder's on
    the same bytes, with the unpack kernel held against its plain version
    on every step's rows; a forced MV-row flip and a forced PackOverflow;
    the kernel on hand-made rows; then the readings."""
    from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder
    from h263_tpu_torch.ops import d24_cuda
    from h263_tpu_torch.ops.d24 import unpack_fused
    from h263_tpu_torch.testing.corpora import (
        d24_rows,
        planes_digest,
        rgba_digest,
    )
    from h263_tpu_torch.utils import trace

    lane_stream = (["fixture"] * 4 + ["fma"] * 4
                   + [f"c{i % N_CORPORA}" for i in range(8, S_MAIN)])
    sampled = [0, 4, *range(8, 8 + N_CORPORA), S_MAIN - 1]
    idx = torch.tensor(sampled, device=DEVICE)
    lists = [[streams[s][t] for s in lane_stream] for t in range(GOP)]
    fourv = [fourv_corpus(SEED + 20 + k, 4) for k in range(4)]
    flip_lists = [[fourv[(i // 8) % 4][t] if i % 8 == 3 else lists[t][i]
                   for i in range(S_MAIN)] for t in range(4)]

    # The reference: the device front-end on the same bytes.
    ref = DeviceFrontendDecoder(S_MAIN, W, H, device=DEVICE)
    want = [tuple(p.clone() for p in ref.decode_step(b)) for b in lists]
    want_rgba = ref.present_rgba(deblock=True)
    ref = DeviceFrontendDecoder(S_MAIN, W, H, device=DEVICE)
    want_flip = [tuple(p.clone() for p in ref.decode_step(b))
                 for b in flip_lists]
    del ref
    torch.cuda.synchronize()

    def same(out, ref_planes, what):
        if not all(torch.equal(a, b) for a, b in zip(out, ref_planes)):
            fail(f"host path: {what} differs from the device front-end's "
                 f"planes")

    # The main path, counted.
    dec = BatchedStreamDecoder(S_MAIN, W, H, device=DEVICE)
    probe = D24Probe(torch)
    torch.cuda.synchronize()
    reset_launches()
    with probe:
        for t, bufs in enumerate(lists):
            out = dec.decode_step(bufs)
            same(out, want[t], f"frame {t}")
            kept = [p.index_select(0, idx).cpu().numpy() for p in out]
            for j, lane in enumerate(sampled):
                if planes_digest(*(k[j] for k in kept)) != \
                        digests[lane_stream[lane]]["planes"][t]:
                    fail(f"host path: lane {lane} frame {t} differs from the "
                         f"reference digest")
            if int(kept[0][1][0, 2]) != (156 if t else 128):
                fail(f"host path: FMA pixel (0,2) is {int(kept[0][1][0, 2])}")
            check_fixture_luma(kept[0][0], golden[t], f"host frame {t}")
        rgba = dec.present_rgba(deblock=True)
        torch.cuda.synchronize()
    launches = read_launches()
    if not torch.equal(rgba, want_rgba):
        fail("host path: present_rgba differs from the device front-end's")
    rgba_s = rgba.index_select(0, idx).cpu().numpy()
    for j, lane in enumerate(sampled):
        if rgba_digest(rgba_s[j]) != digests[lane_stream[lane]]["rgba"][-1]:
            fail(f"host path: lane {lane} RGBA differs from the reference "
                 f"digest")
    log(f"host path: S={S_MAIN} CIF x {GOP} frames, every frame's planes "
        f"equal the device front-end's (torch.equal) and present_rgba too; "
        f"{len(sampled)} sampled lanes equal the reference digests; FMA 156;"
        f" fixture within +-1; launches {launches}; the unpack kernel held "
        f"exact against its plain version on every step's rows "
        f"{probe.calls}")
    if (launches["d24_unpack"] != GOP or launches["reconstruct"] != GOP
            or launches["present_rgba"] != 1
            or launches["entropy_automaton"] != 0):
        fail("the host path must launch the unpack and reconstruct kernels "
             "once a step, the present kernel once a present, and no "
             "automaton")
    del want_rgba, rgba

    # A forced flip and a forced PackOverflow, against the device front-end.
    counters = trace.get_counters()
    fdec = BatchedStreamDecoder(S_MAIN, W, H, device=DEVICE)
    with probe:
        for t, bufs in enumerate(flip_lists):
            same(fdec.decode_step(bufs), want_flip[t], f"flip set frame {t}")
    odec = BatchedStreamDecoder(S_MAIN, W, H, pack_cap=2048, device=DEVICE)
    for t in range(3):
        same(odec.decode_step(lists[t]), want[t], f"pack_cap=2048 frame {t}")
    torch.cuda.synchronize()
    after = trace.get_counters()
    rose = {k: after.get(k, 0) - counters.get(k, 0)
            for k in ("steps_fused_flip", "pack_overflow_fallbacks")}
    log(f"host path: a lane set with INTER4V from frame 2 on: planes equal "
        f"over 4 frames, MV rows full {fdec._mv_full}; pack_cap=2048: "
        f"planes equal over 3 frames; counters rose {rose}; unpack checks "
        f"{probe.calls}")
    if (min(rose.values()) < 1 or not fdec._mv_full
            or probe.calls["entries"] < 1 or probe.calls["full"] < 1):
        fail("the flip or the PackOverflow fallback was not exercised")
    del fdec, odec, want_flip

    # The kernel on hand-made rows.
    rng = np.random.default_rng(SEED + 11)
    n_hand = 0
    for h, w in ((H, W), ODD):
        mbh, mbw = -(-h // 16), -(-w // 16)
        for mv_full in (None, False, True):
            rows = torch.as_tensor(d24_rows(rng, S_ODD, 900, mbh, mbw,
                                            mv_full)).to(DEVICE)
            probe.hold(rows, mbh, mbw, mv_full, f"hand-made rows {w}x{h}")
            n_hand += 1
    log(f"d24: kernel exact on {n_hand} sets of {S_ODD} hand-made rows "
        f"(collisions, cursor -1, escapes, tails past the end) at {W}x{H} "
        f"and {ODD[1]}x{ODD[0]}, entries alone and slim and full fused rows;"
        f" max_abs_err={probe.err}")

    # Readings.  The unpack on a real P-step's rows.
    mbh, mbw = H // 16, W // 16
    packed = dec._packed[dec._packed_idx]
    used = 2 * mbh * mbw + (mbh * mbw + 7) // 8 + 3 * packed.cut
    rows = packed.fused_t.to(DEVICE)[:, :used]     # as the step passes them
    n = d24_cuda.launches
    ms = cuda_ms(lambda: d24_cuda.unpack_fused_cuda(rows, mbh, mbw, False),
                 20)
    d24_cuda.launches = n
    plain_ms = cuda_ms(lambda: unpack_fused(rows, mbh, mbw, False), 3)
    nmb = mbh * mbw
    nbytes = rows.numel() + S_MAIN * nmb * (6 * 128 + 16 + 1)
    b_ms = bytes_bound_ms(nbytes)
    log(f"d24: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call on a "
        f"P-step's rows (S={S_MAIN} CIF, cut {packed.cut}, {rows.numel()} B "
        f"of rows); bound: bytes {b_ms:.4f} ms ({nbytes} B); no single "
        f"PyTorch call computes the unpack (a cumulative sum, the position "
        f"map and a scatter-add), so library_ms is null")

    split_host_step(torch, dec, lists[GOP - 1])

    # The transfer: whole pinned rows (the step's choice), against their
    # used prefix copied into a pinned contiguous buffer, then to the card.
    ship = torch.empty((S_MAIN, used), dtype=torch.uint8, pin_memory=True)

    def prefix():
        np.copyto(ship.numpy(), packed.fused[:, :used])
        return ship.to(DEVICE, non_blocking=True)

    def whole():
        return packed.fused_t.to(DEVICE, non_blocking=True)

    walls = {"prefix": [], "whole": []}
    for kind in ("prefix", "whole", "whole", "prefix", "prefix", "whole"):
        fn = prefix if kind == "prefix" else whole
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[kind].append(round((time.perf_counter() - t0) * 1e3, 3))
    log(f"host transfer of a P-step's rows, host clock to the end of the "
        f"copy: used prefix ({used * S_MAIN} B, host copy + H2D) ms "
        f"{walls['prefix']}; whole rows ({packed.fused.nbytes} B, H2D, the "
        f"step's choice) ms {walls['whole']}")

    # The native parse by thread count (entropy.cpp reads
    # H263_TPU_PARSE_THREADS at every call, every core by default): the
    # whole `parse_batch_packed`, and the native call alone.
    by_threads, native_only = {}, {}
    bufs, has_ref = dec._prepare_sorenson_buffers(lists[GOP - 1], None)
    for k in (1, 2, 4, 8, 1):
        os.environ["H263_TPU_PARSE_THREADS"] = str(k)
        try:
            for _ in range(3):
                p = dec.next_packed_batch()
                t0 = time.perf_counter()
                dec.parse_batch_packed(lists[GOP - 1], p)
                t1 = time.perf_counter()
                p.fused_parser.parse(bufs, has_ref)
                t2 = time.perf_counter()
                by_threads.setdefault(k, []).append(round((t1 - t0) * 1e3, 2))
                native_only.setdefault(k, []).append(
                    round((t2 - t1) * 1e3, 2))
        finally:
            del os.environ["H263_TPU_PARSE_THREADS"]
    log(f"host_parse of {S_MAIN} CIF P-frames by parse threads, ms: "
        f"{by_threads}; the native call alone: {native_only}")

    del want, ship
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dec.decode_step(lists[GOP - 1])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # Back to back against the device front-end, in turns.
    devdec = DeviceFrontendDecoder(S_MAIN, W, H, device=DEVICE)
    pipe = BatchedStreamDecoder(S_MAIN, W, H, device=DEVICE)

    def loop(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_LOOP):
            if kind == "pipelined":
                for _ in pipe.decode_stream_pipelined(iter(lists)):
                    pass
            else:
                d = devdec if kind == "device" else dec
                for bufs in lists:
                    d.decode_step(bufs)
        torch.cuda.synchronize()
        return round(N_LOOP * GOP * S_MAIN / (time.perf_counter() - t0), 1)

    rates = {"device": [], "host": [], "pipelined": []}
    for kind in ("device", "host", "pipelined", "pipelined", "host",
                 "device"):
        rates[kind].append(loop(kind))
    trace.reset_metrics()
    trace.trace_enabled(True)
    try:
        for bufs in lists:
            dec.decode_step(bufs)
        torch.cuda.synchronize()
    finally:
        trace.trace_enabled(False)
    log(f"host path: back to back, {N_LOOP} GOPs of {S_MAIN} CIF streams, "
        f"one synchronise at the end, frames/s: device front-end decode_step"
        f" {rates['device']}, host front-end decode_step {rates['host']}, "
        f"host decode_stream_pipelined {rates['pipelined']}; peak device "
        f"memory of a host P-step {peak / 2**30:.2f} GiB, "
        f"{(peak - held) / 2**30:.2f} GiB over what was held before it (the "
        f"decoder's planes, the phase's rows); host cores {os.cpu_count()}")
    log(f"host path: stage timers (host clock) of one GOP: "
        f"{json.dumps(trace.get_metrics())}")
    del dec, devdec, pipe, rows
    record = dict(name="d24_unpack", route="cuda",
                  source="h263_tpu_torch/csrc/d24.cu",
                  replaces="h263_tpu/decoder/reconstruct.py:252 (XLA ops, "
                           "no Pallas kernel)",
                  max_abs_err=probe.err, ms=ms, plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by="bytes", library_ms=None)
    return record, launches


# -- phase 12: standard H.263 -------------------------------------------------

N_STD = 16                # standard CIF corpora s{k}
N_UMV_LANES = 8           # lanes 0-7: u0 (UMV carried by plain-PTYPE P-frames)
N_MQ_LANES = 4            # lanes 8-11: a MODIFIED_QUANTIZATION I-picture


def std_lanes(streams, mq):
    """Phase 12's lanes: lane -> frames of its 8-frame GOP, and which lanes
    are damaged.  Lanes 0-7 carry u0; lanes 8-11 an MQ I-picture, then
    s0's P-frames (coded, so they fail under the carried MQ too); every
    other lane s{(i // 8) % 16}, and of those, lane i % 8 == 5 is cut and
    i % 8 == 6 byte-flipped after its header in every P-frame (seeded per
    i % 64 and frame), so the GOB scan runs.  I-frames stay whole: the host
    front-end refuses INTER blocks without a reference, the device one does
    not."""
    lanes, damaged = [], set()
    for i in range(S_MAIN):
        if i < N_UMV_LANES:
            lanes.append(list(streams["u0"][2]))
            continue
        if i < N_UMV_LANES + N_MQ_LANES:
            lanes.append([mq] + list(streams["s0"][2][1:]))
            continue
        frames = list(streams[f"s{(i // 8) % N_STD}"][2])
        kind = i % 8
        if kind in (5, 6):
            damaged.add(i)
            for t in range(1, GOP):
                rng = np.random.default_rng(1000 * (i % 64) + t)
                f = frames[t]
                if kind == 5:
                    f = f[:int(rng.integers(8, len(f)))]
                else:
                    b = bytearray(f)
                    b[int(rng.integers(8, len(b)))] ^= int(
                        rng.integers(1, 256))
                    f = bytes(b)
                frames[t] = f
        lanes.append(frames)
    return lanes, damaged


class AutomatonRecorder:
    """Stands in for `automaton_cuda.parse_assemble_cuda` while installed:
    passes every call on and keeps each call's payload, meta and outputs,
    for holding the kernel against its plain version afterwards."""

    def __init__(self):
        from h263_tpu_torch.parser import automaton_cuda

        self.mod, self.fn, self.calls = automaton_cuda, \
            automaton_cuda.parse_assemble_cuda, []

    def __enter__(self):
        self.mod.parse_assemble_cuda = self
        return self

    def __exit__(self, *exc):
        self.mod.parse_assemble_cuda = self.fn

    def __call__(self, payload, meta, **kw):
        out = self.fn(payload, meta, **kw)
        self.calls.append((payload, meta, out))
        return out


def hold_automaton_calls(torch, calls):
    """The kernel's outputs of every recorded call against the plain version
    on the same lanes: the distinct lanes of all calls (payload words and
    meta rows 0-4) go through ONE plain call (its time is the longest
    lane's chain, whatever the lane count), and each call's dense
    coefficients, MVs, flags and statuses must equal the plain ones lane
    for lane.  Returns (max |error|, distinct lanes, plain ms)."""
    from h263_tpu_torch.parser.device_frontend import parse_assemble

    index, words, metas, maps = {}, [], [], []
    woff = 0
    for payload, meta, _ in calls:
        flat = payload.cpu().numpy().reshape(-1)
        m = meta.cpu().numpy()
        lane_idx = np.empty(m.shape[1], dtype=np.int64)
        for i in range(m.shape[1]):
            off, nw = int(m[5, i]), (int(m[1, i]) + 31) // 32
            key = (flat[4 * off:4 * (off + nw)].tobytes(),
                   tuple(int(v) for v in m[:5, i]))
            j = index.get(key)
            if j is None:
                j = index[key] = len(metas)
                words.append(key[0] + b"\0" * (4 * nw - len(key[0])))
                metas.append(list(key[1]) + [woff])
                woff += nw
            lane_idx[i] = j
        maps.append(lane_idx)
    payload = np.frombuffer(bytearray(b"".join(words) + b"\0" * 4),
                            dtype=np.uint8)
    meta = np.ascontiguousarray(np.asarray(metas, dtype=np.int32).T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = parse_assemble(
        torch.as_tensor(payload.reshape(-1, 4)).to(DEVICE),
        torch.as_tensor(meta).to(DEVICE), mbh=H // 16, mbw=W // 16, width=W,
        height=H)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0
    for (_, _, got), lane_idx in zip(calls, maps):
        idx = torch.as_tensor(lane_idx, device=DEVICE)
        for name, a, b in zip(("dense", "mvs", "inter", "status"), got,
                              want):
            e = max_err(torch, a, b.index_select(0, idx))
            err = max(err, e)
            if e:
                fail(f"standard lanes: the automaton kernel's {name} differs "
                     f"from its plain version (max |error| {e})")
    return err, len(metas), plain_ms


def split_std_step(torch, dec, bufs, tag, n=3):
    """Where a standard step's time goes: the stage timers of utils/trace
    (host clock: host_parse, transfer, reconstruct_dispatch, reclaim_wait)
    and CUDA events around the kernels the step launches (the automaton, or
    the unpack, and the reconstruction), with the wall time around it."""
    from h263_tpu_torch.decoder import reconstruct as rec
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.utils import trace

    spans = []

    def timed(fn):
        def call(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans.append((fn.__name__, a, b))
            return out
        return call

    saved = (automaton_cuda.parse_assemble_cuda,
             automaton_cuda.reconstruct_from_dense, rec.d24_to_dense_cuda,
             rec.reconstruct_from_dense)
    automaton_cuda.parse_assemble_cuda = timed(saved[0])
    automaton_cuda.reconstruct_from_dense = timed(saved[1])
    rec.d24_to_dense_cuda = timed(saved[2])
    rec.reconstruct_from_dense = timed(saved[3])
    rows = []
    try:
        for _ in range(n):
            spans.clear()
            trace.reset_metrics()
            trace.trace_enabled(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.decode_step(bufs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            trace.trace_enabled(False)
            stages = {k: round(v["total_s"] * 1e3, 3)
                      for k, v in trace.get_metrics().items()}
            kern = {name: round(a.elapsed_time(b), 3)
                    for name, a, b in spans}
            rows.append((wall, stages, kern))
            log(f"standard split: {tag} {wall:.2f} ms wall; stage timers ms "
                f"{stages}; kernels (CUDA events, wrapper included) ms "
                f"{kern}")
    finally:
        trace.trace_enabled(False)
        (automaton_cuda.parse_assemble_cuda,
         automaton_cuda.reconstruct_from_dense, rec.d24_to_dense_cuda,
         rec.reconstruct_from_dense) = saved
    return rows


def phase_standard(torch, streams, digests):
    """Phase 12 (a) and (b): standard H.263 at S=1024 CIF through
    DeviceFrontendDecoder and BatchedStreamDecoder with DecoderOption.NONE.
    Returns the launches of their two GOPs (the main paths)."""
    from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.parser.tables import (
        ST_UNIMPLEMENTED,
        status_error_class,
    )
    from h263_tpu_torch.testing.corpora import (
        mq_picture,
        planes_digest,
        rgba_digest,
    )
    from h263_tpu_torch.types import DecoderOption, H263Error
    from h263_tpu_torch.utils import trace

    NONE = DecoderOption.NONE
    lanes, damaged = std_lanes(streams, mq_picture(W, H))
    mq_lanes = set(range(N_UMV_LANES, N_UMV_LANES + N_MQ_LANES))
    lane_name = (["u0"] * N_UMV_LANES + ["mq"] * N_MQ_LANES
                 + [f"s{(i // 8) % N_STD}" for i in range(12, S_MAIN)])
    # u0, an undamaged lane of every s{k} (lane 8m carries s{m % 16}), the
    # last lane.
    sampled = [0, *(8 * m for m in range(2, 2 + N_STD)), S_MAIN - 1]
    idx = torch.tensor(sampled, device=DEVICE)
    lists = [[lanes[i][t] for i in range(S_MAIN)] for t in range(GOP)]
    launches = {}

    # (a) The device front-end, counted; every call's automaton recorded.
    dec = DeviceFrontendDecoder(S_MAIN, W, H, NONE, device=DEVICE)
    planes, statuses, step_s = [], [], []
    torch.cuda.synchronize()
    reset_launches()
    with AutomatonRecorder() as rec_calls:
        for t, bufs in enumerate(lists):
            t0 = time.perf_counter()
            out = dec.decode_step(bufs)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            planes.append(tuple(p.clone() for p in out))
            statuses.append(dec.fetch_status().copy())
        rgba_dev = dec.present_rgba(deblock=True)
        rgba_dev_none = dec.present_rgba()
        torch.cuda.synchronize()
    launches["device"] = read_launches()
    for t in range(GOP):
        kept = [p.index_select(0, idx).cpu().numpy() for p in planes[t]]
        for j, lane in enumerate(sampled):
            if planes_digest(*(k[j] for k in kept)) != \
                    digests[lane_name[lane]]["planes"][t]:
                fail(f"standard device path: lane {lane} ({lane_name[lane]})"
                     f" frame {t} differs from the reference digest")
        st = statuses[t]
        bad = sorted(set(np.flatnonzero(st)) - damaged - mq_lanes)
        if bad:
            fail(f"standard device path: frame {t}: undamaged lanes {bad[:8]}"
                 f" errored (statuses {st[bad[:8]].tolist()})")
        if t and not (st[sorted(damaged)] != 0).any():
            fail(f"frame {t}: no damaged lane errored")
        if not (st[sorted(mq_lanes)] == ST_UNIMPLEMENTED).all():
            fail(f"frame {t}: the MQ lanes' statuses are "
                 f"{st[sorted(mq_lanes)].tolist()}, not UNIMPLEMENTED")
    mq_idx = torch.tensor(sorted(mq_lanes), device=DEVICE)
    if any(int(p.index_select(0, mq_idx).max()) for p in planes[-1]):
        fail("the MQ lanes did not keep the identity frame of their zero "
             "planes")
    rgba_s = rgba_dev.index_select(0, idx).cpu().numpy()
    for j, lane in enumerate(sampled):
        if rgba_digest(rgba_s[j]) != digests[lane_name[lane]]["rgba"][-1]:
            fail(f"standard device path: lane {lane} RGBA differs from the "
                 f"reference digest")
    if (launches["device"]["entropy_automaton"] != GOP
            or launches["device"]["reconstruct"] != GOP
            or launches["device"]["present_rgba"] != 2):
        fail(f"the standard device path must launch the automaton and the "
             f"reconstruction once a step: {launches['device']}")
    err, n_distinct, plain_ms = hold_automaton_calls(torch, rec_calls.calls)
    n_err = [int((s != 0).sum()) for s in statuses]
    log(f"standard device path: DeviceFrontendDecoder({S_MAIN}, {W}, {H}, "
        f"DecoderOption.NONE) x {GOP} frames: lanes 0-7 u0 (UMV carried), "
        f"8-11 an MQ I-picture (UNIMPLEMENTED every frame, identity planes), "
        f"{len(damaged)} lanes cut or flipped in every P-frame; errored lanes"
        f" per frame {n_err}; the automaton kernel equals its plain version "
        f"on every lane of every step (dense, MVs, INTER, status; "
        f"max_abs_err={err}; {n_distinct} distinct lanes in one plain call of"
        f" {plain_ms:.0f} ms); {len(sampled)} sampled lanes equal the "
        f"reference digests every frame and in RGBA; launches "
        f"{launches['device']}; step ms {[round(s * 1e3, 2) for s in step_s]}")
    del rec_calls

    # (b) The host front-end on the same bytes.  Per step: first every lane
    # (MQ lanes masked: the native host parser does not refuse an MQ
    # picture, as in the JAX package), which must raise the error class of
    # the lowest lane the automaton failed, with nothing committed; then
    # the lanes the automaton decoded, the others masked (the skip frame,
    # the identity, as the automaton's failed lanes), equal to the device
    # front-end's planes.
    hdec = BatchedStreamDecoder(S_MAIN, W, H, NONE, device=DEVICE)
    probe = D24Probe(torch)
    before = trace.get_counters().get("std_python_header_replays", 0)
    classes, rates = [], []
    torch.cuda.synchronize()
    reset_launches()
    with probe:
        for t, bufs in enumerate(lists):
            live = np.array([i not in mq_lanes for i in range(S_MAIN)])
            ok = live & (statuses[t] == 0)
            fails = np.flatnonzero(live & ~ok)
            if fails.size:
                try:
                    hdec.decode_step(bufs, mask=live)
                    got = None
                except H263Error as e:
                    got = type(e).__name__
                want = status_error_class(int(statuses[t][fails[0]])).__name__
                classes.append(got)
                if got != want:
                    fail(f"standard host path: frame {t} raised {got}, the "
                         f"automaton's lowest failed lane gives {want}")
            out = hdec.decode_step(bufs, mask=ok)
            if not all(torch.equal(a, b) for a, b in zip(out, planes[t])):
                fail(f"standard host path: frame {t} differs from the device "
                     f"front-end's planes")
            rates.append((hdec.last_transfer_bytes, hdec.last_transfer_s))
        rgba_host = hdec.present_rgba(deblock=True)
        rgba_host_none = hdec.present_rgba()
        torch.cuda.synchronize()
    launches["host"] = read_launches()
    replays = trace.get_counters().get("std_python_header_replays", 0) - before
    if not (torch.equal(rgba_host, rgba_dev)
            and torch.equal(rgba_host_none, rgba_dev_none)):
        fail("standard host path: present_rgba differs from the device "
             "front-end's")
    if (launches["host"]["d24_unpack"] != GOP
            or launches["host"]["reconstruct"] != GOP
            or launches["host"]["entropy_automaton"] != 0
            or probe.calls["entries"] != GOP or replays < 1):
        fail(f"the standard host path must unpack and reconstruct once a "
             f"step with no automaton, and replay its PLUSPTYPE step in "
             f"Python: launches {launches['host']}, unpack checks "
             f"{probe.calls}, replays {replays}")
    log(f"standard host path: BatchedStreamDecoder({S_MAIN}, {W}, {H}, "
        f"DecoderOption.NONE) on the same bytes: every frame's planes and "
        f"present_rgba (deblocked and not) equal the device front-end's; "
        f"the unmasked steps raised {classes} (the automaton's lowest failed"
        f" lane's class each time); steps replayed through the Python "
        f"headers (NeedsPythonHeader): {replays}; the unpack kernel exact "
        f"against d24_to_dense on every step's rows {probe.calls}; launches "
        f"{launches['host']}; H2D readings of the masked steps (bytes, s; "
        f"CUDA events, read one step late) {rates}")
    del planes, rgba_dev, rgba_host, rgba_dev_none, rgba_host_none

    # Readings on clean lanes (u0 and s{k}, no MQ, no damage).
    clean = [[streams["u0"][2][t] if i < N_UMV_LANES else
              streams[f"s{(i // 8) % N_STD}"][2][t] for i in range(S_MAIN)]
             for t in range(GOP)]
    ddec = DeviceFrontendDecoder(S_MAIN, W, H, NONE, device=DEVICE)
    with AutomatonRecorder() as rec_calls:
        for bufs in clean:
            ddec.decode_step(bufs)
    std_p = rec_calls.calls[-1][:2]
    sor_p = automaton_inputs(
        torch, [streams[f"c{i % N_CORPORA}"][2][GOP - 1]
                for i in range(S_MAIN)])[:2]
    kw = dict(mbh=H // 16, mbw=W // 16, width=W, height=H)
    n = automaton_cuda.launches
    t_std = [cuda_ms(lambda: automaton_cuda.parse_assemble_cuda(*std_p, **kw),
                     10) for _ in range(2)]
    t_sor = [cuda_ms(lambda: automaton_cuda.parse_assemble_cuda(*sor_p, **kw),
                     10) for _ in range(2)]
    steps_std = int(automaton_cuda._parse_assemble(
        *std_p, H // 16, W // 16, W, H, (0, 0, 0))[4].max())
    steps_sor = int(automaton_cuda._parse_assemble(
        *sor_p, H // 16, W // 16, W, H, (0, 0, 0))[4].max())
    automaton_cuda.launches = n
    log(f"standard automaton: {S_MAIN} clean standard CIF P-frame lanes (u0 "
        f"and s{{k}}, frame {GOP - 1}) {[round(x, 3) for x in t_std]} ms per "
        f"call (longest lane {steps_std} steps), against {S_MAIN} Sorenson "
        f"CIF P-frame lanes (c{{k}}, frame {GOP - 1}) "
        f"{[round(x, 3) for x in t_sor]} ms ({steps_sor} steps), in this "
        f"run: ratio {t_std[-1] / t_sor[-1]:.2f}")
    del rec_calls, std_p, sor_p
    split_std_step(torch, ddec, clean[GOP - 1], "device front-end P-step")
    hclean = BatchedStreamDecoder(S_MAIN, W, H, NONE, device=DEVICE)
    for bufs in clean:
        hclean.decode_step(bufs)
    split_std_step(torch, hclean, clean[GOP - 1], "host front-end P-step")
    peaks = {}
    for name, d in (("device", ddec), ("host", hclean)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        d.decode_step(clean[GOP - 1])
        torch.cuda.synchronize()
        peaks[name] = (round(torch.cuda.max_memory_allocated() / 2**30, 3),
                       round((torch.cuda.max_memory_allocated() - held)
                             / 2**30, 3))

    def loop(d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_LOOP // 2):
            for bufs in clean:
                d.decode_step(bufs)
        torch.cuda.synchronize()
        return round(N_LOOP // 2 * GOP * S_MAIN / (time.perf_counter() - t0),
                     1)

    b2b = {"device": [], "host": []}
    for name in ("device", "host", "host", "device"):
        b2b[name].append(loop(ddec if name == "device" else hclean))
    log(f"standard back to back: {N_LOOP // 2} GOPs of {S_MAIN} clean CIF "
        f"streams, one synchronise at the end, frames/s: device front-end "
        f"{b2b['device']}, host front-end {b2b['host']}; peak device memory "
        f"of a P-step (GiB; over what was held before it) {peaks}")
    del ddec, hclean, dec, hdec
    torch.cuda.synchronize()
    return launches


def phase_standard_pool(torch, streams, digests, frontend):
    """Phase 12 (c): StreamPool(DecoderOption.NONE) with 1024 CIF and 64
    QCIF standard streams on one front-end, with churn and absence; a
    stream with no picture yet moves CIF -> QCIF on a plain-PTYPE I-frame
    (the probe says "changed"); a u0 stream's QCIF I-frame is refused
    (UnimplementedDecoding: the reference refuses any change of format
    against a stream's last picture) and it keeps its state; a P-frame
    rebucket is refused (PictureFormatInvalid).  Sampled streams equal
    their digests every frame.  Returns the launches."""
    from h263_tpu_torch.parallel.pool import (
        StreamPool,
        _sniff_standard_probe,
    )
    from h263_tpu_torch.testing.corpora import planes_digest, rgba_digest
    from h263_tpu_torch.types import (
        DecoderOption,
        PictureFormatInvalid,
        UnimplementedDecoding,
    )

    QC = (176, 144)
    seq_of = {}
    for i in range(S_MAIN):
        seq_of[f"cif{i}"] = "u0" if i < 8 else f"s{i % N_STD}"
    for j in range(S_QCIF):
        seq_of[f"qcif{j}"] = "d0" if j % 2 else "sq0"
    leavers = [f"cif{i}" for i in range(64, 64 + N_LEAVE)]
    joiners = {f"join{k}": f"s{k % N_STD}" for k in range(N_LEAVE)}
    absent, absent_t = "cif17", 2
    # Joiners that decode no picture at CIF: the mover's first frame is a
    # QCIF I-frame at step 5, the refused one's a QCIF P-frame at step 6.
    mover, move_t = "join5", 5
    refused, refuse_t = "join6", 6
    umv_stream = "cif1"               # u0; a QCIF I-frame offered at step 6
    sampled = ["cif0", "cif1", *(f"cif{i}" for i in range(16, 16 + N_STD)),
               "cif17", f"cif{S_MAIN - 1}", "join0", "join1", mover,
               "qcif0", "qcif1", "qcif2"]
    tag = f"standard pool ({frontend})"
    torch.cuda.synchronize()
    reset_launches()
    pool = StreamPool(DecoderOption.NONE, frontend=frontend, device=DEVICE)
    for sid, name in seq_of.items():
        pool.add_stream(sid, *streams[name][:2])
    cursor = {sid: 0 for sid in seq_of}
    pool_s, peaks, frames_done = [], [], 0
    qcif_n0 = None
    for t in range(GOP):
        torch.cuda.reset_peak_memory_stats()
        if t == 4:
            for sid in leavers:
                pool.remove_stream(sid)
                del seq_of[sid], cursor[sid]
            for sid, name in joiners.items():
                pool.add_stream(sid, W, H)
                seq_of[sid], cursor[sid] = name, 0
        if t == move_t:
            seq_of[mover], cursor[mover] = "sq0", 0
            if _sniff_standard_probe(streams["sq0"][2][0], (W, H)) != \
                    "changed":
                fail("the probe did not report the CIF -> QCIF change")
        if t == refuse_t:
            for sid, buf, cls in (
                    (umv_stream, streams["sq0"][2][0], UnimplementedDecoding),
                    (refused, streams["sq0"][2][1], PictureFormatInvalid)):
                try:
                    pool.decode_step({sid: buf})
                    fail(f"{tag}: {sid}'s QCIF frame was accepted")
                except cls as e:
                    log(f"{tag}: {sid}'s QCIF frame refused: "
                        f"{type(e).__name__} ({e})")
                if pool._dims[sid] != (W, H):
                    fail(f"{tag}: the refused stream {sid} moved")
        feed = {sid: streams[name][2][cursor[sid]]
                for sid, name in seq_of.items()
                if not (sid == absent and t == absent_t)
                and not (sid == mover and t == 4) and sid != refused}
        t0 = time.perf_counter()
        out = pool.decode_step(feed)
        torch.cuda.synchronize()
        pool_s.append(time.perf_counter() - t0)
        frames_done += len(feed)
        if t == 0:
            qcif_n0 = pool._buckets[QC].dec.n
        if set(out) != set(feed):
            fail(f"{tag}: frame {t}: results for {len(out)} streams, fed "
                 f"{len(feed)}")
        for sid in sampled:
            if sid not in feed:
                continue
            name, k = seq_of[sid], cursor[sid]
            if planes_digest(*out[sid]) != digests[name]["planes"][k]:
                fail(f"{tag}: {sid} ({name} frame {k}) at step {t} differs "
                     f"from the reference digest")
        for sid in feed:
            cursor[sid] += 1
        rgba = pool.present_rgba(deblock=True)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        for sid in sampled:
            if sid in seq_of and cursor[sid]:
                name, k = seq_of[sid], cursor[sid] - 1
                if rgba_digest(rgba[sid].cpu().numpy()) != \
                        digests[name]["rgba"][k]:
                    fail(f"{tag}: {sid} RGBA ({name} frame {k}) at step {t} "
                         f"differs from the reference digest")
    launches = read_launches()
    qcif_n1 = pool._buckets[QC].dec.n
    if pool._dims[mover] != QC or qcif_n1 <= qcif_n0:
        fail(f"{tag}: the mover did not move to a grown QCIF bucket")
    if frontend == "device" and launches["entropy_automaton"] < 2 * GOP:
        fail(f"{tag}: a bucket step did not launch the automaton")
    if frontend == "host" and (launches["d24_unpack"] < 2 * GOP
                               or launches["entropy_automaton"]):
        fail(f"{tag}: the host pool must unpack every bucket step and "
             f"launch no automaton")
    if min(launches["reconstruct"], launches["present_rgba"]) < 2 * GOP:
        fail(f"{tag}: a bucket step or present launched no kernel")
    log(f"{tag}: {frames_done} frames over {GOP} steps, "
        f"{frames_done / sum(pool_s):.1f} frames/s (step ms "
        f"{[round(s * 1e3, 2) for s in pool_s]}; the refusals' own calls "
        f"not included); QCIF bucket {qcif_n0} -> {qcif_n1} slots; launches "
        f"{launches}; peak device memory of a step with its present "
        f"{max(peaks) / 2**30:.2f} GiB; {len(sampled)} sampled streams equal"
        f" the reference digests every frame (planes and RGBA)")
    del pool
    torch.cuda.synchronize()
    return launches


def phase_switch(torch, streams, golden, digests):
    """Phase 12 (d): a Sorenson StreamPool(frontend="host") on phase 8's
    streams (no churn) switched to the device front-end after its step 3:
    every frame before and after equals its digest, the host steps launch
    the unpack and the device steps the automaton.  Prints the host steps'
    H2D readings (CUDA events, read one step late) that the rate trigger
    reads.  Returns the launches."""
    from h263_tpu_torch.parallel.pool import StreamPool
    from h263_tpu_torch.testing.corpora import planes_digest, rgba_digest
    from h263_tpu_torch.utils.trace import get_counters

    seq_of = {}
    for i in range(S_MAIN):
        seq_of[f"cif{i}"] = ("fixture" if i < 4 else "fma" if i < 8
                             else f"c{i % N_CORPORA}")
    for j in range(S_QCIF):
        seq_of[f"qcif{j}"] = f"q{j % N_QCIF_CORPORA}"
    sampled = ["cif0", "cif4", *(f"cif{i}" for i in range(8, 8 + N_CORPORA)),
               f"cif{S_MAIN - 1}", "qcif0", "qcif1", "qcif2", "qcif3"]
    torch.cuda.synchronize()
    reset_launches()
    pool = StreamPool(frontend="host", device=DEVICE)
    for sid, name in seq_of.items():
        pool.add_stream(sid, *streams[name][:2])
    switches = get_counters().get("pool_frontend_switches", 0)
    pool_s, readings, by_phase = [], [], {}
    for t in range(GOP):
        if t == 4:
            by_phase["host"] = read_launches()
            reset_launches()
            t0 = time.perf_counter()
            pool.switch_frontend("device")
            torch.cuda.synchronize()
            switch_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out = pool.decode_step({sid: streams[name][2][t]
                                for sid, name in seq_of.items()})
        torch.cuda.synchronize()
        pool_s.append(time.perf_counter() - t0)
        if t < 4:
            readings.append([(b.dec.last_transfer_bytes,
                              round(b.dec.last_transfer_s * 1e3, 3))
                             for b in pool._buckets.values()])
        for sid in sampled:
            name = seq_of[sid]
            y, cb, cr = out[sid]
            if planes_digest(y, cb, cr) != digests[name]["planes"][t]:
                fail(f"switched pool: {sid} ({name} frame {t}) at step {t} "
                     f"differs from the reference digest")
            if name == "fixture":
                check_fixture_luma(y, golden[t], f"switched pool step {t}")
        if t in (3, GOP - 1):     # the last host step, the last device step
            rgba = pool.present_rgba(deblock=True)
            for sid in sampled:
                if rgba_digest(rgba[sid].cpu().numpy()) != \
                        digests[seq_of[sid]]["rgba"][t]:
                    fail(f"switched pool: {sid} RGBA at step {t} differs "
                         f"from the reference digest")
    by_phase["device"] = read_launches()
    launches = {k: by_phase["host"][k] + by_phase["device"][k]
                for k in by_phase["host"]}
    if (pool.frontend != "device"
            or get_counters()["pool_frontend_switches"] != switches + 2
            or by_phase["host"]["d24_unpack"] != 2 * 4
            or by_phase["host"]["entropy_automaton"]
            or by_phase["device"]["entropy_automaton"] != 2 * 4
            or by_phase["device"]["d24_unpack"]):
        fail(f"switched pool: the switch did not move both buckets to the "
             f"device front-end: launches {by_phase}")
    rates = [[round(b / s / 1e9, 2) if s else None
              for b, s in ((nb, ms / 1e3) for nb, ms in step)]
             for step in readings]
    log(f"switched pool: a Sorenson host pool of {S_MAIN} CIF + {S_QCIF} "
        f"QCIF streams switched to the device front-end after step 3 in "
        f"{switch_ms:.2f} ms; {len(sampled)} sampled streams equal the "
        f"reference digests at every frame before and after (planes, and "
        f"RGBA after steps 3 and {GOP - 1}); step ms "
        f"{[round(s * 1e3, 2) for s in pool_s]}; launches by front-end "
        f"{by_phase}; the host steps' H2D readings per bucket (bytes, ms) "
        f"{readings}, GB/s {rates}")
    del pool
    torch.cuda.synchronize()
    return launches


# -- phase 13: the single-stream decoder -----------------------------------

# name, width, height, luma tolerance, least exact share: the ffmpeg
# fixtures and the repo's documented tolerances against ffmpeg's decode
# (tests/test_real_corpus.py:13-17, its CORPUS table).
FIXTURES = [
    ("qcif", 176, 144, 1, 0.98), ("cif", 352, 288, 1, 0.98),
    ("longgop", 176, 144, 2, 0.97), ("motion", 352, 288, 1, 0.98),
    ("odd", 120, 90, 5, 0.80), ("quant", 176, 144, 2, 0.96),
    ("scenecut", 176, 144, 2, 0.95), ("p720", 1280, 720, 2, 0.99),
    ("qcoarse", 176, 144, 2, 0.95), ("qfine", 176, 144, 2, 0.94),
    ("starved", 352, 288, 2, 0.97), ("cutstorm", 176, 144, 2, 0.95),
    ("cif16", 1408, 1152, 2, 0.99),
]
SINGLE_PATH = ("reconstruct", "present_rgba")
# Hand-made reconstructions across a size change: (reference luma dims,
# output luma dims, streams).
RESIZE_CASES = [((145, 177), (288, 352), 1), ((288, 352), (145, 177), 1),
                ((22, 36), (58, 72), 4), ((720, 1280), (90, 120), 2),
                ((90, 120), (720, 1280), 2)]


def _fixture(root, name):
    from h263_tpu_torch.io.flv import iter_flv_video_tags

    fix = os.path.join(root, "tests", "fixtures")
    with open(os.path.join(fix, f"ffmpeg_flv1_{name}.flv"), "rb") as fh:
        tags = [t.payload for t in iter_flv_video_tags(fh.read())]
    golden = np.load(os.path.join(fix, f"ffmpeg_flv1_{name}_golden.npz"))
    return tags, golden["luma"]


class SingleProbe:
    """Stands in for `decoder.reconstruct.reconstruct_from_dense`, the
    single decoder's one call of the reconstruct wrapper per frame, while
    installed: passes every call on and holds its planes against the plain
    version on the same inputs on the card (a plain version launches no
    kernel), counting the calls whose reference has other dims."""

    def __init__(self, torch):
        from h263_tpu_torch.decoder import reconstruct as recon_mod

        self.torch, self.mod = torch, recon_mod
        self.fn = recon_mod.reconstruct_from_dense
        self.checked, self.resized = 0, 0

    def __enter__(self):
        self.mod.reconstruct_from_dense = self
        return self

    def __exit__(self, *exc):
        self.mod.reconstruct_from_dense = self.fn

    def __call__(self, *args, out_hw=None):
        from h263_tpu_torch.ops.reconstruct import reconstruct_from_dense_plain

        out = self.fn(*args, out_hw=out_hw)
        if tuple(args[3].shape[1:]) != tuple(out_hw):
            self.resized += 1
        want = reconstruct_from_dense_plain(*args, out_hw=out_hw)
        for name, a, b in zip(("y", "cb", "cr"), out, want):
            if not self.torch.equal(a, b):
                fail(f"reconstruct kernel at reference dims "
                     f"{tuple(args[3].shape[1:])} -> {out_hw}: plane {name} "
                     f"differs from its plain version")
        self.checked += 1
        return out


def _planes_equal(torch, got, want, tag):
    for name, a, b in zip(("y", "cb", "cr"), got, want):
        if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
            fail(f"{tag}: plane {name} differs")


def single_corpora(torch, streams, digests):
    """(a) every stream with reference digests through H263Decoder on the
    card: planes and last_picture_rgba(deblock=True) every frame."""
    from h263_tpu_torch import DecoderOption, H263Decoder
    from h263_tpu_torch.testing.corpora import (is_standard, planes_digest,
                                                rgba_digest)

    n = 0
    for name in sorted(digests):
        opts = (DecoderOption.NONE if is_standard(name)
                else DecoderOption.SORENSON_SPARK_BITSTREAM)
        dec = H263Decoder(opts, device=DEVICE)
        for t, buf in enumerate(streams[name][2]):
            pic = dec.decode_next_picture(buf)
            y, cb, cr = pic.as_yuv()
            if planes_digest(y, cb, cr) != digests[name]["planes"][t]:
                fail(f"single decoder: {name} frame {t} planes differ from "
                     f"the reference digest")
            if rgba_digest(dec.last_picture_rgba(deblock=True)) != \
                    digests[name]["rgba"][t]:
                fail(f"single decoder: {name} frame {t} RGBA differs from "
                     f"the reference digest")
            if name == "fma" and int(y[0, 2]) != (156 if t else 128):
                fail(f"single decoder: FMA pixel (0,2) is {int(y[0, 2])}")
            n += 1
    return n


def single_fixtures(torch, root):
    """(b), the single decoder's half: every ffmpeg fixture through
    H263Decoder on the card, luma within the documented tolerances of
    ffmpeg's; returns {name: (tags, [planes on the card])}."""
    from h263_tpu_torch import DecoderOption, H263Decoder

    out = {}
    for name, w, h, tol, exact_min in FIXTURES:
        tags, golden = _fixture(root, name)
        dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM,
                          device=DEVICE)
        planes, worst = [], 0
        for t, buf in enumerate(tags):
            pic = dec.decode_next_picture(buf)
            if (pic.width, pic.height) != (w, h):
                fail(f"{name}: decoded {pic.width}x{pic.height}")
            planes.append((pic.luma, pic.chroma_b, pic.chroma_r))
            d = np.abs(pic.as_luma().astype(np.int32)
                       - golden[t].astype(np.int32))
            exact = float((d == 0).mean())
            if d.max() > tol or exact < exact_min:
                fail(f"single decoder: {name} frame {t} luma outside "
                     f"ffmpeg's tolerance (max |dY| {int(d.max())}, exact "
                     f"{exact:.4f})")
            worst = max(worst, int(d.max()))
        out[name] = (tags, planes)
        log(f"single decoder: fixture {name} {w}x{h}, {len(tags)} frames "
            f"within +-{tol} of ffmpeg (worst {worst})")
    return out


def single_vs_batched(torch, fixtures):
    """(b), the batched half: each fixture's frames through
    DeviceFrontendDecoder(1, w, h) and BatchedStreamDecoder(1, w, h);
    every frame's planes equal the single decoder's (torch.equal)."""
    from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder

    for name, w, h, _, _ in FIXTURES:
        tags, planes = fixtures[name]
        cap = max(len(b) for b in tags)
        decs = {"device": DeviceFrontendDecoder(1, w, h, device=DEVICE,
                                                max_frame_bytes=cap),
                "host": BatchedStreamDecoder(1, w, h, device=DEVICE)}
        for t, buf in enumerate(tags):
            for kind, dec in decs.items():
                got = dec.decode_step([buf])
                _planes_equal(torch, [p[0] for p in got], planes[t],
                              f"{name} frame {t}: {kind} front-end vs the "
                              f"single decoder")
            if int(decs["device"].fetch_status()[0]) != 0:
                fail(f"{name} frame {t}: the device front-end's lane failed")
    log(f"single decoder: every frame of {len(FIXTURES)} fixtures equals "
        f"DeviceFrontendDecoder(1, w, h) and BatchedStreamDecoder(1, w, h) "
        f"(torch.equal)")


def single_resize(torch):
    """(c) the decoder over every kind of size change, each kernel call
    held against its plain version on the card, and the planes against
    the CPU decoder's."""
    from h263_tpu_torch import DecoderOption, H263Decoder
    from h263_tpu_torch.testing.corpora import resize_sequence

    gd = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEVICE)
    cd = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device="cpu")
    probe = SingleProbe(torch)
    for t, buf in enumerate(resize_sequence()):
        with probe:
            g = gd.decode_next_picture(buf)
        c = cd.decode_next_picture(buf)
        _planes_equal(torch, (g.luma, g.chroma_b, g.chroma_r),
                      (c.luma, c.chroma_b, c.chroma_r),
                      f"resize sequence frame {t}: card vs CPU")
        if not np.array_equal(gd.last_picture_rgba(),
                              cd.last_picture_rgba()):
            fail(f"resize sequence frame {t}: RGBA differs")
    if probe.resized < 5:
        fail(f"only {probe.resized} reconstructions had a reference of "
             f"other dims")
    return probe.checked, probe.resized


def resize_kernel_cases(torch, rng):
    """(c) hand-made inputs across a size change, random MVs reaching past
    every edge: the kernel equals its plain version on the card."""
    from h263_tpu_torch.ops import reconstruct_cuda
    from h263_tpu_torch.ops.reconstruct import reconstruct_from_dense_plain

    err = 0
    for (rh, rw), (h, w), s in RESIZE_CASES:
        mbh, mbw = -(-h // 16), -(-w // 16)
        nblk = 6 * mbh * mbw
        dense = idct_blocks(s * nblk, rng).reshape(s, nblk, 64)
        reach = 2 * max(h, w, rh, rw) + 9
        mvs = rng.integers(-reach, reach + 1, (s, mbh, mbw, 4, 2)).astype(
            np.int16)
        near = rng.random((s, mbh, mbw)) < 0.5
        mvs[near] = rng.integers(-9, 10, mvs[near].shape)
        inter = rng.random((s, mbh, mbw)) < 0.8
        refs = [rng.integers(0, 256, (s, *hw), dtype=np.uint8)
                for hw in plane_shapes(rh, rw)]
        args = [torch.as_tensor(a).to(DEVICE)
                for a in (dense, mvs, inter, *refs)]
        got = reconstruct_cuda.reconstruct_from_dense_cuda(*args,
                                                           out_hw=(h, w))
        want = reconstruct_from_dense_plain(*args, out_hw=(h, w))
        torch.cuda.synchronize()
        e = max(max_err(torch, a, b) for a, b in zip(got, want))
        err = max(err, e)
        if e:
            fail(f"reconstruct kernel, reference {rw}x{rh} -> {w}x{h}: "
                 f"max_abs_err {e}")
    log(f"single decoder: the reconstruct kernel across {len(RESIZE_CASES)} "
        f"hand-made size changes (up and down, MVs past every edge) equals "
        f"its plain version (max_abs_err {err})")
    return err


def single_checkpoints(torch, root, streams):
    """(d) the single decoder saved mid-GOP and resumed on the card; a
    device pool and a host pool on phase 8's streams saved after three
    steps and stepped once more; decode_stream over the fixture in
    odd-sized chunks."""
    from h263_tpu_torch import DecoderOption, H263Decoder
    from h263_tpu_torch.io.stream import decode_stream
    from h263_tpu_torch.parallel.pool import StreamPool
    from h263_tpu_torch.utils import checkpoint as ck

    tags, _ = _fixture(root, "motion")
    whole = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEVICE)
    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEVICE)
    for buf in tags[:7]:
        whole.decode_next_picture(buf)
        dec.decode_next_picture(buf)
    blob = ck.save_decoder_state(dec)
    resumed = ck.load_decoder_state(blob, device=DEVICE)
    for t, buf in enumerate(tags[7:], start=7):
        a, b = whole.decode_next_picture(buf), resumed.decode_next_picture(buf)
        _planes_equal(torch, (b.luma, b.chroma_b, b.chroma_r),
                      (a.luma, a.chroma_b, a.chroma_r),
                      f"resumed single decoder, motion frame {t}")
    if not np.array_equal(whole.last_picture_rgba(),
                          resumed.last_picture_rgba()):
        fail("resumed single decoder: RGBA differs")
    log(f"checkpoint: the single decoder saved after 7 of {len(tags)} "
        f"frames ({len(blob)} B) resumes on the card equal to an "
        f"uninterrupted decode")

    seq_of = {f"cif{i}": ("fixture" if i < 4 else "fma" if i < 8
                          else f"c{i % N_CORPORA}") for i in range(S_MAIN)}
    seq_of.update({f"qcif{j}": f"q{j % N_QCIF_CORPORA}"
                   for j in range(S_QCIF)})
    for frontend in ("device", "host"):
        pools = [StreamPool(frontend=frontend, device=DEVICE)
                 for _ in range(2)]
        for pool in pools:
            for sid, name in seq_of.items():
                pool.add_stream(sid, *streams[name][:2])
            for t in range(3):
                pool.decode_step({sid: streams[name][2][t]
                                  for sid, name in seq_of.items()})
        t0 = time.perf_counter()
        blob = ck.save_pool_state(pools[1])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = ck.load_pool_state(blob, device=DEVICE)
        load_s = time.perf_counter() - t0
        del pools[1]
        feed = {sid: streams[name][2][3] for sid, name in seq_of.items()}
        a, b = pools[0].decode_step(feed), resumed.decode_step(feed)
        for sid in seq_of:
            _planes_equal(torch, b.device_planes(sid), a.device_planes(sid),
                          f"resumed {frontend} pool, stream {sid}")
        log(f"checkpoint: a {frontend} pool of {len(seq_of)} streams saved "
            f"after 3 steps ({len(blob) / 2**20:.1f} MiB, save "
            f"{save_s:.2f} s, load {load_s:.2f} s) steps equal to the "
            f"uninterrupted pool")
        del pools, resumed, a, b

    raw = b"".join(_fixture(root, "cif")[0])
    sizes = [1, 7, 333, 4099]
    chunks, pos, k = [], 0, 0
    while pos < len(raw):
        chunks.append(raw[pos:pos + sizes[k % 4]])
        pos += sizes[k % 4]
        k += 1
    one = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEVICE)
    got = list(decode_stream(chunks, H263Decoder(
        DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEVICE)))
    tags, _ = _fixture(root, "cif")
    if len(got) != len(tags):
        fail(f"decode_stream gave {len(got)} pictures of {len(tags)}")
    for t, (pic, buf) in enumerate(zip(got, tags)):
        want = one.decode_next_picture(buf)
        _planes_equal(torch, (pic.luma, pic.chroma_b, pic.chroma_r),
                      (want.luma, want.chroma_b, want.chroma_r),
                      f"decode_stream frame {t}")
    log(f"stream input: decode_stream over the CIF fixture in "
        f"{len(chunks)} chunks of {sizes} bytes equals frame-by-frame "
        f"decoding")


def single_cli(torch, root):
    """(e) python -m h263_tpu_torch decode / info / selftest as
    subprocesses; the PPMs equal last_picture_rgba's RGB."""
    import tempfile

    from h263_tpu_torch import DecoderOption, H263Decoder

    flv = os.path.join(root, "tests", "fixtures", "ffmpeg_flv1_cif.flv")
    tags, _ = _fixture(root, "cif")
    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEVICE)
    rgb = []
    for buf in tags:
        dec.decode_next_picture(buf)
        rgb.append(dec.last_picture_rgba()[..., :3].tobytes())
    with tempfile.TemporaryDirectory() as tmp:
        for argv in (["decode", flv, "-o", tmp, "--device", DEVICE],
                     ["info", flv], ["selftest", "--device", DEVICE]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "h263_tpu_torch", *argv], cwd=root,
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                fail(f"python -m h263_tpu_torch {argv[0]} exited "
                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            log(f"cli: {argv[0]} exited 0 in "
                f"{time.perf_counter() - t0:.1f} s: "
                f"{proc.stdout.strip().splitlines()[-1]}")
        ppms = sorted(f for f in os.listdir(tmp) if f.endswith(".ppm"))
        if len(ppms) != len(tags):
            fail(f"cli wrote {len(ppms)} PPMs for {len(tags)} frames")
        for f, want in zip(ppms, rgb):
            with open(os.path.join(tmp, f), "rb") as fh:
                data = fh.read()
            if not data.endswith(want) or \
                    len(data) != len(b"P6\n352 288\n255\n") + len(want):
                fail(f"cli: {f} differs from last_picture_rgba's RGB")
    log(f"cli: {len(ppms)} PPMs equal last_picture_rgba's RGB")


def raw_reconstruct_ms(torch, args, out_hw, reps=200):
    """Device ms per launch of the reconstruct kernel through its C entry
    point, on a wrapper call's own inputs: no wrapper Python between the
    launches, so at S=1 the card, not the host, sets the pace."""
    from h263_tpu_torch import kernels
    from h263_tpu_torch.ops.idct_cuda import _BASIS

    dense, mvs, inter, ref_y, ref_cb, ref_cr = args
    s, mbh, mbw = inter.shape
    h, w = out_hw
    outs = [torch.empty((s, *hw), dtype=torch.uint8, device=DEVICE)
            for hw in plane_shapes(h, w)]
    basis = kernels.device_table("idct_basis", _BASIS, dense.device)
    fn, stream = kernels.lib().h263_reconstruct, \
        kernels.stream_handle(dense.device)
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    dims = (s, mbh, mbw, h, w, *ref_y.shape[1:])

    def launch():
        kernels.check(fn(*ptrs, *dims, basis.data_ptr(), stream),
                      "h263_reconstruct")
    return cuda_ms(launch, reps)


def single_readings(torch, root):
    """(f) per-frame split, present, loops, the kernel at S=1, peak."""
    from h263_tpu_torch import DecoderOption, H263Decoder
    from h263_tpu_torch.decoder import reconstruct as recon_mod
    from h263_tpu_torch.decoder import state as state_mod
    from h263_tpu_torch.ops import reconstruct_cuda

    opts = DecoderOption.SORENSON_SPARK_BITSTREAM
    for name in ("cif", "p720", "cif16"):
        tags, _ = _fixture(root, name)
        # The split, per frame of one pass (after a warm pass).
        dec = H263Decoder(opts, device=DEVICE)
        for buf in tags:
            dec.decode_next_picture(buf)
        dec = H263Decoder(opts, device=DEVICE)
        marks = {}

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        hdr_fn, parse_fn = state_mod.decode_picture, state_mod.parse_frame_auto
        rec_fn, pres_fn = (recon_mod.reconstruct_from_dense,
                           state_mod.present_rgba_batched)

        def timed_hdr(*a):
            t0 = time.perf_counter()
            out = hdr_fn(*a)
            marks["hdr"] = time.perf_counter() - t0
            return out

        def timed_parse(*a):
            t0 = time.perf_counter()
            out = parse_fn(*a)
            marks["parse"] = time.perf_counter() - t0
            marks["parsed"] = event()
            return out

        def timed_rec(*a, **k):
            marks["k0"] = event()
            out = rec_fn(*a, **k)
            marks["k1"] = event()
            marks["args"] = (a, k)
            return out

        def timed_present(*a):
            marks["p0"] = event()
            out = pres_fn(*a)
            marks["p1"] = event()
            return out

        state_mod.decode_picture, state_mod.parse_frame_auto = \
            timed_hdr, timed_parse
        recon_mod.reconstruct_from_dense = timed_rec
        state_mod.present_rgba_batched = timed_present
        rows, present, p_args = [], [], None
        try:
            for t, buf in enumerate(tags):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dec.decode_next_picture(buf)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                stage = marks["parsed"].elapsed_time(marks["k0"])
                kern = marks["k0"].elapsed_time(marks["k1"])
                hdr, parse = marks["hdr"] * 1e3, marks["parse"] * 1e3
                rows.append((wall, hdr, parse, stage, kern,
                             wall - hdr - parse - stage - kern))
                if t == len(tags) - 1:
                    p_args = marks["args"]
                t0 = time.perf_counter()
                dec.last_picture_rgba()
                present.append(((time.perf_counter() - t0) * 1e3,
                                marks["p0"].elapsed_time(marks["p1"])))
        finally:
            state_mod.decode_picture, state_mod.parse_frame_auto = \
                hdr_fn, parse_fn
            recon_mod.reconstruct_from_dense = rec_fn
            state_mod.present_rgba_batched = pres_fn
        ps = [r for t, r in enumerate(rows) if t]      # P-frames
        mean = [sum(c) / len(ps) for c in zip(*ps)]
        log(f"single {name}: frame ms (wall, header, native parse, dense "
            f"build + H2D, reconstruct wrapper + kernel, rest) I "
            f"{[round(v, 3) for v in rows[0]]}"
            f", P mean {[round(v, 3) for v in mean]}, P walls "
            f"{[round(r[0], 3) for r in ps]}; last_picture_rgba ms (call "
            f"with D2H, present wrapper + kernel) "
            f"{[(round(a, 3), round(b, 3)) for a, b in present]}")
        # Loops: a fresh decoder over the fixture, N passes, decode only
        # (one synchronise at the end) and with a present every frame.
        for with_present in (False, True):
            passes = max(2, 240 // len(tags))
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(passes):
                dec = H263Decoder(opts, device=DEVICE)
                for buf in tags:
                    dec.decode_next_picture(buf)
                    if with_present:
                        dec.last_picture_rgba()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"single {name}: {passes * len(tags) / dt:.1f} frames/s "
                f"{'with' if with_present else 'without'} presentation "
                f"({passes} passes of {len(tags)} frames); peak device "
                f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        # The kernel at S=1 on the last frame's inputs, against its bytes:
        # launched bare back to back, and through its wrapper.
        a, k = p_args
        ms = raw_reconstruct_ms(torch, a, k["out_hw"])
        wrapped = cuda_ms(lambda: reconstruct_cuda.reconstruct_from_dense_cuda(
            *a, **k), 200)
        out_bytes = sum(int(np.prod(s)) for s in plane_shapes(*k["out_hw"]))
        nbytes = sum(x.numel() * x.element_size() for x in a) + out_bytes
        log(f"single {name}: reconstruct kernel at S=1 {ms * 1e3:.2f} us "
            f"a launch ({wrapped * 1e3:.2f} us a call through its wrapper, "
            f"host-bound) against its bytes bound "
            f"{bytes_bound_ms(nbytes) * 1e3:.3f} us ({nbytes} B, "
            f"{a[0].shape[1]} blocks: {ms / bytes_bound_ms(nbytes):.1f}x)")


def phase_single(torch, root, streams, digests, rng):
    """Phase 13: the single-stream decoder (H263Decoder) on the card."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    n = single_corpora(torch, streams, digests)
    fixtures = single_fixtures(torch, root)
    checked, resized = single_resize(torch)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"single decoder: {n} frames of {len(digests)} corpora equal the "
        f"reference digests (planes and RGBA); {sum(len(v[0]) for v in fixtures.values())} "
        f"fixture frames; the resize sequence with {checked} kernel calls "
        f"held against the plain version, {resized} of them at a reference "
        f"of other dims; launches {launches}")
    if min(launches[k] for k in SINGLE_PATH) < 1:
        fail("a kernel of the single-stream path was not launched")
    if any(v for k, v in launches.items() if k not in SINGLE_PATH):
        fail("the single-stream path launched a kernel outside it")
    single_vs_batched(torch, fixtures)
    del fixtures
    err = resize_kernel_cases(torch, rng)
    single_checkpoints(torch, root, streams)
    single_cli(torch, root)
    single_readings(torch, root)
    log(f"phase 13 done in {time.perf_counter() - t_phase:.1f} s")
    return launches, err


# -- phase 14: stream sharding over a mesh of cards ---------------------------

MESH_LOOPS = 3            # GOPs of a back-to-back loop of phase 14


def sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def on_first(torch, x):
    """A decoder's output on cuda:0 (StreamShards gathered)."""
    from h263_tpu_torch import StreamShards

    return x.gather("cuda:0") if isinstance(x, StreamShards) else x


def mesh_lists(streams, S, n_shards, damage=True):
    """(lane names, the GOP's lists of S buffers, damaged lanes) for a mesh
    of `n_shards` shards: in every shard, local lanes 1-2 carry the ffmpeg
    fixture, 3-4 the FMA sequence, the rest the 16 CIF corpora cycled.
    With `damage`, every shard's first lane is cut and its last lane
    byte-flipped after the header in every P-frame, and the last shard's
    lane 5 is a header reject in frame 5."""
    k = S // n_shards
    names = ["fixture" if i % k in (1, 2) else "fma" if i % k in (3, 4)
             else f"c{i % k % N_CORPORA}" for i in range(S)]
    lists = [[streams[n][t] for n in names] for t in range(GOP)]
    damaged = set()
    if damage:
        rng = np.random.default_rng(SEED + 14)
        for lo in range(0, S, k):
            damaged |= {lo, lo + k - 1}
            for t in range(1, GOP):
                f = lists[t][lo]
                lists[t][lo] = f[:len(f) // 2]
                b = bytearray(lists[t][lo + k - 1])
                b[int(rng.integers(8, len(b)))] ^= int(rng.integers(1, 256))
                lists[t][lo + k - 1] = bytes(b)
        damaged.add(S - k + 5)
        lists[5][S - k + 5] = b"\x00\x01garbage"
    return names, lists, damaged


def mesh_sampled(mesh):
    """Undamaged lanes of every shard covering every stream: local lanes
    1 (fixture), 3 (FMA) and 8-23 (the 16 corpora)."""
    return [k * S_MAIN + j for k in range(mesh.size)
            for j in (1, 3, *range(8, 8 + N_CORPORA))]


def check_digests(torch, planes, names, sampled, digests, t, tag):
    idx = torch.tensor(sampled, device="cuda:0")
    kept = [p.index_select(0, idx).cpu().numpy() for p in planes]
    from h263_tpu_torch.testing.corpora import planes_digest

    for j, lane in enumerate(sampled):
        if planes_digest(*(q[j] for q in kept)) != \
                digests[names[lane]]["planes"][t]:
            fail(f"{tag}: lane {lane} frame {t} differs from the reference "
                 f"digest")


class Counted:
    """Launch counts summed over the runs it wraps (the main path's runs of
    phase 14): each run sets every count to 0 just before it and reads the
    counts just after it, so comparison launches in between are left
    out."""

    def __init__(self, torch):
        self.torch, self.total = torch, {}

    @contextlib.contextmanager
    def run(self):
        sync_all(self.torch)
        reset_launches()
        yield
        sync_all(self.torch)
        for k, n in read_launches().items():
            self.total[k] = self.total.get(k, 0) + n


def decode_or_error(dec, bufs, **kw):
    """decode_step's outputs, or (class, message) of its H263Error."""
    from h263_tpu_torch.types import H263Error

    try:
        return dec.decode_step(bufs, **kw), None
    except H263Error as e:
        return None, (type(e).__name__, str(e))


def mesh_device(torch, mesh, tag, streams, digests, counted):
    """(b): DeviceFrontendDecoder over the mesh against an unsharded one on
    cuda:0 at every frame (planes, statuses, the raised error), in windows
    of 4 too, present_rgba, and the sampled lanes' digests."""
    from h263_tpu_torch import DeviceFrontendDecoder, StreamShards
    from h263_tpu_torch.testing.corpora import rgba_digest
    from h263_tpu_torch.types import H263Error

    S = S_MAIN * mesh.size
    names, lists, damaged = mesh_lists(streams, S, mesh.size)
    sampled = mesh_sampled(mesh)
    ref = DeviceFrontendDecoder(S, W, H, device="cuda:0")
    want = []
    for bufs in lists:
        _, err = decode_or_error(ref, bufs)
        want.append(((ref.ref_y, ref.ref_cb, ref.ref_cr), ref.last_status,
                     err))
    want_rgba = ref.present_rgba(deblock=True)
    del ref
    dec = DeviceFrontendDecoder(S, W, H, mesh=mesh)
    errors = []
    with counted.run():
        for t, bufs in enumerate(lists):
            _, err = decode_or_error(dec, bufs)
            if not isinstance(dec.ref_y, StreamShards) or \
                    dec.ref_y.devices != mesh.devices:
                fail(f"mesh {tag}: the planes are not sharded over the mesh")
            planes = [on_first(torch, p)
                      for p in (dec.ref_y, dec.ref_cb, dec.ref_cr)]
            (wy, wcb, wcr), wst, werr = want[t]
            if err != werr:
                fail(f"mesh {tag}: frame {t} raised {err}, the unsharded "
                     f"decoder {werr}")
            if not all(torch.equal(a, b)
                       for a, b in zip(planes, (wy, wcb, wcr))):
                fail(f"mesh {tag}: frame {t}'s planes differ from the "
                     f"unsharded decoder's")
            st = on_first(torch, dec.last_status)
            if not torch.equal(st, wst):
                fail(f"mesh {tag}: frame {t}'s statuses differ")
            if t and not bool((st.index_select(0, torch.tensor(
                    sorted(damaged), device="cuda:0")) != 0).any()):
                fail(f"mesh {tag}: frame {t}: no damaged lane errored")
            check_digests(torch, planes, names, sampled, digests, t,
                          f"mesh {tag}")
            errors += [err] if err else []
        rgba = on_first(torch, dec.present_rgba(deblock=True))
    if not torch.equal(rgba, want_rgba):
        fail(f"mesh {tag}: present_rgba differs from the unsharded "
             f"decoder's")
    rgba_s = rgba.index_select(0, torch.tensor(sampled, device="cuda:0"))
    for j, lane in enumerate(sampled):
        if rgba_digest(rgba_s[j].cpu().numpy()) != \
                digests[names[lane]]["rgba"][-1]:
            fail(f"mesh {tag}: lane {lane} RGBA differs from the reference "
                 f"digest")
    if errors != [w[2] for w in want if w[2]] or len(errors) != 1 or \
            f"stream {S - S_MAIN + 5}" not in errors[0][1]:
        fail(f"mesh {tag}: the header reject raised {errors}")
    del want, want_rgba, rgba

    # Windows of 4, against the unsharded decoder's windows.
    wref = DeviceFrontendDecoder(S, W, H, device="cuda:0")
    wdec = DeviceFrontendDecoder(S, W, H, mesh=mesh)
    for w0 in range(0, GOP, 4):
        outs = []
        for d in (wref, wdec):
            try:
                # The frames of a window that raised are not returned: its
                # last frame's planes are the decoder's references.
                planes = d.decode_steps(lists[w0:w0 + 4])
                err = None
            except H263Error as e:
                planes = (d.ref_y, d.ref_cb, d.ref_cr)
                err = (type(e).__name__, str(e))
            outs.append((err, on_first(torch, d.last_status_steps),
                         [on_first(torch, p) for p in planes]))
        if wdec.last_status_steps.axis != 1:
            fail(f"mesh {tag}: a window's statuses are not split along the "
                 f"stream axis")
        (e0, s0, p0), (e1, s1, p1) = outs
        if e0 != e1 or not torch.equal(s0, s1) or not all(
                torch.equal(a, b) for a, b in zip(p0, p1)):
            fail(f"mesh {tag}: the window of frames {w0}-{w0 + 3} differs "
                 f"from the unsharded decoder's ({e0} / {e1})")
    if wref.fetch_status().tolist() != wdec.fetch_status().tolist():
        fail(f"mesh {tag}: fetch_status differs after the windows")
    log(f"mesh {tag}: DeviceFrontendDecoder({S}, {W}, {H}, mesh) over {GOP} "
        f"frames equal to the unsharded decoder on cuda:0 at every frame "
        f"(planes, statuses, the raised {errors[0][0]} with its global "
        f"stream {S - S_MAIN + 5}), in windows of 4 too, present_rgba "
        f"equal; {len(sampled)} sampled lanes equal the reference digests; "
        f"{len(damaged)} damaged lanes at the shards' edges")


def mesh_host(torch, mesh, tag, streams, counted):
    """(c): BatchedStreamDecoder over the mesh equal at every frame to the
    device front-end over the mesh on clean lanes (the dry run's
    devfe-vs-host check), with a forced MV-row flip and a PackOverflow
    replay."""
    from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder
    from h263_tpu_torch.utils import trace

    S = S_MAIN * mesh.size
    _, lists, _ = mesh_lists(streams, S, mesh.size, damage=False)
    fourv = [fourv_corpus(SEED + 20 + k, 4) for k in range(4)]
    flip_lists = [[fourv[(i // 8) % 4][t] if i % 8 == 3 else lists[t][i]
                   for i in range(S)] for t in range(4)]

    def device_planes(frame_lists):
        dec = DeviceFrontendDecoder(S, W, H, mesh=mesh)
        out = [[on_first(torch, p).clone() for p in dec.decode_step(b)]
               for b in frame_lists]
        return out, on_first(torch, dec.present_rgba(deblock=True))

    want, want_rgba = device_planes(lists)
    host = BatchedStreamDecoder(S, W, H, mesh=mesh)
    with counted.run():
        for t, bufs in enumerate(lists):
            got = [on_first(torch, p) for p in host.decode_step(bufs)]
            if not all(torch.equal(a, b) for a, b in zip(got, want[t])):
                fail(f"mesh {tag} host: frame {t} differs from the device "
                     f"front-end's")
        rgba = on_first(torch, host.present_rgba(deblock=True))
    if not torch.equal(rgba, want_rgba):
        fail(f"mesh {tag} host: present_rgba differs")
    before = trace.get_counters()
    want_flip, _ = device_planes(flip_lists)
    fdec = BatchedStreamDecoder(S, W, H, mesh=mesh)
    odec = BatchedStreamDecoder(S, W, H, pack_cap=2048, mesh=mesh)
    with counted.run():
        for t, bufs in enumerate(flip_lists):
            got = [on_first(torch, p) for p in fdec.decode_step(bufs)]
            if not all(torch.equal(a, b) for a, b in zip(got, want_flip[t])):
                fail(f"mesh {tag} host: flip set frame {t} differs")
        for t in range(3):
            got = [on_first(torch, p) for p in odec.decode_step(lists[t])]
            if not all(torch.equal(a, b) for a, b in zip(got, want[t])):
                fail(f"mesh {tag} host: pack_cap=2048 frame {t} differs")
    after = trace.get_counters()
    rose = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("steps_fused_flip", "pack_overflow_fallbacks")}
    if min(rose.values()) < 1 or not fdec._mv_full:
        fail(f"mesh {tag} host: the flip or the PackOverflow replay was not "
             f"exercised ({rose})")
    log(f"mesh {tag}: BatchedStreamDecoder({S}, {W}, {H}, mesh) equal to the "
        f"device front-end over the mesh at every frame of the GOP and in "
        f"present_rgba; an MV-row flip set over 4 frames and pack_cap=2048 "
        f"over 3 frames equal too; counters rose {rose}")


def mesh_standard(torch, mesh, tag, streams, digests, counted):
    """(d): a standard-H.263 GOP (DecoderOption.NONE) on both mesh
    decoders, against the unsharded device front-end on cuda:0."""
    from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder
    from h263_tpu_torch.types import DecoderOption

    NONE = DecoderOption.NONE
    S = S_MAIN * mesh.size
    names = [f"s{(i // 8) % N_STD}" for i in range(S)]
    lists = [[streams[n][t] for n in names] for t in range(GOP)]
    sampled = [8 * m for m in range(N_STD)] + [S - 1]
    decs = [DeviceFrontendDecoder(S, W, H, NONE, device="cuda:0"),
            DeviceFrontendDecoder(S, W, H, NONE, mesh=mesh),
            BatchedStreamDecoder(S, W, H, NONE, mesh=mesh)]
    for t, bufs in enumerate(lists):
        want = [p.clone() for p in decs[0].decode_step(bufs)]
        check_digests(torch, want, names, sampled, digests, t,
                      f"mesh {tag} standard")
        with counted.run():
            got = [[on_first(torch, p) for p in d.decode_step(bufs)]
                   for d in decs[1:]]
        for d, g in zip(decs[1:], got):
            if not all(torch.equal(a, b) for a, b in zip(g, want)):
                fail(f"mesh {tag} standard: {type(d).__name__} frame {t} "
                     f"differs from the unsharded device front-end")
    log(f"mesh {tag}: standard H.263 at S={S} CIF, both mesh decoders equal "
        f"to the unsharded device front-end at every frame; "
        f"{len(sampled)} sampled lanes equal the reference digests")


def mesh_split(torch, mesh, tag, streams):
    """(f) Where a mesh P-step's host time goes: each shard's prep and
    copy, then each shard's dispatch (host clock; CUDA events around each
    shard's device work on its card)."""
    from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder
    from h263_tpu_torch.decoder import reconstruct as rec
    from h263_tpu_torch.parser import automaton_cuda

    S = S_MAIN * mesh.size
    _, lists, _ = mesh_lists(streams, S, mesh.size, damage=False)
    dec = DeviceFrontendDecoder(S, W, H, mesh=mesh)
    for bufs in lists[:-1]:
        dec.decode_step(bufs)
    stage, step = dec._stage_step, automaton_cuda.whole_step
    marks = {"prep": [], "dispatch": [], "events": []}

    def timed_stage(sh, bufs):
        t0 = time.perf_counter()
        out = stage(sh, bufs)
        marks["prep"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_step(payload, *args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(payload.device):
            a.record()
            t0 = time.perf_counter()
            out = step(payload, *args, **kw)
            marks["dispatch"].append((time.perf_counter() - t0) * 1e3)
            b.record()
        marks["events"].append((a, b))
        return out

    dec._stage_step = timed_stage
    automaton_cuda.whole_step = timed_step
    try:
        for _ in range(3):
            for v in marks.values():
                v.clear()
            sync_all(torch)
            t0 = time.perf_counter()
            dec.decode_step(lists[-1])
            sync_all(torch)
            wall = (time.perf_counter() - t0) * 1e3
            dev = [a.elapsed_time(b) for a, b in marks["events"]]
            log(f"mesh {tag} split: a P-step {wall:.2f} ms wall; per shard, "
                f"host prep + copy ms {[round(x, 3) for x in marks['prep']]}"
                f", dispatch ms {[round(x, 3) for x in marks['dispatch']]}, "
                f"device ms (automaton + reconstruct) "
                f"{[round(x, 3) for x in dev]}")
    finally:
        del dec._stage_step
        automaton_cuda.whole_step = step

    # The host front-end's mesh step: the one parse, then each shard's
    # copy and dispatch (unpack + reconstruct).
    fused = rec.reconstruct_frame_packed_d24_fused
    marks = {"dispatch": []}

    def timed_fused(buf, *args, **kw):
        t0 = time.perf_counter()
        out = fused(buf, *args, **kw)
        marks["dispatch"].append((time.perf_counter() - t0) * 1e3)
        return out

    rec.reconstruct_frame_packed_d24_fused = timed_fused
    try:
        host = BatchedStreamDecoder(S, W, H, mesh=mesh)
        for bufs in lists[:-1]:
            host.decode_step(bufs)
        parse, transfer = host.parse_batch_packed, host._transfer

        def timed_parse(*args, **kw):
            t0 = time.perf_counter()
            parse(*args, **kw)
            marks["parse"] = (time.perf_counter() - t0) * 1e3

        def timed_transfer(*args, **kw):
            t0 = time.perf_counter()
            out = transfer(*args, **kw)
            marks["transfer"] = (time.perf_counter() - t0) * 1e3
            return out

        host.parse_batch_packed, host._transfer = timed_parse, timed_transfer
        for _ in range(3):
            marks["dispatch"].clear()
            sync_all(torch)
            t0 = time.perf_counter()
            host.decode_step(lists[-1])
            sync_all(torch)
            wall = (time.perf_counter() - t0) * 1e3
            log(f"mesh {tag} host split: a P-step {wall:.2f} ms wall; the "
                f"native parse of {S} frames {marks['parse']:.2f} ms, the "
                f"shards' copies enqueued {marks['transfer']:.3f} ms, per "
                f"shard dispatch ms "
                f"{[round(x, 3) for x in marks['dispatch']]}")
    finally:
        rec.reconstruct_frame_packed_d24_fused = fused


def mesh_rates(torch, meshes, streams):
    """(f) Back-to-back frames/s of each mesh and of the unsharded decoder
    at the same S, in turns: on one card the cost of sharding, over
    several the scaling."""
    from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder

    for tag, mesh in meshes:
        S = S_MAIN * mesh.size
        _, lists, _ = mesh_lists(streams, S, mesh.size, damage=False)
        decs = {}
        for kind, cls in (("device", DeviceFrontendDecoder),
                          ("host", BatchedStreamDecoder)):
            decs[(kind, "mesh")] = cls(S, W, H, mesh=mesh)
            decs[(kind, "unsharded")] = cls(S, W, H, device="cuda:0")
        rates = {k: [] for k in decs}
        for kind in ("device", "host"):
            loops = MESH_LOOPS if kind == "device" else 1
            for which in ("mesh", "unsharded", "unsharded", "mesh"):
                dec = decs[(kind, which)]
                sync_all(torch)
                t0 = time.perf_counter()
                for _ in range(loops):
                    for bufs in lists:
                        dec.decode_step(bufs)
                sync_all(torch)
                rates[(kind, which)].append(round(
                    loops * GOP * S / (time.perf_counter() - t0), 1))
        log(f"mesh {tag} rates: back to back, S={S} CIF, frames/s in turns "
            f"(mesh, unsharded, unsharded, mesh): device front-end mesh "
            f"{rates[('device', 'mesh')]}, unsharded on cuda:0 "
            f"{rates[('device', 'unsharded')]}; host front-end mesh "
            f"{rates[('host', 'mesh')]}, unsharded "
            f"{rates[('host', 'unsharded')]}")
        del decs


def second_card(torch, streams, rng):
    """(e) With two cards or more: decoders on cuda:1 equal cuda:0's at
    every frame (cuda:0 current), and each kernel's launch on cuda:1 equal
    to its plain version (not counted)."""
    from h263_tpu_torch import (BatchedStreamDecoder, DeviceFrontendDecoder,
                                H263Decoder)
    from h263_tpu_torch.native import DevicePrepBatch
    from h263_tpu_torch.ops import (d24_cuda, deblock_cuda, idct_cuda,
                                    present_cuda, reconstruct_cuda, yuv_cuda)
    from h263_tpu_torch.ops.d24 import unpack_fused
    from h263_tpu_torch.ops.deblock import deblock_batched
    from h263_tpu_torch.ops.idct import idct_residual_fused
    from h263_tpu_torch.ops.present import present_rgba_plain
    from h263_tpu_torch.ops.reconstruct import reconstruct_from_dense_plain
    from h263_tpu_torch.ops.yuv import yuv420_to_rgba
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.parser import device_frontend as tdf
    from h263_tpu_torch.testing.corpora import d24_rows
    from h263_tpu_torch.types import DecoderOption

    one = torch.device("cuda:1")
    if torch.cuda.current_device() != 0:
        fail("cuda:0 is not the current device")
    for cls in (DeviceFrontendDecoder, BatchedStreamDecoder):
        # The host front-end refuses a step with a damaged lane whole.
        _, lists, _ = mesh_lists(streams, S_MAIN, 1,
                                 damage=cls is DeviceFrontendDecoder)
        decs = [cls(S_MAIN, W, H, device=d) for d in ("cuda:0", "cuda:1")]
        for t, bufs in enumerate(lists):
            outs = [decode_or_error(d, bufs) for d in decs]
            if outs[0][1] != outs[1][1]:
                fail(f"cuda:1 {cls.__name__}: frame {t} raised "
                     f"{outs[1][1]}, cuda:0 {outs[0][1]}")
            planes = [[p.to("cuda:0") for p in (d.ref_y, d.ref_cb, d.ref_cr)]
                      for d in decs]
            if decs[1].ref_y.device != one or not all(
                    torch.equal(a, b) for a, b in zip(*planes)):
                fail(f"cuda:1 {cls.__name__}: frame {t} differs from cuda:0")
    singles = [H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=d)
               for d in ("cuda:0", "cuda:1")]
    for t, buf in enumerate(streams["fixture"]):
        pics = [d.decode_next_picture(buf) for d in singles]
        if not all(np.array_equal(a, b) for a, b in
                   zip(pics[0].as_yuv(), pics[1].as_yuv())):
            fail(f"cuda:1 H263Decoder: frame {t} differs from cuda:0")

    errs = {}
    c = torch.as_tensor(idct_blocks(4096, rng).reshape(-1, 64))
    errs["idct_residual"] = max_err(torch, idct_cuda.idct_residual_cuda(
        c.to(one)).cpu(), idct_residual_fused(c))
    S, (h, w) = 16, ODD
    mbh, mbw = -(-h // 16), -(-w // 16)
    dense = torch.as_tensor(rng.integers(-300, 300, (S, 6 * mbh * mbw, 64))
                            .astype(np.int16))
    dense[:, ::2] = 0
    mvs = torch.as_tensor(rng.integers(-40, 41, (S, mbh, mbw, 4, 2))
                          .astype(np.int16))
    inter = torch.as_tensor(rng.random((S, mbh, mbw)) < 0.7)
    planes = [torch.as_tensor(blocky_planes(rng, S, *hw))
              for hw in plane_shapes(h, w)]
    args = (dense, mvs, inter, *planes)
    got = reconstruct_cuda.reconstruct_from_dense_cuda(
        *(a.to(one) for a in args))
    errs["reconstruct"] = max(max_err(torch, a.cpu(), b) for a, b in zip(
        got, reconstruct_from_dense_plain(*args)))
    strength = torch.as_tensor(rng.integers(0, 13, S).astype(np.int32))
    apply = torch.as_tensor(rng.random(S) < 0.7)
    errs["deblock"] = max_err(torch, deblock_cuda.deblock_batched_cuda(
        planes[0].to(one), strength.to(one), apply.to(one)).cpu(),
        deblock_batched(planes[0], strength, apply))
    errs["yuv420_to_rgba"] = max_err(torch, yuv_cuda.yuv420_to_rgba_cuda(
        *(p.to(one) for p in planes)).cpu(), yuv420_to_rgba(*planes))
    errs["present_rgba"] = max_err(torch, present_cuda.present_rgba_cuda(
        *(p.to(one) for p in planes), strength.to(one), apply.to(one)).cpu(),
        present_rgba_plain(*planes, strength, apply))
    rows = torch.as_tensor(d24_rows(rng, S, 900, mbh, mbw, True))
    errs["d24_unpack"] = max(max_err(torch, a.cpu(), b) for a, b in zip(
        d24_cuda.unpack_fused_cuda(rows.to(one), mbh, mbw, True),
        unpack_fused(rows, mbh, mbw, True)))
    frames = [streams[f"q{k % N_QCIF_CORPORA}"][k % GOP] for k in range(16)]
    frames[5] = frames[5][:len(frames[5]) // 2]
    prep = DevicePrepBatch(len(frames), 176, 144)
    total = sum(((len(f) + 3) // 4) * 4 for f in frames)
    stage = np.zeros((total // 4 + 1, 4), np.uint8)
    meta = np.zeros((6, len(frames)), np.int32)
    prep.prepare_ragged(frames, stage, meta)
    stage, meta = torch.as_tensor(stage), torch.as_tensor(meta)
    got = automaton_cuda.parse_assemble_cuda(stage.to(one), meta.to(one),
                                             mbh=9, mbw=11)
    want = tdf.parse_assemble(stage, meta, mbh=9, mbw=11)
    errs["entropy_automaton"] = max(max_err(torch, a.cpu().to(b.dtype), b)
                                    for a, b in zip(got, want))
    if torch.cuda.current_device() != 0 or any(errs.values()):
        fail(f"kernels on cuda:1 against their plain versions: {errs}")
    log(f"cuda:1: DeviceFrontendDecoder ({S_MAIN} CIF streams, damaged "
        f"lanes), BatchedStreamDecoder (clean lanes) and H263Decoder (the "
        f"CIF fixture) equal "
        f"cuda:0's at every frame with cuda:0 current; every kernel on "
        f"cuda:1 equals its plain version (max |error| {errs})")


def phase_mesh(torch, streams, digests, rng):
    """Phase 14: both batched decoders over a mesh, a two-shard mesh on
    cuda:0 and, with two cards or more, a mesh over every card; returns the
    launches of its main-path runs."""
    from h263_tpu_torch import make_stream_mesh

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    meshes = [("2 shards on cuda:0", make_stream_mesh(["cuda:0", "cuda:0"]))]
    if n_cards >= 2:
        meshes.append((f"{n_cards} cards", make_stream_mesh()))
    for tag, mesh in meshes:
        log(f"mesh {tag}: {mesh.size} shards of {S_MAIN} CIF streams over "
            f"{mesh.distinct} distinct card(s) "
            f"({', '.join(map(str, mesh.devices))})")
    plain = {k: v[2] for k, v in streams.items()}
    counted = Counted(torch)
    for tag, mesh in meshes:
        mesh_device(torch, mesh, tag, plain, digests, counted)
        mesh_host(torch, mesh, tag, plain, counted)
        mesh_standard(torch, mesh, tag, plain, digests, counted)
    log(f"mesh: launches of the mesh decoders' runs {counted.total}")
    if min(counted.total[k] for k in ("entropy_automaton", "reconstruct",
                                      "present_rgba", "d24_unpack")) < 1:
        fail("a kernel of the mesh paths was not launched")
    if n_cards >= 2:
        second_card(torch, plain, rng)
    else:
        log("mesh: one card on this machine: the mesh over every card and "
            "the cuda:1 checks do not run")
    for tag, mesh in meshes:
        mesh_split(torch, mesh, tag, plain)
    mesh_rates(torch, meshes, plain)
    log(f"phase 14 done in {time.perf_counter() - t_phase:.1f} s")
    return counted.total


# Phase 15: the fuzz library (h263_tpu_torch/testing/fuzz.py) on the card.
# (flavor, seed, bases, mutants a base); "fused" counts scenarios.  The
# seeds are the JAX tests'.
FUZZ_CAMPAIGNS = [
    ("sorenson", 20260816, 100, 10),
    ("standard", 8, 100, 10),
    ("umv", 17, 100, 10),
    ("d24", 3, 100, 10),
    ("device", 11, 100, 10),
    ("device_std", 51, 100, 10),
    ("device_umv", 71, 100, 10),
    ("fused", 31, 80, 0),
]
FUZZ_KERNELS = {"d24": ("d24_unpack",), "device": ("entropy_automaton",),
                "device_std": ("entropy_automaton",),
                "device_umv": ("entropy_automaton",),
                "fused": ("d24_unpack", "entropy_automaton", "reconstruct")}
FUZZ_CIF_BASES = 264      # alternately device and device_std bases
FUZZ_CIF_MUTANTS = 15     # 264 * 16 = 4224 lanes
FUZZ_SMALL = 1024         # lanes of the first launch, rows of the d24 launch
FUZZ_SEED = 15


def fuzz_campaigns(torch, counted, smi):
    """(a) every flavor's campaign on the card; fails on any mismatch."""
    from h263_tpu_torch.testing import fuzz

    for flavor, seed, n, m in FUZZ_CAMPAIGNS:
        failures, notes = [], {}
        before = dict(counted.total)
        t0 = time.perf_counter()
        with counted.run():
            total, fails = fuzz.run_campaign(
                seed=seed, n_base=n, mutations_per_base=m, flavor=flavor,
                device=DEVICE, notes=notes,
                on_fail=lambda tag, why: failures.append((tag, why)))
        secs = time.perf_counter() - t0
        got = {k: counted.total.get(k, 0) - before.get(k, 0)
               for k in FUZZ_KERNELS.get(flavor, ())}
        log(f"fuzz {flavor}: {total} cases, {fails} mismatches, skips "
            f"{dict(notes)}, {secs:.2f} s, {total / secs:.1f} cases/s; "
            f"launches {got} ({smi})")
        if fails:
            fail(f"fuzz {flavor}: {fails} mismatches, first "
                 f"{failures[:3]}")
        if any(v < 1 for v in got.values()):
            fail(f"fuzz {flavor}: a kernel of the flavor was not launched")


def fuzz_cif_cases(rng):
    """(b) fuzzed CIF lanes: FUZZ_CIF_BASES bases of the device and
    device_std generators in turn, each followed by FUZZ_CIF_MUTANTS
    mutants (a splice takes another base's frame)."""
    from h263_tpu_torch.testing import fuzz

    bases = []
    for k in range(FUZZ_CIF_BASES):
        bases += fuzz._cases_for(("device", "device_std")[k % 2], rng, 1, 0,
                                 W, H)
    cases = []
    for base in bases:
        cases.append(base)
        for _ in range(FUZZ_CIF_MUTANTS):
            cases.append((fuzz._mutate(
                rng, base[0],
                lambda: bases[int(rng.integers(len(bases)))][0]),
                *base[1:]))
    return cases


def fuzz_cif_lanes(torch, counted, smi, cases):
    """(b) the automaton over the CIF cases in one launch of FUZZ_SMALL
    lanes and one of all of them, every lane against the host parse of its
    case: the native parse, or the Python parse for a lane under carried
    MODIFIED_QUANTIZATION (the native parser has no MQ flag, ROADMAP Queue
    3).  Returns the status histogram by class."""
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.testing import fuzz
    from h263_tpu_torch.types import PictureOption

    t0 = time.perf_counter()
    refs = []
    payload, meta, preps = fuzz.device_lanes(cases, W, H)
    for (buf, opts, _, pic), prep in zip(cases, preps):
        if prep is None:
            refs.append(None)
            continue
        mq = bool(prep[1] & PictureOption.MODIFIED_QUANTIZATION)
        fn = fuzz._outcome_python if mq else fuzz._outcome_native
        refs.append((fuzz._outcome(fn, buf, W, H, opts, prep[1], pic),
                     "python" if mq else "native"))
    host_s = time.perf_counter() - t0
    outs = {}
    for n in (FUZZ_SMALL, len(cases)):
        p, m, _ = fuzz.device_lanes(cases[:n], W, H)
        pt, mt = torch.as_tensor(p).to(DEVICE), torch.as_tensor(m).to(DEVICE)
        with counted.run():
            got = automaton_cuda.parse_assemble_cuda(
                pt, mt, mbh=H // 16, mbw=W // 16, width=W, height=H)
        ms = cuda_ms(lambda: automaton_cuda.parse_assemble_cuda(
            pt, mt, mbh=H // 16, mbw=W // 16, width=W, height=H), 3)
        outs[n] = tuple(t.cpu().numpy() for t in got)
        log(f"fuzz CIF lanes: one automaton launch over {n} lanes, "
            f"{ms:.3f} ms a call ({smi})")
        del pt, mt, got
    small, big = outs[FUZZ_SMALL], outs[len(cases)]
    for name, a, b in zip(("dense", "mvs", "inter", "status"), small, big):
        if not np.array_equal(a, b[:FUZZ_SMALL]):
            fail(f"fuzz CIF lanes: {name} of the first {FUZZ_SMALL} lanes "
                 f"of the {len(cases)}-lane launch differs from the "
                 f"{FUZZ_SMALL}-lane launch")
    dense, mvs, inter, status = big
    hist, bad = {}, []
    for k, (ref, st) in enumerate(zip(refs, status)):
        if ref is None:
            hist["header-reject"] = hist.get("header-reject", 0) + 1
            continue
        ok, why = fuzz.device_verdict(ref[0], dense[k], mvs[k], inter[k],
                                      int(st), host=ref[1])
        if not ok:
            bad.append((k, why))
        cls = fuzz.status_error_class(int(st))
        key = "ok" if st == 0 else cls.__name__ if cls else f"status {st}"
        hist[key] = hist.get(key, 0) + 1
    log(f"fuzz CIF lanes: {len(cases)} lanes ({FUZZ_CIF_BASES} bases x "
        f"{FUZZ_CIF_MUTANTS + 1}), {len(bad)} differ from the host parse; "
        f"statuses by class {hist}; host parses {host_s:.2f} s ({smi})")
    if bad:
        fail(f"fuzz CIF lanes: {len(bad)} lanes differ from the host parse, "
             f"first {bad[:3]}")
    errors = [k for k in hist if k not in ("ok", "header-reject")]
    if not hist.get("ok") or len(errors) < 5:
        fail(f"fuzz CIF lanes: the set must hold ok lanes and errored lanes "
             f"of at least 5 classes: {hist}")
    return hist


def fuzz_plain(torch, smi):
    """(b) one automaton launch over all the lanes of (a)'s "device"
    campaign (96x80) against its plain version on the card."""
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.parser.device_frontend import parse_assemble
    from h263_tpu_torch.testing import fuzz

    seed, n, m = next((s, n, m) for f, s, n, m in FUZZ_CAMPAIGNS
                      if f == "device")
    cases = fuzz._cases_for("device", np.random.default_rng(seed), n, m, 96,
                            80)
    p, m, _ = fuzz.device_lanes(cases, 96, 80)
    pt, mt = torch.as_tensor(p).to(DEVICE), torch.as_tensor(m).to(DEVICE)
    got = automaton_cuda.parse_assemble_cuda(pt, mt, mbh=5, mbw=6, width=96,
                                             height=80)
    t0 = time.perf_counter()
    want = parse_assemble(pt, mt, mbh=5, mbw=6, width=96, height=80)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max(max_err(torch, a, b) for a, b in zip(got, want))
    log(f"fuzz plain: {len(cases)} lanes at 96x80, the kernel against the "
        f"plain automaton on the card: max_abs_err={err} (dense, MVs, INTER, "
        f"status); plain {plain_s:.1f} s ({smi})")
    if err:
        fail("fuzz plain: the automaton kernel differs from its plain "
             "version on the device campaign's lanes")


def fuzz_d24(torch, counted, smi, cases):
    """(c) the d24 rows of the CIF Sorenson cases (the d24 flavor's
    generator) in one unpack launch of FUZZ_SMALL rows, against the plain
    unpack on the card and the Python dense front-end."""
    from h263_tpu_torch.ops.d24 import d24_to_dense
    from h263_tpu_torch.ops.d24_cuda import d24_to_dense_cuda
    from h263_tpu_torch.testing import fuzz
    from h263_tpu_torch.types import DecoderOption, PictureOption

    sor = [c[0] for c in cases
           if c[1] & DecoderOption.SORENSON_SPARK_BITSTREAM][:FUZZ_SMALL]
    if len(sor) < FUZZ_SMALL:
        fail(f"fuzz d24: {len(sor)} Sorenson CIF cases, {FUZZ_SMALL} needed")
    emits = [fuzz.d24_emit(b, W, H) for b in sor]
    rows = torch.as_tensor(np.stack([e[0] for e in emits])).to(DEVICE)
    with counted.run():
        dense = d24_to_dense_cuda(rows, H // 16, W // 16)
    ms = cuda_ms(lambda: d24_to_dense_cuda(rows, H // 16, W // 16), 10)
    err = max_err(torch, dense, d24_to_dense(rows, H // 16, W // 16))
    dense = dense.cpu().numpy()
    t0 = time.perf_counter()
    bad, notes = [], {}
    for k, (buf, e) in enumerate(zip(sor, emits)):
        py = fuzz._outcome(fuzz._outcome_python, buf, W, H,
                           DecoderOption.SORENSON_SPARK_BITSTREAM,
                           PictureOption.NONE)
        ok, why = fuzz.d24_verdict(py, e, dense[k])
        if not ok:
            bad.append((k, why))
        notes[e[4] or "ok"] = notes.get(e[4] or "ok", 0) + 1
    log(f"fuzz d24: one unpack launch over {len(sor)} CIF rows of "
        f"{rows.shape[1]} bytes, {ms:.3f} ms a call; max_abs_err={err} "
        f"against the plain unpack on the card; {len(bad)} rows differ from "
        f"the Python dense front-end (outcomes {notes}; Python parses "
        f"{time.perf_counter() - t0:.1f} s) ({smi})")
    if err or bad:
        fail(f"fuzz d24: rows differ, first {bad[:3]}")


def phase_fuzz(torch):
    """Phase 15: the fuzz library on the card; returns the launches of its
    counted runs (every campaign, the two CIF automaton launches, the d24
    launch)."""
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    counted = Counted(torch)
    fuzz_campaigns(torch, counted, smi)
    t0 = time.perf_counter()
    cases = fuzz_cif_cases(np.random.default_rng(FUZZ_SEED))
    log(f"fuzz CIF lanes: {len(cases)} cases drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    fuzz_cif_lanes(torch, counted, smi, cases)
    fuzz_plain(torch, smi)
    fuzz_d24(torch, counted, smi, cases)
    log(f"fuzz: launches of phase 15's counted runs {counted.total}")
    if min(counted.total.get(k, 0) for k in ("entropy_automaton",
                                              "d24_unpack",
                                              "reconstruct")) < 1:
        fail("a kernel of the fuzz phase was not launched")
    log(f"phase 15 done in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return counted.total


def load_streams(root):
    """(streams: name -> (width, height, frames), the CIF fixture's golden
    luma, the reference digests) of every phase."""
    from h263_tpu_torch.testing import corpora as C

    streams = {f"c{k}": (W, H, C.cif_corpus(k)) for k in range(N_CORPORA)}
    streams.update({f"q{k}": (176, 144, C.qcif_corpus(k))
                    for k in range(N_QCIF_CORPORA)})
    fix = os.path.join(root, "tests", "fixtures")
    streams["fixture"] = (W, H, C.fixture_frames(
        os.path.join(fix, "ffmpeg_flv1_cif.flv")))
    streams["fma"] = (W, H, C.fma_sequence(W, H, GOP))
    streams.update({f"s{k}": (W, H, C.std_corpus(k)) for k in range(N_STD)})
    streams["sq0"] = (176, 144, C.std_qcif_corpus())
    streams["u0"] = (W, H, C.umv_corpus(W, H, GOP))
    streams["d0"] = (176, 144, C.d3_corpus(176, 144, GOP))
    golden = np.load(os.path.join(fix, "ffmpeg_flv1_cif_golden.npz"))["luma"]
    if len(streams["fixture"][2]) != GOP:
        fail(f"CIF fixture has {len(streams['fixture'][2])} frames, expected "
             f"{GOP}")
    digests = C.load_digests()
    missing = sorted(set(streams) - set(digests))
    if missing:
        fail(f"no reference digests for {missing}")
    return streams, golden, digests


# Run with a checkout as the working directory: that checkout's own
# `split_calls` over its own decoder, as phase 5 splits a P-step.
SPLIT_CHILD = """
import sys, torch
import chip_smoke
from h263_tpu_torch import DeviceFrontendDecoder
from h263_tpu_torch.testing import corpora as C
gops = [C.cif_corpus(k) for k in range(16)]
lists = [[gops[i % 16][t] for i in range(1024)] for t in range(8)]
dec = DeviceFrontendDecoder(1024, 352, 288, device="cuda")
for bufs in lists:
    dec.decode_step(bufs)
chip_smoke.split_calls(torch, dec, lambda: dec.decode_step(lists[-1]),
                       "one P-frame step", n=int(sys.argv[1]))
"""


def split_ab(dirs, n=10) -> int:
    """The one-card main path of several checkouts, in the order given
    (for an A/B: parent, change, change, parent): in each, a P-step of
    DeviceFrontendDecoder(1024, 352, 288) split by that checkout's own
    `split_calls` (n rounds), then its `kernels/reconstruct_time.py`."""
    log(nvidia_smi_line())
    for d in dirs:
        log(f"== {d}")
        for cmd in ([sys.executable, "-c", SPLIT_CHILD, str(n)],
                    [sys.executable, "-m",
                     "h263_tpu_torch.kernels.reconstruct_time"]):
            subprocess.run(cmd, cwd=d, check=True, timeout=900)
    return 0


def main() -> int:
    """With no arguments, every phase on one card.  `--split-ab DIR...`
    instead runs `split_ab` over the checkouts DIR...."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--split-ab"]:
        return split_ab(sys.argv[2:])
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from h263_tpu_torch import kernels, native

    smi = nvidia_smi_line()
    log(f"env: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; host: {host_cpus()}")

    t0 = time.perf_counter()
    kernels.lib()
    native.lib()
    log(f"build: kernels + native library ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {kernels.last_build_seconds})")

    rng = np.random.default_rng(SEED)
    streams, golden, digests = load_streams(root)
    cif = [streams[f"c{k}"][2] for k in range(N_CORPORA)]
    records = [phase_idct(torch, rng), phase_automaton(torch, cif, rng)]
    real, real_present = phase_decoder(
        torch, {k: v[2] for k, v in streams.items()}, golden, digests)
    records.append(phase_reconstruct(torch, rng, real))
    del real
    records += [phase_deblock(torch, rng), phase_yuv(torch, rng),
                phase_present(torch, rng, real_present)]
    del real_present
    launches = phase_pool(torch, streams, golden, digests)
    plain = {k: v[2] for k, v in streams.items()}
    for more in (phase_window(torch, plain, digests),
                 phase_pool_window(torch, streams, golden, digests)):
        for k, n in more.items():
            launches[k] += n
    record, more = phase_host(torch, plain, golden, digests)
    records.append(record)
    for more in (more, phase_pool(torch, streams, golden, digests,
                                  frontend="host")):
        for k, n in more.items():
            launches[k] += n
    std = phase_standard(torch, streams, digests)
    for more in (std["device"], std["host"],
                 phase_standard_pool(torch, streams, digests, "device"),
                 phase_standard_pool(torch, streams, digests, "host"),
                 phase_switch(torch, streams, golden, digests)):
        for k, n in more.items():
            launches[k] += n
    single, resize_err = phase_single(torch, root, streams, digests, rng)
    for more in (single, phase_mesh(torch, streams, digests, rng),
                 phase_fuzz(torch)):
        for k, n in more.items():
            launches[k] += n
    for r in records:
        if r["name"] == "reconstruct":
            r["max_abs_err"] = max(r["max_abs_err"], resize_err)
    for mod in ("jax", "h263_tpu"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    for r in records:
        r["launches"] = launches[r["name"]]
    log("library_ms is null for every kernel: no single PyTorch call computes "
        "any of these functions bit-exactly (the IDCT's strict f32 order and "
        "class paths, with or without the half-pel predictor around it; the "
        "entropy automaton; the deblock's floor and trunc zones; the 16.16 "
        "BT.601 with replicated chroma, with or without that deblock before "
        "it)")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
