#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (h263_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit, before the last line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles h263_tpu_torch/csrc/*.cu (one process per source,
     all at once) and g++ the port's native header prep, from the checkout;
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
     to back, in windows and in steps.

The kernels line's launch counts are those of phases 8, 9 and 10 (each run
with the counts set to 0 just before it).

The oracle is `h263_tpu_torch/testdata/reference_digests.json`: SHA-256
digests of the numpy reference decoder's planes and deblocked RGBA, which
`tests/test_torch_digests.py` recomputes from the reference.

Output: progress lines; a JSON line of the kernels; the nvidia-smi line; and
as the last line {"ok": true, "device": {...}}.  Imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

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


def kernel_modules():
    from h263_tpu_torch.ops import (
        deblock_cuda,
        idct_cuda,
        present_cuda,
        reconstruct_cuda,
        yuv_cuda,
    )
    from h263_tpu_torch.parser import automaton_cuda

    return {"idct_residual": idct_cuda, "entropy_automaton": automaton_cuda,
            "deblock": deblock_cuda, "yuv420_to_rgba": yuv_cuda,
            "reconstruct": reconstruct_cuda, "present_rgba": present_cuda}


class ReconstructProbe:
    """Stands in for `device_batch.reconstruct_from_dense` while installed:
    passes every call on, and on the first call with `n_streams` streams
    keeps the call's inputs and holds its planes against the earlier design
    on the same inputs, the plain reconstruction over the IDCT kernel's
    residuals (which keeps csrc/idct.cu on real main-path data)."""

    def __init__(self, torch, n_streams):
        from h263_tpu_torch.parallel import device_batch

        self.torch, self.n, self.mod = torch, n_streams, device_batch
        self.fn = device_batch.reconstruct_from_dense
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
    """Stands in for `device_batch.present_rgba_batched` while installed:
    passes every call on, and on the first call with `n_streams` streams
    holds its RGBA against the YUV kernel's over the deblock kernel's planes
    on the same inputs (which keeps csrc/deblock.cu and csrc/yuv.cu on real
    main-path data).  With `keep` it keeps that call's inputs."""

    def __init__(self, torch, n_streams, keep=False):
        from h263_tpu_torch.parallel import device_batch

        self.torch, self.n, self.mod = torch, n_streams, device_batch
        self.fn = device_batch.present_rgba_batched
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
    if (min(launches.values()) < 1 or probe.inputs is None
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
    from h263_tpu_torch.parallel import device_batch

    marks, recon_ev = {}, []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    prep, parse, recon = (dec._prep, device_batch.parse_assemble_cuda,
                          device_batch.reconstruct_from_dense)

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

    dec._prep = TimedPrep()
    device_batch.parse_assemble_cuda = timed_parse
    device_batch.reconstruct_from_dense = timed_recon
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
        dec._prep = prep
        device_batch.parse_assemble_cuda = parse
        device_batch.reconstruct_from_dense = recon


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


def phase_pool(torch, streams, golden, digests):
    """The serving pool: two buckets, churn, absence, rebucketing, growth."""
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
    pool = StreamPool(device=DEVICE)
    probe = ReconstructProbe(torch, S_MAIN)
    present_probe = PresentProbe(torch, S_MAIN)
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
                log(f"pool: a P-frame rebucket was refused ({e})")
            if pool._dims[refused] != (W, H):
                fail("the refused stream moved")
        feed = {sid: streams[name][2][cursor[sid]]
                for sid, name in seq_of.items()
                if not (sid == absent and t == absent_t)}
        t0 = time.perf_counter()
        if t == PROBE_STEP:
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
                fail(f"pool: {sid} ({name} frame {k}) at step {t} differs "
                     f"from the reference digest")
            if name == "fma" and int(y[0, 2]) != (156 if k else 128):
                fail(f"pool: FMA pixel (0,2) is {int(y[0, 2])}")
            if name == "fixture":
                check_fixture_luma(y, golden[k], f"pool step {t}")
        for sid in feed:
            cursor[sid] += 1
        t0 = time.perf_counter()
        if t == PROBE_STEP:
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
                fail(f"pool: {sid} RGBA ({name} frame {k}) at step {t} "
                     f"differs from the reference digest")
    launches = read_launches()
    peak = max(p for t, p in enumerate(peaks) if t != PROBE_STEP)
    counters = get_counters()
    qcif_n1 = pool._buckets[(176, 144)].dec.n
    log(f"pool path: launches {launches} (the IDCT kernel's, and the deblock "
        f"and YUV kernels', are step {PROBE_STEP}'s cross-checks of the CIF "
        f"bucket); counters {counters}; QCIF bucket "
        f"{qcif_n0} -> {qcif_n1} slots; CIF bucket {cif_dec.n} slots")
    if (min(launches.values()) < 1 or probe.inputs is None
            or not present_probe.checked):
        fail("a kernel of the pool path was not launched")
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
    # Rates leave out the step that carries the cross-check's second,
    # plain reconstruction.
    own = [s for t, s in enumerate(dec_s, start=1) if t != PROBE_STEP]
    pre_own = [s for t, s in enumerate(pre_s) if t != PROBE_STEP]
    log(f"pool path: {frames_done} frames over {GOP} steps, "
        f"{frames_done / sum(pool_s):.1f} frames/s, step {PROBE_STEP}'s "
        f"cross-check included (step ms "
        f"{[round(s * 1e3, 2) for s in pool_s]}); CIF bucket ({cif_dec.n} "
        f"slots): decode over steps 1-{GOP - 1} but {PROBE_STEP} "
        f"{cif_dec.n * len(own) / sum(own):.1f} frames/s (ms "
        f"{[round(s * 1e3, 2) for s in dec_s]}), present over steps 0-"
        f"{GOP - 1} but {PROBE_STEP} "
        f"{cif_dec.n * len(pre_own) / sum(pre_own):.1f} frames/s (ms "
        f"{[round(s * 1e3, 2) for s in pre_s]}, step {PROBE_STEP} with the "
        f"cross-check); the rest of each pool step"
        f" (QCIF bucket, headers, rebucketing) ms {rest_ms}; present_rgba "
        f"of the whole "
        f"pool ms {[round(s * 1e3, 2) for s in present_s]} (the views of "
        f"a {cif_dec.n}-frame batch alone: {views_ms:.2f} ms); peak device "
        f"memory of a step with its present {peak / 2**30:.2f} GiB "
        f"({peaks[PROBE_STEP] / 2**30:.2f} GiB at step {PROBE_STEP}, with "
        f"the cross-check); {len(sampled)} sampled streams "
        f"equal the reference digests every frame (planes and RGBA)")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from h263_tpu_torch import kernels, native
    from h263_tpu_torch.testing import corpora as C

    smi = nvidia_smi_line()
    log(f"env: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    kernels.lib()
    native.lib()
    log(f"build: kernels + native prep ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {kernels.last_build_seconds})")

    rng = np.random.default_rng(SEED)
    cif = [C.cif_corpus(k) for k in range(N_CORPORA)]
    streams = {f"c{k}": (W, H, cif[k]) for k in range(N_CORPORA)}
    streams.update({f"q{k}": (176, 144, C.qcif_corpus(k))
                    for k in range(N_QCIF_CORPORA)})
    fix = os.path.join(root, "tests", "fixtures")
    streams["fixture"] = (W, H, C.fixture_frames(
        os.path.join(fix, "ffmpeg_flv1_cif.flv")))
    streams["fma"] = (W, H, C.fma_sequence(W, H, GOP))
    golden = np.load(os.path.join(fix, "ffmpeg_flv1_cif_golden.npz"))["luma"]
    if len(streams["fixture"][2]) != GOP:
        fail(f"CIF fixture has {len(streams['fixture'][2])} frames, expected "
             f"{GOP}")
    digests = C.load_digests()
    missing = sorted(set(streams) - set(digests))
    if missing:
        fail(f"no reference digests for {missing}")

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
