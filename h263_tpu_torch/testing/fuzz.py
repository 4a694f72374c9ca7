"""Differential fuzzing of the port's front-ends, on the card.

Port of `h263_tpu/testing/fuzz.py`.  The generators build structured
frames (mixed I/P, INTER4V, both Sorenson escape widths, random
quantizers, DQUANT walks, DisposableP, UMV table-D.3 MVDs) and the
mutator applies byte flips, truncations, cross-frame splices and garbage
tails; each draws from the `np.random.Generator` in the JAX module's
order, so one generator state gives the same bytes on both sides.  The
oracles hold the port's paths against each other: identical tensors or
planes on success, identical error classes on failure.

Flavors (`run_campaign(flavor=...)`):

* host, on the CPU whatever `device` says: "sorenson", "standard" and
  "umv" hold the native parser (`native/entropy.cpp`) against the Python
  parser (`parser/frame.py`);
* "d24": the native delta24 emit, unpacked by the kernel of `csrc/d24.cu`
  (`ops/d24_cuda.py`), against the Python dense front-end;
* "device", "device_std", "device_umv": the entropy automaton of
  `csrc/automaton.cu` (`parser/automaton_cuda.py`) against the Python
  parser, every case of a campaign one lane of one launch;
* "fused": random multi-step scenarios through three decoders on one
  device, `BatchedStreamDecoder` on the fused d24 rows
  (`transport="packed"`) and on the dense transport (`transport="dense"`)
  and `DeviceFrontendDecoder` (the automaton), step by step.

`device` is "cuda" (the default: the kernels) or "cpu" (their plain
versions: `ops/d24.d24_to_dense`, `parser/device_frontend.parse_assemble`
and the plain reconstruction), resolved by `kernels.resolve_device`, which
raises without CUDA: no flavor falls back to the CPU.

Differences from the JAX module:

* The automaton's lanes are ragged (one flat payload, a word offset per
  lane), so there is no 4096-byte transfer bucket and the cases the JAX
  module skipped for it are checked here too.
* The port's automaton has no tape: `ST_TAPE_OVERFLOW` means that a lane
  ran past `lane_step_bound`, which legal and corrupt streams never reach
  (`parser/device_frontend.py`), so it counts as a mismatch here, not as
  an overflow skip.
* The port's per-frame packed parse has no slim-MV output; the slim -> full
  MV-row flip runs in the "fused" flavor instead, whose packed decoder
  ships slim rows until a frame's block MVs vary.
* "fused" holds the fused transport against the dense one and the device
  front-end, not against the legacy three-leaf transport, which the port
  does not have.  See `_fused_scenario` for how the device front-end's
  per-lane isolation is compared with the host decoders' atomic steps.

    python -m h263_tpu_torch.testing.fuzz [seed] [n] [flavor] [--device cuda|cpu]
"""

from __future__ import annotations

import re
import sys

import numpy as np
import torch

from .. import kernels
from ..bitio import BitReader
from ..native import DevicePrepBatch, bindings
from ..native.bindings import ERROR_MAP, PackOverflow
from ..ops.d24_cuda import d24_to_dense_cuda
from ..parallel.batch import BatchedStreamDecoder
from ..parallel.device_batch import DeviceFrontendDecoder
from ..parser.automaton_cuda import parse_assemble_cuda
from ..parser.device_frontend import (
    ST_OK,
    ST_TAPE_OVERFLOW,
    encode_ptype,
    status_error_class,
)
from ..parser.frame import parse_frame
from ..parser.picture import decode_picture
from ..types import (
    DecoderOption,
    H263Error,
    InvalidBitstream,
    MotionVectorRange,
    Picture,
    PictureFormatInvalid,
    PictureOption,
    PictureTypeCode,
    SourceFormat,
    UncodedIFrameBlocks,
    carry_forward_options,
)
from .encoder import (
    BitWriter,
    MBSpec,
    encode_macroblock,
    encode_sorenson_picture,
    encode_standard_picture,
)

_OPTS = DecoderOption.SORENSON_SPARK_BITSTREAM

FLAVORS = ("sorenson", "standard", "umv", "d24", "device", "device_std",
           "device_umv", "fused")
# Flavors that run a kernel (or, on the CPU, its plain version).
DEVICE_FLAVORS = ("d24", "device", "device_std", "device_umv", "fused")
# Lanes (rows) per automaton (unpack) call of a campaign.
LANES_PER_LAUNCH = 4096
# The "fused" flavor's picture sizes, one drawn per scenario.
FUSED_DIMS = [(48, 48), (64, 48), (96, 64), (80, 80)]


# -- generators (the JAX module's, draw for draw) ------------------------------


def _rand_frame(rng: np.random.Generator, width: int, height: int,
                flavor: str = "sorenson") -> bytes:
    nmb = (-(-width // 16)) * (-(-height // 16))
    ptype = (PictureTypeCode.I_FRAME if rng.random() < 0.4
             else PictureTypeCode.P_FRAME)
    mbs = []
    for _ in range(nmb):
        if ptype is PictureTypeCode.P_FRAME and rng.random() < 0.25:
            mbs.append(MBSpec(kind="uncoded"))
            continue
        blocks = []
        for _ in range(6):
            acs = []
            if rng.random() < 0.5:
                for _ in range(int(rng.integers(0, 6))):
                    lvl = int(rng.integers(1, 40))
                    acs.append((int(rng.integers(0, 8)),
                                lvl if rng.random() < 0.5 else -lvl))
            blocks.append(acs)
        if ptype is PictureTypeCode.I_FRAME:
            dc = int(rng.integers(1, 255)) * 8 % 2048 or 8
            mbs.append(MBSpec(kind="intra", intradc=[dc] * 6, blocks=blocks))
        elif rng.random() < 0.2:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
                   for _ in range(4)]
            mbs.append(MBSpec(kind="inter4v", mvd=mvd, blocks=blocks))
        else:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))]
            mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks))
    if flavor == "standard":
        return encode_standard_picture(
            width, height, ptype, mbs,
            quantizer=int(rng.integers(1, 32)),
            temporal_reference=int(rng.integers(0, 256)),
            umv=rng.random() < 0.5)
    return encode_sorenson_picture(
        width, height, ptype, mbs,
        quantizer=int(rng.integers(1, 32)),
        temporal_reference=int(rng.integers(0, 256)),
        version=1 if rng.random() < 0.5 else 0)


def _mutate(rng: np.random.Generator, base: bytes,
            other_frame) -> bytes:
    mut = bytearray(base)
    op = rng.random()
    if op < 0.4 and len(mut) > 6:  # byte flip past the start code
        j = int(rng.integers(4, len(mut)))
        mut[j] ^= int(rng.integers(1, 256))
    elif op < 0.7:  # truncate (legal EOF tail-fill or mid-symbol EOF)
        mut = mut[: int(rng.integers(4, len(mut) + 1))]
    elif op < 0.85 and len(mut) > 8:  # splice another frame's tail on
        other = other_frame()
        j = int(rng.integers(4, len(mut)))
        mut = mut[:j] + other[int(rng.integers(0, min(8, len(other)))):]
    else:  # garbage tail
        mut = mut + bytes(rng.integers(0, 256,
                                       size=int(rng.integers(1, 32)),
                                       dtype=np.uint8))
    return bytes(mut)


def _rand_umv_case(rng: np.random.Generator, width: int, height: int):
    """MB-layer-only bitstream + synthetic PLUSPTYPE picture exercising the
    UMV table-D.3 path with both UNLIMITED and EXTENDED motion-vector
    ranges."""
    nmb = (-(-width // 16)) * (-(-height // 16))
    ptype = (PictureTypeCode.I_FRAME if rng.random() < 0.2
             else PictureTypeCode.P_FRAME)

    def mv():
        if rng.random() < 0.3:  # large magnitudes stress the D.3 mantissa
            return int(rng.integers(-700, 701))
        return int(rng.integers(-31, 32))

    w = BitWriter()
    for _ in range(nmb):
        if ptype is PictureTypeCode.P_FRAME and rng.random() < 0.25:
            mbs = MBSpec(kind="uncoded")
        elif ptype is PictureTypeCode.I_FRAME:
            mbs = MBSpec(kind="intra", intradc=[800] * 6)
        else:
            nmv = 4 if rng.random() < 0.25 else 1
            kind = "inter4v" if nmv == 4 else "inter"
            mbs = MBSpec(kind=kind, mvd=[(mv(), mv()) for _ in range(nmv)],
                         blocks=[[(0, int(rng.integers(1, 9)))],
                                 [], [], [], [], []])
        encode_macroblock(w, mbs, ptype, None, umv_d3=True)
    pic = Picture(
        version=None,
        temporal_reference=0,
        format=SourceFormat.extended(width, height),
        options=PictureOption.UNRESTRICTED_MOTION_VECTORS,
        has_plusptype=True,
        has_opptype=True,
        picture_type=ptype,
        quantizer=int(rng.integers(1, 32)),
        motion_vector_range=(MotionVectorRange.EXTENDED
                             if rng.random() < 0.5
                             else MotionVectorRange.UNLIMITED),
    )
    return w.to_bytes(), pic


def _rand_d24_frame(rng: np.random.Generator, width: int, height: int) -> bytes:
    """Frame generator biased at the delta24 transport's edge cases: long
    empty stretches (a gap > 4095 in ordinal (mb, block, zigzag) space
    forces advance-only escape entries), zigzag-overflow blocks (the whole
    block is discarded and the emitter rewinds its cursor), both Sorenson
    escape widths, INTRADC, INTER4V."""
    nmb = (-(-width // 16)) * (-(-height // 16))
    ptype = (PictureTypeCode.I_FRAME if rng.random() < 0.25
             else PictureTypeCode.P_FRAME)
    sparse = rng.random() < 0.6  # sparse frames hit the gap>4095 escapes
    mbs = []
    for _ in range(nmb):
        if ptype is PictureTypeCode.P_FRAME and rng.random() < (
                0.9 if sparse else 0.25):
            mbs.append(MBSpec(kind="uncoded"))
            continue
        blocks = []
        for _ in range(6):
            acs = []
            roll = rng.random()
            if roll < (0.08 if sparse else 0.4):
                for _ in range(int(rng.integers(1, 5))):
                    lvl = int(rng.integers(1, 40))
                    acs.append((int(rng.integers(0, 10)),
                                lvl if rng.random() < 0.5 else -lvl))
            elif roll < (0.12 if sparse else 0.5):
                # zigzag overflow: runs sum past 63 -> block discard+rewind
                acs = [(30, 5), (30, -7), (30, 9)]
            blocks.append(acs)
        if ptype is PictureTypeCode.I_FRAME:
            dc = int(rng.integers(1, 255)) * 8 % 2048 or 8
            mbs.append(MBSpec(kind="intra", intradc=[dc] * 6, blocks=blocks))
        elif rng.random() < 0.15:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
                   for _ in range(4)]
            mbs.append(MBSpec(kind="inter4v", mvd=mvd, blocks=blocks))
        else:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))]
            mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks))
    return encode_sorenson_picture(
        width, height, ptype, mbs,
        quantizer=int(rng.integers(1, 32)),
        temporal_reference=int(rng.integers(0, 256)),
        version=1 if rng.random() < 0.5 else 0)


def _rand_fused_gop(rng: np.random.Generator, width: int, height: int,
                    n_frames: int) -> list[bytes]:
    """One stream's GOP biased at the fused transport's state machinery:
    random Sorenson versions, random quantizers + DQUANT walks,
    sparse/dense frames (cut-ladder churn), INTER4V at random steps (the
    sticky slim->full MV row flip), DisposableP frames (all-uncoded) and
    uncoded-heavy tails."""
    nmb = (-(-width // 16)) * (-(-height // 16))
    frames = []
    for t in range(n_frames):
        quant = int(rng.integers(1, 32))
        version = 1 if rng.random() < 0.5 else 0
        if t and rng.random() < 0.1:
            frames.append(encode_sorenson_picture(
                width, height, PictureTypeCode.DISPOSABLE_P_FRAME,
                [MBSpec(kind="uncoded")] * nmb, quantizer=quant,
                temporal_reference=t & 0xFF, version=version, pad_bit=1))
            continue
        ptype = (PictureTypeCode.I_FRAME if t == 0 or rng.random() < 0.15
                 else PictureTypeCode.P_FRAME)
        dense = rng.random()  # per-frame density -> cut-ladder churn
        fourv_p = 0.3 if rng.random() < 0.3 else 0.0
        mbs = []
        for _ in range(nmb):
            if ptype is PictureTypeCode.P_FRAME and rng.random() < (
                    0.8 if dense < 0.4 else 0.25):
                mbs.append(MBSpec(kind="uncoded"))
                continue
            blocks = []
            for _ in range(6):
                acs = []
                if rng.random() < (0.15 if dense < 0.4 else 0.55):
                    for _ in range(int(rng.integers(1, 5))):
                        lvl = int(rng.integers(1, 40))
                        acs.append((int(rng.integers(0, 8)),
                                    lvl if rng.random() < 0.5 else -lvl))
                blocks.append(acs)
            dq = int(rng.integers(-2, 3)) if rng.random() < 0.2 else 0
            if ptype is PictureTypeCode.I_FRAME:
                dc = int(rng.integers(1, 255)) * 8 % 2048 or 8
                mbs.append(MBSpec(kind="intra", intradc=[dc] * 6,
                                  blocks=blocks, dquant=dq))
            elif rng.random() < fourv_p:
                mvd = [(int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
                       for _ in range(4)]
                mbs.append(MBSpec(kind="inter4v", mvd=mvd, blocks=blocks,
                                  dquant=dq))
            else:
                mvd = [(int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))]
                mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks,
                                  dquant=dq))
        frames.append(encode_sorenson_picture(
            width, height, ptype, mbs, quantizer=quant,
            temporal_reference=t & 0xFF, version=version))
    return frames


def _fused_case(rng: np.random.Generator, width: int, height: int):
    """One scenario's draws, in the JAX `_fused_scenario`'s order: (S
    streams, T steps, gops [S][T] with truncations and byte flips mid-GOP,
    masks [T] of per-stream booleans or None)."""
    S = int(rng.integers(2, 5))
    T = int(rng.integers(6, 11))
    gops = [_rand_fused_gop(rng, width, height, T) for _ in range(S)]
    for s in range(S):
        for t in range(T):
            r = rng.random()
            buf = gops[s][t]
            if r < 0.08 and len(buf) > 6:  # truncate: tail-fill or EOF error
                gops[s][t] = buf[: int(rng.integers(4, len(buf) + 1))]
            elif r < 0.13 and len(buf) > 6:  # byte flip past the start code
                mut = bytearray(buf)
                mut[int(rng.integers(4, len(mut)))] ^= int(
                    rng.integers(1, 256))
                gops[s][t] = bytes(mut)
    masks = [([bool(x) for x in rng.random(S) < 0.7]
              if rng.random() < 0.25 else None) for _ in range(T)]
    return S, T, gops, masks


# -- host oracles -------------------------------------------------------------


def _outcome_python(buf: bytes, width: int, height: int, opts, running,
                    pic=None):
    r = BitReader(buf)
    if pic is None:
        pic = decode_picture(r, opts, None)
    return parse_frame(r, pic, opts, running, width, height)


def _outcome_native(buf: bytes, width: int, height: int, opts, running,
                    pic=None):
    r = BitReader(buf)
    if pic is None:
        pic = decode_picture(r, opts, None)
    fd, _ = bindings.parse_frame_native(buf, r.pos, pic, opts, running,
                                        width, height)
    return fd


def _outcome(fn, *args):
    """(result, None) or (None, the H263Error's class)."""
    try:
        return fn(*args), None
    except H263Error as e:
        return None, type(e)


_TENSORS = ("coeffs_y", "class_y", "coeffs_cb", "class_cb",
            "coeffs_cr", "class_cr", "mvs", "inter")


def _agree(buf: bytes, width: int, height: int, opts, running,
           pic=None) -> tuple[bool, str]:
    a, ea = _outcome(_outcome_python, buf, width, height, opts, running, pic)
    b, eb = _outcome(_outcome_native, buf, width, height, opts, running, pic)
    ea = ea and ea.__name__
    eb = eb and eb.__name__
    if (a is None) != (b is None):
        return False, f"python={ea or 'ok'} native={eb or 'ok'}"
    if a is None:
        return (ea == eb), f"python={ea} native={eb}"
    for name in _TENSORS:
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            return False, f"tensor {name} differs"
    return True, ""


def _dense_of(frame, nmb: int) -> np.ndarray:
    """A FrameData's coefficients as the kernels lay them out: int16
    [6 * nmb, 64], the luma blocks row-major, then Cb, then Cr."""
    return np.concatenate([frame.coeffs_y.reshape(4 * nmb, 64),
                           frame.coeffs_cb.reshape(nmb, 64),
                           frame.coeffs_cr.reshape(nmb, 64)])


# -- d24: the native emit through the unpack kernel ---------------------------


def d24_emit(buf: bytes, width: int, height: int):
    """The native delta24 emit of one Sorenson frame, as the production
    paths pad it: (row uint8 [3 * cap] zero past the entry count, MVs int16
    [mbh, mbw, 4, 2], INTER uint8 [mbh, mbw], count, error) with error None,
    "PackOverflow" or the H263Error's class name (and zeros for the rest)."""
    mb_w, mb_h = -(-width // 16), -(-height // 16)
    nmb = mb_w * mb_h
    cap = 12 * nmb + 256
    pack = np.zeros(3 * cap, dtype=np.uint8)
    mvs = np.zeros((mb_h, mb_w, 4, 2), dtype=np.int16)
    inter = np.ones((mb_h, mb_w), dtype=np.uint8)
    scratch = np.zeros((nmb, 4, 2), dtype=np.int16)
    try:
        r = BitReader(buf)
        pic = decode_picture(r, _OPTS, None)
        count, _ = bindings.parse_frame_native_packed(
            buf, r.pos, pic, _OPTS, PictureOption.NONE, width, height,
            pack, mvs, inter, scratch)
    except PackOverflow:
        return np.zeros_like(pack), mvs, inter, 0, "PackOverflow"
    except H263Error as e:
        return np.zeros_like(pack), mvs, inter, 0, type(e).__name__
    # Entries past `count` may be leftovers of discard-rewound blocks or
    # EOF-rolled-back macroblocks; the caller owns the padding.
    pack[3 * count:] = 0
    return pack, mvs, inter, count, None


def d24_verdict(py, emit, dense: np.ndarray) -> tuple[bool, str]:
    """One d24 case: `py` the Python dense front-end's (FrameData, error
    class), `emit` the `d24_emit` tuple, `dense` the unpacked row int16
    [6 * nmb, 64]."""
    a, ea = py
    _, mvs, inter, count, eb = emit
    ea = ea and ea.__name__
    if eb == "PackOverflow":
        # Production replays the frame on the dense transport.
        return True, "overflow-skip"
    if (a is None) != (eb is not None):
        return False, f"python={ea or 'ok'} d24={eb or 'ok'}"
    if a is None:
        return (ea == eb), f"python={ea} d24={eb}"
    want = _dense_of(a, a.mb_w * a.mb_h).reshape(-1)
    got = dense.reshape(-1)
    if not np.array_equal(got, want):
        bad = int(np.flatnonzero(got != want)[0])
        return False, (f"coefficient {bad}: d24 {got[bad]} "
                       f"vs dense {want[bad]} (count={count})")
    if not np.array_equal(mvs, a.mvs):
        return False, "mvs differ"
    if not np.array_equal(inter.astype(bool), a.inter):
        return False, "inter differs"
    return True, ""


def _agree_d24_batch(bufs, width: int, height: int,
                     device) -> list[tuple[bool, str]]:
    """Round-trip the d24 transport for every frame of `bufs` against the
    Python dense front-end: native emit (entropy.cpp F_PACK_DELTA24) ->
    `ops/d24_cuda.d24_to_dense_cuda` over all the rows in one call on
    `device` (the kernel on a CUDA device, `ops/d24.d24_to_dense` on the
    CPU) -> the dense coefficients, MVs and INTER flags must equal the
    Python parse's exactly; parse failures must agree on the error class.
    A `PackOverflow` is an "overflow-skip" (production replays the frame on
    the dense transport).  The JAX module also held the emit's slim MVs;
    the port's per-frame packed parse has none, and the "fused" flavor runs
    the slim -> full flip."""
    mbh, mbw = -(-height // 16), -(-width // 16)
    out = []
    for lo in range(0, len(bufs), LANES_PER_LAUNCH):
        chunk = bufs[lo:lo + LANES_PER_LAUNCH]
        emits = [d24_emit(b, width, height) for b in chunk]
        rows = torch.from_numpy(np.stack([e[0] for e in emits]))
        dense = d24_to_dense_cuda(rows.to(device), mbh, mbw).cpu().numpy()
        for k, (b, e) in enumerate(zip(chunk, emits)):
            py = _outcome(_outcome_python, b, width, height, _OPTS,
                          PictureOption.NONE)
            out.append(d24_verdict(py, e, dense[k]))
    return out


def _agree_d24(buf: bytes, width: int, height: int,
               device="cpu") -> tuple[bool, str]:
    """`_agree_d24_batch` of one frame."""
    return _agree_d24_batch([buf], width, height,
                            kernels.resolve_device(device))[0]


# -- device: the entropy automaton --------------------------------------------


def device_lanes(cases, width: int, height: int):
    """The host half of the device front-end for automaton cases, each
    (buf, opts, running, pic): with `pic` None the header parses from
    `buf`, else `buf` starts at the macroblock layer and `pic` is its
    synthetic header (the UMV flavors).  Returns (payload uint8 [Nw, 4]:
    each lane's bytes padded to whole words, back to back, plus one zero
    word; meta int32 [6, N]: start bit, nbits, quant0, ptype, v1, word
    offset; preps: per case (pic, running options as carried) or None when
    the host rejects its header, which is host work in the device path and
    out of scope: the lane is then empty)."""
    parts, preps, woff = [], [], 0
    meta = np.zeros((6, len(cases)), dtype=np.int32)
    for i, (buf, opts, running, pic) in enumerate(cases):
        r = BitReader(buf)
        try:
            if pic is None:
                pic = decode_picture(r, opts, None)
            if pic is None:
                raise H263Error("not a picture")
            run_opts = carry_forward_options(
                pic, running if running is not None else PictureOption.NONE)
        except H263Error:
            preps.append(None)
            meta[:, i] = (0, 0, 1, 1, 0, woff)
            continue
        preps.append((pic, run_opts))
        words = (len(buf) + 3) // 4
        parts.append(bytes(buf) + b"\0" * (4 * words - len(buf)))
        meta[:, i] = (r.pos, 8 * len(buf), pic.quantizer,
                      encode_ptype(pic, run_opts),
                      1 if pic.version == 1 else 0, woff)
        woff += words
    payload = np.frombuffer(b"".join(parts) + b"\0" * 4,
                            dtype=np.uint8).reshape(-1, 4).copy()
    return payload, meta, preps


def launch_lanes(payload: np.ndarray, meta: np.ndarray, width: int,
                 height: int, device):
    """`device_lanes`' output through `parse_assemble_cuda` on `device` (the
    automaton kernel on a CUDA device, its plain version on the CPU) ->
    numpy (dense int16 [N, 6*nmb, 64], MVs, INTER bool, status int32)."""
    outs = parse_assemble_cuda(
        torch.from_numpy(payload).to(device),
        torch.from_numpy(meta).to(device), mbh=-(-height // 16),
        mbw=-(-width // 16), width=width, height=height)
    return tuple(t.cpu().numpy() for t in outs)


def device_verdict(ref, dense, mvs, inter, status: int,
                   host: str = "python") -> tuple[bool, str]:
    """One automaton lane against a host parse `ref` ((FrameData, None) or
    (None, error class)): equal dense coefficients, MVs and INTER on
    success, `status_error_class(status)` the host's class on failure.
    A lane at its step bound (ST_TAPE_OVERFLOW) is a mismatch."""
    a, ea = ref
    if status == ST_TAPE_OVERFLOW:
        return False, (f"{host}={ea.__name__ if ea else 'ok'} "
                       f"device_status={status} (the lane's step bound)")
    if a is None:
        return ((status_error_class(status) is ea),
                f"{host}={ea.__name__} device_status={status}")
    if status != ST_OK:
        return False, f"{host}=ok device_status={status}"
    if not np.array_equal(dense, _dense_of(a, a.mb_w * a.mb_h)):
        return False, "dense coefficients differ"
    if not np.array_equal(mvs, a.mvs):
        return False, "mvs differ"
    if not np.array_equal(inter, a.inter):
        return False, "inter differs"
    return True, ""


def _agree_device_batch(cases, width: int, height: int,
                        device) -> list[tuple[bool, str]]:
    """Differential: the entropy automaton vs the Python host parser for
    every case of `cases` (see `device_lanes`), all of them lanes of one
    call on `device` (up to LANES_PER_LAUNCH lanes a call).  Dense
    coefficients / MVs / INTER must match exactly on success, and error
    CLASSES on failure.  A case whose picture header fails to parse on the
    host is out of scope: (True, "header-reject").  The MB layer runs
    under the CARRIED running options (`carry_forward_options`), as the
    production header prep ships them in the ptype word."""
    out = []
    for lo in range(0, len(cases), LANES_PER_LAUNCH):
        chunk = cases[lo:lo + LANES_PER_LAUNCH]
        payload, meta, preps = device_lanes(chunk, width, height)
        dense, mvs, inter, status = launch_lanes(payload, meta, width,
                                                 height, device)
        for k, ((buf, opts, _, pic), prep) in enumerate(zip(chunk, preps)):
            if prep is None:
                out.append((True, "header-reject"))
                continue
            ref = _outcome(_outcome_python, buf, width, height, opts,
                           prep[1], pic)
            out.append(device_verdict(ref, dense[k], mvs[k], inter[k],
                                      int(status[k])))
    return out


def _agree_device(buf: bytes, width: int, height: int, opts=_OPTS,
                  running=None, pic=None, device="cpu") -> tuple[bool, str]:
    """`_agree_device_batch` of one case.  `running`: carried running
    options; `pic`: header-LESS mode (buf starts at the MB layer and `pic`
    is the synthetic header)."""
    return _agree_device_batch([(buf, opts, running, pic)], width, height,
                               kernels.resolve_device(device))[0]


# -- fused: three decoders, step by step --------------------------------------


def _note(notes, key: str) -> None:
    """Count one outcome that is not a mismatch."""
    notes[key] = notes.get(key, 0) + 1


def _error_stream(exc) -> int:
    """The stream a batched host decoder's native parse names in its error
    ("stream <i>: ..."), or -1."""
    m = re.match(r"stream (\d+):", str(exc))
    return int(m.group(1)) if m else -1


def _header_dims(buf: bytes):
    """The (width, height) a Sorenson frame's header declares, or None."""
    try:
        pic = decode_picture(BitReader(buf), _OPTS, None)
    except H263Error:
        return None
    return pic.format.width_and_height() if pic and pic.format else None


def _host_step(da, db, bufs, live, width, height, notes):
    """One step of the two host decoders (da fused d24 rows, db dense),
    replayed with each failing stream masked until it decodes.  Returns
    ("planes", (y, cb, cr) numpy, {stream: the packed decoder's class
    name}); ("overflow",) when the packed decoder raised PackOverflow; or
    ("mismatch", why)."""
    mask = list(live)
    failed = {}
    while True:
        outs = []
        for dec, transport in ((da, "packed"), (db, "dense")):
            try:
                y, cb, cr = dec.decode_step(bufs, transport=transport,
                                            mask=mask)
                outs.append(tuple(p.cpu().numpy() for p in (y, cb, cr)))
            except H263Error as e:
                outs.append(e)
        a, b = outs
        if isinstance(a, PackOverflow):
            return ("overflow",)
        if isinstance(a, tuple) and isinstance(b, tuple):
            for name, x, y in zip(("y", "cb", "cr"), a, b):
                if not np.array_equal(x, y):
                    bad = np.argwhere(x != y)[0]
                    return ("mismatch", f"plane {name} differs at "
                            f"{bad.tolist()} (packed vs dense)")
            return ("planes", a, failed)
        if isinstance(a, tuple) or isinstance(b, tuple):
            return ("mismatch",
                    f"packed={'ok' if isinstance(a, tuple) else type(a).__name__}"
                    f" dense={'ok' if isinstance(b, tuple) else type(b).__name__}")
        i = _error_stream(a)
        if not (0 <= i < len(mask) and mask[i]):
            return ("mismatch", f"packed raised {type(a).__name__} for no "
                    f"live stream: {a}")
        ca, cb_ = type(a).__name__, type(b).__name__
        if ca != cb_:
            if not (isinstance(a, InvalidBitstream)
                    and isinstance(b, PictureFormatInvalid)
                    and _header_dims(bufs[i]) not in (None,
                                                      (width, height))):
                return ("mismatch", f"stream {i}: packed={ca} dense={cb_}")
            _note(notes, "header-dims")
        failed[i] = ca
        mask[i] = False


def _fused_scenario(rng: np.random.Generator, width: int, height: int,
                    report, device, notes=None) -> tuple[int, int]:
    """One randomized multi-step scenario (the JAX draws: random
    version/quant/density churn, truncations and byte flips mid-GOP,
    absent-slot masks, MV-row flip steps, DisposableP frames) through three
    decoders on `device`: `BatchedStreamDecoder` on the fused d24 rows
    (transport="packed") and on the dense transport, and
    `DeviceFrontendDecoder`.

    A host step that raises is atomic: the host decoders replay it with
    the failing stream (the one the packed decoder's error names) masked,
    until it decodes; both must raise the same class each time.  The
    device front-end takes the step once (a failed lane is its identity
    frame, a header rejected by its native prep too); its failed lanes
    (automaton status, prep return code) must be exactly the host's
    failed streams, with the same classes, and every step's planes must
    be bit-identical across the three.  Stepping continues after every
    step.

    Three outcomes are not mismatches; each is counted in `notes`:
    * "overflow-skip": the packed decoder raised PackOverflow (production
      replays the step on the dense transport); the scenario's remaining
      steps are skipped, since the two host decoders no longer share a
      state;
    * "no-reference": the host decoders refuse a P-frame with INTER
      macroblocks on a stream with no reference picture
      (UncodedIFrameBlocks), while the device front-end, like the JAX
      package's, keeps no such state and decodes it against the planes it
      holds.  That stream's planes are then left out of the comparison
      until the three agree again (its next decoded I-frame);
    * "header-dims": a corrupt header that declares other dims raises
      InvalidBitstream in the native header parse (packed decoder, device
      prep) and PictureFormatInvalid in the Python one (dense decoder), as
      in the JAX package.

    Returns (steps, mismatches); stops at the first mismatch."""
    S, T, gops, masks = _fused_case(rng, width, height)
    notes = notes if notes is not None else {}
    da = BatchedStreamDecoder(S, width, height, _OPTS, device=device)
    db = BatchedStreamDecoder(S, width, height, _OPTS, device=device)
    dc = DeviceFrontendDecoder(S, width, height, _OPTS, device=device)
    prep = DevicePrepBatch(S, width, height)
    skip = da.skip_frame_bytes()
    diverged: set = set()
    cases = 0
    for t in range(T):
        bufs = [gops[s][t] for s in range(S)]
        live = masks[t] or [True] * S
        cases += 1
        host = _host_step(da, db, bufs, live, width, height, notes)
        if host[0] == "overflow":
            _note(notes, "overflow-skip")
            return cases, 0
        if host[0] == "mismatch":
            report(f"step[{t}]", f"{host[1]} (S={S} {width}x{height})")
            return cases, 1
        _, planes, failed = host
        try:
            dc.decode_step(bufs, mask=live)
        except H263Error:
            pass  # a header reject, raised after the step was dispatched
        status = dc.fetch_status()
        staged = [b if live[i] else skip for i, b in enumerate(bufs)]
        stage = np.zeros(sum((len(b) + 3) // 4 * 4 for b in staged) + 4,
                         dtype=np.uint8)
        prep.prepare_ragged(staged, stage, np.zeros((6, S), dtype=np.int32))
        dev = {}
        for i in range(S):
            if prep.rc[i] != 0:
                dev[i] = ERROR_MAP.get(int(prep.rc[i]), H263Error).__name__
            elif status[i] != ST_OK:
                cls = status_error_class(int(status[i]))
                dev[i] = cls.__name__ if cls else f"status {int(status[i])}"
        for i in sorted(set(failed) | set(dev)):
            if failed.get(i) == dev.get(i):
                continue
            if (failed.get(i) == UncodedIFrameBlocks.__name__
                    and i not in dev and not da.states[i].has_reference):
                _note(notes, "no-reference")
                diverged.add(i)
                continue
            report(f"step[{t}]", f"stream {i}: host={failed.get(i, 'ok')} "
                                 f"device={dev.get(i, 'ok')} "
                                 f"(S={S} {width}x{height})")
            return cases, 1
        got = tuple(p.cpu().numpy() for p in (dc.ref_y, dc.ref_cb,
                                                dc.ref_cr))
        for s in range(S):
            same = all(np.array_equal(x[s], y[s])
                       for x, y in zip(planes, got))
            if s in diverged:
                if same:
                    diverged.discard(s)
                continue
            if not same:
                name, x, y = next((n, x, y) for n, x, y in zip(
                    ("y", "cb", "cr"), planes, got)
                    if not np.array_equal(x[s], y[s]))
                bad = np.argwhere(x[s] != y[s])[0]
                report(f"step[{t}]", f"stream {s}: plane {name} differs at "
                                     f"{bad.tolist()} (host vs device, S={S}"
                                     f" {width}x{height})")
                return cases, 1
    return cases, 0


# -- campaigns ----------------------------------------------------------------


def _cases_for(flavor: str, rng, n_base: int, mutations_per_base: int,
               width: int, height: int):
    """The device / d24 flavors' cases in the JAX module's draw order: per
    base, the base then its mutants, each (buf, opts, running, pic) with
    the mutants keeping the base's synthetic header and running
    options."""
    if flavor == "device_std":
        def gen(rng):
            run = (PictureOption.UNRESTRICTED_MOTION_VECTORS
                   if rng.random() < 0.5 else PictureOption.NONE)
            if rng.random() < 0.25:
                # MODIFIED_QUANTIZATION runs in-automaton: the first coded
                # MB must fail UnimplementedDecoding while all-uncoded
                # pictures decode.
                run |= PictureOption.MODIFIED_QUANTIZATION
            buf = _rand_frame(rng, width, height, flavor="standard")
            if rng.random() < 0.4:
                # A GOB-header-shaped run mid-payload drives the automaton's
                # resync scan: GN 0/15 = picture boundary (tail-fill),
                # 1..14 = a real GOB header (UnimplementedDecoding).
                gn = int(rng.choice([0, 15, 1, 5, 14]))
                code = bytes([0, 0, 0x80 | (gn << 2)
                              | int(rng.integers(0, 4))])
                if rng.random() < 0.3:
                    code = b"\x00" + code  # stuffing-heavy run
                at = int(rng.integers(6, max(7, len(buf))))
                buf = buf[:at] + code + buf[at:]
            return buf, DecoderOption.NONE, run, None
    elif flavor == "device_umv":
        def gen(rng):
            buf, pic = _rand_umv_case(rng, width, height)
            return (buf, DecoderOption.NONE,
                    PictureOption.UNRESTRICTED_MOTION_VECTORS, pic)
    else:
        def gen(rng):
            return _rand_d24_frame(rng, width, height), _OPTS, None, None
    cases = []
    for _ in range(n_base):
        base = gen(rng)
        cases.append(base)
        for _ in range(mutations_per_base):
            cases.append((_mutate(rng, base[0], lambda: gen(rng)[0]),
                          *base[1:]))
    return cases


def _tag(i: int, mutations_per_base: int) -> str:
    """The JAX campaign's tag of case i: base[b] or mut[b.m]."""
    b, m = divmod(i, mutations_per_base + 1)
    return f"base[{b}]" if m == 0 else f"mut[{b}.{m - 1}]"


def run_campaign(seed: int = 0, n_base: int = 25, width: int = 96,
                 height: int = 80, mutations_per_base: int = 10,
                 on_fail=None, flavor: str = "sorenson", *,
                 device="cuda", notes=None) -> tuple[int, int]:
    """Run a differential campaign; returns (total_cases, mismatches).

    Each base frame is checked as-is plus `mutations_per_base` mutants.
    `on_fail(tag, detail)` is called per mismatch (default: print).
    `notes`, a dict, receives counts of the outcomes that are not
    mismatches ("header-reject", "overflow-skip", "no-reference",
    "header-dims").

    flavor "sorenson" (default) covers both Sorenson escape widths and
    DisposableP; "standard" uses plain-PTYPE pictures (8-bit escapes) at a
    CIF-family size and randomly injects carried
    UNRESTRICTED_MOTION_VECTORS running options; "umv" PLUSPTYPE UMV
    pictures with table-D.3 MVDs; these three hold the native parser
    against the Python one on the host and ignore `device`.  "d24"
    round-trips the delta24 transport (native emit -> the unpack kernel)
    against the Python dense front-end, biased at the gap>4095 escape and
    discard-rewind edges.  "device" (the d24 generator), "device_std"
    (standard pictures at CIF-family dims, half the bases under carried
    UMV, a quarter under carried MODIFIED_QUANTIZATION, 40% with a spliced
    GOB-header-shaped run) and "device_umv" (header-less PLUSPTYPE UMV
    pictures) hold the entropy automaton against the Python parser.
    "fused" runs multi-step scenarios through three decoders
    (`_fused_scenario`); `n_base` counts scenarios, each 6-10 steps of
    2-4 streams, and the total counts steps.

    `device` ("cuda", "cuda:<k>" or "cpu") is where the d24, device and
    fused flavors run: the kernels on a CUDA device, their plain versions
    on the CPU.  It raises without CUDA unless "cpu" is given.
    """
    if flavor not in FLAVORS:
        raise ValueError(f"flavor must be one of {FLAVORS}, got {flavor!r}")
    if flavor in DEVICE_FLAVORS:
        device = kernels.resolve_device(device)
    notes = notes if notes is not None else {}
    report = on_fail or (lambda tag, why: print(f"MISMATCH {tag}: {why}"))
    rng = np.random.default_rng(seed)
    if flavor == "fused":
        total = fails = 0
        for i in range(n_base):
            w, h = FUSED_DIMS[int(rng.integers(0, len(FUSED_DIMS)))]
            c, f = _fused_scenario(
                rng, w, h,
                lambda tag, why, _i=i: report(f"scenario[{_i}].{tag}", why),
                device, notes)
            total += c
            fails += f
        return total, fails
    if flavor in ("d24", "device", "device_std", "device_umv"):
        if flavor == "device_std" and (width, height) == (96, 80):
            width, height = 128, 96
        cases = _cases_for(flavor, rng, n_base, mutations_per_base, width,
                           height)
        if flavor == "d24":
            verdicts = _agree_d24_batch([c[0] for c in cases], width, height,
                                        device)
        else:
            verdicts = _agree_device_batch(cases, width, height, device)
        fails = 0
        for i, (ok, why) in enumerate(verdicts):
            if not ok:
                fails += 1
                report(_tag(i, mutations_per_base), why)
            elif why in ("header-reject", "overflow-skip"):
                _note(notes, why)
        return len(verdicts), fails
    if flavor == "standard":
        opts = DecoderOption.NONE
        cif_family = {(128, 96), (176, 144), (352, 288), (704, 576),
                      (1408, 1152)}
        if (width, height) == (96, 80):  # the generic default: pick SUB_QCIF
            width, height = 128, 96
        elif (width, height) not in cif_family:
            raise ValueError(
                f"standard flavor needs CIF-family dims, got {(width, height)}")
    elif flavor == "umv":
        opts = DecoderOption.NONE
    else:
        opts = _OPTS
    total = fails = 0
    for i in range(n_base):
        if flavor == "umv":
            running = PictureOption.UNRESTRICTED_MOTION_VECTORS
            base, pic = _rand_umv_case(rng, width, height)
            make = lambda: _rand_umv_case(rng, width, height)[0]  # noqa: E731
        else:
            running = (PictureOption.UNRESTRICTED_MOTION_VECTORS
                       if flavor == "standard" and rng.random() < 0.5
                       else PictureOption.NONE)
            base, pic = _rand_frame(rng, width, height, flavor), None
            make = lambda: _rand_frame(rng, width, height, flavor)  # noqa: E731
        ok, why = _agree(base, width, height, opts, running, pic)
        total += 1
        if not ok:
            fails += 1
            report(f"base[{i}]", why)
        for m in range(mutations_per_base):
            mut = _mutate(rng, base, make)
            ok, why = _agree(mut, width, height, opts, running, pic)
            total += 1
            if not ok:
                fails += 1
                report(f"mut[{i}.{m}]", why)
    return total, fails


def main(argv=None) -> int:
    """`[seed] [n] [flavor] [--device cuda|cpu]`: one campaign; prints the
    JAX module's line and returns 1 on any mismatch."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m h263_tpu_torch.testing.fuzz")
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("n", nargs="?", type=int, default=300)
    ap.add_argument("flavor", nargs="?", default="sorenson", choices=FLAVORS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:<k> or cpu")
    args = ap.parse_args(argv)
    if args.flavor in DEVICE_FLAVORS:
        try:
            kernels.resolve_device(args.device)
        except RuntimeError as e:   # no CUDA, or no such card
            print(f"fuzz: {e}", file=sys.stderr)
            return 2
    total, fails = run_campaign(seed=args.seed, n_base=args.n,
                                flavor=args.flavor, device=args.device)
    print(f"fuzz campaign ({args.flavor}): {total} cases, {fails} mismatches")
    return 1 if fails else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
