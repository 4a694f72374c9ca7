"""Batched decoding with the device entropy front-end, PyTorch.

Port of `h263_tpu/parallel/device_batch.py::DeviceFrontendDecoder`, ragged
payload only: the single-frame step and the K-frame window.  Per step:

    host header prep -> one host-to-device copy of the ragged payload +
    int32 meta [6, S] -> entropy automaton (CUDA kernel) -> IDCT + motion
    compensation + add-clamp (one CUDA kernel) -> planes

Sorenson streams take the native header prep (`native.DevicePrepBatch`,
one call for every stream).  Standard H.263 streams (`DecoderOption.NONE`)
take the JAX package's Python header loop: each stream's picture header
parses against its last one, the running options carry forward
(`_running`: a plain PTYPE keeps the UMV / MODIFIED_QUANTIZATION of an
earlier OPPTYPE), and `parser.device_frontend.encode_ptype` ships them to
the automaton in the ptype word; the loop packs the same ragged layout.
As in the JAX package, a standard decoder has no window (`decode_steps`
raises), since its headers chain from frame to frame on the host.

A window (`decode_steps`) of T frames per stream stages all T frames into
one buffer and makes one copy and one automaton launch over T*S lanes, then
T reconstructions in stream order, each against the planes of the frame
before.  Neither call synchronises the host with the card.

The reference planes stay on the device.  Errored lanes emit the identity
frame, so their previous picture persists (the reference's whole-picture
transaction).  Per-stream status stays on the device until `fetch_status`.

Host staging: the payload and meta go through one pinned ping-pong pair,
sized for every stream at the frame cap (for T frames after a window;
grown if a call needs more), and only the call's used words are copied,
with `non_blocking=True`.  Each buffer carries a CUDA event recorded after
its copy; before a buffer is written again, its event is synchronised
(`reclaim_wait`), so the host never overwrites bytes a copy may still read.
That copy was enqueued two calls earlier, so the wait only holds the host
back when it runs two calls ahead of the card (counted as
`staging_reclaim_waits`).

Stage timers (`utils/trace.py`, off unless enabled) take the JAX package's
names at its places: `host_parse`, `transfer`, `reconstruct_dispatch`,
`reclaim_wait`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..decoder.reconstruct import (
    PresentParams,
    present_rgba_batched,
    reconstruct_from_dense,
)
from ..bitio import BitReader
from ..native import DevicePrepBatch
from ..ops.deblock import QUANT_TO_STRENGTH
from ..parser.automaton_cuda import parse_assemble_cuda
from ..parser.device_frontend import encode_ptype
from ..parser.picture import decode_picture
from ..testing.encoder import (
    MBSpec,
    encode_sorenson_picture,
    encode_standard_picture,
)
from ..types import (
    DecoderOption,
    H263Error,
    PictureOption,
    PictureTypeCode,
    carry_forward_options,
)
from ..utils.trace import incr, trace_stage


class DeviceFrontendDecoder:
    """Decode S same-resolution streams, Sorenson or (with
    `DecoderOption.NONE`) standard H.263, one frame per stream per
    `decode_step`, on `device` ("cuda", the default, or "cpu"; no fallback
    between them).
    """

    def __init__(self, n_streams: int, width: int, height: int,
                 decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 *, device="cuda", max_frame_bytes: Optional[int] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self.decoder_options = decoder_options
        self.n = n_streams
        self.w, self.h = width, height
        self.cw, self.ch = (width + 1) // 2, (height + 1) // 2
        self.mb_w, self.mb_h = -(-width // 16), -(-height // 16)
        cap = (((max_frame_bytes or 8192) + 3) // 4) * 4
        self.max_frame_bytes = cap
        # The native prep parses Sorenson headers; standard ones take the
        # Python loop of `_prepare_standard`.
        self._prep = (DevicePrepBatch(n_streams, width, height)
                      if decoder_options
                      & DecoderOption.SORENSON_SPARK_BITSTREAM else None)
        # Per-stream header state of a standard stream: its last picture
        # header and the running options it carries (state.rs:147-155).
        self._pictures = [None] * n_streams
        self._running = [PictureOption.NONE] * n_streams

        def planes(h, w):
            return torch.zeros((n_streams, h, w), dtype=torch.uint8,
                               device=self.device)

        self.ref_y = planes(self.h, self.w)
        self.ref_cb = planes(self.ch, self.cw)
        self.ref_cr = planes(self.ch, self.cw)
        self.last_status: Optional[torch.Tensor] = None
        # [T, S] statuses of the last window (None after a single step).
        self.last_status_steps: Optional[torch.Tensor] = None
        self._skip: Optional[bytes] = None
        # Last-good presentation params per stream (quantizer -> deblock
        # strength, advisory deblocker flag).
        self._last_quant = np.full(n_streams, 8, dtype=np.int32)
        self._last_deblock = np.zeros(n_streams, dtype=np.bool_)
        # Ping-pong staging pair: flat payload bytes (one spare zero word,
        # so the payload is never empty), meta [T, 6, S] (T = 1 until a
        # window), the event of the last copy.
        self._pin = self.device.type == "cuda"
        self._stage = [torch.zeros(n_streams * cap + 4, dtype=torch.uint8,
                                   pin_memory=self._pin) for _ in range(2)]
        self._meta = [torch.zeros((1, 6, n_streams), dtype=torch.int32,
                                  pin_memory=self._pin) for _ in range(2)]
        self._copied = [None, None]
        self._pp = 0
        self._params = PresentParams(n_streams, self.device)

    # -- host-side helpers ---------------------------------------------------

    def _skip_frame_bytes(self) -> bytes:
        """An all-uncoded P-frame: decodes to the identity frame.  Encoded
        in the decoder's own flavour, so its header parses under the same
        options."""
        if self._skip is None:
            enc = (encode_sorenson_picture if self._prep is not None
                   else encode_standard_picture)
            self._skip = enc(
                self.w, self.h, PictureTypeCode.P_FRAME,
                [MBSpec(kind="uncoded")] * (self.mb_w * self.mb_h),
                temporal_reference=0)
        return self._skip

    def _next_stage(self, nbytes: int, frames: int = 1):
        """The next buffer of the ping-pong pair as its first `nbytes`
        bytes ([nbytes // 4, 4]) and its meta for `frames` frames ([frames,
        6, S]), once the copy that last read them has finished."""
        self._pp ^= 1
        i = self._pp
        ev = self._copied[i]
        if ev is not None:
            if not ev.query():      # the host runs two calls ahead
                incr("staging_reclaim_waits")
            with trace_stage("reclaim_wait"):
                ev.synchronize()
            self._copied[i] = None
        if self._stage[i].numel() < nbytes:
            size = max(nbytes, frames * self.n * self.max_frame_bytes + 4)
            self._stage[i] = torch.zeros(size, dtype=torch.uint8,
                                         pin_memory=self._pin)
        if self._meta[i].shape[0] < frames:
            self._meta[i] = torch.zeros((frames, 6, self.n),
                                        dtype=torch.int32,
                                        pin_memory=self._pin)
        return self._stage[i][:nbytes].view(-1, 4), self._meta[i][:frames]

    def _copy_to_device(self, stage, meta):
        """One `non_blocking` copy each of the staged payload and meta; the
        event after them guards the pinned buffer's reuse."""
        with trace_stage("transfer"):
            dev_stage = stage.to(self.device, non_blocking=True, copy=True)
            dev_meta = meta.to(self.device, non_blocking=True, copy=True)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                self._copied[self._pp] = ev
        return dev_stage, dev_meta

    def _commit(self, buffers, okm) -> None:
        """Commit the presentation params of the lanes whose header parsed,
        except absent (None) lanes: header-commit suppression."""
        hdr = self._prep.hdr
        commit = okm & np.array([b is not None for b in buffers], dtype=bool)
        np.copyto(self._last_quant, hdr[:, 6], where=commit)
        np.copyto(self._last_deblock, hdr[:, 5] != 0, where=commit)

    def _prepare_standard(self, buffers):
        """The standard header prep, the JAX package's Python loop: per
        stream, the picture header against the stream's last one, the dims
        check (an inherited format passes), the carried running options,
        and on success the header state and presentation params committed
        (present lanes only).  A stream that fails (over the cap, a header
        error) stages the skip frame with no options, and the first error
        is returned.  Returns (the payload: each stream's bytes padded to
        whole words, back to back; meta int32 [6, S]; first error)."""
        cap, skip = self.max_frame_bytes, self._skip_frame_bytes()
        meta = np.zeros((6, self.n), dtype=np.int32)
        parts, woff = [], 0
        first_err: Optional[Exception] = None
        for i, buf in enumerate(buffers):
            absent = buf is None
            if absent:
                buf = skip
            running = None  # set when the real header parses
            try:
                if len(buf) > cap:
                    raise H263Error(f"frame exceeds transfer bucket "
                                    f"({len(buf)} > {cap} bytes)")
                r = BitReader(bytes(buf))
                pic = decode_picture(r, self.decoder_options,
                                     self._pictures[i])
                if pic is None:
                    raise H263Error("outside device front-end scope")
                fmt = pic.format.width_and_height() if pic.format else None
                if fmt is not None and fmt != (self.w, self.h):
                    raise H263Error(f"stream {i} resolution {fmt} != bucket "
                                    f"({self.w}, {self.h})")
                # The MB layer runs under the CARRIED options, which
                # encode_ptype ships to the automaton.
                running = carry_forward_options(pic, self._running[i])
                if not absent:
                    self._pictures[i] = pic
                    self._running[i] = running
                    self._last_quant[i] = pic.quantizer
                    self._last_deblock[i] = bool(
                        pic.options & PictureOption.USE_DEBLOCKER)
            except H263Error as e:
                if first_err is None:
                    first_err = e
                r = BitReader(skip)
                pic = decode_picture(r, self.decoder_options, None)
                running = None  # the skip frame carries no options
            data = r.data
            words = (len(data) + 3) // 4
            parts.append(bytes(data) + b"\0" * (4 * words - len(data)))
            meta[:, i] = (r.pos, 8 * len(data), pic.quantizer,
                          encode_ptype(pic, running), 0, woff)
            woff += words
        return b"".join(parts), meta, first_err

    def _staged(self, buffers):
        """The buffers as the prep takes them: the skip frame for None, an
        empty payload (a header reject) for a frame over the cap."""
        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")
        cap = self.max_frame_bytes
        return [self._skip_frame_bytes() if b is None
                else (b"" if len(b) > cap else b) for b in buffers]

    # -- the step ------------------------------------------------------------

    def decode_step(self, buffers: Sequence[Optional[bytes]], mask=None):
        """Decode one frame per stream; returns (y, cb, cr) uint8 planes on
        the device.  `None` (or a False `mask` slot) decodes the skip frame
        with the header commit suppressed.  A frame over the transfer cap or
        with a rejected header decodes as the identity frame, and the first
        such error is raised after the step has been dispatched."""
        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")
        if mask is not None:
            buffers = [b if mask[i] else None for i, b in enumerate(buffers)]
        first_err: Optional[Exception] = None
        if self._prep is None:
            with trace_stage("host_parse"):
                payload, meta_np, first_err = self._prepare_standard(buffers)
            stage, meta = self._next_stage(len(payload) + 4)
            flat = stage.numpy().reshape(-1)
            flat[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
            flat[len(payload):] = 0
            meta = meta[0]
            meta.numpy()[:] = meta_np
        else:
            bufs = self._staged(buffers)
            stage, meta = self._next_stage(
                sum(((len(b) + 3) // 4) * 4 for b in bufs) + 4)
            meta = meta[0]
            with trace_stage("host_parse"):
                failed = self._prep.prepare_ragged(bufs, stage.numpy(),
                                                   meta.numpy())
                okm = self._prep.rc == 0
                self._commit(buffers, okm)
                if failed:
                    i = int(np.argmin(okm))
                    first_err = H263Error(
                        f"stream {i}: header rejected by device front-end "
                        f"prep (rc {int(self._prep.rc[i])})")

        dev_stage, dev_meta = self._copy_to_device(stage, meta)
        with trace_stage("reconstruct_dispatch"):
            dense, mvs, inter, status = parse_assemble_cuda(
                dev_stage, dev_meta, mbh=self.mb_h, mbw=self.mb_w,
                width=self.w, height=self.h)
            y, cb, cr = reconstruct_from_dense(dense, mvs, inter, self.ref_y,
                                               self.ref_cb, self.ref_cr)
        self.ref_y, self.ref_cb, self.ref_cr = y, cb, cr
        self.last_status = status
        self.last_status_steps = None
        if first_err is not None:
            raise first_err
        return y, cb, cr

    # -- the K-frame window ----------------------------------------------------

    def decode_steps(self, frame_lists: Sequence[Sequence[Optional[bytes]]]):
        """Decode a window of T frames per stream: `frame_lists` holds T
        sequences of S buffers.  Returns uint8 (ys, cbs, crs) on the device,
        [T, S, ...]; the per-(frame, stream) status is `last_status_steps`
        (int32 [T, S]) and the last frame's `last_status`.

        Frame for frame it equals T `decode_step` calls: `None` decodes the
        skip frame with the header commit suppressed, a frame over the cap
        decodes as the identity frame, the quantizer and deblock flag are
        committed per frame in order, a failed (frame, stream) gives the
        identity frame for that frame and the later frames decode against
        the surviving reference, and the first header reject is raised
        after the window has been dispatched.

        On the card: the T frames are staged back to back in one pinned
        buffer (frame t's word offsets rebased by the words before it), one
        copy of payload and meta, ONE automaton launch over T*S lanes, then
        T reconstruct launches in stream order, each writing its slices of
        the [T, S, ...] batches.  No host synchronisation: the call returns
        once the work is enqueued.

        Left out against the JAX package, whose automaton fills a tape that
        can overflow: `resolve_window_overflows`, the pre-window replay
        state and the `resolve_overflows` delegation (the port's automaton
        writes its outputs straight and never overflows), and the
        `pallas=` / `unroll=` / `tape_len=` knobs.
        """
        if self._prep is None:
            raise ValueError("decode_steps requires the native header prep "
                             "(Sorenson streams)")
        T = len(frame_lists)
        if T < 1:
            raise ValueError("empty window")
        r_lists = [self._staged(bufs) for bufs in frame_lists]
        wbytes_t = [sum(((len(b) + 3) // 4) * 4 for b in bufs)
                    for bufs in r_lists]
        total = sum(wbytes_t) + 4
        stage, meta = self._next_stage(total, T)
        flat = stage.numpy().reshape(-1)
        meta_np = meta.numpy()
        first_err: Optional[Exception] = None
        woff = 0  # running word offset into the shared flat buffer
        with trace_stage("host_parse"):
            for t, bufs in enumerate(r_lists):
                # Exact-size view: the prep zero-fills its view's tail.
                view = flat[woff * 4: woff * 4 + wbytes_t[t]]
                failed = self._prep.prepare_ragged(bufs, view, meta_np[t])
                okm = self._prep.rc == 0
                self._commit(frame_lists[t], okm)
                if failed and first_err is None:
                    i = int(np.argmin(okm))
                    first_err = H263Error(
                        f"frame {t} stream {i}: header rejected by device "
                        f"front-end prep (rc {int(self._prep.rc[i])})")
                # Failed lanes stage no payload and consume nothing.
                meta_np[t, 5] += woff
                woff += int(np.sum(np.where(
                    okm, (self._prep._lengths + 3) // 4, 0)))
            # The copied bytes past the payload's end (what failed lanes
            # left unused, the spare word) may hold an earlier call's bytes.
            flat[woff * 4: total] = 0

        dev_stage, dev_meta = self._copy_to_device(stage, meta)
        S, dev = self.n, self.device
        with trace_stage("reconstruct_dispatch"):
            dense, mvs, inter, status = parse_assemble_cuda(
                dev_stage, dev_meta, mbh=self.mb_h, mbw=self.mb_w,
                width=self.w, height=self.h)
            ys = torch.empty((T, S, self.h, self.w), dtype=torch.uint8,
                             device=dev)
            cbs = torch.empty((T, S, self.ch, self.cw), dtype=torch.uint8,
                              device=dev)
            crs = torch.empty_like(cbs)
            for t in range(T):
                reconstruct_from_dense(dense[t], mvs[t], inter[t], self.ref_y,
                                       self.ref_cb, self.ref_cr,
                                       out=(ys[t], cbs[t], crs[t]))
                self.ref_y, self.ref_cb, self.ref_cr = ys[t], cbs[t], crs[t]
        self.last_status_steps = status
        self.last_status = status[T - 1]
        if first_err is not None:
            raise first_err
        return ys, cbs, crs

    # -- state ---------------------------------------------------------------

    def load_state(self, y, cb, cr, last_quant=None, last_deblock=None):
        """Replace the reference planes (uint8 numpy [S, H, W] and two
        [S, ch, cw]) and, when given, the per-stream presentation state
        (last quantizer int [S], last deblock flag bool [S]) — e.g. to
        continue a GOP that another decoder started."""
        shapes = ((self.n, self.h, self.w), (self.n, self.ch, self.cw),
                  (self.n, self.ch, self.cw))
        for a, s in zip((y, cb, cr), shapes):
            if np.shape(a) != s:
                raise ValueError(f"plane shape {np.shape(a)} != {s}")
        self.ref_y, self.ref_cb, self.ref_cr = (
            torch.tensor(np.asarray(a, dtype=np.uint8), device=self.device)
            for a in (y, cb, cr))
        if last_quant is not None:
            self._last_quant[:] = np.asarray(last_quant, dtype=np.int32)
        if last_deblock is not None:
            self._last_deblock[:] = np.asarray(last_deblock, dtype=np.bool_)

    def reset_slot_state(self, slot: int, running=None) -> None:
        """Reset one lane to a fresh stream: planes zeroed, no previous
        header, presentation params and status cleared (the pool's
        slot-recycle contract).  `running` seeds the carried options (a
        standard stream rebucketed with them); None is a fresh stream."""
        # Out of place: the planes and status a step returned stay as
        # they were.
        idx = torch.tensor([slot], device=self.device)
        self.ref_y = self.ref_y.index_fill(0, idx, 0)
        self.ref_cb = self.ref_cb.index_fill(0, idx, 0)
        self.ref_cr = self.ref_cr.index_fill(0, idx, 0)
        self._pictures[slot] = None
        self._running[slot] = (PictureOption.NONE if running is None
                               else running)
        self._last_quant[slot] = 8
        self._last_deblock[slot] = False
        if self.last_status is not None:
            self.last_status = self.last_status.index_fill(0, idx, 0)
        if self.last_status_steps is not None:
            self.last_status_steps = self.last_status_steps.index_fill(
                1, idx, 0)

    def fetch_status(self) -> np.ndarray:
        """The last step's per-stream status (int32; 0 = ok).  Waits for
        the step to finish."""
        return self.last_status.cpu().numpy()

    def present_rgba(self, deblock: Optional[bool] = None):
        """RGBA uint8 [S, H, W, 4] of the current planes: per-stream deblock
        (the stream's advisory flag, or `deblock` for all) + BT.601."""
        strength, flags = self._params.to_device(
            QUANT_TO_STRENGTH[self._last_quant & 31],
            self._last_deblock if deblock is None else deblock)
        return present_rgba_batched(self.ref_y, self.ref_cb, self.ref_cr,
                                    strength, flags)
