"""Batched decoding with the device entropy front-end, PyTorch.

Port of `h263_tpu/parallel/device_batch.py::DeviceFrontendDecoder`, ragged
payload only: the single-frame step and the K-frame window.  Per step:

    host header prep -> one host-to-device copy of the ragged payload +
    int32 meta [6, S] -> entropy automaton (CUDA kernel) -> IDCT + motion
    compensation + add-clamp (one CUDA kernel) -> planes

Sorenson streams take the native header prep (`native.DevicePrepBatch`,
one call for every stream).  Standard H.263 streams (`DecoderOption.NONE`)
take the native standard prep (`native.StandardPrepBatch`, one call for
every stream): each plain-PTYPE picture header parses against the
stream's last one, the running options carry forward (`_running`: a
plain PTYPE keeps the UMV / MODIFIED_QUANTIZATION of an earlier
OPPTYPE) into the automaton's ptype word (`encode_ptype`'s bits), and
the frames pack the same ragged layout.  A lane the native call hands
back (a PLUSPTYPE or PB header, a format change, a header after one only
Python parses, PEI bytes, any error, a frame over the cap, other dims)
takes the JAX package's Python loop body for that stream alone
(`_prepare_lane`), in stream order, and the native call then stages it
as given; the native lanes commit their `Picture`s through a cache keyed
by the header row.  As in the JAX package, a standard decoder has no
window (`decode_steps` raises), since its headers chain from frame to
frame on the host.

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

With `mesh=` (`parallel/sharding.py`) the S streams split into contiguous
equal shards, one per mesh device, which share nothing: each shard has its
own header prep over its lanes, its own pinned staging pair and events, its
own presentation params, and its reference planes and statuses on its
device (`StreamShards`).  A step stages and copies every shard in turn,
then runs the sharded step program (`shard_device_frontend_fn`), which
dispatches each shard on its device's current stream; the per-stream
header state (`_pictures`, `_running`, `_last_quant`, `_last_deblock`)
stays global, and a header reject names its global stream.  This takes
the place of the JAX package's `step_fn=` injection.  Without `mesh=` the
decoder runs the same per-shard code over a mesh of its one device and
hands out that shard's tensors.

Stage timers (`utils/trace.py`, off unless enabled) take the JAX package's
names at its places: `host_parse`, `transfer`, `reconstruct_dispatch`,
`reclaim_wait`.
"""

from __future__ import annotations

import operator
from itertools import repeat
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..bitio import BitReader
from ..decoder.reconstruct import PresentParams
from ..native import DevicePrepBatch, StandardPrepBatch
from ..native.bindings import picture_from_std_row, std_prev_fmt
from ..ops.deblock import QUANT_TO_STRENGTH
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
from ..utils.trace import device_span, incr, trace_stage
from .sharding import (
    StreamShards,
    make_stream_mesh,
    place,
    shard_device_frontend_fn,
    shard_present_fn,
)

# Distinct header rows whose Picture a decoder keeps before starting over.
_PIC_CACHE_MAX = 1 << 16


class _Shard:
    """One device's share of a decoder's streams, lanes [lo, hi): the
    header prep over them (Sorenson or standard), the ping-pong staging
    pair (flat payload bytes with one spare zero word, so the payload is
    never empty; meta [T, 6, n], T = 1 until a window), the event of each
    buffer's last copy, and the presentation params."""

    def __init__(self, dec, device, lo, hi):
        n = hi - lo
        self.device, self.lo, self.hi = device, lo, hi
        self.prep = (DevicePrepBatch(n, dec.w, dec.h) if dec._sorenson
                     else StandardPrepBatch(n, dec.w, dec.h,
                                            dec.max_frame_bytes))
        self.pin = device.type == "cuda"
        self.stage = [torch.zeros(n * dec.max_frame_bytes + 4,
                                  dtype=torch.uint8, pin_memory=self.pin)
                      for _ in range(2)]
        self.meta = [torch.zeros((1, 6, n), dtype=torch.int32,
                                 pin_memory=self.pin) for _ in range(2)]
        self.copied = [None, None]
        self.pp = 0
        self.params = PresentParams(n, device)

    def next_stage(self, nbytes: int, frames: int, cap: int):
        """The next buffer of the ping-pong pair as its first `nbytes`
        bytes ([nbytes // 4, 4]) and its meta for `frames` frames ([frames,
        6, n]), once the copy that last read them has finished."""
        self.pp ^= 1
        i, n = self.pp, self.hi - self.lo
        ev = self.copied[i]
        if ev is not None:
            if not ev.query():      # the host runs two calls ahead
                incr("staging_reclaim_waits")
            with trace_stage("reclaim_wait"):
                ev.synchronize()
            self.copied[i] = None
        if self.stage[i].numel() < nbytes:
            size = max(nbytes, frames * n * cap + 4)
            self.stage[i] = torch.zeros(size, dtype=torch.uint8,
                                        pin_memory=self.pin)
        if self.meta[i].shape[0] < frames:
            self.meta[i] = torch.zeros((frames, 6, n), dtype=torch.int32,
                                       pin_memory=self.pin)
        return self.stage[i][:nbytes].view(-1, 4), self.meta[i][:frames]

    def copy_to_device(self, stage, meta):
        """One `non_blocking` copy each of the staged payload and meta; the
        event after them, on this device's stream, guards the pinned
        buffer's reuse."""
        with trace_stage("transfer"), device_span(
                "h2d", self.device, stage.numel() + 4 * meta.numel()):
            dev_stage = stage.to(self.device, non_blocking=True, copy=True)
            dev_meta = meta.to(self.device, non_blocking=True, copy=True)
            if self.pin:
                self.copied[self.pp] = kernels.record_event(self.device)
        return dev_stage, dev_meta


class DeviceFrontendDecoder:
    """Decode S same-resolution streams, Sorenson or (with
    `DecoderOption.NONE`) standard H.263, one frame per stream per
    `decode_step`, on `device` ("cuda", the default, "cuda:<k>" or "cpu";
    no fallback between them), or sharded over `mesh`
    (`parallel.sharding.make_stream_mesh`), whose size must divide S.
    With a mesh, the planes, statuses and RGBA come back as `StreamShards`
    and `device` is None.
    """

    def __init__(self, n_streams: int, width: int, height: int,
                 decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 *, device=None, max_frame_bytes: Optional[int] = None,
                 mesh=None):
        if mesh is not None and device is not None:
            raise ValueError("give device= or mesh=, not both")
        self.mesh = mesh
        self.device = (None if mesh is not None
                       else kernels.resolve_device(device or "cuda"))
        # The unsharded decoder is the mesh of its one device.
        self._mesh = mesh or make_stream_mesh([self.device])
        self._step_fn = shard_device_frontend_fn(self._mesh, height, width)
        self._present_fn = shard_present_fn(self._mesh)
        self.decoder_options = decoder_options
        self._sorenson = bool(decoder_options
                              & DecoderOption.SORENSON_SPARK_BITSTREAM)
        self.n = n_streams
        self.w, self.h = width, height
        self.cw, self.ch = (width + 1) // 2, (height + 1) // 2
        self.mb_w, self.mb_h = -(-width // 16), -(-height // 16)
        self.max_frame_bytes = (((max_frame_bytes or 8192) + 3) // 4) * 4
        # The native prep parses the headers, each shard's over its lanes.
        self._shards = [_Shard(self, dev, lo, hi) for dev, (lo, hi) in zip(
            self._mesh.devices, self._mesh.shard_ranges(n_streams))]
        # Per-stream header state of a standard stream: its last picture
        # header and the running options it carries (state.rs:147-155).
        self._pictures = [None] * n_streams
        self._running = [PictureOption.NONE] * n_streams
        # header row bytes -> (Picture, running options) of native lanes.
        self._pic_cache: dict = {}
        # The native prep's previous-format code of each stream
        # (`std_prev_fmt` of its last header) and the header it was taken
        # from, taken anew where another writer (the pool, a checkpoint,
        # the Python lane body) replaced the stream's `_pictures` entry.
        self._fmt_bits = np.full(n_streams, -1, dtype=np.int32)
        self._fmt_of = [None] * n_streams

        def planes(h, w):
            return self._join(StreamShards([
                torch.zeros((sh.hi - sh.lo, h, w), dtype=torch.uint8,
                            device=sh.device) for sh in self._shards]))

        self.ref_y = planes(self.h, self.w)
        self.ref_cb = planes(self.ch, self.cw)
        self.ref_cr = planes(self.ch, self.cw)
        self.last_status = None
        # [T, S] statuses of the last window (None after a single step).
        self.last_status_steps = None
        self._skip: Optional[bytes] = None
        # Last-good presentation params per stream (quantizer -> deblock
        # strength, advisory deblocker flag).
        self._last_quant = np.full(n_streams, 8, dtype=np.int32)
        self._last_deblock = np.zeros(n_streams, dtype=np.bool_)

    # -- shards ----------------------------------------------------------------

    def _join(self, x: StreamShards):
        """A sharded result as the decoder hands it out: StreamShards with
        a mesh, the one shard's tensor without."""
        return x if self.mesh is not None else x[0]

    def _split(self, x, axis: int = 0) -> StreamShards:
        """The inverse of `_join`."""
        return x if self.mesh is not None else StreamShards((x,), axis)

    def _shard_of(self, slot: int):
        """(shard index, lane within it) of stream `slot`."""
        for k, sh in enumerate(self._shards):
            if sh.lo <= slot < sh.hi:
                return k, slot - sh.lo
        raise IndexError(f"stream {slot} out of range [0, {self.n})")

    def _dispatch(self, staged):
        """The device half of a step or window over every shard:
        (y, cb, cr, status) as StreamShards."""
        payloads, metas = zip(*staged)
        refs = (self._split(r) for r in (self.ref_y, self.ref_cb,
                                         self.ref_cr))
        with trace_stage("reconstruct_dispatch"):
            return self._step_fn(payloads, metas, *refs)

    # -- host-side helpers ---------------------------------------------------

    def _skip_frame_bytes(self) -> bytes:
        """An all-uncoded P-frame: decodes to the identity frame.  Encoded
        in the decoder's own flavour, so its header parses under the same
        options."""
        if self._skip is None:
            enc = (encode_sorenson_picture if self._sorenson
                   else encode_standard_picture)
            self._skip = enc(
                self.w, self.h, PictureTypeCode.P_FRAME,
                [MBSpec(kind="uncoded")] * (self.mb_w * self.mb_h),
                temporal_reference=0)
        return self._skip

    def _commit(self, sh, buffers, okm) -> None:
        """Commit the presentation params of shard `sh`'s lanes whose
        header parsed, except absent (None) lanes: header-commit
        suppression."""
        hdr = sh.prep.hdr
        commit = okm & np.array([b is not None for b in buffers], dtype=bool)
        np.copyto(self._last_quant[sh.lo:sh.hi], hdr[:, 6], where=commit)
        np.copyto(self._last_deblock[sh.lo:sh.hi], hdr[:, 5] != 0,
                  where=commit)

    def _prepare_lane(self, i: int, buf):
        """The Python header prep of stream `i`, the JAX package's loop
        body, for a lane the native prep hands back: the picture header
        against the stream's last one, the dims check (an inherited format
        passes), the carried running options, and on success the header
        state and presentation params committed (a present lane only).  A
        stream that fails (over the cap, a header error) stages the skip
        frame with no options.  Returns (the bytes to stage, meta rows 0-3:
        start bit, nbits, quant0, ptype word; the error or None)."""
        skip = self._skip_frame_bytes()
        absent = buf is None
        if absent:
            buf = skip
        err = None
        try:
            if len(buf) > self.max_frame_bytes:
                raise H263Error(f"frame exceeds transfer bucket "
                                f"({len(buf)} > {self.max_frame_bytes} "
                                f"bytes)")
            r = BitReader(bytes(buf))
            pic = decode_picture(r, self.decoder_options, self._pictures[i])
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
            err = e
            r = BitReader(skip)
            pic = decode_picture(r, self.decoder_options, None)
            running = None  # the skip frame carries no options
        return r.data, (r.pos, 8 * len(r.data), pic.quantizer,
                        encode_ptype(pic, running)), err

    def _prepare_standard(self, sh, buffers, bufs, flat, meta):
        """The standard header prep of shard `sh`'s streams into the flat
        uint8 `flat` and `meta` (int32 [6, n]): one native call over the
        lanes (`bufs`: the shard's `buffers` as bytes, the skip frame for
        None), then the lanes it hands back through `_prepare_lane` in
        stream order and a second call that stages them as given; the
        native lanes' header state and presentation params are committed
        (present lanes only), their Pictures cached per header row.
        Returns (the payload's words, the first error or None)."""
        lo, hi = sh.lo, sh.hi
        prep = sh.prep
        pics = self._pictures[lo:hi]
        if any(map(operator.is_not, pics, self._fmt_of[lo:hi])):
            for k, pic in enumerate(pics):
                if pic is not self._fmt_of[lo + k]:
                    self._fmt_bits[lo + k] = std_prev_fmt(pic)
                    self._fmt_of[lo + k] = pic
        prep.prev_fmt[:] = self._fmt_bits[lo:hi]
        if self.decoder_options & DecoderOption.USE_SCALABILITY_MODE:
            prep.prev_fmt[:] = -2   # a header layout the native parse lacks
        prep.prev_running[:] = np.fromiter(self._running[lo:hi],
                                           dtype=np.uint32, count=hi - lo)
        prep.given[:] = 0
        first_err = None
        punted = prep.prepare(bufs, flat, meta)
        native = prep.rc == 0
        if punted:
            incr("std_python_header_lanes", punted)
            bufs = list(bufs)
            for k in np.flatnonzero(~native).tolist():
                bufs[k], meta[:4, k], err = self._prepare_lane(
                    lo + k, buffers[lo + k])
                if first_err is None:
                    first_err = err
                prep.given[k] = 1
            prep.prepare(bufs, flat, meta)
        commit = native & np.fromiter(
            map(operator.is_not, buffers[lo:hi], repeat(None)), dtype=bool,
            count=hi - lo)
        hdr = prep.hdr
        np.copyto(self._last_quant[lo:hi], hdr[:, 5], where=commit)
        np.copyto(self._last_deblock[lo:hi],
                  (hdr[:, 4] & int(PictureOption.USE_DEBLOCKER)) != 0,
                  where=commit)
        np.copyto(self._fmt_bits[lo:hi], hdr[:, 8], where=commit)
        rows, cache = hdr.tobytes(), self._pic_cache
        step = hdr.shape[1] * hdr.itemsize
        keys = [rows[j:j + step] for j in range(0, len(rows), step)]
        ents = list(map(cache.get, keys))
        for k in np.flatnonzero(commit).tolist():
            ent = ents[k] or cache.get(keys[k])  # or made for a lane before
            if ent is None:
                if len(cache) >= _PIC_CACHE_MAX:
                    cache.clear()
                ent = cache[keys[k]] = (picture_from_std_row(hdr[k]),
                                        PictureOption(int(hdr[k, 9])))
            self._pictures[lo + k] = self._fmt_of[lo + k] = ent[0]
            self._running[lo + k] = ent[1]
        return prep.words, first_err

    def _staged(self, buffers):
        """The buffers as the prep takes them: the skip frame for None, an
        empty payload (a header reject) for a frame over the cap."""
        cap = self.max_frame_bytes
        return [self._skip_frame_bytes() if b is None
                else (b"" if len(b) > cap else b) for b in buffers]

    def _check_len(self, buffers) -> None:
        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")

    # -- the step ------------------------------------------------------------

    def _stage_step(self, sh, buffers):
        """Shard `sh`'s host prep of one step into its next staging buffer,
        copied to its device: ((payload, meta) on the device, first
        error)."""
        cap = self.max_frame_bytes
        first_err: Optional[Exception] = None
        if not self._sorenson:
            skip = self._skip_frame_bytes()
            bufs = [skip if b is None else b if type(b) is bytes
                    else bytes(b) for b in buffers[sh.lo:sh.hi]]
            # Room for each lane's own bytes or the skip frame, whichever
            # it stages, and the spare word.
            lens = np.fromiter(map(len, bufs), dtype=np.int64,
                               count=len(bufs))
            wskip = (len(skip) + 3) // 4 * 4
            room = np.where(lens <= cap, np.maximum((lens + 3) // 4 * 4,
                                                    wskip), wskip)
            stage, meta = sh.next_stage(int(room.sum()) + 4, 1, cap)
            meta = meta[0]
            with trace_stage("host_parse"):
                words, first_err = self._prepare_standard(
                    sh, buffers, bufs, stage.numpy().reshape(-1),
                    meta.numpy())
            stage = stage[:words + 1]
        else:
            mine = buffers[sh.lo:sh.hi]
            bufs = self._staged(mine)
            stage, meta = sh.next_stage(
                sum(((len(b) + 3) // 4) * 4 for b in bufs) + 4, 1, cap)
            meta = meta[0]
            with trace_stage("host_parse"):
                failed = sh.prep.prepare_ragged(bufs, stage.numpy(),
                                                meta.numpy())
                okm = sh.prep.rc == 0
                self._commit(sh, mine, okm)
                if failed:
                    i = int(np.argmin(okm))
                    first_err = H263Error(
                        f"stream {sh.lo + i}: header rejected by device "
                        f"front-end prep (rc {int(sh.prep.rc[i])})")
        return sh.copy_to_device(stage, meta), first_err

    def decode_step(self, buffers: Sequence[Optional[bytes]], mask=None):
        """Decode one frame per stream; returns (y, cb, cr) uint8 planes on
        the device (StreamShards with a mesh).  `None` (or a False `mask`
        slot) decodes the skip frame with the header commit suppressed.  A
        frame over the transfer cap or with a rejected header decodes as
        the identity frame, and the first such error is raised after the
        step has been dispatched on every shard."""
        self._check_len(buffers)
        if mask is not None:
            buffers = [b if mask[i] else None for i, b in enumerate(buffers)]
        staged, first_err = [], None
        for sh in self._shards:
            dev_in, err = self._stage_step(sh, buffers)
            staged.append(dev_in)
            first_err = first_err or err
        y, cb, cr, status = (self._join(x) for x in self._dispatch(staged))
        self.ref_y, self.ref_cb, self.ref_cr = y, cb, cr
        self.last_status = status
        self.last_status_steps = None
        if first_err is not None:
            raise first_err
        return y, cb, cr

    # -- the K-frame window ----------------------------------------------------

    def _stage_window(self, sh, frame_lists):
        """Shard `sh`'s host prep of a window, its T frames back to back in
        one staging buffer (frame t's word offsets rebased by the words
        before it), copied to its device: ((payload, meta) on the device,
        (frame, global stream, error) of its first header reject or
        None)."""
        r_lists = [self._staged(bufs[sh.lo:sh.hi]) for bufs in frame_lists]
        wbytes_t = [sum(((len(b) + 3) // 4) * 4 for b in bufs)
                    for bufs in r_lists]
        total = sum(wbytes_t) + 4
        stage, meta = sh.next_stage(total, len(frame_lists),
                                    self.max_frame_bytes)
        flat = stage.numpy().reshape(-1)
        meta_np = meta.numpy()
        first = None
        woff = 0  # running word offset into the shared flat buffer
        with trace_stage("host_parse"):
            for t, bufs in enumerate(r_lists):
                # Exact-size view: the prep zero-fills its view's tail.
                view = flat[woff * 4: woff * 4 + wbytes_t[t]]
                failed = sh.prep.prepare_ragged(bufs, view, meta_np[t])
                okm = sh.prep.rc == 0
                self._commit(sh, frame_lists[t][sh.lo:sh.hi], okm)
                if failed and first is None:
                    i = int(np.argmin(okm))
                    first = (t, sh.lo + i, H263Error(
                        f"frame {t} stream {sh.lo + i}: header rejected by "
                        f"device front-end prep (rc {int(sh.prep.rc[i])})"))
                # Failed lanes stage no payload and consume nothing.
                meta_np[t, 5] += woff
                woff += int(np.sum(np.where(
                    okm, (sh.prep._lengths + 3) // 4, 0)))
            # The copied bytes past the payload's end (what failed lanes
            # left unused, the spare word) may hold an earlier call's bytes.
            flat[woff * 4: total] = 0
        return sh.copy_to_device(stage, meta), first

    def decode_steps(self, frame_lists: Sequence[Sequence[Optional[bytes]]]):
        """Decode a window of T frames per stream: `frame_lists` holds T
        sequences of S buffers.  Returns uint8 (ys, cbs, crs) on the device,
        [T, S, ...] (StreamShards split along the stream axis, 1, with a
        mesh); the per-(frame, stream) status is `last_status_steps` (int32
        [T, S]) and the last frame's `last_status`.

        Frame for frame it equals T `decode_step` calls: `None` decodes the
        skip frame with the header commit suppressed, a frame over the cap
        decodes as the identity frame, the quantizer and deblock flag are
        committed per frame in order, a failed (frame, stream) gives the
        identity frame for that frame and the later frames decode against
        the surviving reference, and the first header reject (the earliest
        frame, then the lowest stream) is raised after the window has been
        dispatched on every shard.

        On the card, per shard: the T frames are staged back to back in
        one pinned buffer, one copy of payload and meta, ONE automaton
        launch over T*S/n lanes, then T reconstruct launches in stream
        order, each writing its slices of the [T, S/n, ...] batches.  No
        host synchronisation: the call returns once the work is enqueued.

        Left out against the JAX package, whose automaton fills a tape that
        can overflow: `resolve_window_overflows`, the pre-window replay
        state and the `resolve_overflows` delegation (the port's automaton
        writes its outputs straight and never overflows), and the
        `pallas=` / `unroll=` / `tape_len=` knobs.
        """
        if not self._sorenson:
            raise ValueError("decode_steps requires the native header prep "
                             "(Sorenson streams)")
        T = len(frame_lists)
        if T < 1:
            raise ValueError("empty window")
        for bufs in frame_lists:
            self._check_len(bufs)
        staged, rejects = [], []
        for sh in self._shards:
            dev_in, first = self._stage_window(sh, frame_lists)
            staged.append(dev_in)
            if first is not None:
                rejects.append(first)
        outs = self._dispatch(staged)
        ys, cbs, crs, status = (self._join(x) for x in outs)
        (self.ref_y, self.ref_cb, self.ref_cr,
         self.last_status) = (self._join(StreamShards([p[T - 1] for p in x]))
                              for x in outs)
        self.last_status_steps = status
        if rejects:
            raise min(rejects, key=lambda r: r[:2])[2]
        return ys, cbs, crs

    # -- state ---------------------------------------------------------------

    def load_state(self, y, cb, cr, last_quant=None, last_deblock=None):
        """Replace the reference planes (uint8 numpy [S, H, W] and two
        [S, ch, cw], scattered over the mesh) and, when given, the
        per-stream presentation state (last quantizer int [S], last
        deblock flag bool [S]) — e.g. to continue a GOP that another
        decoder started."""
        shapes = ((self.n, self.h, self.w), (self.n, self.ch, self.cw),
                  (self.n, self.ch, self.cw))
        for a, s in zip((y, cb, cr), shapes):
            if np.shape(a) != s:
                raise ValueError(f"plane shape {np.shape(a)} != {s}")
        self.ref_y, self.ref_cb, self.ref_cr = (
            self._join(place(np.asarray(a, dtype=np.uint8), mesh=self._mesh))
            for a in (y, cb, cr))
        if last_quant is not None:
            self._last_quant[:] = np.asarray(last_quant, dtype=np.int32)
        if last_deblock is not None:
            self._last_deblock[:] = np.asarray(last_deblock, dtype=np.bool_)

    def reset_slot_state(self, slot: int, running=None) -> None:
        """Reset one lane to a fresh stream: planes zeroed, no previous
        header, presentation params and status cleared (the pool's
        slot-recycle contract), on the lane's own shard only.  `running`
        seeds the carried options (a standard stream rebucketed with
        them); None is a fresh stream."""
        k, lane = self._shard_of(slot)
        idx = torch.tensor([lane], device=self._shards[k].device)

        def cleared(x, axis=0):
            # Out of place: the planes and status a step returned stay as
            # they were.
            parts = list(self._split(x, axis))
            parts[k] = parts[k].index_fill(axis, idx, 0)
            return self._join(StreamShards(parts, axis))

        self.ref_y = cleared(self.ref_y)
        self.ref_cb = cleared(self.ref_cb)
        self.ref_cr = cleared(self.ref_cr)
        self._pictures[slot] = None
        self._running[slot] = (PictureOption.NONE if running is None
                               else running)
        self._last_quant[slot] = 8
        self._last_deblock[slot] = False
        if self.last_status is not None:
            self.last_status = cleared(self.last_status)
        if self.last_status_steps is not None:
            self.last_status_steps = cleared(self.last_status_steps, 1)

    def fetch_status(self) -> np.ndarray:
        """The last step's per-stream status (int32 [S]; 0 = ok).  Waits
        for the step to finish."""
        return np.concatenate([s.cpu().numpy()
                               for s in self._split(self.last_status)])

    def present_rgba(self, deblock: Optional[bool] = None):
        """RGBA uint8 [S, H, W, 4] of the current planes (StreamShards with
        a mesh): per-stream deblock (the stream's advisory flag, or
        `deblock` for all) + BT.601."""
        strength = QUANT_TO_STRENGTH[self._last_quant & 31]
        flags = np.broadcast_to(np.asarray(
            self._last_deblock if deblock is None else deblock,
            dtype=np.bool_), (self.n,))
        params = [sh.params.to_device(strength[sh.lo:sh.hi],
                                      flags[sh.lo:sh.hi])
                  for sh in self._shards]
        planes = (self._split(r) for r in (self.ref_y, self.ref_cb,
                                           self.ref_cr))
        return self._join(self._present_fn(
            *planes, *(StreamShards(p) for p in zip(*params))))
