"""Mixed-resolution stream pool with dynamic membership, PyTorch.

Port of `h263_tpu/parallel/pool.py::StreamPool`, for Sorenson Spark streams
and (with `DecoderOption.NONE`) standard H.263, with either entropy
front-end: `frontend="device"` (the port's default:
`DeviceFrontendDecoder` buckets, the entropy automaton on the card) or
`"host"` (`BatchedStreamDecoder` buckets, the native host parse and the
fused transport; the JAX package's default).  Streams of different
resolutions cannot share one lockstep batch, so the pool groups them into
per-resolution buckets; within a bucket, slots decode in lockstep:

* **join** -- `add_stream` at any time; a free slot is recycled, or the
  bucket doubles (slot indices preserved, planes and per-stream state
  migrated);
* **leave** -- `remove_stream` frees the slot; its state resets and the
  slot decodes skip frames until reused;
* **absent** -- a registered stream may not supply a frame for a step; its
  slot decodes the skip frame with header commit suppressed, so its planes
  and state do not move;
* **resolution change** -- a stream whose next frame is an I-frame at new
  dimensions moves to that resolution's bucket (reference planes reset, as
  the single-stream decoder does on an I-frame; running options carry
  over); the frame must first pass the host parse in full with no INTER
  macroblock.  A non-I frame at other dimensions, a frame that fails that
  parse, or dimensions beyond `max_dims`, raises PictureFormatInvalid and
  leaves the stream where it was.  A Sorenson header names its dims at a
  fixed place; a standard one is probed at fixed bits first (plain PTYPE
  formats, OPPTYPE formats, an inherited format), and only an ambiguous or
  changed answer runs the Python header parse against the stream's last
  header.  As in the reference, that parse refuses any change of format
  against the stream's last picture (UnimplementedDecoding, raised by the
  stream's bucket), so only a standard stream with no picture yet moves;
  the running options its slot holds go with it, from either front-end.

A device pool's `decode_steps` decodes a window of T frames with one
`DeviceFrontendDecoder.decode_steps` per bucket (one copy, one automaton
launch, T reconstructions), frame for frame equal to T `decode_step` calls;
a window in which a stream changes resolution falls back to those calls
(counted as `pool_window_fallbacks`), as does every window of a standard
pool (its decoders have no window step), and a host pool always runs them.

`switch_frontend("device")` moves a Sorenson host pool onto device
buckets live: the planes stay where they are on the device, and each
stream's last header, running options, quantizer and deblock flag move
into the new `DeviceFrontendDecoder`s.  With `adaptive_frontend=True` a
host pool switches by itself when its host-to-device rate, an average
of each step's copy time over its bytes, falls `degrade_ratio` times
below the best average seen after `adapt_min_samples` steps (the JAX
package's trigger, with its defaults).  The copy time comes from CUDA
events around each step's copies, read one step later once they have
completed, so the host never waits for them.  Counters:
`pool_degraded_window_detected`, `pool_frontend_switches`.

The device front-end stays the port's default: the H100 readings of
PERF.md favour it (phase 11 of chip_smoke.py sets the host front-end beside
it).

Not ported: `resolve_overflows` (the port's automaton has no tape and
never overflows).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..bitio import BitReader
from ..parser.frame import parse_frame_auto
from ..parser.picture import decode_picture
from ..types import (
    DecoderOption,
    H263Error,
    PictureFormatInvalid,
    PictureOption,
    PictureTypeCode,
)
from ..utils.trace import incr
from .batch import BatchedStreamDecoder
from .device_batch import DeviceFrontendDecoder


class _Bucket:
    __slots__ = ("dec", "slots", "free")

    def __init__(self, dec):
        self.dec = dec
        self.slots: dict = {}   # stream_id -> slot index
        self.free: list = list(range(dec.n))[::-1]  # stack of free slots

    def mask(self, present) -> np.ndarray:
        m = np.zeros(self.dec.n, dtype=bool)
        for sid, slot in self.slots.items():
            if sid in present:
                m[slot] = True
        return m


#: Plain-PTYPE / OPPTYPE 3-bit source-format codes -> dims (H.263 table 2).
_STD_FMT_DIMS = {1: (128, 96), 2: (176, 144), 3: (352, 288),
                 4: (704, 576), 5: (1408, 1152)}


def _sniff_standard_probe(buf: bytes, current_dims):
    """Cheap dims probe of a STANDARD picture: "unchanged", "changed", or
    None (ambiguous: the caller runs the full header parse).

    Reads fixed-offset PTYPE/PLUSPTYPE fields from the first 8 bytes:
    PSC(17) GN(5) TR(8) PTYPE['1','0',3 flags] fmt(3); fmt 1-5 are fixed
    formats, 7 is PLUSPTYPE (UFEP(3): 000 inherits the previous format,
    001 carries OPPTYPE whose own fmt(3) is read the same way; custom
    formats need CPFMT and fall back).  It never answers "unchanged" when
    the true dims differ; an inherited format (UFEP=000) is unchanged by
    definition."""
    if len(buf) < 8:
        return None
    v = int.from_bytes(buf[:8], "big")
    if (v >> 42) != 0b1_00000:      # PSC(17) + GN==0
        return None
    if (v >> 33) & 1 != 1 or (v >> 32) & 1 != 0:  # PTYPE '10' marker
        return None
    fmt = (v >> 26) & 7
    if fmt in _STD_FMT_DIMS:
        return ("unchanged" if _STD_FMT_DIMS[fmt] == tuple(current_dims)
                else "changed")
    if fmt != 7:
        return None  # forbidden/reserved: the full parse raises precisely
    ufep = (v >> 23) & 7
    if ufep == 0:
        return "unchanged"  # no OPPTYPE: format inherited
    if ufep != 1:
        return None
    ofmt = (v >> 20) & 7
    if ofmt in _STD_FMT_DIMS:
        return ("unchanged" if _STD_FMT_DIMS[ofmt] == tuple(current_dims)
                else "changed")
    return None  # custom (CPFMT) or reserved


def _sniff_sorenson(buf: bytes):
    """(width, height, is_iframe) from a Sorenson picture header, or None.

    Layout (picture.rs:628-659): PSC(17) version(5) TR(8) fmt(3)
    [custom dims 8+8 or 16+16] ptype(2) ...
    """
    if len(buf) < 9:
        return None
    word = int.from_bytes(buf[:9], "big")  # 72 bits
    top = word >> (72 - 17)
    if top != 1:
        return None
    rest = word & ((1 << 55) - 1)          # after PSC
    fmt = (rest >> (55 - 5 - 8 - 3)) & 0x7
    pos = 5 + 8 + 3
    if fmt == 0:
        w = (rest >> (55 - pos - 8)) & 0xFF
        h = (rest >> (55 - pos - 16)) & 0xFF
        pos += 16
    elif fmt == 1:
        w = (rest >> (55 - pos - 16)) & 0xFFFF
        h = (rest >> (55 - pos - 32)) & 0xFFFF
        pos += 32
    else:
        dims = {2: (352, 288), 3: (176, 144), 4: (128, 96),
                5: (320, 240), 6: (160, 120)}.get(fmt)
        if dims is None:
            return None
        w, h = dims
    ptype = (rest >> (55 - pos - 2)) & 0x3
    return w, h, ptype == 0


class PoolStepResult:
    """Device-resident results of one pool decode step.

    Mapping-shaped: `result[sid]` returns that stream's (y, cb, cr) numpy
    planes -- an explicit copy to the host of one stream's slices.
    `device_planes(sid)` hands back the device tensors (no copy);
    `fetch_all()` copies every decoded stream.
    """

    __slots__ = ("_entries", "_cache")

    def __init__(self):
        self._entries: dict = {}  # sid -> (y, cb, cr batched tensors, slot)
        self._cache: dict = {}

    def _add(self, sid, y, cb, cr, slot: int) -> None:
        self._entries[sid] = (y, cb, cr, slot)

    def device_planes(self, sid):
        """(y, cb, cr) of one stream as device tensors."""
        y, cb, cr, slot = self._entries[sid]
        return y[slot], cb[slot], cr[slot]

    def __getitem__(self, sid):
        got = self._cache.get(sid)
        if got is None:
            incr("pool_host_fetches")
            got = tuple(p.cpu().numpy() for p in self.device_planes(sid))
            self._cache[sid] = got
        return got

    def fetch_all(self) -> dict:
        """{sid: (y, cb, cr) numpy} for every decoded stream."""
        return {sid: self[sid] for sid in self._entries}

    def __contains__(self, sid):
        return sid in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        """(sid, (y, cb, cr) numpy) pairs, each an explicit fetch."""
        return [(sid, self[sid]) for sid in self._entries]

    def values(self):
        return [self[sid] for sid in self._entries]


class StreamPool:
    """Decode many streams of mixed resolutions, Sorenson or (with
    `DecoderOption.NONE`) standard H.263, with dynamic membership, on
    `device` ("cuda", the default, or "cpu").

    Usage:
        pool = StreamPool()
        pool.add_stream("a", 352, 288)
        pool.add_stream("b", 176, 144)
        planes = pool.decode_step({"a": buf_a, "b": buf_b})
        planes["a"]                    # -> (y, cb, cr) numpy (explicit copy)
        planes.device_planes("a")      # -> device tensors, no copy
        pool.remove_stream("b")        # slot recycled
        pool.add_stream("c", 176, 144) # reuses b's slot, fresh state
        rgba = pool.present_rgba()     # {sid: uint8 [H, W, 4] on the device}
    """

    def __init__(self, decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 frontend: str = "device", max_dims: tuple = (2048, 2048),
                 adaptive_frontend: bool = False, degrade_ratio: float = 8.0,
                 adapt_min_samples: int = 8, *, device="cuda",
                 max_frame_bytes: Optional[int] = None):
        """`frontend` selects each bucket's decoder: "device"
        (`DeviceFrontendDecoder`, the default) or "host"
        (`BatchedStreamDecoder`).  `max_dims` bounds the resolutions a
        mid-stream change may create: a bucket's planes are sized by its
        dims, so an unchecked (possibly corrupt) header must not allocate a
        65535x65535 bucket -- frames beyond the bound fail per stream
        instead.  `device` passes to the bucket decoders and
        `max_frame_bytes` to device ones.

        `adaptive_frontend` (Sorenson pools only, as in the JAX package):
        a host pool switches to the device front-end when its
        host-to-device rate falls `degrade_ratio` times below the best
        seen over at least `adapt_min_samples` steps (module
        docstring)."""
        if frontend not in ("host", "device"):
            raise ValueError(f"unknown frontend {frontend!r}")
        if adaptive_frontend and not (
                decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM):
            raise ValueError("adaptive_frontend requires a Sorenson pool")
        self.decoder_options = decoder_options
        self._sorenson = bool(decoder_options
                              & DecoderOption.SORENSON_SPARK_BITSTREAM)
        self.frontend = frontend
        self.max_dims = max_dims
        self.adaptive_frontend = adaptive_frontend
        self.degrade_ratio = float(degrade_ratio)
        self.adapt_min_samples = int(adapt_min_samples)
        self.device = device
        self.max_frame_bytes = max_frame_bytes
        self._pending: dict = {}          # (w, h) -> [stream_id, ...]
        self._pending_running: dict = {}  # stream_id -> carried options
        self._buckets: dict = {}          # (w, h) -> _Bucket
        self._dims: dict = {}             # stream_id -> (w, h)
        # The rate monitor: an average of bytes/s, the best average seen.
        self._bw_ema: Optional[float] = None
        self._bw_best = 0.0
        self._bw_samples = 0
        # Where a host bucket's last copy reading comes from (the tests
        # feed readings here).
        self._transfer_stats_fn = (
            lambda dec: (dec.last_transfer_bytes, dec.last_transfer_s))

    def _make_decoder(self, n: int, width: int, height: int,
                      frontend: Optional[str] = None):
        if (frontend or self.frontend) == "host":
            return BatchedStreamDecoder(n, width, height,
                                        self.decoder_options,
                                        device=self.device)
        return DeviceFrontendDecoder(n, width, height, self.decoder_options,
                                     device=self.device,
                                     max_frame_bytes=self.max_frame_bytes)

    # -- membership -----------------------------------------------------------

    def add_stream(self, stream_id, width: int, height: int) -> None:
        """Register a stream (before or after decoding has started)."""
        if stream_id in self._dims:
            raise RuntimeError(f"duplicate stream id {stream_id!r}")
        key = (width, height)
        self._dims[stream_id] = key
        incr("pool_joins")
        if key in self._buckets:
            self._join(key, stream_id)
        else:
            self._pending.setdefault(key, []).append(stream_id)

    def remove_stream(self, stream_id) -> None:
        """Unregister a stream; its slot pads until recycled by a join."""
        key = self._dims.pop(stream_id)
        incr("pool_leaves")
        self._pending_running.pop(stream_id, None)
        pend = self._pending.get(key)
        if pend and stream_id in pend:
            pend.remove(stream_id)
            return
        bucket = self._buckets[key]
        slot = bucket.slots.pop(stream_id)
        bucket.dec.reset_slot_state(slot)
        bucket.free.append(slot)

    def _join(self, key, stream_id, running=None) -> int:
        bucket = self._buckets[key]
        if not bucket.free:
            self._grow(key)
            bucket = self._buckets[key]
        slot = bucket.free.pop()
        bucket.dec.reset_slot_state(slot, running)
        bucket.slots[stream_id] = slot
        return slot

    def _finalize(self, key):
        ids = self._pending.pop(key)
        bucket = _Bucket(self._make_decoder(len(ids), key[0], key[1]))
        self._buckets[key] = bucket
        for sid in ids:
            slot = bucket.slots[sid] = bucket.free.pop()
            running = self._pending_running.pop(sid, None)
            if running is not None:  # carried across a pending rebucket
                bucket.dec.reset_slot_state(slot, running)

    def _grow(self, key) -> None:
        """Double a full bucket's capacity, migrating planes and per-stream
        state; slot indices are preserved so outputs stay stable."""
        old = self._buckets[key]
        n_old = old.dec.n
        n_new = max(2 * n_old, 1)
        dec = self._make_decoder(n_new, key[0], key[1])
        if self.frontend == "host":
            dec.states[:n_old] = old.dec.states
            dec._std_prev_fmt[:n_old] = old.dec._std_prev_fmt
            dec._mv_full = old.dec._mv_full
        else:
            dec._pictures[:n_old] = old.dec._pictures
            dec._running[:n_old] = old.dec._running
            dec._last_quant[:n_old] = old.dec._last_quant
            dec._last_deblock[:n_old] = old.dec._last_deblock
            if old.dec.last_status is not None:
                status = torch.zeros(n_new, dtype=old.dec.last_status.dtype,
                                     device=dec.device)
                status[:n_old] = old.dec.last_status
                dec.last_status = status
        for name in ("ref_y", "ref_cb", "ref_cr"):
            getattr(dec, name)[:n_old] = getattr(old.dec, name)
        bucket = _Bucket(dec)
        bucket.slots = dict(old.slots)
        used = set(old.slots.values())
        bucket.free = [i for i in range(n_new)[::-1] if i not in used]
        self._buckets[key] = bucket

    # -- resolution change ----------------------------------------------------

    def _sniff(self, stream_id, buf: bytes):
        """(w, h, is_iframe) of the frame, or None if unparseable."""
        if self._sorenson:
            return _sniff_sorenson(bytes(buf))
        # The probe answers the common "dims unchanged" case from a few
        # fixed bits; an ambiguous or changed answer takes the full header
        # parse against the stream's last header.
        if _sniff_standard_probe(bytes(buf),
                                 self._dims[stream_id]) == "unchanged":
            w, h = self._dims[stream_id]
            return w, h, False  # is_iframe unused when the dims match
        bucket = self._buckets.get(self._dims[stream_id])
        last = None
        if bucket is not None and stream_id in bucket.slots:
            slot = bucket.slots[stream_id]
            states = getattr(bucket.dec, "states", None)
            last = (states[slot].last_header if states is not None
                    else bucket.dec._pictures[slot])
        try:
            pic = decode_picture(BitReader(bytes(buf)), self.decoder_options,
                                 last)
        except Exception:
            return None  # the bucket's parse raises the precise error
        if pic is None:
            return None
        fmt = pic.format or (last.format if last else None)
        wh = fmt.width_and_height() if fmt else None
        if wh is None:
            return None
        return wh[0], wh[1], pic.picture_type is PictureTypeCode.I_FRAME

    def _validate_rebucket_frame(self, buf: bytes, w: int, h: int) -> bool:
        """Full entropy-layer validation of a resolution-change frame BEFORE
        the old slot's state is destroyed (an errored picture must leave
        state untouched, state.rs:119-137), as the JAX pool does it for
        both front-ends: the host header parse and the native macroblock
        parse of this one frame, on the host.  It must parse without error
        and hold no INTER macroblock -- the new bucket has no reference at
        the new size, so an EOF tail-fill would predict from nothing."""
        try:
            r = BitReader(bytes(buf))
            pic = decode_picture(r, self.decoder_options, None)
            if pic is None:
                return False
            fd = parse_frame_auto(r, pic, self.decoder_options, pic.options,
                                  w, h)
            return not fd.inter.any()
        except H263Error:
            return False

    def _rebucket(self, stream_id, new_key, is_iframe: bool,
                  buf: bytes) -> None:
        old_key = self._dims[stream_id]
        incr("pool_rebuckets")
        if not is_iframe:
            raise PictureFormatInvalid(
                f"stream {stream_id!r}: {old_key} -> {new_key} resolution "
                f"change on a non-I frame (no reference at the new size)")
        mw, mh = self.max_dims
        if not (0 < new_key[0] <= mw and 0 < new_key[1] <= mh):
            raise PictureFormatInvalid(
                f"stream {stream_id!r}: resolution {new_key} outside the "
                f"pool bound {self.max_dims} (would size a bucket's planes "
                f"from an untrusted header)")
        pend = self._pending.get(old_key)
        if pend and stream_id in pend:  # registered but never decoded
            pend.remove(stream_id)
            self._dims[stream_id] = new_key
            if new_key in self._buckets:
                self._join(new_key, stream_id,
                           self._pending_running.pop(stream_id, None))
            else:
                self._pending.setdefault(new_key, []).append(stream_id)
            return
        if not self._validate_rebucket_frame(bytes(buf), *new_key):
            raise PictureFormatInvalid(
                f"stream {stream_id!r}: {old_key} -> {new_key} I-frame "
                f"failed full validation; keeping the stream's state")
        bucket = self._buckets[old_key]
        slot = bucket.slots.pop(stream_id)
        # Running options carry across the rebucket (standard H.263; a
        # Sorenson header carries none): a host bucket keeps them per
        # stream state, a device bucket in `_running`.
        states = getattr(bucket.dec, "states", None)
        running = (states[slot].running_options if states is not None
                   else bucket.dec._running[slot])
        bucket.dec.reset_slot_state(slot)
        bucket.free.append(slot)
        self._dims[stream_id] = new_key
        if new_key in self._buckets:
            self._join(new_key, stream_id, running)
        else:
            if running:
                self._pending_running[stream_id] = running
            self._pending.setdefault(new_key, []).append(stream_id)

    # -- decode ---------------------------------------------------------------

    def decode_step(self, buffers: dict) -> PoolStepResult:
        """Decode one frame for each stream present in `buffers` (stream_id
        -> frame bytes).

        Registered streams absent from `buffers` keep their state and
        planes.  A stream whose frame is an I-frame at new dimensions is
        rebucketed first.  Every bucket steps even when one raises: the
        first error surfaces afterwards, with the step's results attached
        as `pool_step_result`.  A device bucket that raises has stepped
        every lane (errored lanes decode the identity frame); a host bucket
        that raises has committed nothing and updated no plane.
        """
        unknown = set(buffers) - set(self._dims)
        if unknown:
            # key=repr: ids may mix int and str (not mutually orderable).
            raise KeyError(
                f"unregistered streams: {sorted(unknown, key=repr)!r}")

        # Resolution-change pre-pass: move streams whose header disagrees
        # with their bucket before building the lockstep batches.
        for sid, buf in list(buffers.items()):
            sniffed = self._sniff(sid, buf)
            if sniffed is None:
                continue  # let the bucket's header prep raise
            w, h, is_i = sniffed
            if (w, h) != self._dims[sid]:
                self._rebucket(sid, (w, h), is_i, buf)

        for key in list(self._pending):
            self._finalize(key)

        out = PoolStepResult()
        first_err: Optional[H263Error] = None
        step_bytes, step_seconds = 0, 0.0
        for bucket in self._buckets.values():
            dec = bucket.dec
            mask = bucket.mask(buffers)
            if not mask.any():
                continue
            batch = [None] * dec.n
            for sid, slot in bucket.slots.items():
                if mask[slot]:
                    batch[slot] = buffers[sid]
            try:
                y, cb, cr = dec.decode_step(batch, mask=mask)
                if self.frontend == "host":
                    nb, s = self._transfer_stats_fn(dec)
                    step_bytes += nb
                    step_seconds += s
            except H263Error as e:
                # Per-stream isolation: the other buckets must still step;
                # this bucket's planes are not attached.
                if first_err is None:
                    first_err = e
                continue
            for sid, slot in bucket.slots.items():
                if mask[slot]:
                    out._add(sid, y, cb, cr, slot)
        if self.adaptive_frontend and self.frontend == "host":
            self._note_transfer(step_bytes, step_seconds)
        if first_err is not None:
            first_err.pool_step_result = out
            raise first_err
        return out

    def decode_steps(self, frame_lists) -> list:
        """Decode a window of T frames (`frame_lists`: T dicts of stream_id
        -> frame bytes) with one window step per bucket; returns T
        `PoolStepResult`s, frame for frame what T `decode_step` calls give.

        Registered streams absent from a frame's dict decode the skip frame
        with the header commit suppressed.  A failed (frame, stream) decodes
        the identity frame, and the first error is raised after every
        bucket has stepped, with the window's results attached as
        `pool_window_results`.  Unknown ids raise KeyError before anything
        steps.  A host pool (`BatchedStreamDecoder` has no window step), and
        a window in which any stream's header names other dimensions than
        its bucket's (a resolution change needs the per-frame pre-pass),
        run as T `decode_step` calls instead, as does every window of a
        standard pool (its decoders have no window step; counted as
        `pool_window_fallbacks`).
        """
        T = len(frame_lists)
        if T == 0:
            return []
        unknown = set().union(*frame_lists) - set(self._dims)
        if unknown:
            raise KeyError(
                f"unregistered streams: {sorted(unknown, key=repr)!r}")
        if self.frontend == "host":
            return [self.decode_step(b) for b in frame_lists]
        if not self._sorenson:
            incr("pool_window_fallbacks")
            return [self.decode_step(b) for b in frame_lists]
        for b in frame_lists:
            for sid, buf in b.items():
                sniffed = _sniff_sorenson(bytes(buf))
                if sniffed is not None and sniffed[:2] != self._dims[sid]:
                    incr("pool_window_fallbacks")
                    return [self.decode_step(b) for b in frame_lists]
        for key in list(self._pending):
            self._finalize(key)

        results = [PoolStepResult() for _ in range(T)]
        first_err: Optional[H263Error] = None
        for bucket in self._buckets.values():
            dec = bucket.dec
            window = [[None] * dec.n for _ in range(T)]
            present = False
            for t, b in enumerate(frame_lists):
                for sid, slot in bucket.slots.items():
                    if sid in b:
                        window[t][slot] = b[sid]
                        present = True
            if not present:
                continue
            try:
                ys, cbs, crs = dec.decode_steps(window)
            except H263Error as e:
                # As in decode_step: the window was dispatched (failed lanes
                # decode identity frames), so the other buckets still step;
                # this bucket's planes are not attached.
                if first_err is None:
                    first_err = e
                continue
            # One view of each frame's planes, shared by its streams.
            for b, res, y, cb, cr in zip(frame_lists, results, ys.unbind(0),
                                         cbs.unbind(0), crs.unbind(0)):
                for sid, slot in bucket.slots.items():
                    if sid in b:
                        res._add(sid, y, cb, cr, slot)
        if first_err is not None:
            first_err.pool_window_results = results
            raise first_err
        return results

    # -- the front-end switch and its trigger (module docstring) -------------

    def _note_transfer(self, nbytes: int, seconds: float) -> None:
        """Feed one step's copy reading to the rate average; switch the
        pool to the device front-end when the average falls
        `degrade_ratio` times below the best average seen."""
        if nbytes < 1024 or seconds <= 0:
            return  # too small to estimate a rate
        bw = nbytes / seconds
        alpha = 0.3
        self._bw_ema = (bw if self._bw_ema is None
                        else alpha * bw + (1 - alpha) * self._bw_ema)
        self._bw_samples += 1
        if self._bw_samples < self.adapt_min_samples:
            return
        self._bw_best = max(self._bw_best, self._bw_ema)
        if self._bw_ema < self._bw_best / self.degrade_ratio:
            incr("pool_degraded_window_detected")
            self.switch_frontend("device")

    def switch_frontend(self, frontend: str) -> None:
        """Switch every bucket's decoder to `frontend` live, moving the
        reference planes (they stay on the device) and each stream's
        carried header state.  Host to device only, Sorenson pools only,
        as in the JAX package."""
        if frontend == self.frontend:
            return
        if frontend != "device":
            raise ValueError("switch_frontend supports host->device only")
        if not self._sorenson:
            raise ValueError("frontend switch requires a Sorenson pool")
        for key, bucket in self._buckets.items():
            old = bucket.dec
            new = self._make_decoder(old.n, key[0], key[1],
                                     frontend="device")
            # Same stream of work: the new decoder's first step reads the
            # planes after the old decoder's last step wrote them.
            new.ref_y, new.ref_cb, new.ref_cr = (old.ref_y, old.ref_cb,
                                                 old.ref_cr)
            for i, st in enumerate(old.states):
                new._pictures[i] = st.last_header
                new._running[i] = st.running_options
                if st.last_header is not None:
                    new._last_quant[i] = st.last_header.quantizer
                    new._last_deblock[i] = bool(
                        st.last_header.options & PictureOption.USE_DEBLOCKER)
            bucket.dec = new
            incr("pool_frontend_switches")
        self.frontend = frontend

    def present_rgba(self, deblock: Optional[bool] = None) -> dict:
        """RGBA of every registered stream's last decoded frame: {sid: uint8
        [H, W, 4] on the device}, a view of its bucket's batch."""
        out = {}
        for bucket in self._buckets.values():
            if not bucket.slots:
                continue
            frames = bucket.dec.present_rgba(deblock).unbind(0)
            for sid, slot in bucket.slots.items():
                out[sid] = frames[slot]
        return out
