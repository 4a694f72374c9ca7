"""Mixed-resolution stream pool with dynamic membership, PyTorch.

Port of `h263_tpu/parallel/pool.py::StreamPool` with the device entropy
front-end (`frontend="device"`) for Sorenson Spark streams.  Streams of
different resolutions cannot share one lockstep batch, so the pool groups
them into per-resolution `DeviceFrontendDecoder` buckets; within a bucket,
slots decode in lockstep:

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
  the single-stream decoder does on an I-frame); a non-I frame at other
  dimensions, or dimensions beyond `max_dims`, raises PictureFormatInvalid
  and leaves the stream where it was.

Not ported (see ROADMAP): `decode_steps` (the K-frame window),
`frontend="host"`, `switch_frontend` and the adaptive trigger,
standard-H.263 pools, and `resolve_overflows` (the port's automaton has no
tape and never overflows).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..native import DevicePrepBatch
from ..parser.automaton_cuda import parse_assemble_cuda
from ..parser.tables import ST_OK
from ..types import DecoderOption, H263Error, PictureFormatInvalid
from ..utils.trace import incr
from .device_batch import DeviceFrontendDecoder


class _Bucket:
    __slots__ = ("dec", "slots", "free")

    def __init__(self, dec: DeviceFrontendDecoder):
        self.dec = dec
        self.slots: dict = {}   # stream_id -> slot index
        self.free: list = list(range(dec.n))[::-1]  # stack of free slots

    def mask(self, present) -> np.ndarray:
        m = np.zeros(self.dec.n, dtype=bool)
        for sid, slot in self.slots.items():
            if sid in present:
                m[slot] = True
        return m


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
    """Decode many Sorenson streams of mixed resolutions with dynamic
    membership, on `device` ("cuda", the default, or "cpu").

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
                 frontend: str = "device", max_dims: tuple = (2048, 2048), *,
                 device="cuda", max_frame_bytes: Optional[int] = None):
        """`max_dims` bounds the resolutions a mid-stream change may create:
        a bucket's planes are sized by its dims, so an unchecked (possibly
        corrupt) header must not allocate a 65535x65535 bucket -- frames
        beyond the bound fail per stream instead.  `device` and
        `max_frame_bytes` pass to the bucket decoders."""
        if frontend != "device":
            raise ValueError(f"frontend {frontend!r}: only the device "
                             f"front-end is ported")
        if not decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM:
            raise ValueError("the device front-end pool decodes Sorenson "
                             "streams only")
        self.decoder_options = decoder_options
        self.frontend = frontend
        self.max_dims = max_dims
        self.device = device
        self.max_frame_bytes = max_frame_bytes
        self._pending: dict = {}          # (w, h) -> [stream_id, ...]
        self._buckets: dict = {}          # (w, h) -> _Bucket
        self._dims: dict = {}             # stream_id -> (w, h)

    def _make_decoder(self, n: int, width: int, height: int):
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
        pend = self._pending.get(key)
        if pend and stream_id in pend:
            pend.remove(stream_id)
            return
        bucket = self._buckets[key]
        slot = bucket.slots.pop(stream_id)
        bucket.dec.reset_slot_state(slot)
        bucket.free.append(slot)

    def _join(self, key, stream_id) -> int:
        bucket = self._buckets[key]
        if not bucket.free:
            self._grow(key)
            bucket = self._buckets[key]
        slot = bucket.free.pop()
        bucket.dec.reset_slot_state(slot)
        bucket.slots[stream_id] = slot
        return slot

    def _finalize(self, key):
        ids = self._pending.pop(key)
        bucket = _Bucket(self._make_decoder(len(ids), key[0], key[1]))
        self._buckets[key] = bucket
        for sid in ids:
            bucket.slots[sid] = bucket.free.pop()

    def _grow(self, key) -> None:
        """Double a full bucket's capacity, migrating planes and per-stream
        state; slot indices are preserved so outputs stay stable."""
        old = self._buckets[key]
        n_old = old.dec.n
        n_new = max(2 * n_old, 1)
        dec = self._make_decoder(n_new, key[0], key[1])
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

    def _validate_rebucket_frame(self, buf: bytes, w: int, h: int) -> bool:
        """Full entropy-layer validation of a resolution-change frame BEFORE
        the old slot's state is destroyed (an errored picture must leave
        state untouched, state.rs:119-137): the native header prep, then
        the automaton on the pool's device (the CUDA kernel, or on the CPU
        its plain version), for this one frame.  It must parse without
        error and hold no INTER macroblock -- the new bucket has no
        reference at the new size, so an EOF tail-fill would predict from
        nothing."""
        stage = np.zeros(((len(buf) + 3) // 4 + 1) * 4, dtype=np.uint8)
        meta = np.zeros((6, 1), dtype=np.int32)
        if DevicePrepBatch(1, w, h).prepare_ragged([buf], stage, meta):
            return False
        _, _, inter, status = parse_assemble_cuda(
            torch.from_numpy(stage).view(-1, 4).to(self.device),
            torch.from_numpy(meta).to(self.device),
            mbh=-(-h // 16), mbw=-(-w // 16), width=w, height=h)
        return int(status[0]) == ST_OK and not bool(inter.any())

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
                self._join(new_key, stream_id)
            else:
                self._pending.setdefault(new_key, []).append(stream_id)
            return
        if not self._validate_rebucket_frame(bytes(buf), *new_key):
            raise PictureFormatInvalid(
                f"stream {stream_id!r}: {old_key} -> {new_key} I-frame "
                f"failed full validation; keeping the stream's state")
        bucket = self._buckets[old_key]
        slot = bucket.slots.pop(stream_id)
        bucket.dec.reset_slot_state(slot)
        bucket.free.append(slot)
        self._dims[stream_id] = new_key
        if new_key in self._buckets:
            self._join(new_key, stream_id)
        else:
            self._pending.setdefault(new_key, []).append(stream_id)

    # -- decode ---------------------------------------------------------------

    def decode_step(self, buffers: dict) -> PoolStepResult:
        """Decode one frame for each stream present in `buffers` (stream_id
        -> frame bytes).

        Registered streams absent from `buffers` keep their state and
        planes.  A stream whose frame is an I-frame at new dimensions is
        rebucketed first.  Every bucket steps even when one raises: the
        first error surfaces afterwards, with the step's results attached
        as `pool_step_result`.
        """
        unknown = set(buffers) - set(self._dims)
        if unknown:
            # key=repr: ids may mix int and str (not mutually orderable).
            raise KeyError(
                f"unregistered streams: {sorted(unknown, key=repr)!r}")

        # Resolution-change pre-pass: move streams whose header disagrees
        # with their bucket before building the lockstep batches.
        for sid, buf in list(buffers.items()):
            sniffed = _sniff_sorenson(bytes(buf))
            if sniffed is None:
                continue  # let the bucket's header prep raise
            w, h, is_i = sniffed
            if (w, h) != self._dims[sid]:
                self._rebucket(sid, (w, h), is_i, buf)

        for key in list(self._pending):
            self._finalize(key)

        out = PoolStepResult()
        first_err: Optional[H263Error] = None
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
            except H263Error as e:
                # Per-stream isolation: the bucket decoder stepped every lane
                # (errored lanes got identity frames) before raising, so the
                # other buckets must still step; this bucket's planes are not
                # attached.
                if first_err is None:
                    first_err = e
                continue
            for sid, slot in bucket.slots.items():
                if mask[slot]:
                    out._add(sid, y, cb, cr, slot)
        if first_err is not None:
            first_err.pool_step_result = out
            raise first_err
        return out

    def present_rgba(self, deblock: Optional[bool] = None) -> dict:
        """RGBA of every registered stream's last decoded frame: {sid: uint8
        [H, W, 4] on the device}, a view of its bucket's batch."""
        out = {}
        for bucket in self._buckets.values():
            if not bucket.slots:
                continue
            rgba = bucket.dec.present_rgba(deblock)
            for sid, slot in bucket.slots.items():
                out[sid] = rgba[slot]
        return out
