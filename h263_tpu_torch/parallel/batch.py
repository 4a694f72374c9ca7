"""Batched multi-stream decoding with the host entropy front-end, PyTorch.

Port of `h263_tpu/parallel/batch.py::BatchedStreamDecoder`, for Sorenson
Spark streams and (with `DecoderOption.NONE`) standard H.263.  Per
Sorenson step (`decode_step`):

    one native call parses every stream's frame on the host's cores into a
    pinned staging row [int8 MVs | INTER bitmask | delta24 entries] ->
    one host-to-device copy of the whole rows -> the unpack kernel
    (`csrc/d24.cu`) on the rows' used prefix, a strided view on the card ->
    IDCT + motion compensation + add-clamp (`csrc/reconstruct.cu`) ->
    planes

* The coefficient cut is one of a three-value ladder, chosen by the native
  parse from the step's largest count; the kernel reads entries up to it.
  The rows ship whole, not their used prefix: on the H100's host one
  pinned copy of the whole rows took less time than copying the prefix
  into a contiguous buffer on the host (PERF.md §6).
* MVs ship slim (2 B/MB) until the first frame whose block MVs differ: that
  step (the flip) ships its delta24 entries beside the host's full int16
  MVs and byte flags, and every later parse writes 8 B/MB rows.
* A frame with more coefficients than `pack_cap` raises `PackOverflow` in
  the native parse, before anything is committed; the step then replays
  on the dense transport (the Python header parse + the native dense parse
  per stream, header commits staged until every stream parsed).

A standard step parses every stream's plain-PTYPE header and macroblocks
in one native call (`StandardBatchParser`) into pinned rows of delta24
entries [n, 3 * pack_cap] beside full int16 MVs and byte flags; the three
ship whole, and the unpack kernel reads the rows up to the ladder's cut.
A header outside that shape (PLUSPTYPE, PB frames, reserved formats)
makes the call raise `NeedsPythonHeader` with nothing committed, and the
step replays through the Python header parser (`_parse_header`) and the
native packed parse per stream, committing only after every stream
parsed.  `_std_prev_fmt` keeps each stream's last PTYPE format code (-1
none, -2 after a header the native call does not parse), so the native
call can apply the reference's format-change rule or hand the batch back.
* A corrupt stream makes the step raise its error class with no header
  state committed and no plane changed, on either transport.
* Masked slots decode the cached all-uncoded skip frame with the header
  commit suppressed, so their planes and state do not move.

Host staging: the parse writes into a ping-pong pair of pinned buffer sets;
each set carries a CUDA event recorded after its copies, synchronised
before the set is parsed into again (`reclaim_wait`), so the host never
blocks on the step's outputs.  `submit_step` parses on the caller's thread
and runs the copy and the kernels on a one-worker pipeline, on the caller's
CUDA stream; the native parse releases the GIL, so parsing frame t+1
overlaps step t.

Per-stream header state (running options, the reference rule, the
disposable-P quirk) follows the JAX package's `_StreamState`.  Counters
(`frames_decoded`, `steps`, `steps_dense`, `steps_fused`,
`steps_fused_flip`, `pack_overflow_fallbacks`, `transfer_bytes`) and stage
timers (`host_parse`, `bucket_slice`, `transfer`, `reconstruct_dispatch`,
`reclaim_wait`, `reclaim_fut_wait`) take the JAX package's names; the
port adds `std_python_header_replays`, the standard steps replayed
through the Python header parser.

Left out against the JAX package: the u32 and split transports and their
parsers, the standard path's slim MVs (its rows ship full MVs from the
first step), the non-fused Sorenson batch parser, the `pallas=`,
`coef_transport=` and reconstruct-function injection arguments, and the
`H263_TPU_NO_*` switches.
"""

from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..bitio import BitReader
from ..decoder.reconstruct import (
    PresentParams,
    present_rgba_batched,
    reconstruct_frame_packed_d24,
    reconstruct_frame_packed_d24_fused,
    reconstruct_from_dense,
)
from ..native.bindings import (
    NeedsPythonHeader,
    PackOverflow,
    SorensonFusedBatchParser,
    StandardBatchParser,
    parse_frame_native,
    parse_frame_native_packed,
)
from ..ops.d24 import fused_sections
from ..ops.deblock import QUANT_TO_STRENGTH
from ..parser.frame import FrameData, parse_frame_auto
from ..parser.picture import decode_picture
from ..testing.encoder import (
    MBSpec,
    encode_sorenson_picture,
    encode_standard_picture,
)
from ..types import (
    MPPTYPE_OPTIONS,
    OPPTYPE_OPTIONS,
    DecoderOption,
    MiddleOfBitstream,
    MotionVectorRange,
    Picture,
    PictureFormatInvalid,
    PictureFormatMissing,
    PictureOption,
    PictureTypeCode,
    SourceFormat,
    SourceFormatKind,
    UncodedIFrameBlocks,
    carry_forward_options,
)
from ..utils.trace import incr, trace_stage

_PTYPES = (PictureTypeCode.I_FRAME, PictureTypeCode.P_FRAME,
           PictureTypeCode.DISPOSABLE_P_FRAME, PictureTypeCode.RESERVED)
_FORMATS = {2: SourceFormatKind.FULL_CIF, 3: SourceFormatKind.QUARTER_CIF,
            4: SourceFormatKind.SUB_QCIF}
# Plain-PTYPE source format codes (H.263 table 2) and their kinds.
_STD_KIND_BY_BITS = {1: SourceFormatKind.SUB_QCIF,
                     2: SourceFormatKind.QUARTER_CIF,
                     3: SourceFormatKind.FULL_CIF,
                     4: SourceFormatKind.FOUR_CIF,
                     5: SourceFormatKind.SIXTEEN_CIF}
_STD_FMT_BITS = {k: b for b, k in _STD_KIND_BY_BITS.items()}


def _picture_from_fields(hdr) -> Picture:
    """A Picture from the native header fields [version, tr, w, h, ptype,
    deblocker, quant, fmt_code]."""
    kind = _FORMATS.get(int(hdr[7]))
    fmt = (SourceFormat(kind) if kind is not None
           else SourceFormat.extended(int(hdr[2]), int(hdr[3])))
    return Picture(
        version=int(hdr[0]),
        temporal_reference=int(hdr[1]),
        format=fmt,
        options=(PictureOption.USE_DEBLOCKER if hdr[5] else PictureOption.NONE),
        picture_type=_PTYPES[int(hdr[4])],
        quantizer=int(hdr[6]),
        motion_vector_range=MotionVectorRange.UNLIMITED,
    )


class _StreamState:
    __slots__ = ("running_options", "last_header", "has_reference")

    def __init__(self):
        self.running_options = PictureOption.NONE
        self.last_header: Optional[Picture] = None
        self.has_reference = False


def _pinned(shape, dtype, pin, fill=0):
    t = torch.full(shape, fill, dtype=dtype, pin_memory=pin)
    return t, t.numpy()


class _HostBatch:
    """Pinned host buffers of one dense step.  The native dense parse
    writes each stream's coefficients straight into its slices of `dense`
    (int16 [n, 6*nmb, 64]: the luma block grid, then Cb, then Cr, the
    layout the reconstruct kernel reads), so the step ships `dense`, `mvs`
    and `inter` as they are.  The host IDCT classes stay on the host."""

    def __init__(self, n, mb_w, mb_h, pin):
        nmb = mb_w * mb_h
        self.dense_t, d = _pinned((n, 6 * nmb, 64), torch.int16, pin)
        self.coeffs_y = d[:, :4 * nmb].reshape(n, 2 * mb_h, 2 * mb_w, 8, 8)
        self.coeffs_cb = d[:, 4 * nmb:5 * nmb].reshape(n, mb_h, mb_w, 8, 8)
        self.coeffs_cr = d[:, 5 * nmb:].reshape(n, mb_h, mb_w, 8, 8)
        assert all(np.shares_memory(a, d) for a in
                   (self.coeffs_y, self.coeffs_cb, self.coeffs_cr))
        self.class_y = np.zeros((n, 2 * mb_h, 2 * mb_w), dtype=np.int8)
        self.class_cb = np.zeros((n, mb_h, mb_w), dtype=np.int8)
        self.class_cr = np.zeros((n, mb_h, mb_w), dtype=np.int8)
        self.mvs_t, self.mvs = _pinned((n, mb_h, mb_w, 4, 2), torch.int16, pin)
        self.inter_t, self.inter = _pinned((n, mb_h, mb_w), torch.uint8, pin,
                                           fill=1)
        self.copied = None  # event after the copies that read these buffers

    def slice_of(self, i):
        return (self.coeffs_y[i], self.class_y[i], self.coeffs_cb[i],
                self.class_cb[i], self.coeffs_cr[i], self.class_cr[i],
                self.mvs[i], self.inter[i])


class _PackedBatch:
    """Pinned host buffers of one packed step: the fused staging rows the
    native Sorenson parse writes (`fused`, uint8 [n, row], allocated per MV
    row stride) or a standard step's rows of delta24 entries (`rows`,
    uint8 [n, 3 * pack_cap]), and the full int16 MVs and byte flags (of
    the flip step, or of every standard step)."""

    def __init__(self, n, mb_w, mb_h, pin):
        self.pin = pin
        self.mvs_t, self.mvs = _pinned((n, mb_h, mb_w, 4, 2), torch.int16, pin)
        self.inter_t, self.inter = _pinned((n, mb_h, mb_w), torch.uint8, pin,
                                           fill=1)
        self.counts = np.zeros(n, dtype=np.int64)
        self.varied_mvs = np.zeros(n, dtype=np.bool_)
        self.fused_t = None       # the pinned staging rows [n, row]
        self.fused = None         # their numpy view, which the parse fills
        self.fused_mv_stride = 0  # 2 (slim) or 8 (full) int8 MV bytes/MB
        self.fused_parser = None
        self.cut = 0              # the native-chosen coefficient cut
        self.rows_t = None        # a standard step's pinned delta24 rows
        self.rows = None          # their numpy view
        self.std_parser = None    # the StandardBatchParser bound to them
        self.copied = None        # event after the copies of the last step
        self.fut = None           # pipeline future of the consuming step


class BatchedStreamDecoder:
    """Decode n same-resolution streams, Sorenson or (with
    `DecoderOption.NONE`) standard H.263, in lockstep, one frame per
    stream per `decode_step`, on `device` ("cuda", the default, or "cpu";
    no fallback between them)."""

    def __init__(self, n_streams: int, width: int, height: int,
                 decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 pack_cap: Optional[int] = None, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self.n = n_streams
        self.w, self.h = width, height
        self.cw, self.ch = (width + 1) // 2, (height + 1) // 2
        self.decoder_options = decoder_options
        self._sorenson = bool(decoder_options
                              & DecoderOption.SORENSON_SPARK_BITSTREAM)
        self.states = [_StreamState() for _ in range(n_streams)]
        # Each stream's last PTYPE format code for the native standard
        # parse: -1 none, -2 a header it does not parse (punts to Python).
        self._std_prev_fmt = np.full(n_streams, -1, dtype=np.int32)
        # The last timed host-to-device copies of a step: seconds, bytes
        # (`_transfer`), and the CUDA events of copies not yet read.
        self.last_transfer_s = 0.0
        self.last_transfer_bytes = 0
        self._copy_times = collections.deque(maxlen=8)
        mb_w, mb_h = -(-width // 16), -(-height // 16)
        self.mb_w, self.mb_h = mb_w, mb_h

        def planes(h, w):
            return torch.zeros((n_streams, h, w), dtype=torch.uint8,
                               device=self.device)

        self.ref_y = planes(self.h, self.w)
        self.ref_cb = planes(self.ch, self.cw)
        self.ref_cr = planes(self.ch, self.cw)
        self._pin = self.device.type == "cuda"
        # Dense buffers are made at the first dense step (a PackOverflow).
        self._batches = [None, None]
        self._batch_idx = 0
        # Coefficient capacity: 16 a macroblock by default; the ladder of
        # transfer cuts (tiny, small, full) as the JAX package's.
        self.pack_cap = pack_cap or max(1024, 16 * mb_w * mb_h)
        self.pack_cap_small = min(max(512, 4 * mb_w * mb_h), self.pack_cap)
        self.pack_cap_tiny = min(max(256, (3 * mb_w * mb_h) // 2),
                                 self.pack_cap_small)
        self._ladder = np.array(
            sorted({self.pack_cap_tiny, self.pack_cap_small, self.pack_cap}),
            dtype=np.int32)
        self._mv_full = False  # sticky: set on the first varied-MV frame
        self._packed = [_PackedBatch(n_streams, mb_w, mb_h, self._pin)
                        for _ in range(2)]
        self._packed_idx = 0
        self._executor = None  # the pipeline worker of submit_step
        self._skip_frame: Optional[bytes] = None
        self._pred_scratch = np.zeros((mb_w * mb_h, 4, 2), dtype=np.int16)
        # Header commit: Picture objects per distinct native header row,
        # PictureOption per running-options value.
        self._pic_cache: dict = {}
        self._po_cache: dict = {}
        self._params = PresentParams(n_streams, self.device)

    # -- staging buffers ------------------------------------------------------

    @staticmethod
    def _reclaim(buf):
        """Wait until the copies that last read `buf` have finished."""
        if buf.copied is not None:
            with trace_stage("reclaim_wait"):
                buf.copied.synchronize()
            buf.copied = None

    def next_host_batch(self) -> _HostBatch:
        self._batch_idx ^= 1
        batch = self._batches[self._batch_idx]
        if batch is None:
            batch = self._batches[self._batch_idx] = _HostBatch(
                self.n, self.mb_w, self.mb_h, self._pin)
        self._reclaim(batch)
        return batch

    def next_packed_batch(self) -> _PackedBatch:
        self._packed_idx ^= 1
        packed = self._packed[self._packed_idx]
        if packed.fut is not None:
            # The consuming step may not have run yet.  Its exception was
            # delivered to the submitter through this same future, so it is
            # swallowed here: a failed step records no event, and the next
            # parse refills the buffers from scratch.
            fut, packed.fut = packed.fut, None
            with trace_stage("reclaim_fut_wait"):
                try:
                    fut.result()
                except Exception:
                    pass
        self._reclaim(packed)
        return packed

    def _transfer(self, host, buf):
        """Copy the host tensors to the device (`non_blocking` from pinned
        memory); the event after the copies guards `buf`'s reuse.  On the
        card, CUDA events around the copies time them, and
        `last_transfer_s` / `last_transfer_bytes` hold the last copies
        whose events have completed (`_read_copy_times`); on the CPU, the
        host time of the copies."""
        nbytes = sum(t.numel() * t.element_size() for t in host)
        if not self._pin:
            t0 = time.perf_counter()
            dev = [t.to(self.device) for t in host]
            self.last_transfer_s = time.perf_counter() - t0
            self.last_transfer_bytes = nbytes
            return dev
        self._read_copy_times()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        dev = [t.to(self.device, non_blocking=True) for t in host]
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        if buf is not None:
            buf.copied = end
        self._copy_times.append((start, end, nbytes))
        return dev

    def _read_copy_times(self) -> None:
        """Take the times of the earlier steps' copies whose events have
        completed (`query`, no wait): the host-to-device rate that the
        pool's front-end trigger reads, one step behind."""
        while self._copy_times and self._copy_times[0][1].query():
            start, end, nbytes = self._copy_times.popleft()
            self.last_transfer_s = start.elapsed_time(end) / 1e3
            self.last_transfer_bytes = nbytes

    # -- host stage -----------------------------------------------------------

    def _parse_header(self, stream_idx: int, r: BitReader):
        """Picture header of one stream -> (picture, running options)."""
        st = self.states[stream_idx]
        pic = decode_picture(r, self.decoder_options, st.last_header)
        if pic is None:
            raise MiddleOfBitstream()
        running = carry_forward_options(pic, st.running_options)
        fmt = pic.format
        if fmt is None:
            if (st.last_header is None
                    or pic.picture_type is PictureTypeCode.I_FRAME):
                raise PictureFormatMissing()
            fmt = st.last_header.format
        wh = fmt.width_and_height()
        if wh is None or wh != (self.w, self.h):
            raise PictureFormatInvalid(
                f"stream {stream_idx}: expected {(self.w, self.h)}, got {wh}")
        return pic, running

    def _commit_header(self, stream_idx: int, pic: Picture,
                       running: PictureOption) -> None:
        """state.rs:464-483 header-state semantics."""
        st = self.states[stream_idx]
        if pic.picture_type is PictureTypeCode.I_FRAME:
            st.has_reference = False
        st.last_header = pic
        if not pic.picture_type.is_disposable():
            st.has_reference = True
        st.running_options = running
        if not self._sorenson:
            # Bookkeeping for the native standard parse's format rule.
            bits = -2
            if not pic.has_plusptype and pic.format is not None:
                bits = _STD_FMT_BITS.get(pic.format.kind, -2)
            self._std_prev_fmt[stream_idx] = bits

    def reset_slot_state(self, slot: int,
                         running: Optional[PictureOption] = None) -> None:
        """Fresh per-stream state for a (re)joined batch slot; its planes
        are kept (the next frame of a joining stream is an I-frame)."""
        st = self.states[slot]
        st.running_options = (running if running is not None
                              else PictureOption.NONE)
        st.last_header = None
        st.has_reference = False
        self._std_prev_fmt[slot] = -1

    def skip_frame_bytes(self) -> bytes:
        """A cached all-uncoded P-frame at this decoder's dims, in its own
        flavour: every macroblock copies its reference with MV 0, so a slot
        decoding it with the commit suppressed keeps its planes and header
        state."""
        if self._skip_frame is None:
            enc = (encode_sorenson_picture if self._sorenson
                   else encode_standard_picture)
            self._skip_frame = enc(
                self.w, self.h, PictureTypeCode.P_FRAME,
                [MBSpec(kind="uncoded")] * (self.mb_w * self.mb_h))
        return self._skip_frame

    def parse_one(self, stream_idx: int, buf: bytes,
                  batch: Optional[_HostBatch] = None, commit: bool = True,
                  stage_commit: Optional[list] = None) -> FrameData:
        """Entropy-decode one stream's next frame to dense tensors, into
        its slices of `batch` when given.  commit=False parses without
        touching the header state or enforcing the reference rule (a padded
        slot).  With `stage_commit` (a list) the commit is appended as
        (stream_idx, pic, running) for the caller to apply once every
        stream parsed."""
        st = self.states[stream_idx]
        r = BitReader(bytes(buf))
        pic, running = self._parse_header(stream_idx, r)
        if batch is not None:
            frame, r.pos = parse_frame_native(
                r.data, r.pos, pic, self.decoder_options, running, self.w,
                self.h, out=batch.slice_of(stream_idx))
        else:
            frame = parse_frame_auto(r, pic, self.decoder_options, running,
                                     self.w, self.h)
        if commit:
            if frame.inter.any() and not st.has_reference:
                raise UncodedIFrameBlocks()
            if stage_commit is not None:
                stage_commit.append((stream_idx, pic, running))
            else:
                self._commit_header(stream_idx, pic, running)
        return frame

    def parse_batch_packed(self, buffers: Sequence[bytes],
                           packed: _PackedBatch, mask=None) -> None:
        """Parse every stream's frame in ONE native call into `packed`'s
        staging rows, and commit the header states; a failure raises with
        nothing committed.  False `mask` slots decode the skip frame with
        the commit and the reference rule suppressed."""
        if not self._sorenson:
            return self.parse_batch_packed_standard(buffers, packed, mask)
        stride = 8 if self._mv_full else 2
        if packed.fused is None or packed.fused_mv_stride != stride:
            nmb = self.mb_w * self.mb_h
            row = sum(fused_sections(nmb, stride == 8)) + 3 * self.pack_cap
            packed.fused_t, packed.fused = _pinned((self.n, row), torch.uint8,
                                                   self._pin)
            packed.fused_mv_stride = stride
            packed.fused_parser = SorensonFusedBatchParser(
                self.n, self.w, self.h, packed.fused, stride, packed.mvs,
                packed.inter, self._pred_scratch, self.pack_cap,
                self._ladder)
        buffers, has_ref = self._prepare_sorenson_buffers(buffers, mask)
        hdr, counts, flags, cut = packed.fused_parser.parse(buffers, has_ref)
        packed.counts[:] = counts
        packed.varied_mvs[:] = (flags & 2) != 0
        packed.cut = cut
        self._commit_sorenson_headers(hdr, mask)

    def parse_batch_packed_standard(self, buffers: Sequence[bytes],
                                    packed: _PackedBatch, mask=None) -> None:
        """The standard parse of every stream's frame into `packed`'s rows,
        MVs and flags, and the header commit; a failure raises with
        nothing committed.  Plain-PTYPE headers parse in one native call;
        any other header makes it raise `NeedsPythonHeader` (nothing
        committed) and the batch replays through the Python header parser
        with the native packed parse per stream."""
        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")
        if packed.rows is None:
            packed.rows_t, packed.rows = _pinned((self.n, 3 * self.pack_cap),
                                                 torch.uint8, self._pin)
            packed.std_parser = StandardBatchParser(
                self.n, self.w, self.h, packed.rows, packed.mvs,
                packed.inter, self._pred_scratch)
        bufs = [(b if type(b) is bytes else bytes(b))
                if mask is None or mask[i] else self.skip_frame_bytes()
                for i, b in enumerate(buffers)]
        try:
            return self._parse_std_native(bufs, packed, mask)
        except NeedsPythonHeader:
            incr("std_python_header_replays")
        staged = []
        for i, b in enumerate(bufs):
            live = mask is None or mask[i]
            r = BitReader(b)
            pic, running = self._parse_header(i, r)
            count, _ = parse_frame_native_packed(
                r.data, r.pos, pic, self.decoder_options, running, self.w,
                self.h, packed.rows[i], packed.mvs[i], packed.inter[i],
                self._pred_scratch)
            if (live and not self.states[i].has_reference
                    and packed.inter[i].any()):
                raise UncodedIFrameBlocks(f"stream {i}: no reference picture")
            packed.rows[i, 3 * count:] = 0
            packed.counts[i] = count
            staged.append((pic, running) if live else None)
        m = packed.mvs
        packed.varied_mvs[:] = (m != m[:, :, :, 0:1, :]).any(axis=(1, 2, 3, 4))
        for i, st in enumerate(staged):
            if st is not None:
                self._commit_header(i, *st)

    def _parse_std_native(self, bufs, packed: _PackedBatch, mask) -> None:
        """The one native call of a standard step, and the header commit
        from its rows (Pictures cached per distinct row).  Raises
        `NeedsPythonHeader` with nothing committed when a header needs the
        Python parser."""
        p = packed.std_parser
        has_ref = [True] * self.n
        for i, st in enumerate(self.states):
            if mask is None or mask[i]:
                has_ref[i] = st.has_reference
            p.prev_running[i] = int(st.running_options)
        p.prev_fmt[:] = self._std_prev_fmt
        hdr, counts, flags = p.parse(bufs, has_ref)
        packed.counts[:] = counts
        packed.varied_mvs[:] = (flags & 2) != 0
        rows = hdr.tobytes()
        rowlen = hdr.shape[1] * hdr.itemsize
        pic_cache, po_cache = self._pic_cache, self._po_cache
        for i, st in enumerate(self.states):
            if mask is not None and not mask[i]:
                continue  # padded slot: no header-state commit
            key = rows[i * rowlen:(i + 1) * rowlen]
            ent = pic_cache.get(key)
            if ent is None:
                row = hdr[i]
                pic = Picture(
                    version=None,
                    temporal_reference=int(row[0]),
                    format=SourceFormat.standard(_STD_KIND_BY_BITS[
                        int(row[8])]),
                    options=PictureOption(int(row[4])),
                    has_plusptype=False,
                    has_opptype=False,
                    picture_type=(PictureTypeCode.I_FRAME if row[3] == 0
                                  else PictureTypeCode.P_FRAME),
                    quantizer=int(row[5]),
                    multiplex_bitstream=(int(row[7]) if row[6] else None),
                )
                ent = (pic, int(row[9]), int(row[8]))
                pic_cache[key] = ent
            pic, running, fmt_bits = ent
            st.last_header = pic
            st.has_reference = True  # standard has no disposable frames
            po = po_cache.get(running)
            if po is None:
                po = po_cache[running] = PictureOption(running)
            st.running_options = po
            self._std_prev_fmt[i] = fmt_bits

    def _prepare_sorenson_buffers(self, buffers, mask):
        """(buffers as bytes, has_reference), masked slots padded with the
        skip frame."""
        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")
        bufs, has_ref = [], []
        for i, b in enumerate(buffers):
            if mask is None or mask[i]:
                has_ref.append(self.states[i].has_reference)
                bufs.append(b if type(b) is bytes else bytes(b))
            else:
                has_ref.append(True)  # the skip frame is all-uncoded INTER
                bufs.append(self.skip_frame_bytes())
        return bufs, has_ref

    def _commit_sorenson_headers(self, hdr, mask) -> None:
        """The per-stream header commit from the native header rows, with
        Pictures cached per distinct row and the running-option merge on
        plain ints."""
        keep = int(OPPTYPE_OPTIONS | MPPTYPE_OPTIONS)
        rows = hdr.tobytes()
        rowlen = hdr.shape[1] * hdr.itemsize
        pic_cache, po_cache = self._pic_cache, self._po_cache
        for i, st in enumerate(self.states):
            if mask is not None and not mask[i]:
                continue  # padded slot: no header-state commit
            key = rows[i * rowlen:(i + 1) * rowlen]
            ent = pic_cache.get(key)
            if ent is None:
                pic = _picture_from_fields(hdr[i])
                ent = (pic, int(pic.options) & ~keep,
                       pic.picture_type is PictureTypeCode.I_FRAME,
                       not pic.picture_type.is_disposable())
                pic_cache[key] = ent
            pic, base_opts, is_i, not_disp = ent
            running = base_opts | (int(st.running_options) & keep)
            st.last_header = pic
            if is_i or not_disp:
                st.has_reference = not_disp
            po = po_cache.get(running)
            if po is None:
                po = po_cache[running] = PictureOption(running)
            st.running_options = po

    # -- device stage ---------------------------------------------------------

    def _advance(self, out, *counters):
        """The step's planes become the references; count the step."""
        self.ref_y, self.ref_cb, self.ref_cr = out
        incr("frames_decoded", self.n)
        for name in counters:
            incr(name)
        incr("transfer_bytes", self.last_transfer_bytes)
        return out

    def step(self, frames: Sequence[FrameData]):
        """Reconstruct one frame for every stream from parsed FrameData;
        returns the (y, cb, cr) planes on the device."""
        if len(frames) != self.n:
            raise ValueError(f"expected {self.n} frames, got {len(frames)}")
        dense = np.concatenate([
            np.stack([f.coeffs_y for f in frames]).reshape(self.n, -1, 64),
            np.stack([f.coeffs_cb for f in frames]).reshape(self.n, -1, 64),
            np.stack([f.coeffs_cr for f in frames]).reshape(self.n, -1, 64)],
            axis=1)
        dev = self._transfer([torch.from_numpy(a) for a in (
            dense, np.stack([f.mvs for f in frames]),
            np.stack([f.inter for f in frames]).astype(np.uint8))], None)
        out = reconstruct_from_dense(*dev, self.ref_y, self.ref_cb,
                                     self.ref_cr)
        self.ref_y, self.ref_cb, self.ref_cr = out
        return out

    def step_batch(self, batch: _HostBatch):
        """Reconstruct from a _HostBatch filled by parse_one(...,
        batch=...): one copy of the dense coefficients, MVs and flags."""
        dense, mvs, inter = self._transfer(
            (batch.dense_t, batch.mvs_t, batch.inter_t), batch)
        out = reconstruct_from_dense(dense, mvs, inter, self.ref_y,
                                     self.ref_cb, self.ref_cr)
        return self._advance(out, "steps_dense")

    def step_packed(self, packed: _PackedBatch):
        """Reconstruct from the fused staging rows of the last parse: one
        copy of the whole rows, whose used prefix [MVs | flags |
        d24[:3*cut]] the unpack kernel reads.  On the flip step (block MVs
        vary while the rows are slim) the rows' delta24 entries go beside
        the full int16 MVs and byte flags instead, and later parses write
        8 B/MB rows.  A standard step ships its delta24 rows whole beside
        the full MVs and flags, and the unpack kernel reads the rows up to
        the smallest cut of the ladder that holds every stream's
        entries."""
        if not self._sorenson:
            return self._step_standard(packed)
        nmb = self.mb_w * self.mb_h
        flip = bool(packed.varied_mvs.any()) and packed.fused_mv_stride == 2
        mv_full = packed.fused_mv_stride == 8
        head = sum(fused_sections(nmb, mv_full))
        end = head + 3 * packed.cut
        with trace_stage("bucket_slice"):
            host = ((packed.fused_t, packed.mvs_t, packed.inter_t) if flip
                    else (packed.fused_t,))
            if flip:
                self._mv_full = True  # the next parses write 8 B/MB rows
        with trace_stage("transfer"):
            dev = self._transfer(host, packed)
        refs = (self.ref_y, self.ref_cb, self.ref_cr)
        with trace_stage("reconstruct_dispatch"):
            if flip:
                out = reconstruct_frame_packed_d24(dev[0][:, head:end],
                                                   *dev[1:], *refs)
            else:
                out = reconstruct_frame_packed_d24_fused(
                    dev[0][:, :end], *refs, mv_full=mv_full, mbh=self.mb_h,
                    mbw=self.mb_w)
        return self._advance(out, "steps",
                             "steps_fused_flip" if flip else "steps_fused")

    def _step_standard(self, packed: _PackedBatch):
        k = int(packed.counts.max()) if self.n else 0
        cut = int(self._ladder[np.searchsorted(self._ladder, k)])
        with trace_stage("transfer"):
            dev = self._transfer((packed.rows_t, packed.mvs_t,
                                  packed.inter_t), packed)
        with trace_stage("reconstruct_dispatch"):
            out = reconstruct_frame_packed_d24(
                dev[0][:, :3 * cut], dev[1], dev[2], self.ref_y,
                self.ref_cb, self.ref_cr)
        return self._advance(out, "steps")

    def submit_step(self, buffers: Sequence[bytes]):
        """Pipelined decode: parse this frame now (caller thread), then copy
        and reconstruct on the pipeline worker, on the caller's CUDA
        stream, while the caller parses the next frame.  Returns a Future
        of (y, cb, cr).  Steps run in submission order.

        A parse failure raises here with nothing committed; a device-stage
        failure is delivered once through the future, and that frame's
        planes were never updated."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="h263-device")
        packed = self.next_packed_batch()
        with trace_stage("host_parse"):
            self.parse_batch_packed(buffers, packed)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)

            def run():
                with torch.cuda.stream(stream):
                    return self.step_packed(packed)
        else:
            def run():
                return self.step_packed(packed)
        packed.fut = self._executor.submit(run)
        return packed.fut

    def decode_stream_pipelined(self, frame_iter):
        """Generator driving the two-stage pipeline over an iterator of
        frame-buffer lists; yields (y, cb, cr) per step in order."""
        pending = None
        for buffers in frame_iter:
            fut = self.submit_step(buffers)
            if pending is not None:
                yield pending.result()
            pending = fut
        if pending is not None:
            yield pending.result()

    def present_rgba(self, deblock: Optional[bool] = None):
        """RGBA uint8 [S, H, W, 4] of the current planes: per-stream deblock
        (each stream's advisory USE_DEBLOCKER flag, or `deblock` for all)
        at the Table J.2 strength of its last picture's quantizer, then
        BT.601."""
        strength = np.zeros(self.n, dtype=np.int32)
        flags = np.zeros(self.n, dtype=np.bool_)
        for i, st in enumerate(self.states):
            hdr = st.last_header
            if hdr is None:
                continue
            strength[i] = QUANT_TO_STRENGTH[hdr.quantizer & 31]
            flags[i] = (bool(hdr.options & PictureOption.USE_DEBLOCKER)
                        if deblock is None else deblock)
        strength_d, flags_d = self._params.to_device(strength, flags)
        return present_rgba_batched(self.ref_y, self.ref_cb, self.ref_cr,
                                    strength_d, flags_d)

    def decode_step(self, buffers: Sequence[bytes], transport: str = "auto",
                    mask=None):
        """Parse every stream's frame, then reconstruct the batch; returns
        the (y, cb, cr) planes on the device.

        transport "auto" takes the fused transport and replays a
        `PackOverflow` step on the dense one; "packed" and "dense" force
        one.  False `mask` slots decode the skip frame with the header
        commit suppressed."""
        if transport not in ("auto", "packed", "dense"):
            raise ValueError(f"transport must be 'auto', 'packed', or "
                             f"'dense'; got {transport!r}")
        if transport != "dense":
            packed = self.next_packed_batch()
            try:
                with trace_stage("host_parse"):
                    self.parse_batch_packed(buffers, packed, mask=mask)
                return self.step_packed(packed)
            except PackOverflow:
                if transport == "packed":
                    raise
                # Nothing was committed (the native call fails before any
                # commit): replay on the dense transport.
                incr("pack_overflow_fallbacks")

        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")
        batch = self.next_host_batch()
        staged: list = []
        for i, b in enumerate(buffers):
            live = mask is None or mask[i]
            self.parse_one(i, b if live else self.skip_frame_bytes(),
                           batch=batch, commit=live, stage_commit=staged)
        for i, pic, running in staged:
            self._commit_header(i, pic, running)
        return self.step_batch(batch)
