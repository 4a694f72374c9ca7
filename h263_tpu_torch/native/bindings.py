"""ctypes bindings of the port's native host entropy decoder (`entropy.cpp`,
built by `native/__init__.py`): the port of `h263_tpu/native/bindings.py`,
for the host front-end's two transports.

* `parse_frame_native`: one frame's macroblock layer into the dense
  tensors of `parser/frame.FrameData` (coefficients, IDCT classes, MVs,
  INTER flags), from the bit where the Python header parse stopped;
  `parse_frame_native_packed` the same into one row of delta24 entries
  with int16 MVs and byte flags (the standard batch's Python-header
  replay).
* `SorensonFusedBatchParser`: every stream's Sorenson frame in ONE native
  call (fanned out over the host's cores inside the library, with the GIL
  released by ctypes), each into one staging row [int8 MVs | INTER bitmask
  | delta24 coefficients] of the fused transport, plus the full int16 MVs
  and byte flags of the MV-flip step.  Atomic: a failing stream raises
  before the caller commits anything.
* `StandardBatchParser`: the same for standard H.263 streams with plain
  PTYPE headers, into rows of delta24 entries beside int16 MVs and byte
  flags.  A header outside that shape (PLUSPTYPE, PB frames, reserved
  formats, malformed bits) raises `NeedsPythonHeader` with nothing
  written that the caller commits; the caller replays the step through
  the Python header parser.

Native return codes map to the error classes of `types.py` as in the JAX
package; `PackOverflow` marks a frame with more coefficients than the
transport holds (the caller replays the step on the dense path).

Left out against the JAX package: the u32 and split transports (the
packed parses bind the delta24 transport only), `SorensonFastParser`, the
non-fused `SorensonBatchParser`, the device-prep binding `prepare` (the
port stages ragged payloads only, through `native.DevicePrepBatch`), and
the `fastcall.cpp` pointer helper.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import E_NEEDS_PYTHON, lib
from ..types import (
    BitstreamExhausted,
    DecoderOption,
    H263Error,
    InternalDecoderError,
    InvalidBitstream,
    InvalidIntraDc,
    InvalidLongCoefficient,
    InvalidMacroblockCodedBits,
    InvalidMacroblockHeader,
    InvalidMvd,
    InvalidShortCoefficient,
    MotionVectorRange,
    Picture,
    PictureOption,
    PictureTypeCode,
    SourceFormat,
    SourceFormatKind,
    UncodedIFrameBlocks,
    UnimplementedDecoding,
)


class PackOverflow(H263Error):
    """Packed-coefficient capacity exceeded; the caller falls back to the
    dense transport for this frame."""


class NeedsPythonHeader(Exception):
    """The batch holds a header outside the native PTYPE-only path
    (PLUSPTYPE chain, PB frame, reserved or invalid format, malformed
    bits).  Nothing was committed; the caller replays through the exact
    Python header parser."""


ERROR_MAP = {
    -100: BitstreamExhausted,
    -1: InternalDecoderError,
    -2: InvalidMacroblockHeader,
    -3: InvalidMacroblockCodedBits,
    -4: InvalidIntraDc,
    -5: InvalidShortCoefficient,
    -6: InvalidLongCoefficient,
    -7: InvalidMvd,
    -8: UncodedIFrameBlocks,
    -9: UnimplementedDecoding,
    -10: InvalidBitstream,
    -11: PackOverflow,
}

_PICTURE_TYPE_CODE = {
    PictureTypeCode.I_FRAME: 0,
    PictureTypeCode.P_FRAME: 1,
    PictureTypeCode.DISPOSABLE_P_FRAME: 2,
}

F_SORENSON = 1
F_HAS_PLUSPTYPE = 2
F_UMV_OPTION = 4
F_MV_RANGE_EXTENDED = 8
F_PACK_DELTA24 = 16


def _raise(rc: int, what: str):
    raise ERROR_MAP.get(rc, InternalDecoderError)(f"{what}: native error {rc}")


def _mv_ranges(width: int, height: int) -> tuple[int, int]:
    """Extended-UMV half-pel ranges keyed to picture dims
    (mvd_pred.rs:94-109, incl. the band-gap fallthrough)."""
    def rx(dim):
        if 0 <= dim <= 352:
            return 64
        if 356 <= dim <= 704:
            return 128
        if 708 <= dim <= 1408:
            return 256
        if dim >= 1412:
            return 512
        return 64

    def ry(dim):
        if 0 <= dim <= 288:
            return 64
        if 292 <= dim <= 576:
            return 128
        if dim >= 580:
            return 256
        return 64

    return rx(width), ry(height)


def _frame_args(picture: Picture, decoder_options,
                running_options: PictureOption, width: int, height: int,
                flags: int) -> tuple:
    """(ptype code, flags, version, quantizer, range x, range y) of
    `h263_parse_frame` for one picture."""
    if decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM:
        flags |= F_SORENSON
    if picture.has_plusptype:
        flags |= F_HAS_PLUSPTYPE
    if running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS:
        flags |= F_UMV_OPTION
    if picture.motion_vector_range is MotionVectorRange.EXTENDED:
        flags |= F_MV_RANGE_EXTENDED
    return (_PICTURE_TYPE_CODE.get(picture.picture_type, 3), flags,
            picture.version if picture.version is not None else -1,
            picture.quantizer, *_mv_ranges(width, height))


def parse_frame_native(data: bytes, start_bit: int, picture: Picture,
                       decoder_options, running_options: PictureOption,
                       width: int, height: int, out=None):
    """Native equivalent of `parser.frame.parse_frame`: the macroblock
    layer of `data` from bit `start_bit` (after the picture header) ->
    (FrameData, end bit).

    `out` may be a tuple of preallocated C-contiguous arrays (coeffs_y,
    class_y, coeffs_cb, class_cb, coeffs_cr, class_cr, mvs, inter as
    uint8), e.g. one stream's slices of a batch buffer, which are reset and
    filled in place."""
    from ..parser.frame import FrameData

    mb_w, mb_h = -(-width // 16), -(-height // 16)
    if out is not None:
        for a in out:
            if not a.flags["C_CONTIGUOUS"]:
                raise ValueError("out buffers must be C-contiguous")
        (coeffs_y, class_y, coeffs_cb, class_cb, coeffs_cr, class_cr,
         mvs, inter) = out
        for a in out[:-1]:
            a[...] = 0
        inter[...] = 1
    else:
        coeffs_y = np.zeros((2 * mb_h, 2 * mb_w, 8, 8), dtype=np.int16)
        class_y = np.zeros((2 * mb_h, 2 * mb_w), dtype=np.int8)
        coeffs_cb = np.zeros((mb_h, mb_w, 8, 8), dtype=np.int16)
        class_cb = np.zeros((mb_h, mb_w), dtype=np.int8)
        coeffs_cr = np.zeros((mb_h, mb_w, 8, 8), dtype=np.int16)
        class_cr = np.zeros((mb_h, mb_w), dtype=np.int8)
        mvs = np.zeros((mb_h, mb_w, 4, 2), dtype=np.int16)
        inter = np.ones((mb_h, mb_w), dtype=np.uint8)
    pred_scratch = np.zeros((mb_w * mb_h, 4, 2), dtype=np.int16)

    end_bit = ctypes.c_uint64(0)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = lib().h263_parse_frame(
        buf.ctypes.data, len(data), start_bit, width, height,
        *_frame_args(picture, decoder_options, running_options, width,
                     height, 0),
        coeffs_y.ctypes.data, class_y.ctypes.data, coeffs_cb.ctypes.data,
        class_cb.ctypes.data, coeffs_cr.ctypes.data, class_cr.ctypes.data,
        mvs.ctypes.data, inter.ctypes.data, pred_scratch.ctypes.data,
        None, None, 0, None, ctypes.addressof(end_bit), None,
        None, None, 0, None)
    if rc != 0:
        _raise(rc, "native parse")
    frame = FrameData(
        picture=picture, width=width, height=height, mb_w=mb_w, mb_h=mb_h,
        coeffs_y=coeffs_y, class_y=class_y,
        coeffs_cb=coeffs_cb, class_cb=class_cb,
        coeffs_cr=coeffs_cr, class_cr=class_cr,
        mvs=mvs, inter=inter.astype(np.bool_),
    )
    return frame, int(end_bit.value)


class SorensonFusedBatchParser:
    """One native call per step writing the fused transport of n Sorenson
    streams.

    Row i of `fused` (uint8 [n, row], rows `fused.strides[0]` bytes apart,
    so it may be the numpy view of a pinned tensor) receives
    [int8 MVs: `mv8_stride` B/MB | INTER bits, MSB-first | delta24
    entries], with the d24 tail padded up to the chosen cut of `ladder`.
    `mvs` (int16 [n, mbh, mbw, 4, 2]) and `inter` (uint8 [n, mbh, mbw])
    receive the full MVs and byte flags while the rows are slim (stride 2).
    """

    __slots__ = ("_n", "_hdr", "_counts", "_flags", "_failed", "_cut",
                 "_has_ref", "_fixed", "_keep")

    def __init__(self, n: int, width: int, height: int, fused: np.ndarray,
                 mv8_stride: int, mvs: np.ndarray, inter: np.ndarray,
                 pred_scratch: np.ndarray, pack_cap: int,
                 ladder: np.ndarray):
        nmb = (-(-width // 16)) * (-(-height // 16))
        row = nmb * mv8_stride + (nmb + 7) // 8 + 3 * pack_cap
        if mv8_stride not in (2, 8):
            raise ValueError(f"mv8_stride must be 2 or 8, got {mv8_stride}")
        if (fused.dtype != np.uint8 or fused.shape[0] != n
                or fused.shape[1] < row or fused.strides[1] != 1):
            raise ValueError(f"fused must be uint8 [{n}, >= {row}] with "
                             f"contiguous rows")
        if ladder.dtype != np.int32 or int(ladder[-1]) != pack_cap:
            raise ValueError("ladder must be int32 and end at pack_cap")
        for a, dt, shape in ((mvs, np.int16, (n, nmb * 8)),
                             (inter, np.uint8, (n, nmb)),
                             (pred_scratch, np.int16, (nmb * 8,))):
            if (a.dtype != dt or a.size != int(np.prod(shape))
                    or not a.flags["C_CONTIGUOUS"]):
                raise ValueError(f"expected a contiguous {np.dtype(dt)} "
                                 f"array of {shape}")
        self._n = n
        self._hdr = np.zeros((n, 8), dtype=np.int32)
        self._counts = np.zeros(n, dtype=np.int32)
        self._flags = np.zeros(n, dtype=np.int32)
        self._failed = ctypes.c_int32(-1)
        self._cut = ctypes.c_int32(0)
        self._has_ref = np.zeros(n, dtype=np.uint8)
        self._fixed = (
            n, width, height, 0, self._has_ref.ctypes.data,
            self._hdr.ctypes.data, mvs.ctypes.data, inter.ctypes.data,
            fused.ctypes.data, int(fused.strides[0]), mv8_stride,
            pred_scratch.ctypes.data, pack_cap,
            ladder.ctypes.data, int(ladder.shape[0]),
            self._counts.ctypes.data, self._flags.ctypes.data,
            ctypes.addressof(self._cut), ctypes.addressof(self._failed))
        # The arrays must outlive the bound addresses.
        self._keep = (fused, mvs, inter, pred_scratch, ladder)

    def parse(self, buffers, has_reference):
        """Parse every stream's frame (`bytes` each; `has_reference` bool
        per stream).  Returns (hdr int32 [n, 8]: version, TR, w, h, ptype
        code, deblocker, quant, format code; coefficient counts; flags: bit
        0 any INTER MB, bit 1 varied block MVs; cut).  Raises the mapped
        error, naming the lowest failing stream, with nothing returned."""
        n = self._n
        if len(buffers) != n:
            raise ValueError(f"expected {n} buffers, got {len(buffers)}")
        ptrs = (ctypes.c_char_p * n)(*buffers)
        lengths = np.fromiter((len(b) for b in buffers), dtype=np.uint64,
                              count=n)
        self._has_ref[:] = has_reference
        rc = lib().h263_sorenson_decode_batch_fused(
            ctypes.addressof(ptrs), lengths.ctypes.data, *self._fixed)
        if rc != 0:
            _raise(rc, f"stream {int(self._failed.value)}")
        return self._hdr, self._counts, self._flags, int(self._cut.value)


def parse_frame_native_packed(data: bytes, start_bit: int, picture: Picture,
                              decoder_options,
                              running_options: PictureOption, width: int,
                              height: int, pack_d24: np.ndarray,
                              mvs: np.ndarray, inter: np.ndarray,
                              pred_scratch: np.ndarray):
    """Like `parse_frame_native`, but into the delta24 transport: one
    stream's row `pack_d24` (uint8 [3 * cap]) receives the coefficient
    entries, `mvs` (int16 [mbh, mbw, 4, 2]) and `inter` (uint8 [mbh,
    mbw]) are reset and filled.  For any header flavour: the standard
    batch's replay parses its headers in Python.  Returns (entry count,
    end bit); the caller zero-pads the row past the count."""
    for a, dt in ((pack_d24, np.uint8), (mvs, np.int16), (inter, np.uint8),
                  (pred_scratch, np.int16)):
        if a.dtype != dt or not a.flags["C_CONTIGUOUS"]:
            raise ValueError(f"expected a contiguous {np.dtype(dt)} array")
    end_bit = ctypes.c_uint64(0)
    count = ctypes.c_int32(0)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = lib().h263_parse_frame(
        buf.ctypes.data, len(data), start_bit, width, height,
        *_frame_args(picture, decoder_options, running_options, width,
                     height, F_PACK_DELTA24),
        None, None, None, None, None, None,
        mvs.ctypes.data, inter.ctypes.data, pred_scratch.ctypes.data,
        pack_d24.ctypes.data, None, pack_d24.size // 3,
        ctypes.addressof(count), ctypes.addressof(end_bit), None,
        None, None, 0, None)
    if rc != 0:
        _raise(rc, "native packed parse")
    return int(count.value), int(end_bit.value)


def native_option_masks():
    """(OPPTYPE, MPPTYPE) carry-forward masks as compiled into the native
    library; the tests hold them against `types.py`."""
    opp = np.zeros(1, dtype=np.uint32)
    mpp = np.zeros(1, dtype=np.uint32)
    lib().h263_option_masks(opp.ctypes.data, mpp.ctypes.data)
    return int(opp[0]), int(mpp[0])


# Plain-PTYPE source format codes (H.263 table 2) and their kinds.
STD_KIND_BY_BITS = {1: SourceFormatKind.SUB_QCIF,
                    2: SourceFormatKind.QUARTER_CIF,
                    3: SourceFormatKind.FULL_CIF,
                    4: SourceFormatKind.FOUR_CIF,
                    5: SourceFormatKind.SIXTEEN_CIF}
STD_FMT_BITS = {k: b for b, k in STD_KIND_BY_BITS.items()}


def std_prev_fmt(pic) -> int:
    """The previous-format code the native plain-PTYPE parses take for a
    stream whose last header is `pic`: -1 none, the PTYPE format code after
    a plain-PTYPE header of a standard format, else -2 (the native call
    hands the next header to the Python parser, for the reference's
    format-change rule)."""
    if pic is None:
        return -1
    if pic.has_plusptype or pic.format is None:
        return -2
    return STD_FMT_BITS.get(pic.format.kind, -2)


def picture_from_std_row(row) -> Picture:
    """The Picture of a native plain-PTYPE header row (TR, width, height,
    ptype, header options, quantizer, CPM, PSBI, format code, running
    options): the Python parser's for the same header, less its PEI bytes
    (the native parse skips them)."""
    return Picture(
        version=None,
        temporal_reference=int(row[0]),
        format=SourceFormat.standard(STD_KIND_BY_BITS[int(row[8])]),
        options=PictureOption(int(row[4])),
        has_plusptype=False,
        has_opptype=False,
        picture_type=(PictureTypeCode.I_FRAME if row[3] == 0
                      else PictureTypeCode.P_FRAME),
        quantizer=int(row[5]),
        multiplex_bitstream=int(row[7]) if row[6] else None)


class StandardBatchParser:
    """One native call per step for n standard (non-Sorenson) H.263 streams
    with plain PTYPE headers, into the delta24 transport: row i of `pack`
    (uint8 [n, 3 * cap], contiguous, so it may be the numpy view of a
    pinned tensor) receives stream i's entries, zero-padded to the cap;
    `mvs` (int16 [n, mbh, mbw, 4, 2]) and `inter` (uint8 [n, mbh, mbw])
    the full MVs and byte flags.  Before each `parse` the caller fills
    `prev_running` (each stream's running options) and `prev_fmt` (its
    last PTYPE format code: -1 none, -2 a header the native path does not
    parse, which sends the batch to Python)."""

    __slots__ = ("_n", "hdr", "_counts", "_flags", "_failed", "_has_ref",
                 "prev_running", "prev_fmt", "_fixed", "_keep")

    def __init__(self, n: int, width: int, height: int, pack: np.ndarray,
                 mvs: np.ndarray, inter: np.ndarray,
                 pred_scratch: np.ndarray):
        nmb = (-(-width // 16)) * (-(-height // 16))
        if (pack.dtype != np.uint8 or pack.ndim != 2 or pack.shape[0] != n
                or pack.shape[1] % 3 or not pack.flags["C_CONTIGUOUS"]):
            raise ValueError(f"pack must be contiguous uint8 [{n}, 3 * cap]")
        for a, dt, shape in ((mvs, np.int16, (n, nmb * 8)),
                             (inter, np.uint8, (n, nmb)),
                             (pred_scratch, np.int16, (nmb * 8,))):
            if (a.dtype != dt or a.size != int(np.prod(shape))
                    or not a.flags["C_CONTIGUOUS"]):
                raise ValueError(f"expected a contiguous {np.dtype(dt)} "
                                 f"array of {shape}")
        self._n = n
        self.hdr = np.zeros((n, 10), dtype=np.int32)
        self._counts = np.zeros(n, dtype=np.int32)
        self._flags = np.zeros(n, dtype=np.int32)
        self._failed = ctypes.c_int32(-1)
        self._has_ref = np.zeros(n, dtype=np.uint8)
        self.prev_running = np.zeros(n, dtype=np.uint32)
        self.prev_fmt = np.full(n, -1, dtype=np.int32)
        self._fixed = (
            n, width, height, F_PACK_DELTA24, self._has_ref.ctypes.data,
            self.prev_running.ctypes.data, self.prev_fmt.ctypes.data,
            self.hdr.ctypes.data, mvs.ctypes.data, None, inter.ctypes.data,
            pred_scratch.ctypes.data, pack.ctypes.data, None,
            pack.shape[1] // 3, self._counts.ctypes.data,
            self._flags.ctypes.data, ctypes.addressof(self._failed))
        # The arrays must outlive the bound addresses.
        self._keep = (pack, mvs, inter, pred_scratch)

    def parse(self, buffers, has_reference):
        """Parse every stream's frame (`bytes` each; `has_reference` bool
        per stream).  Returns (hdr int32 [n, 10]: TR, w, h, ptype, header
        options, quant, CPM, PSBI, format code, running options; entry
        counts; flags: bit 0 any INTER MB, bit 1 varied block MVs).
        Raises `NeedsPythonHeader` when a header needs the Python parser,
        else the mapped error naming the lowest failing stream."""
        n = self._n
        if len(buffers) != n:
            raise ValueError(f"expected {n} buffers, got {len(buffers)}")
        ptrs = (ctypes.c_char_p * n)(*buffers)
        lengths = np.fromiter((len(b) for b in buffers), dtype=np.uint64,
                              count=n)
        self._has_ref[:] = has_reference
        rc = lib().h263_standard_decode_batch(
            ctypes.addressof(ptrs), lengths.ctypes.data, *self._fixed)
        if rc == E_NEEDS_PYTHON:
            raise NeedsPythonHeader(int(self._failed.value))
        if rc != 0:
            _raise(rc, f"stream {int(self._failed.value)}")
        return self.hdr, self._counts, self._flags
