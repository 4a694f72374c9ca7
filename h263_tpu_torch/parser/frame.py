"""Whole-frame entropy front-end: a copy of `h263_tpu/parser/frame.py`,
with `parse_frame_auto` always native.

Drains one picture's macroblock layer into dense, dependency-free numpy
tensors — the host/device seam of the framework.  This corresponds to the
macroblock loop of H263State::decode_next_picture (state.rs:178-427) plus
inverse RLE / dezigzag / dequantization (cpu/rle.rs), with the serial MV and
quantizer recurrences fully resolved so every downstream TPU kernel is
trivially parallel over macroblocks.

Output layout (FrameData):
  coeffs_y : int16   [2*mbh, 2*mbw, 8, 8]   dequantized levels, [by,bx,row,col]
  class_y  : int8    [2*mbh, 2*mbw]          BLOCK_CLASS_* (drives exact IDCT path)
  coeffs_cb/cr : int16   [mbh, mbw, 8, 8]
  class_cb/cr  : int8    [mbh, mbw]
  mvs      : int16   [mbh, mbw, 4, 2]        decoded luma block MVs, (x, y) half-pel
  inter    : bool    [mbh, mbw]              True = INTER (incl. uncoded/tail-fill)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitio import BitReader
from ..types import (
    BLOCK_CLASS_DC,
    BLOCK_CLASS_FULL,
    BLOCK_CLASS_VERT,
    BLOCK_CLASS_ZERO,
    Block,
    DecoderOption,
    H263Error,
    InvalidBitstream,
    MacroblockKind,
    MacroblockType,
    Picture,
    PictureOption,
    PictureTypeCode,
    UncodedIFrameBlocks,
    ZERO_MV,
)
from ..vlc_tables import ZIGZAG_XY
from .block import decode_block
from .macroblock import decode_macroblock
from .mvpred import mv_decode, predict_candidate
from .picture import decode_gob


@dataclass
class FrameData:
    """Dense per-frame tensors ready for the TPU reconstruction program."""

    picture: Picture
    width: int
    height: int
    mb_w: int
    mb_h: int
    coeffs_y: np.ndarray
    class_y: np.ndarray
    coeffs_cb: np.ndarray
    class_cb: np.ndarray
    coeffs_cr: np.ndarray
    class_cr: np.ndarray
    mvs: np.ndarray
    inter: np.ndarray

    @property
    def chroma_width(self) -> int:
        return (self.width + 1) // 2

    @property
    def chroma_height(self) -> int:
        return (self.height + 1) // 2


def _wrap_i16(x: int) -> int:
    """Two's-complement int16 wraparound (rle.rs dequant arithmetic)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def inverse_rle(block: Block, quant: int, coeffs_out: np.ndarray) -> int:
    """Dezigzag + dequantize one block into `coeffs_out` (8x8 int16, pre-zeroed).

    Returns the block's sparsity class.  Parity with cpu/rle.rs:82-172,
    including the quirk that a zigzag-index overflow discards the *entire*
    block (the reference early-returns before storing its result).
    """
    if not block.tcoef:
        if block.intradc is not None and block.intradc != 0:
            coeffs_out[0, 0] = block.intradc
            return BLOCK_CLASS_DC
        return BLOCK_CLASS_ZERO

    is_horiz = True
    is_vert = True
    zz = 0
    if block.intradc is not None:
        coeffs_out[0, 0] = block.intradc
        zz = 1

    parity = 0 if quant % 2 == 1 else -1
    for tc in block.tcoef:
        zz += tc.run
        if zz >= 64:
            # rle.rs:125-127: silent truncation discards the whole block.
            coeffs_out[:] = 0.0
            return BLOCK_CLASS_ZERO
        x, y = ZIGZAG_XY[zz]
        mag = tc.level if tc.level >= 0 else -tc.level
        # rle.rs:130-133 computes in i16, which WRAPS in release builds
        # for Sorenson v1 11-bit escape levels (quant*(2|L|+1) > 32767,
        # e.g. quant>=17 with |L| near 1023).  Bit-exactness requires
        # replicating the wrap before the clamp.
        dequantized = _wrap_i16(quant * (2 * mag + 1))
        sign = 1 if tc.level > 0 else -1
        value = _wrap_i16(sign * _wrap_i16(dequantized + parity))
        value = max(-2048, min(2047, value))
        coeffs_out[y, x] = value
        zz += 1
        if value != 0:
            if y > 0:
                is_horiz = False
            if x > 0:
                is_vert = False

    if is_horiz and is_vert:
        if coeffs_out[0, 0] == 0:
            return BLOCK_CLASS_ZERO
        return BLOCK_CLASS_DC
    if is_vert:
        return BLOCK_CLASS_VERT
    # The reference's Horiz fast path computes bit-identical f32 results to
    # its Full path (row-0-only input), so both map to FULL here.
    return BLOCK_CLASS_FULL


def parse_frame_auto(r: BitReader, picture: Picture, decoder_options: DecoderOption,
                     running_options: PictureOption, width: int, height: int) -> FrameData:
    """parse_frame through the native C++ front-end (`native/bindings.py`),
    which gives the Python `parse_frame`'s tensors and error classes
    (`tests/test_torch_host_parser.py`).  The port has no switch to the
    Python path: a failed native build raises."""
    from ..native.bindings import parse_frame_native

    frame, end_bit = parse_frame_native(
        r.data, r.pos, picture, decoder_options, running_options,
        width, height)
    r.pos = end_bit
    return frame


def parse_frame(r: BitReader, picture: Picture, decoder_options: DecoderOption,
                running_options: PictureOption, width: int, height: int) -> FrameData:
    """Drain one picture's macroblocks into dense tensors.

    `picture` is the already-parsed header; the reader must be positioned at
    the first macroblock.  Implements the reference's error recovery: GOB
    resync after macroblock errors (non-Sorenson), EOF ends the picture, and
    missing tail macroblocks become empty INTER MBs with zero MVs
    (state.rs:386-427).
    """
    is_sorenson = bool(decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM)
    mb_w = -(-width // 16)
    mb_h = -(-height // 16)
    nmb = mb_w * mb_h

    coeffs_y = np.zeros((2 * mb_h, 2 * mb_w, 8, 8), dtype=np.int16)
    class_y = np.zeros((2 * mb_h, 2 * mb_w), dtype=np.int8)
    coeffs_cb = np.zeros((mb_h, mb_w, 8, 8), dtype=np.int16)
    class_cb = np.zeros((mb_h, mb_w), dtype=np.int8)
    coeffs_cr = np.zeros((mb_h, mb_w, 8, 8), dtype=np.int16)
    class_cr = np.zeros((mb_h, mb_w), dtype=np.int8)
    mvs_arr = np.zeros((mb_h, mb_w, 4, 2), dtype=np.int16)
    # Tail-filled MBs default to INTER with zero MV (state.rs:419-427).
    inter = np.ones((mb_h, mb_w), dtype=np.bool_)

    in_force_quantizer = picture.quantizer
    predictor_vectors: list = []  # one [mv0..mv3] per decoded MB
    mb_types: list = []
    macroblocks_after_gob = 0
    is_iframe = picture.picture_type is PictureTypeCode.I_FRAME

    while True:
        try:
            mb = decode_macroblock(r, picture, running_options)
        except H263Error as e:
            if e.is_macroblock_error() and not is_sorenson:
                # Resync to the next GOB / picture start (state.rs:386-408).
                try:
                    gob = decode_gob(r, decoder_options)
                except H263Error as ge:
                    if ge.is_eof_error() or ge.is_gob_error():
                        break
                    raise
                if gob is None:
                    break  # resynchronized to end of picture
                in_force_quantizer = gob.quantizer
                macroblocks_after_gob = len(mb_types)
                continue
            if e.is_eof_error():
                break
            raise

        index = len(mb_types)
        mby, mbx = divmod(index, mb_w)
        motion_vectors = [ZERO_MV, ZERO_MV, ZERO_MV, ZERO_MV]

        if mb.kind is MacroblockKind.STUFFING:
            continue
        if mb.kind is MacroblockKind.UNCODED:
            if is_iframe:
                raise UncodedIFrameBlocks()
            mb_type = MacroblockType.INTER
        else:
            mb_type = mb.mb_type
            quantizer = in_force_quantizer + (mb.d_quantizer or 0)
            in_force_quantizer = max(1, min(31, quantizer))

            if mb_type.is_inter():
                slice_preds = predictor_vectors[macroblocks_after_gob:]
                mv1 = mb.motion_vector or ZERO_MV
                mpred1 = predict_candidate(slice_preds, motion_vectors, mb_w, 0)
                motion_vectors[0] = mv_decode(
                    picture, running_options, mpred1, mv1, width, height)
                if mb.addl_motion_vectors is not None:
                    for k, mvk in enumerate(mb.addl_motion_vectors, start=1):
                        mpred = predict_candidate(slice_preds, motion_vectors, mb_w, k)
                        motion_vectors[k] = mv_decode(
                            picture, running_options, mpred, mvk, width, height)
                else:
                    motion_vectors[1] = motion_vectors[0]
                    motion_vectors[2] = motion_vectors[0]
                    motion_vectors[3] = motion_vectors[0]

            cbp = mb.coded_block_pattern
            in_range = index < nmb
            if not in_range:
                # The reference calls inverse_rle for EVERY block of EVERY
                # coded macroblock — empty CBP included — indexing
                # levels[block_id] past its buffers (rle.rs:90, a panic);
                # we reject the stream instead, uniformly.
                raise InvalidBitstream()

            # 4 luma blocks, then Cb, Cr (state.rs:287-381).
            for k in range(4):
                blk = decode_block(r, decoder_options, picture, running_options,
                                   mb_type, cbp.codes_luma[k])
                if in_range:
                    by = 2 * mby + (k >> 1)
                    bx = 2 * mbx + (k & 1)
                    class_y[by, bx] = inverse_rle(
                        blk, in_force_quantizer, coeffs_y[by, bx])
            blk = decode_block(r, decoder_options, picture, running_options,
                               mb_type, cbp.codes_chroma_b)
            if in_range:
                class_cb[mby, mbx] = inverse_rle(
                    blk, in_force_quantizer, coeffs_cb[mby, mbx])
            blk = decode_block(r, decoder_options, picture, running_options,
                               mb_type, cbp.codes_chroma_r)
            if in_range:
                class_cr[mby, mbx] = inverse_rle(
                    blk, in_force_quantizer, coeffs_cr[mby, mbx])

        predictor_vectors.append(tuple(motion_vectors))
        mb_types.append(mb_type)
        if index < nmb:
            inter[mby, mbx] = mb_type.is_inter()
            for k in range(4):
                mvs_arr[mby, mbx, k, 0] = motion_vectors[k].x
                mvs_arr[mby, mbx, k, 1] = motion_vectors[k].y

    return FrameData(
        picture=picture,
        width=width,
        height=height,
        mb_w=mb_w,
        mb_h=mb_h,
        coeffs_y=coeffs_y,
        class_y=class_y,
        coeffs_cb=coeffs_cb,
        class_cb=class_cb,
        coeffs_cr=coeffs_cr,
        class_cr=class_cr,
        mvs=mvs_arr,
        inter=inter,
    )
