"""Macroblock-layer parsing (parity with h263/src/parser/macroblock.rs).

A copy of `h263_tpu/parser/macroblock.py`, so that the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from ..bitio import BitReader
from ..types import (
    CodedBlockPattern,
    InvalidMacroblockCodedBits,
    InvalidMacroblockHeader,
    InvalidMvd,
    Macroblock,
    MacroblockKind,
    MotionVector,
    Picture,
    PictureOption,
    PictureTypeCode,
    UnimplementedDecoding,
)
from ..vlc_tables import (
    CBPY,
    MCBPC_I,
    MCBPC_P,
    MODB,
    MVD,
    VLC_INVALID,
    VLC_STUFFING,
)

_DQUANT_MAP = {0: -1, 1: -2, 2: 1, 3: 2}  # macroblock.rs:257-270


def decode_motion_vector(r: BitReader, picture: Picture,
                         running_options: PictureOption) -> MotionVector:
    """One MVD pair: UMV fixed codes when UMV+PLUSPTYPE, else Table 14 VLC
    (macroblock.rs:414-437)."""

    def body(r: BitReader):
        if (running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS
                and picture.has_plusptype):
            return MotionVector(r.read_umv(), r.read_umv())
        x = r.read_vlc(MVD)
        if x == VLC_INVALID:
            raise InvalidMvd()
        y = r.read_vlc(MVD)
        if y == VLC_INVALID:
            raise InvalidMvd()
        return MotionVector(x, y)

    return r.with_transaction(body)


def decode_macroblock(r: BitReader, picture: Picture,
                      running_options: PictureOption) -> Macroblock:
    """COD/MCBPC/MODB/CBPY/DQUANT/MVD chain (macroblock.rs:445-549)."""

    def body(r: BitReader):
        if picture.picture_type is PictureTypeCode.I_FRAME:
            is_coded = 0
        else:
            is_coded = r.read_bits(1)

        if is_coded != 0:
            return Macroblock(MacroblockKind.UNCODED)

        if picture.picture_type is PictureTypeCode.I_FRAME:
            mcbpc = r.read_vlc(MCBPC_I)
        elif picture.picture_type is PictureTypeCode.P_FRAME:
            mcbpc = r.read_vlc(MCBPC_P)
        else:
            # Parity with macroblock.rs:461-464: only IFrame/PFrame dispatch;
            # every other type — including Sorenson DisposablePFrame — fails
            # on its first *coded* macroblock (uncoded COD=1 MBs still work).
            raise UnimplementedDecoding()

        if mcbpc == VLC_STUFFING:
            return Macroblock(MacroblockKind.STUFFING)
        if mcbpc == VLC_INVALID:
            raise InvalidMacroblockHeader()
        mb_type, codes_chroma_b, codes_chroma_r = mcbpc

        if picture.picture_type is PictureTypeCode.PB_FRAME:
            has_cbpb, has_mvdb = r.read_vlc(MODB)
        else:
            has_cbpb, has_mvdb = False, False

        cbpy = r.read_vlc(CBPY)
        if cbpy == VLC_INVALID:
            raise InvalidMacroblockCodedBits()
        if mb_type.is_intra():
            codes_luma = cbpy
        else:
            codes_luma = tuple(not v for v in cbpy)

        coded_block_pattern_b = None
        if has_cbpb:
            bits = [r.read_bits(1) == 1 for _ in range(6)]
            coded_block_pattern_b = CodedBlockPattern(
                tuple(bits[:4]), bits[4], bits[5])

        if running_options & PictureOption.MODIFIED_QUANTIZATION:
            raise UnimplementedDecoding()
        d_quantizer = None
        if mb_type.has_quantizer():
            d_quantizer = _DQUANT_MAP[r.read_bits(2)]

        motion_vector = None
        if mb_type.is_inter() or picture.picture_type.is_any_pbframe():
            motion_vector = decode_motion_vector(r, picture, running_options)

        addl_motion_vectors = None
        if mb_type.has_fourvec():
            addl_motion_vectors = tuple(
                decode_motion_vector(r, picture, running_options)
                for _ in range(3)
            )

        motion_vectors_b = None
        if has_mvdb:
            motion_vectors_b = tuple(
                decode_motion_vector(r, picture, running_options)
                for _ in range(4)
            )

        return Macroblock(
            MacroblockKind.CODED,
            mb_type=mb_type,
            coded_block_pattern=CodedBlockPattern(
                codes_luma, codes_chroma_b, codes_chroma_r),
            coded_block_pattern_b=coded_block_pattern_b,
            d_quantizer=d_quantizer,
            motion_vector=motion_vector,
            addl_motion_vectors=addl_motion_vectors,
            motion_vectors_b=motion_vectors_b,
        )

    return r.with_transaction(body)
