"""Picture- and GOB-layer header parsing.

A copy of `h263_tpu/parser/picture.py`, so that the port imports nothing of
the JAX package.

Functional parity with h263/src/parser/picture.rs and gob.rs.  Each decode
function is wrapped in a reader transaction so a failed parse leaves the
bitstream position untouched.
"""

from __future__ import annotations

from typing import Optional

from ..bitio import BitReader
from ..types import (
    BPictureQuantizer,
    CustomPictureClock,
    CustomPictureFormat,
    DecoderOption,
    GroupOfBlocks,
    InvalidBitstream,
    InvalidGobHeader,
    InvalidPlusPType,
    InvalidPType,
    MiddleOfBitstream,
    MotionVectorRange,
    OPPTYPE_OPTIONS,
    Picture,
    PictureFormatInvalid,
    PictureOption,
    PictureTypeCode,
    PixelAspectRatio,
    ReferencePictureSelectionMode,
    ScalabilityLayer,
    SliceSubmode,
    SourceFormat,
    SourceFormatKind,
    UnimplementedDecoding,
)

# PLUSPTYPE follower flags (cf. picture.rs:91-99)
_F_CUSTOM_FORMAT = 1
_F_CUSTOM_CLOCK = 2
_F_MV_RANGE = 4
_F_SLICE_SUBMODE = 8
_F_REF_LAYER_NUM = 16
_F_RPS_MODE = 32


def _decode_ptype(r: BitReader):
    """First 8+5 bits of PTYPE (picture.rs:21-81).

    Returns (options, None) when PLUSPTYPE follows, else
    (options, (source_format, picture_type)).
    """

    def body(r: BitReader):
        options = PictureOption.NONE
        high = r.read_u8()
        if high & 0xC0 != 0x80:
            raise InvalidPType()
        if high & 0x20:
            options |= PictureOption.USE_SPLIT_SCREEN
        if high & 0x10:
            options |= PictureOption.USE_DOCUMENT_CAMERA
        if high & 0x08:
            options |= PictureOption.RELEASE_FULL_PICTURE_FREEZE

        fmt_bits = high & 0x07
        if fmt_bits == 0:
            raise InvalidPType()
        if fmt_bits == 7:
            return options, None  # PLUSPTYPE follows
        source_format = SourceFormat.standard(
            {
                1: SourceFormatKind.SUB_QCIF,
                2: SourceFormatKind.QUARTER_CIF,
                3: SourceFormatKind.FULL_CIF,
                4: SourceFormatKind.FOUR_CIF,
                5: SourceFormatKind.SIXTEEN_CIF,
            }[fmt_bits]
        ) if fmt_bits != 6 else SourceFormat(SourceFormatKind.RESERVED)

        low = r.read_bits(5)
        ptype = PictureTypeCode.I_FRAME if low & 0x10 else PictureTypeCode.P_FRAME
        if low & 0x08:
            options |= PictureOption.UNRESTRICTED_MOTION_VECTORS
        if low & 0x04:
            options |= PictureOption.SYNTAX_BASED_ARITHMETIC_CODING
        if low & 0x02:
            options |= PictureOption.ADVANCED_PREDICTION
        if low & 0x01:
            ptype = PictureTypeCode.PB_FRAME
        return options, (source_format, ptype)

    return r.with_transaction(body)


def _decode_plusptype(r: BitReader, decoder_options: DecoderOption,
                      previous_options: PictureOption):
    """UFEP/OPPTYPE/MPPTYPE chain (picture.rs:138-266).

    Returns (options, source_format|None, picture_type, followers, has_opptype).
    """

    def body(r: BitReader):
        ufep = r.read_bits(3)
        if ufep == 0:
            has_opptype = False
        elif ufep == 1:
            has_opptype = True
        else:
            raise InvalidPlusPType()

        options = PictureOption.NONE
        followers = 0
        source_format = None

        if has_opptype:
            opptype = r.read_bits(18)
            if (opptype & 0xF) != 0x8:  # must end in 1000 (5.1.4.2)
                raise InvalidPlusPType()
            fmt = (opptype & 0x38000) >> 15
            if fmt == 6:
                followers |= _F_CUSTOM_FORMAT
            else:
                source_format = SourceFormat(
                    {
                        0: SourceFormatKind.RESERVED,
                        1: SourceFormatKind.SUB_QCIF,
                        2: SourceFormatKind.QUARTER_CIF,
                        3: SourceFormatKind.FULL_CIF,
                        4: SourceFormatKind.FOUR_CIF,
                        5: SourceFormatKind.SIXTEEN_CIF,
                        7: SourceFormatKind.RESERVED,
                    }[fmt]
                )
            if opptype & 0x04000:
                followers |= _F_CUSTOM_CLOCK
            if opptype & 0x02000:
                options |= PictureOption.UNRESTRICTED_MOTION_VECTORS
                followers |= _F_MV_RANGE
            if opptype & 0x01000:
                options |= PictureOption.SYNTAX_BASED_ARITHMETIC_CODING
            if opptype & 0x00800:
                options |= PictureOption.ADVANCED_PREDICTION
            if opptype & 0x00400:
                options |= PictureOption.ADVANCED_INTRA_CODING
            if opptype & 0x00200:
                options |= PictureOption.DEBLOCKING_FILTER
            if opptype & 0x00100:
                options |= PictureOption.SLICE_STRUCTURED
                followers |= _F_SLICE_SUBMODE
            if opptype & 0x00080:
                options |= PictureOption.REFERENCE_PICTURE_SELECTION
                followers |= _F_RPS_MODE
            if opptype & 0x00040:
                options |= PictureOption.INDEPENDENT_SEGMENT_DECODING
            if opptype & 0x00020:
                options |= PictureOption.ALTERNATIVE_INTER_VLC
            if opptype & 0x00010:
                options |= PictureOption.MODIFIED_QUANTIZATION
            if decoder_options & DecoderOption.USE_SCALABILITY_MODE:
                followers |= _F_REF_LAYER_NUM
        else:
            options |= previous_options & OPPTYPE_OPTIONS

        mpptype = r.read_bits(9)
        if mpptype & 0x007 != 0x1:  # must end in 001 (5.1.4.3)
            raise InvalidPlusPType()
        picture_type = {
            0: PictureTypeCode.I_FRAME,
            1: PictureTypeCode.P_FRAME,
            2: PictureTypeCode.IMPROVED_PB_FRAME,
            3: PictureTypeCode.B_FRAME,
            4: PictureTypeCode.EI_FRAME,
            5: PictureTypeCode.EP_FRAME,
        }.get((mpptype & 0x1C0) >> 6, PictureTypeCode.RESERVED)
        if mpptype & 0x020:
            options |= PictureOption.REFERENCE_PICTURE_RESAMPLING
        if mpptype & 0x010:
            options |= PictureOption.REDUCED_RESOLUTION_UPDATE
        if mpptype & 0x008:
            options |= PictureOption.ROUNDING_TYPE_ONE

        return options, source_format, picture_type, followers, has_opptype

    return r.with_transaction(body)


def _decode_sorenson_ptype(r: BitReader):
    """Sorenson Spark header flavor (picture.rs:271-327)."""

    def body(r: BitReader):
        fmt_bits = r.read_bits(3)
        source_format = None
        bit_count = 0
        if fmt_bits == 0:
            bit_count = 8
        elif fmt_bits == 1:
            bit_count = 16
        elif fmt_bits == 2:
            source_format = SourceFormat.standard(SourceFormatKind.FULL_CIF)
        elif fmt_bits == 3:
            source_format = SourceFormat.standard(SourceFormatKind.QUARTER_CIF)
        elif fmt_bits == 4:
            source_format = SourceFormat.standard(SourceFormatKind.SUB_QCIF)
        elif fmt_bits == 5:
            source_format = SourceFormat.extended(320, 240)
        elif fmt_bits == 6:
            source_format = SourceFormat.extended(160, 120)
        else:
            source_format = SourceFormat(SourceFormatKind.RESERVED)

        if source_format is None:
            w = r.read_bits(bit_count)
            h = r.read_bits(bit_count)
            source_format = SourceFormat.extended(w, h)

        ptype_bits = r.read_bits(2)
        picture_type = {
            0: PictureTypeCode.I_FRAME,
            1: PictureTypeCode.P_FRAME,
            2: PictureTypeCode.DISPOSABLE_P_FRAME,
        }.get(ptype_bits, PictureTypeCode.RESERVED)

        options = PictureOption.NONE
        if r.read_bits(1) == 1:
            options |= PictureOption.USE_DEBLOCKER

        return source_format, picture_type, options

    return r.with_transaction(body)


def _decode_cpm_and_psbi(r: BitReader) -> Optional[int]:
    def body(r: BitReader):
        if r.read_bits(1) != 0:
            return r.read_bits(2)
        return None

    # NB: a None result is a *valid* outcome here, so use a plain transaction.
    saved = r.pos
    try:
        return body(r)
    except Exception:
        r.pos = saved
        raise


def _decode_cpfmt(r: BitReader) -> CustomPictureFormat:
    """CPFMT follower (picture.rs:349-392)."""

    def body(r: BitReader):
        cpfmt = r.read_bits(23)
        if cpfmt & 0x000200 == 0:
            raise PictureFormatInvalid()
        par_bits = (cpfmt & 0x780000) >> 19
        par_width = par_height = 0
        if par_bits == 0:
            raise PictureFormatInvalid()
        elif par_bits == 1:
            par = PixelAspectRatio.SQUARE
        elif par_bits == 2:
            par = PixelAspectRatio.PAR_12_11
        elif par_bits == 3:
            par = PixelAspectRatio.PAR_10_11
        elif par_bits == 4:
            par = PixelAspectRatio.PAR_16_11
        elif par_bits == 5:
            par = PixelAspectRatio.PAR_40_33
        elif par_bits == 15:
            par_width = r.read_u8()
            par_height = r.read_u8()
            if par_width == 0 or par_height == 0:
                raise PictureFormatInvalid()
            par = PixelAspectRatio.EXTENDED
        else:
            par = PixelAspectRatio.RESERVED
        width = (((cpfmt & 0x07FC00) >> 10) + 1) * 4
        height = (cpfmt & 0x0000FF) * 4
        return CustomPictureFormat(par, width, height, par_width, par_height)

    return r.with_transaction(body)


def _decode_uui(r: BitReader) -> MotionVectorRange:
    def body(r: BitReader):
        if r.read_bits(1) == 1:
            return MotionVectorRange.EXTENDED
        if r.read_bits(1) == 1:
            return MotionVectorRange.UNLIMITED
        raise InvalidBitstream()

    return r.with_transaction(body)


def _decode_pei(r: BitReader) -> bytes:
    """PEI/PSUPP loop (picture.rs:577-595)."""

    def body(r: BitReader):
        data = bytearray()
        while r.read_bits(1) == 1:
            data.append(r.read_u8())
        return bytes(data)

    return r.with_transaction(body)


def decode_picture(r: BitReader, decoder_options: DecoderOption,
                   previous_picture: Optional[Picture]) -> Optional[Picture]:
    """Parse a picture header (picture.rs:611-817).

    Returns None when positioned at a (non-picture) GOB header instead.
    Raises MiddleOfBitstream when no start code is recognizable here.
    """

    def body(r: BitReader):
        skipped = r.recognize_start_code(False)
        if skipped is None:
            raise MiddleOfBitstream()
        r.skip_bits(17 + skipped)

        gob_id = r.read_bits(5)

        if decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM:
            temporal_reference = r.read_u8()
            source_format, picture_type, options = _decode_sorenson_ptype(r)
            quantizer = r.read_bits(5)
            extra = _decode_pei(r)
            return Picture(
                version=gob_id,  # Sorenson abuses the GOB id as a version
                temporal_reference=temporal_reference,
                format=source_format,
                options=options,
                has_plusptype=False,
                has_opptype=False,
                picture_type=picture_type,
                quantizer=quantizer,
                extra=extra,
                motion_vector_range=MotionVectorRange.UNLIMITED,
            )

        if gob_id != 0:
            return None  # positioned at a GOB, not a picture

        low_tr = r.read_u8()
        options, maybe_fmt_type = _decode_ptype(r)
        # CPM/PSBI placement depends on PLUSPTYPE presence; _UNREAD marks
        # "not read yet" — distinct from "read, feature off" (None), matching
        # the reference's Option<Option<u8>> (picture.rs:666-688,774-777).
        _UNREAD = object()
        multiplex_bitstream = _UNREAD
        if maybe_fmt_type is not None:
            fmt, picture_type = maybe_fmt_type
            followers = 0
            has_plusptype = False
            has_opptype = False
        else:
            prev_opts = previous_picture.options if previous_picture else PictureOption.NONE
            extra_options, fmt, picture_type, followers, has_opptype = _decode_plusptype(
                r, decoder_options, prev_opts)
            options |= extra_options
            multiplex_bitstream = _decode_cpm_and_psbi(r)
            has_plusptype = True

        if followers & _F_CUSTOM_FORMAT:
            fmt = SourceFormat(SourceFormatKind.EXTENDED, _decode_cpfmt(r))

        picture_clock = None
        if followers & _F_CUSTOM_CLOCK:
            cpcfc = r.read_u8()
            picture_clock = CustomPictureClock(bool(cpcfc & 0x80), cpcfc & 0x7F)

        if picture_clock is not None:
            temporal_reference = (r.read_bits(2) << 8) | low_tr
        else:
            temporal_reference = low_tr

        motion_vector_range = None
        if followers & _F_MV_RANGE:
            motion_vector_range = _decode_uui(r)

        slice_submode = None
        if followers & _F_SLICE_SUBMODE:
            slice_submode = SliceSubmode(r.read_bits(2))

        scalability_layer = None
        if decoder_options & DecoderOption.USE_SCALABILITY_MODE:
            enhancement = r.read_bits(4)
            reference = r.read_bits(4) if (followers & _F_REF_LAYER_NUM) else None
            scalability_layer = ScalabilityLayer(enhancement, reference)

        reference_picture_selection_mode = None
        if followers & _F_RPS_MODE:
            # picture.rs:477-497: the raw 3 bits are NOT the flag values —
            # RESERVED is set when bit 0x4 is ABSENT, 0x2 requests NACKs,
            # 0x1 requests ACKs.
            raw = r.read_bits(3)
            reference_picture_selection_mode = ReferencePictureSelectionMode(0)
            if not raw & 0x4:
                reference_picture_selection_mode |= (
                    ReferencePictureSelectionMode.RESERVED)
            if raw & 0x2:
                reference_picture_selection_mode |= (
                    ReferencePictureSelectionMode
                    .REQUEST_NEGATIVE_ACKNOWLEDGEMENT)
            if raw & 0x1:
                reference_picture_selection_mode |= (
                    ReferencePictureSelectionMode.REQUEST_ACKNOWLEDGEMENT)

        prediction_reference = None
        backchannel_message = None
        if options & PictureOption.REFERENCE_PICTURE_SELECTION:
            if r.read_bits(1) == 1:  # TRPI
                prediction_reference = r.read_bits(10)
            # BCM: '1' => unimplemented backchannel, '01' => none
            if r.read_bits(1) == 1:
                raise UnimplementedDecoding()
            if r.read_bits(1) != 1:
                raise InvalidBitstream()

        # RPRP (reference picture resampling parameters) — unimplemented,
        # matching the reference (picture.rs:540-545).
        prev_fmt = previous_picture.format if previous_picture else None
        if (options & PictureOption.REFERENCE_PICTURE_RESAMPLING) or (
            previous_picture is not None and prev_fmt != fmt
        ):
            raise UnimplementedDecoding()

        quantizer = r.read_bits(5)

        if multiplex_bitstream is _UNREAD:
            multiplex_bitstream = _decode_cpm_and_psbi(r)

        pb_reference = None
        pb_quantizer = None
        if picture_type.is_any_pbframe():
            pb_reference = r.read_bits(5 if picture_clock is not None else 3)
            pb_quantizer = BPictureQuantizer(r.read_bits(2))  # DBQUANT (5/4..8/4)

        extra = _decode_pei(r)

        return Picture(
            version=None,
            temporal_reference=temporal_reference,
            format=fmt,
            options=options,
            has_plusptype=has_plusptype,
            has_opptype=has_opptype,
            picture_type=picture_type,
            motion_vector_range=motion_vector_range,
            slice_submode=slice_submode,
            scalability_layer=scalability_layer,
            reference_picture_selection_mode=reference_picture_selection_mode,
            prediction_reference=prediction_reference,
            backchannel_message=backchannel_message,
            reference_picture_resampling=None,
            quantizer=quantizer,
            multiplex_bitstream=multiplex_bitstream,
            pb_reference=pb_reference,
            pb_quantizer=pb_quantizer,
            extra=extra,
        )

    return r.with_transaction_union(body)


def decode_gob(r: BitReader, decoder_options: DecoderOption) -> Optional[GroupOfBlocks]:
    """GOB resync point (gob.rs:21-42).

    Yields None when the start code is actually a picture (GN 0 or 15); real
    GOB headers are unimplemented, matching the reference — they only serve
    as error-recovery resync targets.
    """

    def body(r: BitReader):
        skipped = r.recognize_start_code(False)
        if skipped is None:
            raise InvalidGobHeader()
        r.skip_bits(17 + skipped)
        gob_id = r.read_bits(5)
        if gob_id == 0 or gob_id == 15:
            return None
        raise UnimplementedDecoding()

    return r.with_transaction_union(body)
