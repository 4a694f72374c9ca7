"""Block-layer parsing: INTRADC + TCOEF run events.

A copy of `h263_tpu/parser/block.py`, so that the port imports nothing of
the JAX package.

Parity with h263/src/parser/block.rs:670-755.
"""

from __future__ import annotations

from ..bitio import BitReader
from ..types import (
    Block,
    DecoderOption,
    InvalidIntraDc,
    InvalidLongCoefficient,
    InvalidShortCoefficient,
    MacroblockType,
    Picture,
    PictureOption,
    TCoefficient,
    intradc_from_u8,
)
from ..vlc_tables import TCOEF, VLC_ESCAPE, VLC_INVALID


def decode_block(r: BitReader, decoder_options: DecoderOption, picture: Picture,
                 running_options: PictureOption, macroblock_type: MacroblockType,
                 tcoef_present: bool) -> Block:
    """Decode one 8x8 block's coefficients.

    `tcoef_present` is the corresponding CodedBlockPattern bit; INTRA blocks
    always carry an INTRADC byte regardless.
    """

    def body(r: BitReader):
        intradc = None
        if macroblock_type.is_intra():
            intradc = intradc_from_u8(r.read_u8())
            if intradc is None:
                raise InvalidIntraDc()

        tcoef: list[TCoefficient] = []
        present = tcoef_present
        while present:
            sym = r.read_vlc(TCOEF)
            if sym == VLC_INVALID:
                raise InvalidShortCoefficient()
            if sym == VLC_ESCAPE:
                # ESCAPE: fixed-length LAST(1) RUN(6) LEVEL(w).  Sorenson
                # version 1 selects 7- or 11-bit levels with a flag bit; all
                # other streams (incl. Sorenson v0) use 8 bits
                # (block.rs:693-709).
                if (decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM
                        and picture.version == 1):
                    level_width = 11 if r.read_bits(1) == 1 else 7
                else:
                    level_width = 8
                last = r.read_bits(1) == 1
                run = r.read_bits(6)
                level = r.read_signed_bits(level_width)
                if level == 0:
                    raise InvalidLongCoefficient()
                # NB: the reference also rejects `level == i16::MAX << width`,
                # but that value is unreachable from a `width`-bit signed read
                # (the shift wraps to a value outside the read range), so
                # level==0 is the only live error path (block.rs:711-722).
                tcoef.append(TCoefficient(False, run, level))
                present = not last
            else:
                last, run, magnitude = sym
                sign = r.read_bits(1)
                level = -magnitude if sign else magnitude
                tcoef.append(TCoefficient(True, run, level))
                present = not last

        return Block(intradc=intradc, tcoef=tcoef)

    return r.with_transaction(body)
