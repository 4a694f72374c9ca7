"""The bitstream types the port uses, with the names and values of
`h263_tpu/types.py` (a copy, so that the port imports nothing of the JAX
package; `tests/test_torch_tables.py` holds the two equal).

Only what the device path needs: the decoder options, picture and
macroblock types, the error classes that a device status maps to, the
half-pel motion-vector ranges and the IDCT's block classes.
"""

from __future__ import annotations

import enum


class H263Error(Exception):
    """Base class for all decode errors."""


class InvalidMacroblockHeader(H263Error):
    pass


class InvalidMacroblockCodedBits(H263Error):
    pass


class InvalidIntraDc(H263Error):
    pass


class InvalidShortCoefficient(H263Error):
    pass


class InvalidLongCoefficient(H263Error):
    pass


class InvalidMvd(H263Error):
    pass


class InvalidBitstream(H263Error):
    pass


class PictureFormatInvalid(H263Error):
    pass


class BitstreamExhausted(H263Error):
    """Ran out of bits (the reference's UnexpectedEof; ends the picture)."""


class UnimplementedDecoding(H263Error):
    pass


class DecoderOption(enum.IntFlag):
    NONE = 0
    SORENSON_SPARK_BITSTREAM = 1
    USE_SCALABILITY_MODE = 2


class PictureTypeCode(enum.Enum):
    I_FRAME = "I"
    P_FRAME = "P"
    PB_FRAME = "PB"
    IMPROVED_PB_FRAME = "IPB"
    B_FRAME = "B"
    EI_FRAME = "EI"
    EP_FRAME = "EP"
    RESERVED = "RES"
    # Sorenson-only.
    DISPOSABLE_P_FRAME = "DP"


class MacroblockType(enum.IntEnum):
    INTER = 0
    INTER_Q = 1
    INTER_4V = 2
    INTRA = 3
    INTRA_Q = 4
    INTER_4V_Q = 5


HALFPEL_STANDARD_RANGE = 32
HALFPEL_EXTENDED_RANGE = 64
HALFPEL_EXTENDED_RANGE_QUADCIF = 128
HALFPEL_EXTENDED_RANGE_SIXTEENCIF = 256
HALFPEL_EXTENDED_RANGE_BEYONDCIF = 512

BLOCK_CLASS_ZERO = 0
BLOCK_CLASS_DC = 1
BLOCK_CLASS_VERT = 2
BLOCK_CLASS_FULL = 3  # covers the reference's Horiz and Full paths
