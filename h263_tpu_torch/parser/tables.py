"""The entropy automaton's constants and packed VLC tables.

A copy of what the automaton needs from `h263_tpu/parser/device_frontend.py`
(phases, status codes, macroblock-type and record-flag codes, `_pack_table`
and the packed `*_ARR` tables, `status_error_class`, `_dense_block_perm`)
and from `h263_tpu/parser/mvpred.py` (`_extended_range_for_dim`), with the
same names and values; `tests/test_torch_tables.py` holds them equal.

Packed entry layout (each table is a dense 2^maxlen int32 array indexed by
the next `maxlen` bits, zero-padded at EOF):
  bits 0..12   value field (table-specific)
  bits 16..20  code length in bits
  bit 24       STUFFING (MCBPC) / ESCAPE (TCOEF)
  bit 25       INVALID
"""

from __future__ import annotations

import numpy as np

from ..types import (
    HALFPEL_EXTENDED_RANGE,
    HALFPEL_EXTENDED_RANGE_BEYONDCIF,
    HALFPEL_EXTENDED_RANGE_QUADCIF,
    HALFPEL_EXTENDED_RANGE_SIXTEENCIF,
    BitstreamExhausted,
    InvalidBitstream,
    InvalidIntraDc,
    InvalidLongCoefficient,
    InvalidMacroblockCodedBits,
    InvalidMacroblockHeader,
    InvalidMvd,
    InvalidShortCoefficient,
    UnimplementedDecoding,
)
from ..vlc_tables import (
    CBPY_CODES,
    MCBPC_I_CODES,
    MCBPC_P_CODES,
    MVD_CODES,
    TCOEF_CODES,
    VLC_ESCAPE,
    VLC_INVALID,
    VLC_STUFFING,
)

# Phases of the per-lane automaton.
PH_HEADER = 0   # COD + MCBPC + CBPY + DQUANT
PH_MVD = 1      # one MVD pair per step (1 or 4 per inter MB)
PH_DC = 2       # INTRADC byte
PH_COEF = 3     # one TCOEF event per step
PH_DONE = 4     # EOF at a macroblock boundary: success (tail-fill applies)
PH_ERR = 5      # bitstream error: whole frame fails (identity frame)

# Status codes (0 = ok).
ST_OK = 0
ST_EOF_IN_BLOCK = 1        # BitstreamExhausted inside block layer
ST_BAD_MCBPC = 2           # InvalidMacroblockHeader
ST_BAD_CBPY = 3            # InvalidMacroblockCodedBits
ST_BAD_MVD = 4             # InvalidMvd
ST_BAD_INTRADC = 5         # InvalidIntraDc
ST_BAD_TCOEF = 6           # InvalidShortCoefficient
ST_BAD_ESCAPE = 7          # InvalidLongCoefficient (level == 0)
ST_BEYOND_NMB = 8          # coded content past the MB count (InvalidBitstream)
ST_UNIMPLEMENTED = 9       # coded MB in a non-I/P picture
ST_TAPE_OVERFLOW = 10      # step bound reached (never by legal or corrupt
                           # streams: see device_frontend.lane_step_bound)


def status_error_class(status: int):
    """The host error class of a device status code (None for OK and
    overflow)."""
    return {
        ST_EOF_IN_BLOCK: BitstreamExhausted,
        ST_BAD_MCBPC: InvalidMacroblockHeader,
        ST_BAD_CBPY: InvalidMacroblockCodedBits,
        ST_BAD_MVD: InvalidMvd,
        ST_BAD_INTRADC: InvalidIntraDc,
        ST_BAD_TCOEF: InvalidShortCoefficient,
        ST_BAD_ESCAPE: InvalidLongCoefficient,
        ST_BEYOND_NMB: InvalidBitstream,
        ST_UNIMPLEMENTED: UnimplementedDecoding,
    }.get(int(status))


# Macroblock types, numerically identical to types.MacroblockType.
_MT_INTER, _MT_INTER_Q, _MT_INTER_4V, _MT_INTRA, _MT_INTRA_Q, _MT_INTER_4V_Q = range(6)

# MB-record flag bits.
_FLG_PRESENT = 1
_FLG_INTER = 1 << 1
_FLG_4V = 1 << 2

_F_MARK = 1 << 24
_F_INVALID = 1 << 25


def _pack_table(codes, maxlen, value_fn):
    size = 1 << maxlen
    out = np.zeros(size, dtype=np.int32)
    seen = np.zeros(size, dtype=bool)
    for code, value in codes:
        n = len(code)
        entry = n << 16
        if value == VLC_INVALID:
            entry |= _F_INVALID
        elif value in (VLC_STUFFING, VLC_ESCAPE):
            entry |= _F_MARK
        else:
            entry |= value_fn(value)
        start = int(code, 2) << (maxlen - n)
        span = 1 << (maxlen - n)
        if seen[start:start + span].any():
            raise ValueError(f"overlapping code {code}")
        out[start:start + span] = entry
        seen[start:start + span] = True
    if not seen.all():
        raise ValueError("incomplete prefix code")
    return out


def _mcbpc_value(v):
    mb_type, cb, cr = v
    return int(mb_type) | (int(cb) << 3) | (int(cr) << 4)


def _cbpy_value(v):
    return sum(int(b) << k for k, b in enumerate(v))


def _mvd_value(v):
    return int(v) & 0xFF  # int8 two's complement (half-pel, -32..31)


def _tcoef_value(v):
    last, run, mag = v
    return int(mag) | (int(run) << 5) | (int(last) << 11)


MCBPC_I_LEN = 9
MCBPC_P_LEN = 13
CBPY_LEN = 6
MVD_LEN = 13
TCOEF_LEN = 13

MCBPC_I_ARR = _pack_table(MCBPC_I_CODES, MCBPC_I_LEN, _mcbpc_value)
MCBPC_P_ARR = _pack_table(MCBPC_P_CODES, MCBPC_P_LEN, _mcbpc_value)
CBPY_ARR = _pack_table(CBPY_CODES, CBPY_LEN, _cbpy_value)
MVD_ARR = _pack_table(MVD_CODES, MVD_LEN, _mvd_value)
TCOEF_ARR = _pack_table(TCOEF_CODES, TCOEF_LEN, _tcoef_value)


def _dense_block_perm(mbh: int, mbw: int):
    """inv_perm[dense_blk] = mb*6 + b: the discard-flag space in the dense
    layout (luma 2mbh x 2mbw grid row-major, then Cb, then Cr)."""
    nmb = mbh * mbw
    inv = np.empty(6 * nmb, dtype=np.int32)
    for mb in range(nmb):
        r, c = divmod(mb, mbw)
        for b in range(4):
            dense = (2 * r + (b >> 1)) * (2 * mbw) + 2 * c + (b & 1)
            inv[dense] = mb * 6 + b
        inv[4 * nmb + mb] = mb * 6 + 4
        inv[5 * nmb + mb] = mb * 6 + 5
    return inv


def _extended_range_for_dim(dim: int, is_x: bool) -> int:
    """H.263 D.1/D.2 extended-UMV ranges keyed to picture size; the gaps
    between the spec's bands fall back to the base extended range."""
    if is_x:
        if 0 <= dim <= 352:
            return HALFPEL_EXTENDED_RANGE
        if 356 <= dim <= 704:
            return HALFPEL_EXTENDED_RANGE_QUADCIF
        if 708 <= dim <= 1408:
            return HALFPEL_EXTENDED_RANGE_SIXTEENCIF
        if dim >= 1412:
            return HALFPEL_EXTENDED_RANGE_BEYONDCIF
        return HALFPEL_EXTENDED_RANGE
    if 0 <= dim <= 288:
        return HALFPEL_EXTENDED_RANGE
    if 292 <= dim <= 576:
        return HALFPEL_EXTENDED_RANGE_QUADCIF
    if dim >= 580:
        return HALFPEL_EXTENDED_RANGE_SIXTEENCIF
    return HALFPEL_EXTENDED_RANGE
