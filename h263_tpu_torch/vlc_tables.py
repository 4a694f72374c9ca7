"""H.263 (01/2005) variable-length-code tables: a copy of
`h263_tpu/vlc_tables.py`, so that the port imports nothing of the JAX package
(`tests/test_torch_tables.py` holds every list equal to the JAX package's).

Each table is written as an explicit list of (bit-string, decoded value)
pairs taken from the spec (Tables 7-9, 13-14, 16/H.263), then compiled into a
flat 2^maxlen prefix lookup table so the reader can decode any symbol with a
single peek.  The host parsers (`bitio.py`, `parser/`) read the compiled
tables, `native/gen_tables.py` writes them into `native/tables.h`, and the
packed device tables (`parser/tables.py`) and the test encoder
(`testing/encoder.py`) are built from the code lists.

The compiler verifies each table is a *complete* prefix code (every bit
pattern resolves, no overlaps), which structurally guards against
transcription errors.
"""

from __future__ import annotations

from .types import MacroblockType

# Sentinels -----------------------------------------------------------------

VLC_INVALID = "invalid"
VLC_STUFFING = "stuffing"
VLC_ESCAPE = "escape"


class PrefixLut:
    """A complete prefix-code lookup table.

    table[word] = (value, code_length) where word is the next `maxlen` bits
    of the stream (zero-padded at EOF).
    """

    __slots__ = ("maxlen", "table", "codes")

    def __init__(self, codes: list[tuple[str, object]]):
        self.codes = codes
        maxlen = max(len(c) for c, _ in codes)
        self.maxlen = maxlen
        size = 1 << maxlen
        table: list = [None] * size
        for code, value in codes:
            n = len(code)
            start = int(code, 2) << (maxlen - n)
            entry = (value, n)
            for i in range(start, start + (1 << (maxlen - n))):
                if table[i] is not None:
                    raise ValueError(f"overlapping code {code}")
                table[i] = entry
        if any(e is None for e in table):
            missing = next(i for i, e in enumerate(table) if e is None)
            raise ValueError(
                f"incomplete prefix code: pattern {missing:0{maxlen}b} unassigned"
            )
        self.table = table


# ---------------------------------------------------------------------------
# MCBPC for I-pictures — Table 8/H.263 part 1 (macroblock types 3 & 4).
# Value: (MacroblockType, codes_chroma_b, codes_chroma_r) or a sentinel.
# ---------------------------------------------------------------------------

_I = MacroblockType.INTRA
_IQ = MacroblockType.INTRA_Q

MCBPC_I_CODES = [
    ("1", (_I, False, False)),
    ("001", (_I, False, True)),
    ("010", (_I, True, False)),
    ("011", (_I, True, True)),
    ("0001", (_IQ, False, False)),
    ("000001", (_IQ, False, True)),
    ("000010", (_IQ, True, False)),
    ("000011", (_IQ, True, True)),
    ("000000001", VLC_STUFFING),
    # Long zero runs are forbidden (they collide with start codes).
    ("0000001", VLC_INVALID),
    ("00000001", VLC_INVALID),
    ("000000000", VLC_INVALID),
]

# ---------------------------------------------------------------------------
# MCBPC for P-pictures — Table 8/H.263 part 2 (all macroblock types).
# ---------------------------------------------------------------------------

_P = MacroblockType.INTER
_PQ = MacroblockType.INTER_Q
_P4 = MacroblockType.INTER_4V
_P4Q = MacroblockType.INTER_4V_Q

MCBPC_P_CODES = [
    ("1", (_P, False, False)),
    ("0011", (_P, False, True)),
    ("0010", (_P, True, False)),
    ("000101", (_P, True, True)),
    ("011", (_PQ, False, False)),
    ("0000111", (_PQ, False, True)),
    ("0000110", (_PQ, True, False)),
    ("000000101", (_PQ, True, True)),
    ("010", (_P4, False, False)),
    ("0000101", (_P4, False, True)),
    ("0000100", (_P4, True, False)),
    ("00000101", (_P4, True, True)),
    ("00011", (_I, False, False)),
    ("00000100", (_I, False, True)),
    ("00000011", (_I, True, False)),
    ("0000011", (_I, True, True)),
    ("000100", (_IQ, False, False)),
    ("000000100", (_IQ, False, True)),
    ("000000011", (_IQ, True, False)),
    ("000000010", (_IQ, True, True)),
    ("000000001", VLC_STUFFING),
    # Annex-T extension rows (INTER4V+Q); present in the standard table.
    ("00000000010", (_P4Q, False, False)),
    ("0000000001100", (_P4Q, False, True)),
    ("0000000001110", (_P4Q, True, False)),
    ("0000000001111", (_P4Q, True, True)),
    ("0000000000", VLC_INVALID),
    ("0000000001101", VLC_INVALID),
]

# ---------------------------------------------------------------------------
# MODB — Table 11/H.263 (PB-frames mode).
# Value: (has_cbpb, has_mvdb)
# ---------------------------------------------------------------------------

MODB_CODES = [
    ("0", (False, False)),
    ("10", (False, True)),
    ("11", (True, True)),
]

# ---------------------------------------------------------------------------
# CBPY — Table 13/H.263.  Value is the INTRA luma pattern (blocks 0..3);
# INTER patterns are the bitwise complement (handled by the caller).
# ---------------------------------------------------------------------------

CBPY_CODES = [
    ("0011", (False, False, False, False)),
    ("00101", (False, False, False, True)),
    ("00100", (False, False, True, False)),
    ("1001", (False, False, True, True)),
    ("00011", (False, True, False, False)),
    ("0111", (False, True, False, True)),
    ("000010", (False, True, True, False)),
    ("1011", (False, True, True, True)),
    ("00010", (True, False, False, False)),
    ("000011", (True, False, False, True)),
    ("0101", (True, False, True, False)),
    ("1010", (True, False, True, True)),
    ("0100", (True, True, False, False)),
    ("1000", (True, True, False, True)),
    ("0110", (True, True, True, False)),
    ("11", (True, True, True, True)),
    ("00000", VLC_INVALID),
]

# ---------------------------------------------------------------------------
# MVD — Table 14/H.263.  Value is the *half-pel* integer (vector * 2), read
# from the "Vector" column; the "Differences" interpretation is applied later
# by the range-wrapping logic (see decoder mv math).
# ---------------------------------------------------------------------------


def _mvd_codes() -> list[tuple[str, object]]:
    codes: list[tuple[str, object]] = [("1", 0)]
    # (positive-code, halfpel-magnitude); the negative code is positive+1.
    pos = [
        ("010", 1), ("0010", 2), ("00010", 3),
        ("0000110", 4), ("00001010", 5), ("00001000", 6), ("00000110", 7),
        ("0000010110", 8), ("0000010100", 9), ("0000010010", 10),
        ("00000100010", 11), ("00000100000", 12), ("00000011110", 13),
        ("00000011100", 14), ("00000011010", 15), ("00000011000", 16),
        ("00000010110", 17), ("00000010100", 18), ("00000010010", 19),
        ("00000010000", 20), ("00000001110", 21), ("00000001100", 22),
        ("00000001010", 23), ("00000001000", 24), ("000000001110", 25),
        ("000000001100", 26), ("000000001010", 27), ("000000001000", 28),
        ("000000000110", 29), ("000000000100", 30), ("0000000000110", 31),
    ]
    for code, mag in pos:
        codes.append((code, mag))
        neg = code[:-1] + "1"
        codes.append((neg, -mag))
    codes.append(("0000000000101", -32))
    codes.append(("00000000000", VLC_INVALID))
    codes.append(("0000000000100", VLC_INVALID))
    return codes


MVD_CODES = _mvd_codes()

# ---------------------------------------------------------------------------
# TCOEF — Table 16/H.263.  Value: (last, run, level-magnitude); the sign bit
# follows the code in the stream.  ESCAPE selects the fixed-length form.
# ---------------------------------------------------------------------------

TCOEF_CODES: list[tuple[str, object]] = [
    ("10", (0, 0, 1)),
    ("110", (0, 1, 1)),
    ("1110", (0, 2, 1)),
    ("1111", (0, 0, 2)),
    ("0111", (1, 0, 1)),
    ("01100", (0, 4, 1)),
    ("01101", (0, 3, 1)),
    ("01011", (0, 5, 1)),
    ("010000", (0, 9, 1)),
    ("010001", (0, 8, 1)),
    ("010010", (0, 7, 1)),
    ("010011", (0, 6, 1)),
    ("010100", (0, 1, 2)),
    ("010101", (0, 0, 3)),
    ("001100", (1, 4, 1)),
    ("001101", (1, 3, 1)),
    ("001110", (1, 2, 1)),
    ("001111", (1, 1, 1)),
    ("0010000", (1, 8, 1)),
    ("0010001", (1, 7, 1)),
    ("0010010", (1, 6, 1)),
    ("0010011", (1, 5, 1)),
    ("0010100", (0, 12, 1)),
    ("0010101", (0, 11, 1)),
    ("0010110", (0, 10, 1)),
    ("0010111", (0, 0, 4)),
    ("00011000", (1, 11, 1)),
    ("00011001", (1, 10, 1)),
    ("00011010", (1, 9, 1)),
    ("00011011", (0, 14, 1)),
    ("00011100", (0, 13, 1)),
    ("00011101", (0, 2, 2)),
    ("00011110", (0, 1, 3)),
    ("00011111", (0, 0, 5)),
    ("00010100", (1, 15, 1)),
    ("00010101", (1, 14, 1)),
    ("00010110", (1, 13, 1)),
    ("00010111", (1, 12, 1)),
    ("00010011", (1, 16, 1)),
    ("000100000", (0, 16, 1)),
    ("000100001", (0, 15, 1)),
    ("000100010", (0, 4, 2)),
    ("000100011", (0, 3, 2)),
    ("000100100", (0, 0, 7)),
    ("000100101", (0, 0, 6)),
    ("0000100000", (0, 0, 9)),
    ("0000100001", (0, 0, 8)),
    ("000010001", (1, 24, 1)),
    ("000010010", (1, 23, 1)),
    ("000010011", (1, 22, 1)),
    ("000010100", (1, 21, 1)),
    ("000010101", (1, 20, 1)),
    ("000010110", (1, 19, 1)),
    ("000010111", (1, 18, 1)),
    ("000011000", (1, 17, 1)),
    ("000011001", (1, 0, 2)),
    ("000011010", (0, 22, 1)),
    ("000011011", (0, 21, 1)),
    ("000011100", (0, 20, 1)),
    ("000011101", (0, 19, 1)),
    ("000011110", (0, 18, 1)),
    ("000011111", (0, 17, 1)),
    ("0000011", VLC_ESCAPE),
    ("00000100000", (0, 0, 12)),
    ("00000100001", (0, 1, 5)),
    ("00000100010", (0, 23, 1)),
    ("00000100011", (0, 24, 1)),
    ("00000100100", (1, 29, 1)),
    ("00000100101", (1, 30, 1)),
    ("00000100110", (1, 31, 1)),
    ("00000100111", (1, 32, 1)),
    ("000001010000", (0, 1, 6)),
    ("000001010001", (0, 2, 4)),
    ("000001010010", (0, 4, 3)),
    ("000001010011", (0, 5, 3)),
    ("000001010100", (0, 6, 3)),
    ("000001010101", (0, 10, 2)),
    ("000001010110", (0, 25, 1)),
    ("000001010111", (0, 26, 1)),
    ("000001011000", (1, 33, 1)),
    ("000001011001", (1, 34, 1)),
    ("000001011010", (1, 35, 1)),
    ("000001011011", (1, 36, 1)),
    ("000001011100", (1, 37, 1)),
    ("000001011101", (1, 38, 1)),
    ("000001011110", (1, 39, 1)),
    ("000001011111", (1, 40, 1)),
    ("0000001000", (0, 9, 2)),
    ("0000001001", (0, 8, 2)),
    ("0000001010", (0, 7, 2)),
    ("0000001011", (0, 6, 2)),
    ("0000001100", (0, 5, 2)),
    ("0000001101", (0, 3, 3)),
    ("0000001110", (0, 2, 3)),
    ("0000001111", (0, 1, 4)),
    ("0000000100", (1, 28, 1)),
    ("0000000101", (1, 27, 1)),
    ("0000000110", (1, 26, 1)),
    ("0000000111", (1, 25, 1)),
    ("00000000100", (1, 1, 2)),
    ("00000000101", (1, 0, 3)),
    ("00000000110", (0, 0, 11)),
    ("00000000111", (0, 0, 10)),
    ("000000000", VLC_INVALID),
]

# ---------------------------------------------------------------------------
# Compiled LUTs
# ---------------------------------------------------------------------------

MCBPC_I = PrefixLut(MCBPC_I_CODES)
MCBPC_P = PrefixLut(MCBPC_P_CODES)
MODB = PrefixLut(MODB_CODES)
CBPY = PrefixLut(CBPY_CODES)
MVD = PrefixLut(MVD_CODES)
TCOEF = PrefixLut(TCOEF_CODES)


# ---------------------------------------------------------------------------
# Zigzag scan — figure 5/H.263 (cf. rle.rs:6-71).  Generated algorithmically;
# ZIGZAG_XY[i] = (x, y) of the i-th coefficient in scan order.
# ---------------------------------------------------------------------------


def _zigzag_xy() -> list[tuple[int, int]]:
    out = []
    for d in range(15):
        lo = max(0, d - 7)
        hi = min(d, 7)
        xs = range(lo, hi + 1) if d % 2 == 0 else range(hi, lo - 1, -1)
        for x in xs:
            out.append((x, d - x))
    return out


ZIGZAG_XY = _zigzag_xy()
assert ZIGZAG_XY[0] == (0, 0) and ZIGZAG_XY[1] == (1, 0) and ZIGZAG_XY[2] == (0, 1)
assert ZIGZAG_XY[5] == (2, 0) and ZIGZAG_XY[63] == (7, 7) and len(ZIGZAG_XY) == 64

#: Row-major (y*8 + x) index for each zigzag position.
ZIGZAG_TO_ROWMAJOR = [y * 8 + x for (x, y) in ZIGZAG_XY]


# ---------------------------------------------------------------------------
# Encoding helpers (used by the test-suite bitstream assembler and anywhere a
# symbol needs to be re-emitted).  code_map: value -> bit-string.
# ---------------------------------------------------------------------------


def build_encode_map(codes: list[tuple[str, object]]) -> dict:
    out = {}
    for code, value in codes:
        if value in (VLC_INVALID,):
            continue
        key = value if not isinstance(value, tuple) else tuple(value)
        if key not in out:  # keep the shortest/first code
            out[key] = code
    return out
