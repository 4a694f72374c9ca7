"""Minimal H.263 / Sorenson Spark bitstream assembler.

A copy of `h263_tpu/testing/encoder.py`: builds syntactically valid
pictures symbol by symbol from the spec VLC tables, Sorenson pictures and
standard ones (plain PTYPE for the CIF family, PLUSPTYPE + OPPTYPE + CPFMT
for custom sizes).  The decoders encode their skip frames with it;
`chip_smoke.py` and the tests build their corpora with it.
`tests/test_torch_tables.py` holds its bytes equal to the JAX package's
encoder.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..types import MacroblockType, PictureTypeCode
from ..vlc_tables import (
    CBPY_CODES,
    MCBPC_I_CODES,
    MCBPC_P_CODES,
    MVD_CODES,
    TCOEF_CODES,
    VLC_ESCAPE,
    VLC_INVALID,
    VLC_STUFFING,
    build_encode_map,
)

_MCBPC_I_MAP = build_encode_map(MCBPC_I_CODES)
_MCBPC_P_MAP = build_encode_map(MCBPC_P_CODES)
_CBPY_MAP = build_encode_map(CBPY_CODES)
_MVD_MAP = {v: c for c, v in MVD_CODES if v != VLC_INVALID}
_TCOEF_MAP = {v: c for c, v in TCOEF_CODES
              if v not in (VLC_INVALID, VLC_ESCAPE)}
_ESCAPE_CODE = next(c for c, v in TCOEF_CODES if v == VLC_ESCAPE)
_DQUANT_BITS = {-1: 0b00, -2: 0b01, 1: 0b10, 2: 0b11}


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def write_bits(self, value: int, n: int) -> "BitWriter":
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)
        return self

    def write_code(self, code: str) -> "BitWriter":
        for ch in code:
            self._bits.append(1 if ch == "1" else 0)
        return self

    def __len__(self):
        return len(self._bits)

    def to_bytes(self, pad_bit: int = 0) -> bytes:
        """Pad to a byte boundary.  Zero padding is safe: at most 7 zeros
        cannot complete any macroblock symbol, so the decoder's EOF handling
        cleanly ends the picture."""
        bits = self._bits[:]
        while len(bits) % 8:
            bits.append(pad_bit)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


@dataclass
class MBSpec:
    """One macroblock's symbols.

    kind: 'intra' | 'inter' | 'uncoded' | 'stuffing'
    intradc: 6 DC reconstruction levels (multiples of 8 in [8,2032] or 1024),
             required for intra MBs.
    blocks: 6 lists of (run, level) TCOEF events (luma0..3, cb, cr).
    mvd: the raw MVD symbol(s) in half-pel units — one (x, y) pair, or four
         for an INTER4V macroblock.  These are *differences*, pre-prediction.
    """

    kind: str = "intra"
    dquant: int = 0
    mvd: Optional[Sequence] = None
    intradc: Optional[Sequence[int]] = None
    blocks: Sequence[Sequence[tuple[int, int]]] = field(
        default_factory=lambda: [[], [], [], [], [], []])


def _encode_intradc(w: BitWriter, level: int) -> None:
    if level == 1024:
        w.write_bits(0xFF, 8)
        return
    assert level % 8 == 0 and 8 <= level <= 2032 and level != 1024, level
    w.write_bits(level >> 3, 8)


def _encode_tcoef_events(w: BitWriter, events: Sequence[tuple[int, int]],
                         sorenson_version: Optional[int]) -> None:
    """Emit TCOEF events; the final event carries the LAST flag."""
    n = len(events)
    for i, (run, level) in enumerate(events):
        assert level != 0
        last = 1 if i == n - 1 else 0
        mag = abs(level)
        key = (last, run, mag)
        if key in _TCOEF_MAP:
            w.write_code(_TCOEF_MAP[key])
            w.write_bits(0 if level > 0 else 1, 1)
        else:
            w.write_code(_ESCAPE_CODE)
            if sorenson_version == 1:
                width = 7 if -64 <= level <= 63 else 11
                w.write_bits(1 if width == 11 else 0, 1)
            else:
                width = 8
                assert -128 <= level <= 127, "8-bit escape range"
            w.write_bits(last, 1)
            w.write_bits(run, 6)
            w.write_bits(level & ((1 << width) - 1), width)


def _encode_mvd_component(w: BitWriter, hp: int) -> None:
    assert hp in _MVD_MAP, f"MVD halfpel {hp} not directly codable"
    w.write_code(_MVD_MAP[hp])


def _encode_umv_component(w: BitWriter, hp: int) -> None:
    """UMV fixed code, table D.3 (reader.rs:298-324 inverse).

    0 -> "1"; else "0", then one (mantissa-bit, 1) pair per mantissa bit
    MSB-first, then the (sign-bit, 0) terminator — magnitude = 2^k +
    mantissa, k = number of continuation pairs, valid 1..4095."""
    if hp == 0:
        w.write_bits(1, 1)
        return
    m = abs(hp)
    assert 1 <= m <= 4095, f"UMV halfpel {hp} out of table D.3 range"
    w.write_bits(0, 1)
    k = m.bit_length() - 1
    mantissa = m - (1 << k)
    for i in range(k - 1, -1, -1):
        w.write_bits((mantissa >> i) & 1, 1)
        w.write_bits(1, 1)
    w.write_bits(1 if hp < 0 else 0, 1)
    w.write_bits(0, 1)


def encode_macroblock(w: BitWriter, mb: MBSpec, picture_type: PictureTypeCode,
                      sorenson_version: Optional[int],
                      umv_d3: bool = False) -> None:
    """umv_d3: emit MVD components in the UMV fixed code (table D.3)
    instead of the MVD VLC — the coding used when the picture has
    PLUSPTYPE and UNRESTRICTED_MOTION_VECTORS is active."""
    is_iframe = picture_type is PictureTypeCode.I_FRAME
    if mb.kind == "uncoded":
        assert not is_iframe
        w.write_bits(1, 1)  # COD
        return
    if mb.kind == "stuffing":
        if not is_iframe:
            w.write_bits(0, 1)
        w.write_code(_MCBPC_I_MAP[VLC_STUFFING] if is_iframe
                     else _MCBPC_P_MAP[VLC_STUFFING])
        return

    if not is_iframe:
        w.write_bits(0, 1)  # COD = coded

    intra = mb.kind == "intra"
    fourv = mb.mvd is not None and len(mb.mvd) == 4 and not intra
    has_q = mb.dquant != 0
    if intra:
        mb_type = MacroblockType.INTRA_Q if has_q else MacroblockType.INTRA
    elif fourv:
        mb_type = MacroblockType.INTER_4V_Q if has_q else MacroblockType.INTER_4V
    else:
        mb_type = MacroblockType.INTER_Q if has_q else MacroblockType.INTER

    coded = [bool(ev) for ev in mb.blocks]
    cb, cr = coded[4], coded[5]
    mcbpc_map = _MCBPC_I_MAP if is_iframe else _MCBPC_P_MAP
    w.write_code(mcbpc_map[(mb_type, cb, cr)])

    # CBPY: the table codes the INTRA pattern; INTER emits the complement.
    luma = tuple(coded[:4])
    pattern = luma if intra else tuple(not v for v in luma)
    w.write_code(_CBPY_MAP[pattern])

    if has_q:
        w.write_bits(_DQUANT_BITS[mb.dquant], 2)

    if not intra:
        mvds = mb.mvd if mb.mvd is not None else [(0, 0)]
        if not fourv:
            mvds = mvds[:1]
        for mx, my in mvds:
            enc = _encode_umv_component if umv_d3 else _encode_mvd_component
            enc(w, mx)
            enc(w, my)

    for k in range(6):
        if intra:
            _encode_intradc(w, mb.intradc[k])
        if coded[k]:
            _encode_tcoef_events(w, mb.blocks[k], sorenson_version)


_SORENSON_STD_FORMATS = {
    (352, 288): 2,
    (176, 144): 3,
    (128, 96): 4,
    (320, 240): 5,
    (160, 120): 6,
}


def encode_sorenson_picture(width: int, height: int, picture_type: PictureTypeCode,
                            macroblocks: Sequence[MBSpec], quantizer: int = 8,
                            temporal_reference: int = 0, version: int = 1,
                            deblocker: bool = False, extra: bytes = b"",
                            force_custom_dims: bool = False,
                            pad_bit: int = 0) -> bytes:
    """Assemble one complete Sorenson Spark picture (picture.rs:628-659).

    pad_bit: byte-alignment filler.  0 (default) is safe for I/P frames
    (an incomplete trailing symbol EOFs the picture); DisposableP frames
    need pad_bit=1 — their padding then reads as excess UNCODED
    macroblocks, since ANY coded MB (even stuffing) in a DisposableP hits
    the reference's UnimplementedDecoding quirk (macroblock.rs:461-464).
    """
    w = BitWriter()
    w.write_bits(1, 17)                 # start code
    w.write_bits(version, 5)
    w.write_bits(temporal_reference & 0xFF, 8)

    key = (width, height)
    if not force_custom_dims and key in _SORENSON_STD_FORMATS:
        w.write_bits(_SORENSON_STD_FORMATS[key], 3)
    elif width < 256 and height < 256 and not force_custom_dims:
        w.write_bits(0, 3)
        w.write_bits(width, 8)
        w.write_bits(height, 8)
    else:
        w.write_bits(1, 3)
        w.write_bits(width, 16)
        w.write_bits(height, 16)

    ptype_bits = {
        PictureTypeCode.I_FRAME: 0,
        PictureTypeCode.P_FRAME: 1,
        PictureTypeCode.DISPOSABLE_P_FRAME: 2,
    }[picture_type]
    w.write_bits(ptype_bits, 2)
    w.write_bits(1 if deblocker else 0, 1)
    w.write_bits(quantizer, 5)
    for b in extra:
        w.write_bits(1, 1)
        w.write_bits(b, 8)
    w.write_bits(0, 1)                  # end PEI

    for mb in macroblocks:
        encode_macroblock(w, mb, picture_type, version)

    return w.to_bytes(pad_bit)


_STANDARD_FORMAT_BITS = {
    (128, 96): 1,
    (176, 144): 2,
    (352, 288): 3,
    (704, 576): 4,
    (1408, 1152): 5,
}


def encode_standard_picture(width: int, height: int, picture_type: PictureTypeCode,
                            macroblocks: Sequence[MBSpec], quantizer: int = 8,
                            temporal_reference: int = 0,
                            umv: bool = False) -> bytes:
    """Assemble a standard (non-Sorenson) H.263 picture.

    CIF-family dimensions get a plain PTYPE header; any other (multiple-
    of-4) dimensions get a self-contained PLUSPTYPE + OPPTYPE + CPFMT
    header (custom picture format) — needed e.g. for skip frames in
    custom-format serving buckets.

    Parity note: the reference maps PTYPE bit 9 SET to an I-frame
    (picture.rs:57-61), so this encoder emits the same convention.
    """
    fmt_bits = _STANDARD_FORMAT_BITS.get((width, height))
    w = BitWriter()
    w.write_bits(1, 17)                   # PSC
    w.write_bits(0, 5)                    # GN=0
    w.write_bits(temporal_reference & 0xFF, 8)
    w.write_code("10")                    # PTYPE prefix
    w.write_code("000")                   # split/doc/freeze off
    if fmt_bits is not None:
        w.write_bits(fmt_bits, 3)
        w.write_bits(1 if picture_type is PictureTypeCode.I_FRAME else 0, 1)
        w.write_bits(1 if umv else 0, 1)  # UMV (Annex D)
        w.write_bits(0, 1)                # SAC off
        w.write_bits(0, 1)                # AP off
        w.write_bits(0, 1)                # not PB
        w.write_bits(quantizer, 5)
        w.write_bits(0, 1)                # CPM off
        w.write_bits(0, 1)                # PEI end
    else:
        if width % 4 or height % 4 or not (
                4 <= width <= 2044 and 4 <= height <= 1020):
            raise ValueError(
                f"custom standard format needs multiple-of-4 dims within "
                f"CPFMT range, got {width}x{height}")
        w.write_code("111")               # source format 7 => PLUSPTYPE
        w.write_code("001")               # UFEP: OPPTYPE present
        w.write_code("110")               # OPPTYPE fmt = custom (CPFMT)
        w.write_bits(0, 1)                # custom PCF off
        w.write_bits(1 if umv else 0, 1)  # UMV
        w.write_bits(0, 9)                # other OPPTYPE options off
        w.write_code("1000")              # mandatory tail
        w.write_code("000" if picture_type is PictureTypeCode.I_FRAME
                     else "001")          # MPPTYPE picture type
        w.write_code("000")               # rprp/rru/rounding off
        w.write_code("001")               # mandatory tail
        w.write_bits(0, 1)                # CPM off
        # CPFMT: PAR=0001 (square), PWI, '1', PHI
        w.write_bits(0b0001, 4)
        w.write_bits(width // 4 - 1, 9)
        w.write_bits(1, 1)
        w.write_bits(height // 4, 9)
        if umv:
            w.write_bits(1, 1)            # UUI: '1' => extended range
        w.write_bits(quantizer, 5)
        w.write_bits(0, 1)                # PEI end

    for mb in macroblocks:
        encode_macroblock(w, mb, picture_type, None)
    return w.to_bytes()
