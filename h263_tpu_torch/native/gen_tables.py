"""Generate C++ VLC lookup tables from the Python table definitions.

The port's copy of `h263_tpu/native/gen_tables.py`: it reads the port's
`h263_tpu_torch/vlc_tables.py` and writes the same `tables.h`, byte for
byte (`tests/test_torch_native_entropy.py`).  Emits flat 2^maxlen prefix
LUTs — the same decode strategy as the Python reader, so the two
front-ends are symbol-for-symbol identical.

    python3 -m h263_tpu_torch.native.gen_tables    # rewrites native/tables.h
"""

from __future__ import annotations

import os

from ..vlc_tables import (
    CBPY,
    MCBPC_I,
    MCBPC_P,
    MVD,
    TCOEF,
    VLC_ESCAPE,
    VLC_INVALID,
    VLC_STUFFING,
)

HEADER = """\
// AUTO-GENERATED by gen_tables.py — do not edit.
// Flat prefix LUTs: entry = (payload << 8) | code_length.
// A code_length of 0 never occurs (tables are complete prefix codes).
#pragma once
#include <cstdint>

"""


def _emit(name: str, lut, encode) -> str:
    entries = []
    for value, length in lut.table:
        payload = encode(value)
        entries.append((payload << 8) | length)
    lines = [f"static const uint32_t {name}[{len(entries)}] = {{"]
    for i in range(0, len(entries), 8):
        lines.append("  " + ", ".join(f"0x{e:08x}" for e in entries[i : i + 8]) + ",")
    lines.append("};")
    lines.append(f"static const int {name}_BITS = {lut.maxlen};")
    return "\n".join(lines) + "\n\n"


def _encode_mcbpc(v) -> int:
    # payload: kind(2) | mb_type(3) | cb(1) | cr(1)  => bits [6:5]=kind etc.
    if v == VLC_STUFFING:
        return 1 << 5
    if v == VLC_INVALID:
        return 2 << 5
    mb_type, cb, cr = v
    return (0 << 5) | (int(mb_type) << 2) | (int(cb) << 1) | int(cr)


def _encode_cbpy(v) -> int:
    # payload: invalid(1) | pattern(4)
    if v == VLC_INVALID:
        return 1 << 4
    return (int(v[0]) << 3) | (int(v[1]) << 2) | (int(v[2]) << 1) | int(v[3])


def _encode_mvd(v) -> int:
    # payload: invalid(1) | halfpel+64 (7 bits, range -32..31)
    if v == VLC_INVALID:
        return 1 << 7
    return v + 64


def _encode_tcoef(v) -> int:
    # payload: kind(2) | last(1) | run(6) | level(5)   kind 0=run,1=escape,2=invalid
    if v == VLC_ESCAPE:
        return 1 << 12
    if v == VLC_INVALID:
        return 2 << 12
    last, run, level = v
    return (0 << 12) | (last << 11) | (run << 5) | level


def main(out_path: str) -> None:
    parts = [HEADER]
    parts.append(_emit("MCBPC_I_LUT", MCBPC_I, _encode_mcbpc))
    parts.append(_emit("MCBPC_P_LUT", MCBPC_P, _encode_mcbpc))
    parts.append(_emit("CBPY_LUT", CBPY, _encode_cbpy))
    parts.append(_emit("MVD_LUT", MVD, _encode_mvd))
    parts.append(_emit("TCOEF_LUT", TCOEF, _encode_tcoef))

    # Zigzag: scan position -> row-major index.
    from ..vlc_tables import ZIGZAG_TO_ROWMAJOR

    parts.append("static const uint8_t ZIGZAG_RM[64] = {\n  "
                 + ", ".join(str(i) for i in ZIGZAG_TO_ROWMAJOR) + "\n};\n")

    with open(out_path, "w") as f:
        f.write("".join(parts))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tables.h"))
