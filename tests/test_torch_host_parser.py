"""The port's host parsers (`h263_tpu_torch/bitio.py`, `parser/picture.py`,
`parser/mvpred.py`, `parser/block.py`, `parser/macroblock.py`,
`parser/frame.py`) against the JAX package's, which they copy.

Inputs: random bytes through one script of reader calls; the encoder's
Sorenson and standard picture headers and PLUSPTYPE headers (the recipe of
tests/test_plusptype.py), with and without a previous picture; the CIF
fixture FLV's frames; and seeded frames of `h263_tpu.testing.fuzz`'s
generators (flavors "sorenson", "standard" and the "fused" GOPs), with
their mutants.  Equal `Picture` fields, reader positions, `FrameData`
arrays and error classes.  The port's native `parse_frame_auto` is held to
the same arrays and error classes (the native parse may stop at another
bit after the last macroblock, as in the JAX package's own fuzz claim).
"""

import dataclasses
import enum
import pathlib

import numpy as np
import pytest

from h263_tpu import bitio as jbitio
from h263_tpu import vlc_tables as jvlc
from h263_tpu.parser import frame as jframe
from h263_tpu.parser import picture as jpicture
from h263_tpu.testing.encoder import BitWriter
from h263_tpu.testing.fuzz import _mutate, _rand_frame, _rand_fused_gop
from h263_tpu.types import DecoderOption as JOption
from h263_tpu.types import PictureOption as JPictureOption
from h263_tpu_torch import bitio as tbitio
from h263_tpu_torch import vlc_tables as tvlc
from h263_tpu_torch.parser import frame as tframe
from h263_tpu_torch.parser import picture as tpicture
from h263_tpu_torch.testing.corpora import fixture_frames
from h263_tpu_torch.types import DecoderOption, PictureOption

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"
SOR = DecoderOption.SORENSON_SPARK_BITSTREAM
_LUTS = ("MCBPC_I", "MCBPC_P", "MODB", "CBPY", "MVD", "TCOEF")
_FRAME_FIELDS = ("coeffs_y", "class_y", "coeffs_cb", "class_cb", "coeffs_cr",
                 "class_cr", "mvs", "inter")


def _plain(v):
    """A value of either package with its enums, dataclasses and tuples
    made plain, so that the two packages' objects compare."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, {f.name: _plain(getattr(v, f.name))
                                   for f in dataclasses.fields(v)})
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


def _try(fn):
    """fn()'s result, or the class name of what it raised."""
    try:
        return fn()
    except Exception as e:                           # noqa: BLE001
        return type(e).__name__


def _opts(o, j):
    return JOption(int(o)) if j else o


def _run(o, j):
    return JPictureOption(int(o)) if j else o


# -- bitio ---------------------------------------------------------------------

def _reader_script(r, lut_mod, ops):
    """Apply a script of reader calls; record each result or error."""
    log = []
    for op, arg in ops:
        try:
            if op == "vlc":
                got = r.read_vlc(getattr(lut_mod, arg))
            elif op == "start":
                got = r.recognize_start_code(arg)
            elif op in ("read_u8", "realignment_bits", "read_umv",
                        "remaining"):
                got = getattr(r, op)()
            elif op == "rollback":
                got = r.rollback(arg)
            else:
                got = getattr(r, op)(arg)
        except Exception as e:                       # noqa: BLE001
            got = type(e).__name__
        log.append((op, _plain(got), r.pos))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_bit_reader_matches_jax(seed):
    rng = np.random.default_rng(seed)
    data = bytes(rng.integers(0, 256, int(rng.integers(4, 60)),
                              dtype=np.uint8))
    if seed % 2:
        data = data[:3] + b"\x00\x00\x80" + data[3:]     # a start code
    ops = []
    for _ in range(120):
        k = int(rng.integers(0, 11))
        if k < 3:
            ops.append((("read_bits", "peek_bits", "skip_bits")[k],
                        int(rng.integers(0, 33))))
        elif k == 3:
            ops.append(("read_signed_bits", int(rng.integers(1, 17))))
        elif k == 4:
            ops.append(("vlc", _LUTS[int(rng.integers(0, len(_LUTS)))]))
        elif k == 5:
            ops.append(("start", bool(rng.integers(0, 2))))
        elif k == 6:
            ops.append(("peek_bits_padded", int(rng.integers(1, 33))))
        elif k == 7:
            ops.append(("rollback", int(rng.integers(-2, 8 * len(data) + 4))))
        else:
            ops.append((("read_u8", "realignment_bits", "read_umv")[k - 8],
                        None))
    want = _reader_script(jbitio.BitReader(data), jvlc, ops)
    got = _reader_script(tbitio.BitReader(data), tvlc, ops)
    assert got == want


# -- picture headers -----------------------------------------------------------

def _plusptype(ptype_bits="000", umv=True, ufep=True, tr=5, quant=9,
               w_pix=176, h_pix=144):
    """tests/test_plusptype.py::_plusptype_header."""
    w = BitWriter()
    w.write_bits(1, 17)
    w.write_bits(0, 5)
    w.write_bits(tr, 8)
    w.write_code("10000")
    w.write_code("111")
    if ufep:
        w.write_code("001")
        w.write_code("110")
        w.write_bits(0, 1)
        w.write_bits(1 if umv else 0, 1)
        w.write_bits(0, 9)
        w.write_code("1000")
    else:
        w.write_code("000")
    w.write_code(ptype_bits)
    w.write_code("000")
    w.write_code("001")
    w.write_bits(0, 1)
    if ufep:
        w.write_bits(0b0001, 4)
        w.write_bits(w_pix // 4 - 1, 9)
        w.write_bits(1, 1)
        w.write_bits(h_pix // 4, 9)
        if umv:
            w.write_bits(1, 1)
    w.write_bits(quant, 5)
    w.write_bits(0, 1)
    return w.to_bytes()


def _header_pair(buf, opts, prev=None):
    """decode_picture of both packages (with their own previous picture
    when `prev` bytes are given): plain Picture + reader position, or the
    error class name, each."""
    def go(j, mod, bit):
        last = None
        if prev is not None:
            last = mod.decode_picture(bit.BitReader(prev), _opts(opts, j),
                                      None)
        r = bit.BitReader(buf)
        pic = mod.decode_picture(r, _opts(opts, j), last)
        return _plain(pic), r.pos

    return [_try(lambda: go(True, jpicture, jbitio)),
            _try(lambda: go(False, tpicture, tbitio))]


def _fixture_frames():
    return fixture_frames(FIX / "ffmpeg_flv1_cif.flv")


def test_picture_headers_match_jax():
    rng = np.random.default_rng(7)
    cases = []
    for k in range(20):
        f = _rand_frame(rng, 96, 80, "sorenson")
        cases += [(f, SOR, None), (f[:int(rng.integers(1, 12))], SOR, None)]
        s = _rand_frame(rng, 128, 96, "standard")
        cases += [(s, DecoderOption.NONE, None),
                  (_mutate(rng, s, lambda: s), DecoderOption.NONE, None)]
    for bits in ("000", "001", "010", "111"):
        for umv in (False, True):
            cases.append((_plusptype(bits, umv=umv), DecoderOption.NONE,
                          None))
        cases.append((_plusptype(bits, ufep=False), DecoderOption.NONE,
                      _plusptype()))
        cases.append((_plusptype(bits, ufep=False), DecoderOption.NONE,
                      None))
    fix = _fixture_frames()
    cases += [(f, SOR, None) for f in fix]
    cases += [(fix[1], SOR, fix[0]), (b"", SOR, None), (b"\xff" * 9, SOR, None)]
    kinds = set()
    for buf, opts, prev in cases:
        a, b = _header_pair(buf, opts, prev)
        assert a == b, (buf[:12].hex(), a, b)
        kinds.add(a if isinstance(a, str) else "ok")
    assert "ok" in kinds and len(kinds) >= 3


# -- whole frames --------------------------------------------------------------

def _frame_pair(buf, w, h, opts, running):
    """parse_frame (Python) of both packages and the port's native
    parse_frame_auto after each package's own header parse: (arrays, end
    bit) or the error class name, each."""
    def go(j, mod, bit, fn):
        def run():
            r = bit.BitReader(buf)
            pic = (jpicture if j else tpicture).decode_picture(
                r, _opts(opts, j), None)
            fd = getattr(mod, fn)(r, pic, _opts(opts, j), _run(running, j),
                                  w, h)
            return [np.asarray(getattr(fd, f)) for f in _FRAME_FIELDS], r.pos
        return run

    return [_try(go(True, jframe, jbitio, "parse_frame")),
            _try(go(False, tframe, tbitio, "parse_frame")),
            _try(go(False, tframe, tbitio, "parse_frame_auto"))]


def _check_frames(cases, w, h, opts, running):
    n_ok = 0
    for buf in cases:
        got = _frame_pair(buf, w, h, opts, running)
        want = got[0]
        for k, other in enumerate(got[1:]):
            if isinstance(want, str) or isinstance(other, str):
                assert other == want, (buf[:12].hex(), want, other)
                continue
            if k == 0:              # the end bit: Python parse against Python
                assert other[1] == want[1]
            for f, a, b in zip(_FRAME_FIELDS, want[0], other[0]):
                np.testing.assert_array_equal(b, a, err_msg=f)
        n_ok += not isinstance(want, str)
    return n_ok


@pytest.mark.parametrize("flavor", ["sorenson", "standard", "fused"])
def test_frames_match_jax(flavor):
    rng = np.random.default_rng({"sorenson": 1, "standard": 2,
                                 "fused": 3}[flavor])
    if flavor == "standard":
        w, h, opts = 128, 96, DecoderOption.NONE
        bases = [_rand_frame(rng, w, h, "standard") for _ in range(6)]
    elif flavor == "sorenson":
        w, h, opts = 96, 80, SOR
        bases = [_rand_frame(rng, w, h) for _ in range(6)]
    else:
        w, h, opts = 64, 48, SOR
        bases = _rand_fused_gop(rng, w, h, 6)
    cases = []
    for b in bases:
        cases += [b] + [_mutate(rng, b, lambda: bases[0]) for _ in range(3)]
    runs = [PictureOption.NONE]
    if flavor == "standard":
        runs.append(PictureOption.UNRESTRICTED_MOTION_VECTORS)
    for running in runs:
        assert _check_frames(cases, w, h, opts, running) >= 6


def test_fixture_frames_match_jax():
    assert _check_frames(_fixture_frames()[:3], 352, 288, SOR,
                         PictureOption.NONE) == 3
