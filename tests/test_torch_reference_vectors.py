"""The reference implementation's own test vectors (ruffle-rs/h263-rs),
through the port: tests/test_reference_vectors.py case for case, on
`h263_tpu_torch` instead of `h263_tpu`.

- the bit reader cases (reader.rs:444-560) on `h263_tpu_torch.bitio`;
- the macroblock and TCOEF table walks (`macroblock.json`, `tcoef.json`)
  on the port's `vlc_tables`;
- the eight `decode_block` cases (block.rs:1707-2124) on
  `h263_tpu_torch/parser/block.py`;
- the YUV vectors (`yuv.json`: scalar anchors, golden images) and the
  deblock vectors (`deblock.json`: quartets, the no-op identities, the
  11x17 image at strengths 4, 8 and 12) on the plain `ops/yuv.py` and
  `ops/deblock.py`, and on the g++ builds of the CUDA kernels' own sources
  that tests/test_torch_present.py makes (tests/deblock_host.cpp,
  tests/present_host.cpp).  The kernels' quartet is reached through a
  10x1 plane: its one horizontal edge (row 8) lies in the reference's
  scalar (truncating) zone, as no column is left of 8 * (w // 8) = 0.

The vectors are read from tests/ref_vectors/ and nothing there changes;
tests/test_torch_gpu.py runs the CUDA kernels on the same images.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from h263_tpu_torch.bitio import BitReader  # noqa: E402
from h263_tpu_torch.ops.deblock import _process, deblock  # noqa: E402
from h263_tpu_torch.ops.yuv import yuv420_to_rgba  # noqa: E402
from h263_tpu_torch.parser.block import decode_block  # noqa: E402
from h263_tpu_torch.types import (  # noqa: E402
    BitstreamExhausted,
    Block,
    DecoderOption,
    MacroblockType,
    Picture,
    PictureOption,
    PictureTypeCode,
    TCoefficient,
)
from h263_tpu_torch.vlc_tables import (  # noqa: E402
    CBPY,
    MCBPC_I,
    MCBPC_P,
    MODB,
    MVD,
    TCOEF,
    VLC_ESCAPE,
    VLC_INVALID,
    VLC_STUFFING,
)
from test_torch_present import (  # noqa: E402
    _build_host,
    run_deblock_host,
    run_present_host,
)

HERE = pathlib.Path(__file__).resolve().parent
VEC = HERE / "ref_vectors"


def load(name):
    return json.loads((VEC / name).read_text())


@pytest.fixture(scope="module")
def deblock_host(tmp_path_factory):
    return _build_host(tmp_path_factory.mktemp("deblock"),
                       HERE / "deblock_host.cpp", "h263_deblock_host")


@pytest.fixture(scope="module")
def present_host(tmp_path_factory):
    return _build_host(tmp_path_factory.mktemp("present"),
                       HERE / "present_host.cpp", "h263_present_host")


# -- bit reader: reader.rs:444-560 --------------------------------------------


class TestReader:
    def test_read_unaligned_bits(self):  # reader.rs:448-458
        r = BitReader(bytes([0xFF, 0x72, 0x1C, 0x1F]))
        assert r.read_bits(3) == 0x07
        assert r.read_bits(6) == 0x3E
        assert r.read_bits(23) == 0x721C1F
        with pytest.raises(BitstreamExhausted):
            r.read_bits(1)

    def test_read_signed_bits(self):  # reader.rs:460-481
        r = BitReader(bytes([0xFF, 0x40, 0x72, 0x1C, 0x1F]))
        assert r.read_signed_bits(3) == -1
        assert r.read_signed_bits(6) == -2
        assert r.read_signed_bits(8) == -0x80
        assert r.read_signed_bits(23) == -0xDE3E1
        with pytest.raises(BitstreamExhausted):
            r.read_bits(1)

    def test_peek_bits(self):  # reader.rs:483-493
        r = BitReader(bytes([0xFF, 0x72, 0x1C, 0x1F]))
        assert r.peek_bits(3) == 0x07
        assert r.peek_bits(6) == 0x3F
        assert r.peek_bits(23) == 0x7FB90E
        with pytest.raises(BitstreamExhausted):
            r.peek_bits(64)

    def test_read_u8(self):  # reader.rs:495-503
        r = BitReader(bytes([0xFE, 0x73, 0xF3]))
        assert r.read_u8() == 0xFE
        assert r.read_u8() == 0x73
        assert r.read_u8() == 0xF3

    def test_read_u8_unaligned(self):  # reader.rs:505-515
        r = BitReader(bytes([0xFE, 0x73, 0xF3]))
        r.skip_bits(2)
        assert r.read_u8() == 0xF9
        assert r.read_u8() == 0xCF
        with pytest.raises(BitstreamExhausted):
            r.read_u8()

    def test_read_u16(self):  # reader.rs:517-524
        r = BitReader(bytes([0xFE, 0x73, 0x50, 0xF3]))
        assert r.read_bits(16) == 0xFE73
        assert r.read_bits(16) == 0x50F3

    def test_read_u32(self):  # reader.rs:526-532
        r = BitReader(bytes([0xFE, 0x73, 0x50, 0xF3]))
        assert r.read_bits(32) == 0xFE7350F3

    def test_aligned_start_code(self):  # reader.rs:534-540
        r = BitReader(bytes([0x00, 0x00, 0x80, 0x00]))
        assert r.recognize_start_code(False) == 0

    def test_stuffed_start_code(self):  # reader.rs:542-551
        r = BitReader(bytes([0x00, 0x00, 0x08, 0x00]))
        assert r.recognize_start_code(False) is None
        r.skip_bits(1)
        assert r.recognize_start_code(False) == 3

    def test_resynchronize_to_start_code(self):  # reader.rs:553-559
        r = BitReader(bytes([0x13, 0x80, 0x00, 0x40, 0x00]))
        assert r.recognize_start_code(True) == 9


# -- VLC table walks: macroblock.rs and block.rs bit patterns ------------------

_LUTS = {
    "MCBPC_I_TABLE": MCBPC_I,
    "MCBPC_P_TABLE": MCBPC_P,
    "MODB_TABLE": MODB,
    "CBPY_TABLE_INTRA": CBPY,
    "MVD_TABLE": MVD,
    "TCOEF_TABLE": TCOEF,
}

_RUST_MB_TYPE = {
    "Intra": MacroblockType.INTRA,
    "IntraQ": MacroblockType.INTRA_Q,
    "Inter": MacroblockType.INTER,
    "InterQ": MacroblockType.INTER_Q,
    "Inter4V": MacroblockType.INTER_4V,
    "Inter4Vq": MacroblockType.INTER_4V_Q,
}


def _expected_symbol(table: str, exp):
    """A fixture's expected value as the port's LUT decodes it."""
    if table in ("MCBPC_I_TABLE", "MCBPC_P_TABLE"):
        if exp == "stuffing":
            return VLC_STUFFING
        if exp == "invalid":
            return VLC_INVALID
        return (_RUST_MB_TYPE[exp["mb_type"]], exp["cb"], exp["cr"])
    if table == "MODB_TABLE":
        return tuple(exp)
    if table == "CBPY_TABLE_INTRA":
        return VLC_INVALID if exp is None else tuple(exp)
    if table == "MVD_TABLE":
        # The reference stores full-pel f32, the table half-pel integers.
        return VLC_INVALID if exp is None else round(exp * 2)
    if table == "TCOEF_TABLE":
        if exp is None:
            return VLC_INVALID
        if exp == "escape":
            return VLC_ESCAPE
        return (int(exp["last"]), exp["run"], exp["level"])
    raise AssertionError(table)


def _run_walk(walk):
    r = BitReader(bytes(walk["bit_pattern"]))
    lut = _LUTS[walk["table"]]
    for i, exp in enumerate(walk["expected"]):
        got = r.read_vlc(lut)
        want = _expected_symbol(walk["table"], exp)
        assert got == want, (
            f"{walk['source_fn']} symbol {i}: got {got!r}, want {want!r}")


MB_WALKS = load("macroblock.json")["walks"]


@pytest.mark.parametrize("walk", MB_WALKS,
                         ids=[w["source_fn"] for w in MB_WALKS])
def test_macroblock_table_walks(walk):
    _run_walk(walk)


def test_tcoef_table_walk():
    walk = load("tcoef.json")["walk"]
    assert len(walk["expected"]) == 102  # every short-form row of Table 16
    _run_walk(walk)


# -- decode_block: block.rs:1707-2124 -----------------------------------------
# IntraDc::from_level(0x318): the FLC byte 0x63 decodes to level 0x318.


def _dummy_picture(ptype=PictureTypeCode.I_FRAME, version=None):
    return Picture(version=version, temporal_reference=0, format=None,
                   options=PictureOption.NONE, picture_type=ptype, quantizer=1)


def _decode(data, mb_type, tcoef_present, picture, options=DecoderOption(0)):
    return decode_block(BitReader(bytes(data)), options, picture,
                        PictureOption.NONE, mb_type, tcoef_present)


LONG_35_1216 = [TCoefficient(False, 3, 5), TCoefficient(False, 12, 16)]


class TestDecodeBlock:
    def test_empty_inter_block(self):  # block.rs:1708-1750
        got = _decode([0x00], MacroblockType.INTER, False,
                      _dummy_picture(PictureTypeCode.P_FRAME))
        assert got == Block(intradc=None, tcoef=[])

    def test_empty_intra_block(self):  # block.rs:1752-1794
        got = _decode([0x63], MacroblockType.INTRA, False, _dummy_picture())
        assert got == Block(intradc=0x318, tcoef=[])

    def test_long_coded_inter_block(self):  # block.rs:1796-1849
        got = _decode([0x06, 0x0C, 0x14, 0x1C, 0xC1, 0x00],
                      MacroblockType.INTER, True, _dummy_picture())
        assert got == Block(intradc=None, tcoef=LONG_35_1216)

    def test_long_coded_intra_block(self):  # block.rs:1851-1904
        got = _decode([0x63, 0x06, 0x0C, 0x14, 0x1C, 0xC1, 0x00],
                      MacroblockType.INTRA, True, _dummy_picture())
        assert got == Block(intradc=0x318, tcoef=LONG_35_1216)

    def test_short_coded_inter_block(self):  # block.rs:1906-1959
        got = _decode([0x03, 0x00, 0x14], MacroblockType.INTER, True,
                      _dummy_picture())
        assert got == Block(intradc=None, tcoef=[
            TCoefficient(True, 5, 2), TCoefficient(True, 0, 3)])

    def test_short_coded_intra_block(self):  # block.rs:1961-2014
        got = _decode([0x63, 0x03, 0x00, 0x14], MacroblockType.INTRA, True,
                      _dummy_picture())
        assert got == Block(intradc=0x318, tcoef=[
            TCoefficient(True, 5, 2), TCoefficient(True, 0, 3)])

    def test_sorenson_long_coded_intra_block(self):  # block.rs:2016-2069
        got = _decode([0x63, 0x06, 0x06, 0x14, 0x1A, 0x61, 0x00],
                      MacroblockType.INTRA, True,
                      _dummy_picture(version=1),
                      DecoderOption.SORENSON_SPARK_BITSTREAM)
        assert got == Block(intradc=0x318, tcoef=LONG_35_1216)

    def test_sorenson_xlong_coded_intra_block(self):  # block.rs:2071-2123
        got = _decode([0x63, 0x07, 0x06, 0x01, 0x41, 0xE6, 0x01, 0x00],
                      MacroblockType.INTRA, True,
                      _dummy_picture(version=1),
                      DecoderOption.SORENSON_SPARK_BITSTREAM)
        assert got == Block(intradc=0x318, tcoef=LONG_35_1216)


# -- YUV: bt601.rs golden values and images -----------------------------------

YUV = load("yuv.json")


def yuv_planes(img):
    """(y, cb, cr, rgba) of one golden image, numpy uint8."""
    w = img["y_width"]
    y = np.asarray(img["y"], dtype=np.uint8)
    h = 0 if w == 0 else len(img["y"]) // w
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return (y.reshape(h, w),
            np.asarray(img["cb"], dtype=np.uint8).reshape(ch, cw),
            np.asarray(img["cr"], dtype=np.uint8).reshape(ch, cw),
            np.asarray(img["rgba"], dtype=np.uint8).reshape(h, w, 4))


def _scalar_planes():
    """The scalar anchors as lanes of 1x1 pictures: (y, cb, cr) [n, 1, 1]
    and the expected RGB [n, 3]."""
    yuv = np.asarray([c["yuv"] for c in YUV["scalar"]], np.uint8)
    planes = [np.ascontiguousarray(yuv[:, k, None, None]) for k in range(3)]
    return planes, np.asarray([c["rgb"] for c in YUV["scalar"]], np.uint8)


class TestYuvReferenceVectors:
    def test_scalar_anchors_plain(self):  # bt601.rs:198-225
        for case in YUV["scalar"]:
            y, u, v = (torch.full((1, 1), x, dtype=torch.uint8)
                       for x in case["yuv"])
            got = yuv420_to_rgba(y, u, v)
            assert got[0, 0, :3].tolist() == case["rgb"], case

    def test_scalar_anchors_kernel_source(self, present_host):
        planes, want = _scalar_planes()
        n = len(want)
        got = run_present_host(present_host, *planes,
                               np.zeros(n, np.int32), np.zeros(n, bool))
        np.testing.assert_array_equal(got[:, 0, 0, :3], want)
        assert (got[..., 3] == 255).all()

    @pytest.mark.parametrize("idx", range(len(YUV["images"])))
    def test_golden_images_plain(self, idx):  # bt601.rs:329-483
        y, cb, cr, want = yuv_planes(YUV["images"][idx])
        got = yuv420_to_rgba(*(torch.as_tensor(p) for p in (y, cb, cr)))
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("idx", range(len(YUV["images"])))
    def test_golden_images_kernel_source(self, present_host, idx):
        y, cb, cr, want = yuv_planes(YUV["images"][idx])
        got = run_present_host(present_host, y[None], cb[None], cr[None],
                               np.zeros(1, np.int32), np.zeros(1, bool))
        np.testing.assert_array_equal(got[0], want)


# -- deblock: deblock.rs quartet table and 11x17 golden images ----------------
# The reference's scalar `process` is the truncating zone's.

DEBLOCK = load("deblock.json")
QUARTETS = DEBLOCK["quartets"]


def _process_scalar(q, strength):
    a, b, c, d = (torch.tensor([v], dtype=torch.int32) for v in q)
    return [int(x[0]) for x in _process(a, b, c, d, strength, False)]


def quartet_lanes(inputs):
    """Each quartet as the rows 6-9 of a 10x1 plane (lanes [n, 10, 1]),
    whose one edge the deblock filters in the truncating zone; the other
    rows hold a value the filter must leave alone."""
    planes = np.full((len(inputs), 10, 1), 77, np.uint8)
    planes[:, 6:10, 0] = np.asarray(inputs, np.uint8)
    return planes


def image_case(strength):
    img = DEBLOCK["image"]
    w = img["width"]
    data = np.asarray(img["data"], np.uint8).reshape(-1, w)
    want = np.asarray(img["expected"][str(strength)], np.uint8).reshape(-1, w)
    return data, want


class TestDeblockReferenceVectors:
    def test_quartets_plain(self):  # deblock.rs:352-440
        for case in QUARTETS:
            got = _process_scalar(case["input"], case["strength"])
            assert got == case["output"], case
            # Direction symmetry (deblock.rs:426-429).
            rev = _process_scalar(case["input"][::-1], case["strength"])
            assert rev[::-1] == case["output"], case
            # Brightness-inversion symmetry (deblock.rs:431-438).
            inv = _process_scalar([255 - v for v in case["input"]],
                                  case["strength"])
            assert [255 - v for v in inv] == case["output"], case

    def test_quartets_through_the_plain_plane_filter(self):
        strength = torch.tensor([c["strength"] for c in QUARTETS],
                                dtype=torch.int32)[:, None, None]
        got = deblock(torch.as_tensor(quartet_lanes(
            [c["input"] for c in QUARTETS])), strength).numpy()
        np.testing.assert_array_equal(
            got[:, 6:10, 0], [c["output"] for c in QUARTETS])
        assert (got[:, :6] == 77).all()

    def test_quartets_kernel_source(self, deblock_host):
        strength = np.asarray([c["strength"] for c in QUARTETS], np.int32)
        apply = np.ones(len(QUARTETS), bool)
        for flip in (False, True):
            for invert in (False, True):
                inputs = [c["input"][::-1] if flip else c["input"]
                          for c in QUARTETS]
                if invert:
                    inputs = [[255 - v for v in q] for q in inputs]
                got = run_deblock_host(deblock_host, quartet_lanes(inputs),
                                       strength, apply)[:, 6:10, 0]
                if invert:
                    got = 255 - got
                if flip:
                    got = got[:, ::-1]
                np.testing.assert_array_equal(
                    got, [c["output"] for c in QUARTETS],
                    err_msg=f"reversed {flip}, inverted {invert}")

    def test_process_const_noop(self):  # deblock.rs:324-334, vectorised
        vals = torch.arange(256, dtype=torch.int32)
        for strength in range(1, 13):
            for floor_mode in (False, True):
                for o in _process(vals, vals, vals, vals, strength,
                                  floor_mode):
                    assert torch.equal(o, vals)

    def test_process_symmetric_noop(self):  # deblock.rs:336-349, vectorised
        outer, inner = torch.meshgrid(torch.arange(256, dtype=torch.int32),
                                      torch.arange(256, dtype=torch.int32),
                                      indexing="xy")
        outer, inner = outer.reshape(-1), inner.reshape(-1)
        for strength in (1, 4, 8, 12):
            for floor_mode in (False, True):
                a, b, c, d = _process(outer, inner, inner, outer, strength,
                                      floor_mode)
                for got, want in ((a, outer), (b, inner), (c, inner),
                                  (d, outer)):
                    assert torch.equal(got, want)

    @pytest.mark.parametrize("strength", [4, 8, 12])
    def test_golden_image_plain(self, strength):  # deblock.rs:442-558
        data, want = image_case(strength)
        np.testing.assert_array_equal(
            deblock(torch.as_tensor(data), strength).numpy(), want)

    @pytest.mark.parametrize("strength", [4, 8, 12])
    def test_golden_image_kernel_source(self, deblock_host, strength):
        data, want = image_case(strength)
        for threads in (256, 32):
            got = run_deblock_host(deblock_host, data[None],
                                   np.asarray([strength], np.int32),
                                   np.ones(1, bool), threads=threads)
            np.testing.assert_array_equal(got[0], want)
