"""The port's native host entropy decoder against the JAX package's.

* The sources are copies: `h263_tpu_torch/native/entropy.cpp` is byte-equal
  to `h263_tpu/native/entropy.cpp`, and the port's `gen_tables` writes the
  JAX package's `tables.h` from the port's `vlc_tables.py`.
* `SorensonFusedBatchParser.parse` on the same buffers, slim and full MV
  rows, with absent (skip-frame) lanes: equal row prefixes up to the cut,
  header rows, counts, flags, cut, full MVs and byte flags.
* A corrupt lane: the same error class naming the same stream; a frame past
  `pack_cap`: `PackOverflow` on the same input.
* `parse_frame_native`: equal dense tensors, IDCT classes, MVs, flags, end
  bit and error classes, on fuzzed frames and their mutants.
"""

import os

import numpy as np
import pytest

from h263_tpu.bitio import BitReader as JBitReader
from h263_tpu.native import bindings as jn
from h263_tpu.parser.picture import decode_picture as j_decode_picture
from h263_tpu.testing.fuzz import _mutate, _rand_frame, _rand_fused_gop
from h263_tpu.types import DecoderOption as JOption
from h263_tpu.types import PictureOption as JPictureOption
from h263_tpu_torch import native
from h263_tpu_torch.bitio import BitReader
from h263_tpu_torch.native import bindings as tn
from h263_tpu_torch.native import gen_tables
from h263_tpu_torch.ops.d24 import fused_sections
from h263_tpu_torch.parser.picture import decode_picture
from h263_tpu_torch.testing.encoder import MBSpec, encode_sorenson_picture
from h263_tpu_torch.types import DecoderOption, PictureOption, PictureTypeCode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOR = DecoderOption.SORENSON_SPARK_BITSTREAM


def _read(*parts):
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


def test_entropy_source_is_a_copy():
    assert _read("h263_tpu_torch", "native", "entropy.cpp") == \
        _read("h263_tpu", "native", "entropy.cpp")


def test_tables_regenerate_byte_equal(tmp_path):
    out = tmp_path / "tables.h"
    gen_tables.main(str(out))
    want = _read("h263_tpu", "native", "tables.h")
    assert out.read_bytes() == want
    assert _read("h263_tpu_torch", "native", "tables.h") == want


class _Pair:
    """The JAX and the port's fused batch parsers over like buffers."""

    def __init__(self, n, w, h, stride, cap=None):
        assert jn.ensure_built()
        mbw, mbh = -(-w // 16), -(-h // 16)
        self.nmb = nmb = mbw * mbh
        self.cap = cap = cap or 16 * nmb
        ladder = np.array(sorted({min(256, cap), cap}), dtype=np.int32)
        row = sum(fused_sections(nmb, stride == 8)) + 3 * cap
        self.stride = stride
        self.bufs = []
        parsers = []
        for mod in (jn, tn):
            fused = np.full((n, row), 0xAB, dtype=np.uint8)
            mvs = np.full((n, mbh, mbw, 4, 2), -7, dtype=np.int16)
            inter = np.full((n, mbh, mbw), 9, dtype=np.uint8)
            self.bufs.append((fused, mvs, inter))
            parsers.append(mod.SorensonFusedBatchParser(
                n, w, h, fused, stride, mvs, inter,
                np.zeros((nmb, 4, 2), dtype=np.int16), cap, ladder))
        self.parsers = parsers

    def parse(self, buffers, has_ref):
        """Both parses: (outputs, error) each; equal, or the same error."""
        res = []
        for p in self.parsers:
            try:
                hdr, counts, flags, cut = p.parse(buffers, has_ref)
                res.append(((hdr.copy(), counts.copy(), flags.copy(), cut),
                            None))
            except Exception as e:               # noqa: BLE001
                res.append((None, e))
        (a, ea), (b, eb) = res
        if ea is not None or eb is not None:
            assert type(ea).__name__ == type(eb).__name__, (ea, eb)
            assert str(ea).split(":")[0] == str(eb).split(":")[0]
            return None, eb
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]
        used = sum(fused_sections(self.nmb, self.stride == 8)) + 3 * a[3]
        (fj, mj, ij), (ft, mt, it) = self.bufs
        np.testing.assert_array_equal(ft[:, :used], fj[:, :used])
        np.testing.assert_array_equal(it, ij)
        if self.stride == 2 and (b[2] & 2).any():
            np.testing.assert_array_equal(mt, mj)    # the flip step's MVs
        return b, None


@pytest.mark.parametrize("stride", [2, 8])
@pytest.mark.parametrize("dims", [(48, 48), (96, 64), (177, 145)])
def test_fused_batch_parse_matches_jax(stride, dims):
    w, h = dims
    rng = np.random.default_rng(w * h + stride)
    n, T = 4, 8
    gops = [_rand_fused_gop(rng, w, h, T) for _ in range(n)]
    pair = _Pair(n, w, h, stride)
    skip = encode_sorenson_picture(w, h, PictureTypeCode.P_FRAME,
                                   [MBSpec(kind="uncoded")] * pair.nmb)
    ok = errs = 0
    for t in range(T):
        bufs = [g[t] for g in gops]
        if t % 3 == 2:
            bufs[1] = skip                    # an absent lane's skip frame
        if t == 5:
            b = bytearray(bufs[2])
            b[len(b) // 2] ^= 0x3C
            bufs[2] = bytes(b)
        out, err = pair.parse(bufs, [t > 0] * n)
        ok += out is not None
        errs += err is not None
    assert ok >= 3


def test_corrupt_lane_names_the_same_stream():
    w, h = 64, 48
    rng = np.random.default_rng(5)
    gops = [_rand_fused_gop(rng, w, h, 2) for _ in range(5)]
    pair = _Pair(5, w, h, 2)
    bufs = [g[0] for g in gops]
    pair.parse(bufs, [True] * 5)
    bufs[3] = bufs[3][:9]                          # cut in the first MBs
    bufs[4] = b"\x00\x00\x81garbage"
    _, err = pair.parse(bufs, [True] * 5)
    assert err is not None and str(err).startswith("stream 3")
    # INTER macroblocks without a reference picture.
    p = encode_sorenson_picture(w, h, PictureTypeCode.P_FRAME,
                                [MBSpec(kind="inter", mvd=[(1, 1)])] * 12)
    _, err = pair.parse([gops[i][0] for i in range(4)] + [p],
                        [True] * 4 + [False])
    assert type(err).__name__ == "UncodedIFrameBlocks"


def test_pack_overflow_at_the_same_input():
    w, h = 48, 32
    nmb = 6
    dense = encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[64] * 6,
                blocks=[[(0, 3)] * 10] * 6)] * nmb)
    sparse = encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME, [MBSpec(kind="intra",
                                               intradc=[64] * 6)] * nmb)
    overflowed = []
    for cap in (30, 200, 400, 600, 2000):
        pair = _Pair(2, w, h, 2, cap=cap)
        _, err = pair.parse([sparse, dense], [True, True])
        assert err is None or isinstance(err, tn.PackOverflow), err
        overflowed.append(err is not None)
    assert overflowed[0] and not overflowed[-1]


def _dense_pair(buf, w, h, opts, running):
    """parse_frame_native of both packages after their own header parse:
    (frame, end bit) or the error class name, each."""
    out = []
    for mod, reader, dec, o, run in (
            (jn, JBitReader, j_decode_picture, JOption(int(opts)),
             JPictureOption(int(running))),
            (tn, BitReader, decode_picture, opts, running)):
        try:
            r = reader(buf)
            pic = dec(r, o, None)
            out.append(mod.parse_frame_native(r.data, r.pos, pic, o, run,
                                              w, h))
        except Exception as e:                   # noqa: BLE001
            out.append(type(e).__name__)
    return out


_FIELDS = ("coeffs_y", "class_y", "coeffs_cb", "class_cb", "coeffs_cr",
           "class_cr", "mvs", "inter")


@pytest.mark.parametrize("flavor", ["sorenson", "standard"])
def test_dense_parse_matches_jax(flavor):
    assert jn.ensure_built()
    w, h = (96, 80) if flavor == "sorenson" else (128, 96)
    opts = SOR if flavor == "sorenson" else DecoderOption.NONE
    rng = np.random.default_rng(17 if flavor == "sorenson" else 18)
    n_ok = 0
    for k in range(12):
        base = _rand_frame(rng, w, h, flavor)
        run = (PictureOption.UNRESTRICTED_MOTION_VECTORS
               if flavor == "standard" and k % 2 else PictureOption.NONE)
        for buf in [base] + [_mutate(rng, base,
                                     lambda: _rand_frame(rng, w, h, flavor))
                             for _ in range(4)]:
            a, b = _dense_pair(buf, w, h, opts, run)
            if isinstance(a, str) or isinstance(b, str):
                assert a == b, (k, a, b)
                continue
            n_ok += 1
            assert a[1] == b[1]
            for f in _FIELDS:
                np.testing.assert_array_equal(getattr(b[0], f),
                                              getattr(a[0], f), err_msg=f)
    assert n_ok >= 12


def test_dense_parse_writes_into_given_slices():
    w, h = 48, 32
    f = _rand_frame(np.random.default_rng(2), w, h)
    r = BitReader(f)
    pic = decode_picture(r, SOR, None)
    fresh, end = tn.parse_frame_native(r.data, r.pos, pic, SOR,
                                       PictureOption.NONE, w, h)
    out = tuple(np.full_like(getattr(fresh, k), 5) for k in _FIELDS[:-1]) + (
        np.zeros((2, 3), dtype=np.uint8),)
    got, end2 = tn.parse_frame_native(r.data, r.pos, pic, SOR,
                                      PictureOption.NONE, w, h, out=out)
    assert end2 == end
    for k, o in zip(_FIELDS, out):
        np.testing.assert_array_equal(o.astype(getattr(fresh, k).dtype),
                                      getattr(fresh, k))
    with pytest.raises(ValueError):
        tn.parse_frame_native(r.data, r.pos, pic, SOR, PictureOption.NONE,
                              w, h, out=(out[0][:, ::2],) + out[1:])


def test_library_is_built_once_per_source():
    assert native.lib() is native.lib()
    assert native._library_path().exists()
    assert native.lib().h263_abi_version() == native.ABI_VERSION
