"""The port's own copies of the JAX package's host layer, held equal to it.

The port imports nothing of `h263_tpu`, so it carries copies of the
bitstream types, the VLC code lists and packed automaton tables, the IDCT
basis, the BT.601 and deblock constants, the test encoder and the FLV
demuxer.  Each copy is held here against its original, exactly.
"""

import enum
import pathlib

import numpy as np
import pytest

import h263_tpu.io.flv as j_flv
import h263_tpu.ops.deblock as j_deblock
import h263_tpu.ops.idct as j_idct
import h263_tpu.ops.yuv as j_yuv
import h263_tpu.parser.device_frontend as j_df
import h263_tpu.parser.mvpred as j_mvpred
import h263_tpu.testing.encoder as j_enc
import h263_tpu.types as j_types
import h263_tpu.vlc_tables as j_vlc
import h263_tpu_torch.io.flv as t_flv
import h263_tpu_torch.ops.deblock as t_deblock
import h263_tpu_torch.ops.idct as t_idct
import h263_tpu_torch.ops.yuv as t_yuv
import h263_tpu_torch.parser.tables as t_tab
import h263_tpu_torch.testing.encoder as t_enc
import h263_tpu_torch.types as t_types
import h263_tpu_torch.utils.trace as t_trace
import h263_tpu_torch.vlc_tables as t_vlc

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"


def _plain(v):
    """A code-list value with enum members replaced by their values."""
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    return v


# -- types -------------------------------------------------------------------

_ERRORS = [n for n, v in vars(t_types).items()
           if isinstance(v, type) and issubclass(v, Exception)]


@pytest.mark.parametrize("name", sorted(_ERRORS))
def test_error_classes_keep_names_and_hierarchy(name):
    t, j = getattr(t_types, name), getattr(j_types, name)
    assert issubclass(t, t_types.H263Error) == issubclass(j, j_types.H263Error)
    assert [c.__name__ for c in t.__mro__[:-3]] == \
        [c.__name__ for c in j.__mro__[:-3]]


@pytest.mark.parametrize("name", ["DecoderOption", "PictureTypeCode",
                                  "MacroblockType"])
def test_enums_equal(name):
    t, j = getattr(t_types, name), getattr(j_types, name)
    assert [(m.name, m.value) for m in t] == [(m.name, m.value) for m in j]


def test_integer_constants_equal():
    def names(mod):
        return sorted(n for n, v in vars(mod).items()
                      if n.isupper() and isinstance(v, int))

    assert names(t_types) == names(j_types)
    assert len(names(t_types)) == 11
    for n in names(t_types):
        assert getattr(t_types, n) == getattr(j_types, n), n


# -- VLC tables --------------------------------------------------------------

_CODE_LISTS = ["MCBPC_I_CODES", "MCBPC_P_CODES", "CBPY_CODES", "MVD_CODES",
               "TCOEF_CODES"]


@pytest.mark.parametrize("name", _CODE_LISTS)
def test_code_lists_equal(name):
    t, j = getattr(t_vlc, name), getattr(j_vlc, name)
    assert [(c, _plain(v)) for c, v in t] == [(c, _plain(v)) for c, v in j]
    assert t_vlc.build_encode_map(t).keys().__len__() == \
        len(j_vlc.build_encode_map(j))


def test_zigzag_and_sentinels_equal():
    assert t_vlc.ZIGZAG_XY == j_vlc.ZIGZAG_XY
    assert t_vlc.ZIGZAG_TO_ROWMAJOR == j_vlc.ZIGZAG_TO_ROWMAJOR
    for n in ("VLC_INVALID", "VLC_STUFFING", "VLC_ESCAPE"):
        assert getattr(t_vlc, n) == getattr(j_vlc, n)


# -- the automaton's packed tables and codes ---------------------------------

@pytest.mark.parametrize("name", ["MCBPC_I", "MCBPC_P", "CBPY", "MVD",
                                  "TCOEF"])
def test_packed_tables_equal(name):
    t, j = getattr(t_tab, f"{name}_ARR"), getattr(j_df, f"{name}_ARR")
    assert t.dtype == j.dtype and np.array_equal(t, j)
    assert getattr(t_tab, f"{name}_LEN") == getattr(j_df, f"{name}_LEN")


def test_phase_status_and_flag_codes_equal():
    names = [n for n in vars(t_tab)
             if n.startswith(("PH_", "ST_", "_FLG_", "_MT_", "_F_"))]
    assert len(names) == 28
    for n in names:
        assert getattr(t_tab, n) == getattr(j_df, n), n


@pytest.mark.parametrize("status", range(12))
def test_status_error_class_names_equal(status):
    t, j = t_tab.status_error_class(status), j_df.status_error_class(status)
    assert (t and t.__name__) == (j and j.__name__)
    assert t is None or issubclass(t, t_types.H263Error)


@pytest.mark.parametrize("mbh,mbw", [(1, 1), (2, 3), (9, 11), (18, 22),
                                     (45, 80)])
def test_dense_block_perm_equal(mbh, mbw):
    np.testing.assert_array_equal(t_tab._dense_block_perm(mbh, mbw),
                                  j_df._dense_block_perm(mbh, mbw))


def test_extended_range_for_dim_equal():
    for dim in range(0, 2200):
        for is_x in (True, False):
            assert t_tab._extended_range_for_dim(dim, is_x) == \
                j_mvpred._extended_range_for_dim(dim, is_x), (dim, is_x)


# -- kernel constants --------------------------------------------------------

def test_idct_basis_bit_equal():
    assert t_idct.BASIS_F32.dtype == np.float32
    np.testing.assert_array_equal(t_idct.BASIS_F32.view(np.uint32),
                                  np.asarray(j_idct.BASIS_F32).view(np.uint32))


def test_bt601_and_deblock_constants_equal():
    for n in ("_GRAY", "_CR2R", "_CR2G", "_CB2G", "_CB2B", "_HALF"):
        assert getattr(t_yuv, n) == getattr(j_yuv, n), n
    np.testing.assert_array_equal(t_deblock.QUANT_TO_STRENGTH,
                                  j_deblock.QUANT_TO_STRENGTH)
    assert t_deblock.QUANT_TO_STRENGTH.dtype == np.int32


# -- the test encoder ---------------------------------------------------------

def _specs(enc, case):
    M = enc.MBSpec
    intra = M(kind="intra", intradc=[8, 1024, 2032, 16, 512, 1024],
              blocks=[[(0, 3), (2, -1)], [], [(1, 70)], [], [(0, -1)], []])
    inter = M(kind="inter", mvd=[(3, -2)],
              blocks=[[(0, 1)], [(5, -9)], [], [], [], [(0, 120)]])
    four = M(kind="inter", mvd=[(1, 1), (-2, 0), (0, 5), (31, -32)],
             blocks=[[], [], [], [(0, 2)], [], []])
    return {
        "intra_i": ("I", [intra] * 4),
        "intra_dquant": ("I", [M(kind="intra", dquant=2,
                                 intradc=[64] * 6)] * 4),
        "stuffing_i": ("I", [M(kind="stuffing"), intra, intra, intra,
                             intra]),
        "inter_p": ("P", [inter, M(kind="uncoded"), four, intra]),
        "inter_dquant": ("P", [M(kind="inter", dquant=-1, mvd=[(0, 0)],
                                 blocks=[[(0, 1)], [], [], [], [], []])] * 4),
        "escape_long": ("P", [M(kind="inter", mvd=[(0, 0)],
                                blocks=[[(0, 1000), (3, -900)], [], [], [],
                                        [], []])] * 4),
        "disposable": ("DP", [M(kind="uncoded")] * 4),
    }[case]


_CASES = ["intra_i", "intra_dquant", "stuffing_i", "inter_p",
          "inter_dquant", "escape_long", "disposable"]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("dims,kw", [
    ((32, 32), {}),
    ((352, 288), {}),
    ((48, 32), dict(version=0, deblocker=True, quantizer=17)),
    ((32, 32), dict(force_custom_dims=True, extra=b"\x01\xfe",
                    temporal_reference=300)),
])
def test_encoder_bytes_equal(case, dims, kw):
    w, h = dims
    nmb = (-(-w // 16)) * (-(-h // 16))
    out = []
    for enc, types in ((j_enc, j_types), (t_enc, t_types)):
        code, mbs = _specs(enc, case)
        ptype = {"I": types.PictureTypeCode.I_FRAME,
                 "P": types.PictureTypeCode.P_FRAME,
                 "DP": types.PictureTypeCode.DISPOSABLE_P_FRAME}[code]
        mbs = (mbs * nmb)[:nmb]
        if case == "escape_long" and kw.get("version") == 0:
            mbs = [enc.MBSpec(kind="inter", mvd=[(0, 0)],
                              blocks=[[(0, 100)], [], [], [], [], []])] * nmb
        pad = 1 if code == "DP" else 0
        out.append(enc.encode_sorenson_picture(w, h, ptype, mbs, pad_bit=pad,
                                               **kw))
    assert out[0] == out[1]


def test_standard_format_bits_equal():
    assert t_enc._STANDARD_FORMAT_BITS == j_enc._STANDARD_FORMAT_BITS


# Standard escapes are 8-bit: the Sorenson long escape has no standard form.
@pytest.mark.parametrize("case", [c for c in _CASES
                                  if c not in ("disposable", "escape_long")])
@pytest.mark.parametrize("dims,kw", [
    ((352, 288), {}),                        # plain PTYPE
    ((128, 96), dict(umv=True, quantizer=3, temporal_reference=300)),
    ((48, 32), {}),                          # PLUSPTYPE + OPPTYPE + CPFMT
    ((64, 48), dict(umv=True, quantizer=31)),
])
def test_standard_encoder_bytes_equal(case, dims, kw):
    w, h = dims
    nmb = (-(-w // 16)) * (-(-h // 16))
    out = []
    for enc, types in ((j_enc, j_types), (t_enc, t_types)):
        code, mbs = _specs(enc, case)
        ptype = {"I": types.PictureTypeCode.I_FRAME,
                 "P": types.PictureTypeCode.P_FRAME}[code]
        out.append(enc.encode_standard_picture(w, h, ptype,
                                               (mbs * nmb)[:nmb], **kw))
    assert out[0] == out[1]


def test_standard_encoder_refuses_the_same_dims():
    for enc, types in ((j_enc, j_types), (t_enc, t_types)):
        with pytest.raises(ValueError):
            enc.encode_standard_picture(50, 32, types.PictureTypeCode.I_FRAME,
                                        [])


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {}), (2, {}), (900, dict(n=3)),
    (2, dict(width=64, height=48, n=3)), (5, dict(version=0)),
])
def test_rich_gop_bytes_equal(seed, kw):
    """The port's copy of the rich GOP recipe (intra MBs in P-frames, 4V,
    DQUANT, stuffing, both escapes, zigzag overflow) gives the bytes of the
    JAX package's tests."""
    from test_device_frontend import rich_gop as j_rich_gop

    from h263_tpu_torch.testing.corpora import rich_gop

    assert rich_gop(seed, **kw) == j_rich_gop(seed, **kw)


# -- the FLV demuxer and the counters ----------------------------------------

@pytest.mark.parametrize("name", ["ffmpeg_flv1_cif.flv",
                                  "ffmpeg_flv1_qcif.flv"])
def test_flv_demuxer_equal(name):
    data = (FIX / name).read_bytes()
    for cut in (len(data), len(data) // 2, 12):
        t = list(t_flv.iter_flv_video_tags(data[:cut]))
        j = list(j_flv.iter_flv_video_tags(data[:cut]))
        assert [(x.timestamp_ms, x.frame_type, x.codec_id, x.payload)
                for x in t] == [(x.timestamp_ms, x.frame_type, x.codec_id,
                                 x.payload) for x in j]
    assert len(t) == 0 and len(list(t_flv.iter_flv_video_tags(data))) > 0


def test_event_counters():
    before = t_trace.get_counters()
    t_trace.incr("test_counter_a")
    t_trace.incr("test_counter_a", 3)
    t_trace.incr("test_counter_b")
    snap = t_trace.get_counters()
    assert snap["test_counter_a"] - before.get("test_counter_a", 0) == 4
    assert snap["test_counter_b"] - before.get("test_counter_b", 0) == 1
    t_trace.incr("test_counter_b")
    assert t_trace.get_counters()["test_counter_b"] == \
        snap["test_counter_b"] + 1
    assert snap != t_trace.get_counters()    # a snapshot, not a view
