"""Standard H.263 (`DecoderOption.NONE`) through the port's decoders on the
CPU, against the JAX package's, exactly.

* `encode_ptype` against the JAX function on every header of the corpora
  (the standard corpora, PLUSPTYPE recipes, the fuzz corpus's standard and
  UMV frames and their mutants, Sorenson frames), under every carried
  option set;
* `DeviceFrontendDecoder`: the Python header prep beside the JAX one, step
  for step: planes, statuses, error classes, the carried options and last
  headers, the presentation params and RGBA, over a GOP with a masked step,
  carried UMV, an MQ picture, cut and flipped lanes, an over-cap frame and
  a rejected header; a custom-size bucket with table-D.3 MVDs;
* `BatchedStreamDecoder`: the native plain-PTYPE parse and its Python
  header replay (`NeedsPythonHeader`) beside the JAX one, with custom dims,
  the skip frame, `PackOverflow` and corrupt steps, and the replay forced
  on every step.

Sizes are small (128x96, 48x32 and 64x48, 3-4 streams, GOPs of 4-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import h263_tpu.parser.device_frontend as j_df  # noqa: E402
from h263_tpu.bitio import BitReader as JaxReader  # noqa: E402
from h263_tpu.parallel.batch import (  # noqa: E402
    BatchedStreamDecoder as JaxBatch,
)
from h263_tpu.parallel.device_batch import (  # noqa: E402
    DeviceFrontendDecoder as JaxDevice,
)
from h263_tpu.parser.picture import decode_picture as j_decode_picture  # noqa: E402
from h263_tpu.testing import fuzz  # noqa: E402
from h263_tpu.types import DecoderOption as JaxOption  # noqa: E402
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu.types import PictureOption as JaxPO  # noqa: E402
from h263_tpu.types import carry_forward_options as j_carry  # noqa: E402
from h263_tpu_torch import BatchedStreamDecoder, DeviceFrontendDecoder  # noqa: E402
from h263_tpu_torch.bitio import BitReader  # noqa: E402
from h263_tpu_torch.native import bindings  # noqa: E402
from h263_tpu_torch.parser.device_frontend import encode_ptype  # noqa: E402
from h263_tpu_torch.parser.picture import decode_picture  # noqa: E402
from h263_tpu_torch.testing import corpora as C  # noqa: E402
from h263_tpu_torch.testing.encoder import (  # noqa: E402
    MBSpec,
    encode_sorenson_picture,
    encode_standard_picture,
)
from h263_tpu_torch.types import (  # noqa: E402
    OPPTYPE_OPTIONS,
    MPPTYPE_OPTIONS,
    DecoderOption,
    H263Error,
    PictureOption,
    PictureTypeCode,
    carry_forward_options,
)
from h263_tpu_torch.utils import trace  # noqa: E402
from test_torch_pool import _np  # noqa: E402
from test_torch_pool import _picture_fields as _fields  # noqa: E402

NONE = DecoderOption.NONE
SQ = (128, 96)       # a plain-PTYPE size
UMV = PictureOption.UNRESTRICTED_MOTION_VECTORS
MQ = PictureOption.MODIFIED_QUANTIZATION


# -- encode_ptype --------------------------------------------------------------

def _ptype_corpus(group):
    """(frame bytes, decoder options) of one group of headers."""
    rng = np.random.default_rng(7)
    if group == "corpora":
        frames = (C.std_corpus(0)[:3] + C.umv_corpus(*SQ, 3)
                  + C.d3_corpus(*C.QCIF, 3) + [C.mq_picture(*SQ)])
        return [(f, NONE) for f in frames]
    if group == "plusptype":
        cases = []
        for dims in (SQ, C.QCIF, (48, 32), (64, 48)):
            for ptype in (PictureTypeCode.I_FRAME, PictureTypeCode.P_FRAME):
                for kw in (dict(), dict(umv=True), dict(mq=True),
                           dict(umv=True, mq=True), dict(ufep=False),
                           dict(umv=True, custom=True)):
                    cases.append((C.plusptype_picture(*dims, ptype, **kw),
                                  NONE))
        return cases
    if group == "fuzz_standard":
        cases = []
        for _ in range(12):
            base = fuzz._rand_frame(rng, *SQ, flavor="standard")
            cases.append((base, NONE))
            for _ in range(4):
                cases.append((fuzz._mutate(
                    rng, base,
                    lambda: fuzz._rand_frame(rng, *SQ, flavor="standard")),
                    NONE))
        return cases
    if group == "sorenson":
        return [(f, DecoderOption.SORENSON_SPARK_BITSTREAM)
                for f in C.build_corpus(48, 32, 3, seed=3)
                + [encode_sorenson_picture(
                    48, 32, PictureTypeCode.DISPOSABLE_P_FRAME,
                    [MBSpec(kind="uncoded")] * 6, version=0, pad_bit=1)]]
    raise ValueError(group)


@pytest.mark.parametrize("group", ["corpora", "plusptype", "fuzz_standard",
                                   "sorenson"])
def test_encode_ptype_matches_jax(group):
    """Every header that parses in both packages gives the same ptype word
    under every carried option set, the options carried from it included;
    a header that fails fails in both, with the same class."""
    parsed = 0
    prev_t = prev_j = None
    for buf, opts in _ptype_corpus(group):
        errs, pics = [], []
        for dec, reader, o, prev in (
                (decode_picture, BitReader, opts, prev_t),
                (j_decode_picture, JaxReader, JaxOption(int(opts)), prev_j)):
            try:
                pics.append(dec(reader(buf), o, prev))
                errs.append(None)
            except (H263Error, JaxH263Error) as e:
                pics.append(None)
                errs.append(type(e).__name__)
        assert errs[0] == errs[1], buf.hex()[:40]
        tp, jp = pics
        assert (tp is None) == (jp is None)
        if tp is None:
            continue
        parsed += 1
        for run in (None, 0, int(UMV), int(MQ), int(UMV | MQ)):
            trun = None if run is None else PictureOption(run)
            jrun = None if run is None else JaxPO(run)
            assert encode_ptype(tp, trun) == j_df.encode_ptype(jp, jrun)
            if run is not None:
                tc = carry_forward_options(tp, trun)
                jc = j_carry(jp, jrun)
                assert int(tc) == int(jc)
                assert encode_ptype(tp, tc) == j_df.encode_ptype(jp, jc)
        prev_t, prev_j = tp, jp
    assert parsed >= 3


def test_encode_ptype_bits():
    i_pic = decode_picture(BitReader(C.umv_corpus(*SQ, 2)[0]), NONE, None)
    p_pic = decode_picture(BitReader(C.umv_corpus(*SQ, 2)[1]), NONE, i_pic)
    d_pic = decode_picture(BitReader(C.d3_corpus(*SQ, 2)[1]), NONE, None)
    assert encode_ptype(i_pic, carry_forward_options(i_pic, 0)) == 0 + 4 + 16 + 32
    assert encode_ptype(p_pic, None) == 1 + 4
    assert encode_ptype(p_pic, carry_forward_options(p_pic, UMV)) == 1 + 4 + 8
    assert encode_ptype(d_pic, carry_forward_options(d_pic, 0)) == \
        1 + 4 + 16 + 32
    assert encode_ptype(p_pic, MQ) == 1 + 4 + 64


# -- DeviceFrontendDecoder ------------------------------------------------------

def _device_twins(S, dims):
    return (JaxDevice(S, *dims, JaxOption.NONE, unroll=1),
            DeviceFrontendDecoder(S, *dims, NONE, device="cpu"))


def _device_step(jd, td, bufs, mask=None):
    errs = []
    for dec in (jd, td):
        try:
            dec.decode_step(bufs, mask=mask)
            errs.append(None)
        except (JaxH263Error, H263Error) as e:
            errs.append(type(e).__name__)
    assert errs[0] == errs[1]
    for name in ("ref_y", "ref_cb", "ref_cr"):
        np.testing.assert_array_equal(_np(getattr(td, name)),
                                      _np(getattr(jd, name)), err_msg=name)
    np.testing.assert_array_equal(td.fetch_status(), jd.fetch_status())
    np.testing.assert_array_equal(td._last_quant, jd._last_quant)
    np.testing.assert_array_equal(td._last_deblock, jd._last_deblock)
    assert [int(r) for r in td._running] == [int(r) for r in jd._running]
    assert [_fields(p) for p in td._pictures] == \
        [_fields(p) for p in jd._pictures]
    return errs[1]


def _cut_after_header(frame, k):
    """The frame cut some way into its macroblocks, or a byte there
    flipped (k even: cut, odd: flip)."""
    if k % 2 == 0:
        return frame[:len(frame) * 2 // 3]
    b = bytearray(frame)
    b[len(b) // 2] ^= 0x5A
    return bytes(b)


def test_standard_device_decoder_matches_jax():
    S, T = 4, 5
    streams = [C.build_corpus(*SQ, T, seed=11, standard=True),
               C.build_corpus(*SQ, T, seed=12, standard=True),
               C.umv_corpus(*SQ, T),
               [C.mq_picture(*SQ)] + C.build_corpus(*SQ, T, seed=13,
                                                    standard=True)[1:]]
    jd, td = _device_twins(S, SQ)
    raised, statuses = [], []
    for t in range(T):
        bufs = [s[t] for s in streams]
        mask = None
        if t == 1:
            mask = [True, False, True, True]        # a masked lane
        if t == 2:
            bufs[0] = _cut_after_header(bufs[0], 0)
            bufs[1] = _cut_after_header(bufs[1], 1)
        if t == 3:
            bufs[0] = bufs[0] + b"\0" * 9000        # over the transfer cap
            bufs[1] = b"\x00\x00\x80garbage"        # a rejected header
        raised.append(_device_step(jd, td, bufs, mask))
        statuses.append(td.fetch_status().copy())
        if t == 1:
            assert bufs[1] is not None              # masked, not absent
    assert raised[3] is not None and raised[:3] == [None] * 3
    assert statuses[0][3] != 0                      # MQ: UNIMPLEMENTED
    assert td._running[2] & UMV and td._running[3] & MQ
    assert (statuses[2][:2] != 0).any()             # a cut or flipped lane
    for deblock in (True, None):
        np.testing.assert_array_equal(td.present_rgba(deblock).numpy(),
                                      np.asarray(jd.present_rgba(deblock)))


def test_standard_device_decoder_custom_size_d3():
    """A custom-size bucket: PLUSPTYPE + CPFMT headers throughout, MVDs in
    table D.3 with the extended range, and its skip frame in the same
    flavour for a masked lane."""
    dims = (48, 32)
    streams = [C.d3_corpus(*dims, 4, seed=21), C.d3_corpus(*dims, 4, seed=22),
               C.build_corpus(*dims, 4, seed=23, standard=True)]
    jd, td = _device_twins(3, dims)
    assert td._skip_frame_bytes() == jd._skip_frame_bytes()
    for t in range(4):
        mask = [True, t != 2, True]
        _device_step(jd, td, [s[t] for s in streams], mask)
    assert (td.fetch_status() == 0).all()


def test_standard_device_decoder_slots_and_window():
    td = DeviceFrontendDecoder(2, *SQ, NONE, device="cpu")
    with pytest.raises(ValueError, match="native header prep"):
        td.decode_steps([[None, None]])
    td.decode_step([C.umv_corpus(*SQ, 1)[0], None])
    assert td._running[0] & UMV and td._pictures[0] is not None
    td.reset_slot_state(0, MQ)
    assert td._running[0] == MQ and td._pictures[0] is None
    td.reset_slot_state(0)
    assert td._running[0] == PictureOption.NONE


# -- BatchedStreamDecoder -------------------------------------------------------

def _batch_step(jb, tb, bufs, mask=None, transport="auto"):
    errs = []
    for dec in (jb, tb):
        try:
            dec.decode_step(bufs, mask=mask, transport=transport)
            errs.append(None)
        except (JaxH263Error, H263Error) as e:
            errs.append(type(e).__name__)
    assert errs[0] == errs[1]
    for name in ("ref_y", "ref_cb", "ref_cr"):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      _np(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(tb._std_prev_fmt, jb._std_prev_fmt)
    for a, b in zip(tb.states, jb.states):
        assert (int(a.running_options), a.has_reference,
                _fields(a.last_header)) == (int(b.running_options),
                                            b.has_reference,
                                            _fields(b.last_header))
    return errs[1]


def test_standard_batch_decoder_matches_jax():
    """Plain-PTYPE steps parse in one native call; the step with the UMV
    stream's PLUSPTYPE I-frame replays in Python, and so does the next one
    (the stream's last header is not a PTYPE one); its P-frames decode
    under the carried UMV.  A masked lane, a corrupt step (it raises with
    nothing committed) and steps over a small pack_cap (the dense replay)
    follow."""
    T = 5
    streams = [C.build_corpus(*SQ, T, seed=31, standard=True),
               C.umv_corpus(*SQ, T),
               C.build_corpus(*SQ, T, seed=32, standard=True)]
    jb = JaxBatch(3, *SQ, JaxOption.NONE)
    tb = BatchedStreamDecoder(3, *SQ, NONE, device="cpu")
    trace.reset_metrics()
    for t in range(T):
        bufs = [s[t] for s in streams]
        mask = [True, t != 2, True]
        assert _batch_step(jb, tb, bufs, mask) is None
        if t == 0:
            # The PLUSPTYPE I-frame replays in Python, and marks its stream.
            assert trace.get_counters()["std_python_header_replays"] == 1
            assert tb._std_prev_fmt[1] == -2
    assert trace.get_counters()["std_python_header_replays"] >= 2
    assert tb.states[1].running_options & UMV
    corrupt = [s[T - 1] for s in streams]
    corrupt[2] = corrupt[2][:5]                     # a header cut short
    assert _batch_step(jb, tb, corrupt) is not None
    small_j = JaxBatch(3, *SQ, JaxOption.NONE, pack_cap=64)
    small_t = BatchedStreamDecoder(3, *SQ, NONE, pack_cap=64, device="cpu")
    before = trace.get_counters().get("pack_overflow_fallbacks", 0)
    for t in range(2):
        _batch_step(small_j, small_t, [s[t] for s in streams])
    assert trace.get_counters()["pack_overflow_fallbacks"] > before
    for deblock in (True, None):
        np.testing.assert_array_equal(tb.present_rgba(deblock).numpy(),
                                      np.asarray(jb.present_rgba(deblock)))


def test_standard_batch_custom_dims_and_skip_frame():
    """A custom-size bucket (PLUSPTYPE + CPFMT, every step through the
    Python headers) pads an absent slot with its own skip frame."""
    w, h = 64, 48
    nmb = (w // 16) * (h // 16)
    f0 = encode_standard_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[640] * 6)] * nmb)
    f1 = encode_standard_picture(
        w, h, PictureTypeCode.P_FRAME,
        [MBSpec(kind="inter", mvd=[(2, 0)],
                blocks=[[(0, 4)], [], [], [], [], []])] * nmb,
        temporal_reference=1)
    jb = JaxBatch(2, w, h, JaxOption.NONE)
    tb = BatchedStreamDecoder(2, w, h, NONE, device="cpu")
    assert tb.skip_frame_bytes() == jb.skip_frame_bytes()
    _batch_step(jb, tb, [f0, f0])
    kept = tb.ref_y[1].numpy().copy()
    _batch_step(jb, tb, [f1, None], mask=np.array([True, False]))
    np.testing.assert_array_equal(tb.ref_y[1].numpy(), kept)


def test_standard_batch_python_headers_equal_native():
    """The Python header replay forced on every step gives the native
    parse's planes and header state (tests/test_parallel.py's
    test_native_matches_python_headers, on the port)."""
    streams = [C.build_corpus(*SQ, 4, seed=40 + i, standard=True)
               for i in range(3)]
    fast = BatchedStreamDecoder(3, *SQ, NONE, device="cpu")
    slow = BatchedStreamDecoder(3, *SQ, NONE, device="cpu")

    def punt(*args, **kwargs):
        raise bindings.NeedsPythonHeader(-1)
    slow._parse_std_native = punt
    for t in range(4):
        bufs = [s[t] for s in streams]
        np.testing.assert_array_equal(fast.decode_step(bufs)[0].numpy(),
                                      slow.decode_step(bufs)[0].numpy())
    for a, b in zip(fast.states, slow.states):
        assert (int(a.running_options), a.has_reference,
                _fields(a.last_header)) == (int(b.running_options),
                                            b.has_reference,
                                            _fields(b.last_header))
    np.testing.assert_array_equal(fast._std_prev_fmt, slow._std_prev_fmt)
    piped = BatchedStreamDecoder(3, *SQ, NONE, device="cpu")
    outs = list(piped.decode_stream_pipelined(
        [[s[t] for s in streams] for t in range(4)]))
    np.testing.assert_array_equal(outs[-1][0].numpy(), fast.ref_y.numpy())
    assert piped.last_transfer_bytes > 0 and piped.last_transfer_s > 0


def test_standard_native_bindings():
    assert bindings.native_option_masks() == (int(OPPTYPE_OPTIONS),
                                              int(MPPTYPE_OPTIONS))
    nmb = 48
    with pytest.raises(ValueError):
        bindings.StandardBatchParser(
            2, *SQ, np.zeros((2, 10), np.uint8),
            np.zeros((2, nmb * 8), np.int16), np.zeros((2, nmb), np.uint8),
            np.zeros(nmb * 8, np.int16))
    rows = np.zeros((1, 3 * 512), np.uint8)
    mvs = np.zeros((1, nmb * 8), np.int16)
    inter = np.zeros((1, nmb), np.uint8)
    p = bindings.StandardBatchParser(1, *SQ, rows, mvs, inter,
                                     np.zeros(nmb * 8, np.int16))
    with pytest.raises(bindings.NeedsPythonHeader):
        p.parse([C.umv_corpus(*SQ, 1)[0]], [False])
    hdr, counts, flags = p.parse(
        [C.build_corpus(*SQ, 1, seed=5, standard=True)[0]], [False])
    assert counts[0] > 0 and hdr[0, 8] == 1 and flags[0] & 1 == 0
