"""The port's single-stream decoder against the JAX package's.

`h263_tpu_torch.H263Decoder(device="cpu")` (the plain reconstruction and
presentation) decodes the same bytes as the JAX `H263Decoder` with both of
its backends, `numpy` (the scalar oracle) and `jax` (XLA on the CPU):
every case of tests/test_e2e.py (resolution changes, the reference-picture
quirk, error atomicity, standard GOPs, UMV, GOB resync), disposable
frames, I-frames whose tail macroblocks predict from an old-size
reference, P-frames at a new size with motion in both directions, the
small ffmpeg fixtures and the encoder's GOPs.  Zero tolerance: planes,
error classes, the reader's position after a failure, the decoder's state
and `last_picture_rgba` with the deblock left to the stream, forced on and
forced off.  The frames come from the JAX package's encoder (the port's
copy is held equal to it by test_torch_tables.py).

Also here: the parser's block classes, which the JAX single path hands to
its IDCT, against the classes the fused kernel derives from the dense
block, over a fuzz corpus (zigzag overflow, i16 wrap, DC-only blocks).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu import DecoderOption as JOpt  # noqa: E402
from h263_tpu import H263Decoder as JaxDecoder  # noqa: E402
from h263_tpu import PictureTypeCode  # noqa: E402
from h263_tpu.bitio import BitReader as JaxReader  # noqa: E402
from h263_tpu.testing import fuzz as jfuzz  # noqa: E402
from h263_tpu.testing.encoder import (  # noqa: E402
    BitWriter,
    MBSpec,
    encode_sorenson_picture,
    encode_standard_picture,
)
from h263_tpu_torch import BitReader, DecoderOption, H263Decoder  # noqa: E402
from h263_tpu_torch import DecodedPicture  # noqa: E402
from h263_tpu_torch.decoder.reconstruct import FrameStaging  # noqa: E402
from h263_tpu_torch.io.flv import iter_flv_video_tags  # noqa: E402
from h263_tpu_torch.ops import present_cuda, reconstruct_cuda  # noqa: E402
from h263_tpu_torch.ops.idct import derive_classes  # noqa: E402
from h263_tpu_torch.parser.frame import parse_frame_auto  # noqa: E402
from h263_tpu_torch.parser.picture import decode_picture  # noqa: E402
from h263_tpu_torch.testing import corpora as C  # noqa: E402
from h263_tpu_torch.types import H263Error  # noqa: E402
from test_torch_reference_native import require_reference_native  # noqa: E402

FIX = pathlib.Path(__file__).parent / "fixtures"
SOR = JOpt.SORENSON_SPARK_BITSTREAM
P, I, DP = (PictureTypeCode.P_FRAME, PictureTypeCode.I_FRAME,
            PictureTypeCode.DISPOSABLE_P_FRAME)


def _nmb(w, h):
    return (-(-w // 16)) * (-(-h // 16))


def _gray(w, h, dc=1024, quant=8, tr=0, n=None, **kw):
    mbs = [MBSpec(kind="intra", intradc=[dc] * 6)] * (n or _nmb(w, h))
    return encode_sorenson_picture(w, h, I, mbs, quantizer=quant,
                                   temporal_reference=tr, **kw)


def _textured(w, h, seed, tr=0, n=None):
    """An I-frame with a distinct DC and AC pattern in every block."""
    rng = np.random.default_rng(seed)
    mbs = [MBSpec(kind="intra",
                  intradc=[int(rng.integers(1, 250)) * 8 for _ in range(6)],
                  blocks=[[(int(rng.integers(0, 6)), int(rng.integers(1, 9)))]
                          for _ in range(6)])
           for _ in range(n or _nmb(w, h))]
    return encode_sorenson_picture(w, h, I, mbs, temporal_reference=tr)


def _moving(w, h, seed, tr, reach=30):
    """A P-frame at w x h: random MVDs (4V in some macroblocks) that reach
    past every edge, residuals, uncoded macroblocks."""
    rng = np.random.default_rng(seed)
    mbs = []
    for _ in range(_nmb(w, h)):
        roll = rng.random()
        if roll < 0.15:
            mbs.append(MBSpec(kind="uncoded"))
            continue
        nmv = 4 if roll > 0.8 else 1
        mvd = [(int(rng.integers(-reach, reach + 1)),
                int(rng.integers(-reach, reach + 1))) for _ in range(nmv)]
        mbs.append(MBSpec(kind="inter" if nmv == 1 else "inter4v", mvd=mvd,
                          blocks=[[(int(rng.integers(0, 9)),
                                    int(rng.integers(-9, 10)) or 1)]
                                  if rng.random() < 0.5 else []
                                  for _ in range(6)]))
    return encode_sorenson_picture(w, h, P, mbs, temporal_reference=tr)


def _disposable(w, h, tr, coded=False):
    """A disposable P-frame.  The reference decodes only uncoded
    macroblocks in one (padding with 1 bits reads as more of them); a
    coded one is UnimplementedDecoding (macroblock.rs:461-464)."""
    mbs = [MBSpec(kind="inter", mvd=[(2, 0)]) if coded
           else MBSpec(kind="uncoded")] * _nmb(w, h)
    return encode_sorenson_picture(w, h, DP, mbs, temporal_reference=tr,
                                   pad_bit=1)


def _p(w, h, mbs, tr, **kw):
    return encode_sorenson_picture(w, h, P, mbs, temporal_reference=tr, **kw)


def _std_iframe(tr=0, dc=800):
    return encode_standard_picture(
        128, 96, I, [MBSpec(kind="intra", intradc=[dc] * 6)] * 48,
        temporal_reference=tr)


def _gob_resync_frame():
    """tests/test_e2e.py's: two uncoded macroblocks, an invalid MCBPC, then
    a picture start code."""
    w = BitWriter()
    w.write_bits(1, 17)
    w.write_bits(0, 5)
    w.write_bits(1, 8)
    w.write_code("10").write_code("000").write_bits(1, 3)
    w.write_code("00000")
    w.write_bits(8, 5)
    w.write_bits(0, 1)
    w.write_bits(0, 1)
    for _ in range(2):
        w.write_bits(1, 1)
    w.write_bits(0, 1)
    w.write_code("0000000000")
    while len(w) % 8:
        w.write_bits(0, 1)
    w.write_bits(1, 17)
    w.write_bits(0, 5)
    return w.to_bytes()


def _gob_header_only():
    """A byte-aligned GOB header (GN 3), no picture start code: the
    picture-header parse finds no picture (MiddleOfBitstream)."""
    w = BitWriter()
    w.write_bits(1, 17)
    w.write_bits(3, 5)
    w.write_bits(0, 2)
    w.write_bits(8, 5)
    while len(w) % 8:
        w.write_bits(0, 1)
    return w.to_bytes() + b"\x55" * 8


def _ac_mb():
    return MBSpec(kind="intra", intradc=[1024, 512, 256, 1024, 800, 264],
                  blocks=[[(0, 30), (2, -5)], [(1, 1)], [], [(0, -100)],
                          [(63, 2)], [(5, 600)]])


def _residual(level):
    return [[(0, level)], [], [], [], [], []]


# name -> (frames, decoder options, check RGBA after every frame)
CASES = {
    "single_mb_gray": lambda: ([_gray(16, 16)], SOR, True),
    "cif_gray": lambda: ([_gray(352, 288, dc=512)], SOR, False),
    "odd_dims": lambda: ([_gray(100, 62)], SOR, True),
    "ac_coefficients": lambda: ([encode_sorenson_picture(
        16, 16, I, [_ac_mb()], quantizer=7, version=1)], SOR, True),
    "tail_fill_without_reference": lambda: ([
        _gray(32, 32, n=1), _gray(32, 32, dc=800),
        _p(32, 32, [MBSpec(kind="uncoded")] * 4, 1)], SOR, True),
    "uncoded_copy": lambda: ([
        _gray(32, 16, dc=800), _p(32, 16, [MBSpec(kind="uncoded")] * 2, 1)],
        SOR, True),
    "zero_mv_residual": lambda: ([
        _gray(16, 16, dc=800),
        _p(16, 16, [MBSpec(kind="inter", mvd=[(0, 0)],
                           blocks=_residual(3))], 1)], SOR, True),
    "fullpel_motion": lambda: ([
        encode_sorenson_picture(32, 32, I, [
            MBSpec(kind="intra", intradc=[512 + 8 * i] * 6,
                   blocks=[[(0, 20)], [], [(1, -7)], [], [], []])
            for i in range(4)]),
        _p(32, 32, [MBSpec(kind="inter", mvd=[(-4, 2)])]
           + [MBSpec(kind="uncoded")] * 3, 1)], SOR, True),
    "halfpel_motion": lambda: ([
        _textured(16, 16, 1), _p(16, 16, [MBSpec(kind="inter",
                                                 mvd=[(1, 1)])], 1)],
        SOR, True),
    "mv_prediction_chain": lambda: ([
        _textured(64, 32, 2),
        _p(64, 32, [MBSpec(kind="inter", mvd=[m]) for m in
                    [(2, 0), (2, 2), (-4, 6), (8, -2), (0, 0), (6, 6),
                     (-2, -2), (4, 0)]], 1)], SOR, True),
    "inter4v": lambda: ([
        _textured(32, 32, 3),
        _p(32, 32, [MBSpec(kind="inter", mvd=[(2, 0), (0, 2), (-2, 0),
                                               (1, 1)])]
           + [MBSpec(kind="uncoded")] * 3, 1)], SOR, True),
    "dquant_running_scan": lambda: ([
        _gray(48, 16, dc=800),
        _p(48, 16, [MBSpec(kind="inter", mvd=[(0, 0)], dquant=d,
                           blocks=_residual(4)) for d in (2, -1, 2)], 1,
           quantizer=8)], SOR, True),
    "gop_chain_and_iframe_reset": lambda: ([_gray(16, 16, dc=800)] + [
        _p(16, 16, [MBSpec(kind="inter", mvd=[(0, 0)],
                           blocks=_residual(1))], tr) for tr in (1, 2, 3)]
        + [_gray(16, 16, dc=512, tr=4)], SOR, True),
    "state_survives_bad_frame": lambda: ([
        _gray(16, 16, dc=800), b"\x00\x01\x02",
        _p(16, 16, [MBSpec(kind="uncoded")], 1)], SOR, True),
    "deblocker_flag": lambda: ([
        _gray(32, 32, dc=808, quant=9, deblocker=True),
        _moving(32, 32, 4, 1)], SOR, True),
    "iframe_resolution_change": lambda: ([
        _gray(32, 32, dc=800), _gray(64, 48, dc=512, tr=1),
        _p(64, 48, [MBSpec(kind="uncoded")] * 12, 2)], SOR, True),
    "pframe_resolution_change_with_motion": lambda: ([
        _gray(32, 32, dc=800),
        _p(48, 48, [MBSpec(kind="inter", mvd=[(0, 0)])] * 9, 1)], SOR, True),
    # Both directions, with motion that reaches past every edge of the
    # old-size reference, at sizes that are not multiples of 16.
    "pframe_size_change_smaller_to_larger": lambda: ([
        _textured(40, 24, 5), _moving(72, 58, 6, 1),
        _moving(72, 58, 7, 2)], SOR, True),
    "pframe_size_change_larger_to_smaller": lambda: ([
        _textured(88, 70, 8), _moving(36, 22, 9, 1),
        _moving(36, 22, 10, 2)], SOR, True),
    # An I-frame that ends early: its tail macroblocks are INTER with MV 0
    # and predict from the old-size reference.
    "iframe_tail_fill_over_smaller_reference": lambda: ([
        _textured(40, 24, 11), _moving(40, 24, 12, 1),
        _textured(72, 58, 13, tr=2, n=7)], SOR, True),
    "iframe_tail_fill_over_larger_reference": lambda: ([
        _textured(88, 70, 14), _textured(36, 22, 15, tr=1, n=2),
        _moving(36, 22, 16, 2)], SOR, True),
    # Disposable frames never become references; the reference-picture
    # quirk returns the last picture, the disposable one included.
    "disposable_frames": lambda: ([
        _textured(48, 32, 17), _moving(48, 32, 18, 1),
        _disposable(48, 32, 2), _moving(48, 32, 20, 3),
        _disposable(48, 32, 4, coded=True), _disposable(48, 32, 5),
        _disposable(48, 32, 6), _moving(48, 32, 23, 7)], SOR, True),
    "standard_gop": lambda: ([_std_iframe(), encode_standard_picture(
        128, 96, P, [MBSpec(kind="inter", mvd=[(2, -2)],
                            blocks=_residual(4))] * 48,
        temporal_reference=1)], JOpt.NONE, True),
    "umv_motion_vectors": lambda: ([_std_iframe(), encode_standard_picture(
        128, 96, P, [MBSpec(kind="inter", mvd=[(4, 6)])] * 48,
        temporal_reference=1, umv=True)], JOpt.NONE, True),
    "gob_resync_recovery": lambda: ([_std_iframe(), _gob_resync_frame()],
                                    JOpt.NONE, True),
    "middle_of_bitstream": lambda: ([_std_iframe(), _gob_header_only(),
                                     _gob_resync_frame()], JOpt.NONE, True),
    # PLUSPTYPE: a P-frame with UFEP 000 names no format, so as a first
    # picture it has none to inherit (PictureFormatMissing), and after one
    # the reference's format-change rule refuses it (UnimplementedDecoding,
    # picture.rs:540-545); the UMV of an OPPTYPE carries into plain
    # P-frames.
    "plusptype_format_rules": lambda: ([
        C.plusptype_picture(176, 144, P, ufep=False),
        *C.umv_corpus(176, 144, 3),
        C.plusptype_picture(176, 144, P, [MBSpec(kind="uncoded")] * 99,
                            ufep=False, temporal_reference=9)],
        JOpt.NONE, True),
    # The MQ mirror: the native parse decodes an MQ picture the Python
    # parser refuses, in both packages.
    "modified_quantization_picture": lambda: ([
        C.mq_picture(176, 144), *C.std_qcif_corpus()[1:3]], JOpt.NONE,
        True),
    # Every kind of size change in one stream (testing/corpora.py), the
    # sequence chip_smoke.py decodes on the card.
    "resize_sequence": lambda: (C.resize_sequence(), SOR, True),
    "480p": lambda: ([encode_sorenson_picture(
        640, 480, I, [MBSpec(kind="intra", intradc=[int(v) * 8] * 6)
                      for v in np.random.default_rng(5).integers(1, 128,
                                                                 1200)]),
        _p(640, 480, [MBSpec(kind="inter", mvd=[(2, -2)])] * 1200, 1)],
        SOR, False),
}


def _outcome(dec, reader):
    try:
        return None, dec.decode_next_picture(reader)
    except Exception as e:  # noqa: BLE001 -- the two packages' classes
        return type(e).__name__, None


def _state(dec):
    ref = dec.get_reference_picture()
    return (dec.last_picture, dec.reference_picture,
            int(dec.running_options), sorted(dec.reference_states),
            None if ref is None else ref.as_header().temporal_reference)


def _equal_planes(a, b, tag):
    for name, x, y in zip(("y", "cb", "cr"), a.as_yuv(), b.as_yuv()):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, f"{tag} {name}: {x.shape} vs {y.shape}"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} plane {name}")


def decode_side_by_side(frames, opts, rgba, backends=("numpy", "jax")):
    """Decode `frames` with the port on the CPU and the JAX decoder of
    each backend; hold outcomes, reader positions, state and RGBA equal.
    Returns the port's decoder and the number of frames decoded.

    The JAX side parses with its native front-end, the JAX package's
    default, which the port follows."""
    require_reference_native()
    jdecs = [JaxDecoder(opts, backend=b) for b in backends]
    port = H263Decoder(DecoderOption(int(opts)), device="cpu")
    decoded = 0
    for t, buf in enumerate(frames):
        jr = [JaxReader(bytes(buf)) for _ in jdecs]
        want = [_outcome(d, r) for d, r in zip(jdecs, jr)]
        pr = BitReader(bytes(buf))
        err, pic = _outcome(port, pr)
        for b, (werr, wpic), r, d in zip(backends, want, jr, jdecs):
            tag = f"frame {t} vs {b}"
            assert err == werr, f"{tag}: port {err}, JAX {werr}"
            assert pr.pos == r.pos, f"{tag}: reader at {pr.pos} vs {r.pos}"
            assert _state(port) == _state(d), tag
            if pic is not None:
                _equal_planes(pic, wpic, tag)
                assert isinstance(pic, DecodedPicture)
                assert pic.luma.dtype == torch.uint8
        if pic is None:
            continue
        decoded += 1
        _equal_planes(port.get_last_picture(), jdecs[0].get_last_picture(),
                      f"frame {t} last picture")
        if rgba:
            for deblock in (None, True, False):
                np.testing.assert_array_equal(
                    port.last_picture_rgba(deblock),
                    jdecs[0].last_picture_rgba(deblock),
                    err_msg=f"frame {t} RGBA deblock={deblock}")
    return port, decoded


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_decoder_on_every_e2e_case(case):
    frames, opts, rgba = CASES[case]()
    _, decoded = decode_side_by_side(frames, opts, rgba)
    assert decoded >= 1


def test_error_cases_raise_the_reference_classes():
    """The named failures, each with the decoder left as it was: INTER
    with no reference, no picture start, no format on a first P-frame."""
    cases = {
        "UncodedIFrameBlocks": _gray(32, 32, n=1),
        "MiddleOfBitstream": _gob_header_only(),
    }
    for name, buf in cases.items():
        opts = (DecoderOption.NONE if name == "MiddleOfBitstream"
                else DecoderOption.SORENSON_SPARK_BITSTREAM)
        dec = H263Decoder(opts, device="cpu")
        r = BitReader(buf)
        with pytest.raises(H263Error) as info:
            dec.decode_next_picture(r)
        assert type(info.value).__name__ == name
        assert r.pos == 0 and dec.get_last_picture() is None
        assert dec.last_picture_rgba() is None


@pytest.mark.parametrize("name", ["odd", "qcif", "cutstorm"])
def test_matches_jax_decoder_on_ffmpeg_fixtures(name):
    """Every frame of the small ffmpeg fixtures; the RGBA of the last."""
    data = (FIX / f"ffmpeg_flv1_{name}.flv").read_bytes()
    tags = [t.payload for t in iter_flv_video_tags(data)]
    port, decoded = decode_side_by_side(tags, SOR, rgba=False)
    assert decoded == len(tags)
    golden = np.load(FIX / f"ffmpeg_flv1_{name}_golden.npz")["luma"]
    assert port.get_last_picture().as_luma().shape == golden[-1].shape
    jdec = JaxDecoder(SOR, backend="numpy")
    for p in tags:
        jdec.decode_next_picture(p)
    for deblock in (None, True, False):
        np.testing.assert_array_equal(port.last_picture_rgba(deblock),
                                      jdec.last_picture_rgba(deblock))


ENCODER_GOPS = {
    "rich_gop_v1": lambda: (C.rich_gop(31, 48, 32, 6, version=1), SOR),
    "rich_gop_v0": lambda: (C.rich_gop(32, 64, 48, 6, version=0), SOR),
    "q0": lambda: (C.qcif_corpus(0), SOR),
    "fma": lambda: (C.fma_sequence(48, 32, 4), SOR),
    "sq0": lambda: (C.std_qcif_corpus(), JOpt.NONE),
    "d0": lambda: (C.d3_corpus(176, 144, 4), JOpt.NONE),
    "u0_qcif": lambda: (C.umv_corpus(176, 144, 4), JOpt.NONE),
}


@pytest.mark.parametrize("gop", sorted(ENCODER_GOPS))
def test_matches_jax_decoder_on_encoder_gops(gop):
    frames, opts = ENCODER_GOPS[gop]()
    _, decoded = decode_side_by_side(frames, opts, rgba=False,
                                     backends=("numpy",))
    assert decoded == len(frames)


def test_fma_sequence_gives_156():
    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device="cpu")
    for t, buf in enumerate(C.fma_sequence(48, 32, 3)):
        y = dec.decode_next_picture(buf).as_luma()
        assert y[0, 2] == (156 if t else 128)


def test_cpu_decoder_takes_the_plain_versions_and_cuda_raises_without_card():
    before = (reconstruct_cuda.launches, present_cuda.launches)
    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device="cpu")
    dec.decode_next_picture(_gray(32, 32))
    dec.last_picture_rgba()
    assert (reconstruct_cuda.launches, present_cuda.launches) == before
    assert dec.get_last_picture().luma.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            H263Decoder()
    with pytest.raises(ValueError):
        H263Decoder(device="meta")


def test_accessors_return_host_copies():
    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device="cpu")
    pic = dec.decode_next_picture(_gray(40, 24))
    y = pic.as_luma()
    y[:] = 0
    assert (pic.as_luma() == 128).all()
    assert (pic.width, pic.height) == (40, 24)
    assert DecodedPicture.dims(pic.format) == (40, 24, 20, 12)
    assert pic.luma_samples_per_row() == 40
    assert pic.chroma_samples_per_row() == 20
    assert pic.as_chroma_b().shape == pic.as_chroma_r().shape == (12, 20)


def _class_corpus(seed, n=60, w=48, h=32):
    """Fuzzed Sorenson frames (the JAX fuzz corpus's generator and
    mutations), rich GOPs with zigzag-overflow discards, and frames whose
    v1 11-bit escapes wrap in int16 at quantizers >= 17."""
    rng = np.random.default_rng(seed)
    bufs = []
    for _ in range(n):
        base = jfuzz._rand_frame(rng, w, h)
        bufs.append(base)
        bufs.append(jfuzz._mutate(rng, base,
                                  lambda: jfuzz._rand_frame(rng, w, h)))
    bufs += C.rich_gop(seed, w, h, 5, version=1)
    for q in (17, 23, 31):
        mbs = [MBSpec(kind="intra", intradc=[8] * 6,
                      blocks=[[(0, int(v))] for v in
                              rng.choice([1023, -1023, 1000, -700, 0x2AA],
                                         6)])
               for _ in range(_nmb(w, h))]
        bufs.append(encode_sorenson_picture(w, h, I, mbs, quantizer=q,
                                            version=1))
        # DC-only blocks, some with a DC that dequantizes to zero.
        mbs = [MBSpec(kind="inter", mvd=[(0, 0)],
                      blocks=[[(0, int(v))] for v in
                              rng.choice([1, -1, 3], 6)])
               for _ in range(_nmb(w, h))]
        bufs.append(encode_sorenson_picture(w, h, P, mbs, quantizer=q,
                                            version=1))
    return bufs


def test_parser_classes_equal_the_classes_derived_from_dense_blocks():
    """The JAX single path's IDCT takes the parser's classes; the fused
    kernel derives them from the dense tensor the staging builds."""
    opts = DecoderOption.SORENSON_SPARK_BITSTREAM
    staging = FrameStaging("cpu")
    checked = 0
    for buf in _class_corpus(3):
        r = BitReader(buf)
        try:
            pic = decode_picture(r, opts, None)
            if pic is None:
                continue
            w, h = pic.format.width_and_height()
            frame = parse_frame_auto(r, pic, opts, pic.options, w, h)
        except H263Error:
            continue
        dense, mvs, inter = staging.to_device(frame)
        want = np.concatenate([frame.class_y.reshape(-1),
                               frame.class_cb.reshape(-1),
                               frame.class_cr.reshape(-1)])
        got = derive_classes(dense[0]).numpy().reshape(-1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mvs[0].numpy(), frame.mvs)
        np.testing.assert_array_equal(inter[0].numpy(),
                                      frame.inter.astype(np.uint8))
        checked += 1
    assert checked >= 60
