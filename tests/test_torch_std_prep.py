"""The native standard header prep of the device front-end
(`native.StandardPrepBatch`, `native/std_prep.cpp`) on the CPU.

* The prep of `DeviceFrontendDecoder(..., DecoderOption.NONE)` against the
  Python loop it replaced (the JAX package's loop body, `_prepare_lane`,
  over every lane of a twin decoder), step for step: the staged payload
  byte for byte (and the stage zeroed past it), meta, the first error's
  class and message, and the committed state (`_pictures` through
  `picture_to_dict`, `_running`, `_last_quant`, `_last_deblock`).  The
  cases: plain-PTYPE GOPs, CPM with PSBI, PEI bytes, PLUSPTYPE streams
  that hand their lanes back and then return to plain PTYPE, a format
  change, other dims, an over-cap frame, masked and None lanes, byte-
  flipped and cut frames (the fuzz `_mutate`), header bits flipped at
  random, a GOB header, a batch where only some lanes are handed back, a
  custom-size bucket (every lane handed back) and the scalability option.
* `decode_step` against the JAX package's `DeviceFrontendDecoder` with
  `DecoderOption.NONE`: planes, statuses, the error's class and message,
  the header state and RGBA; at 128x96 and QCIF, and over a two-shard
  mesh on the CPU; a checkpoint saved after native steps loads into the
  JAX decoder, equal to the JAX decoder's own, and decodes on alike.
* The binding: argument checks, the stage's cap, given lanes.

Sizes are small (128x96, QCIF and 48x32, 3-8 streams)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu.parallel.device_batch import (  # noqa: E402
    DeviceFrontendDecoder as JaxDevice,
)
from h263_tpu.types import DecoderOption as JaxOption  # noqa: E402
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu.utils import checkpoint as jck  # noqa: E402
from h263_tpu_torch import DeviceFrontendDecoder, native  # noqa: E402
from h263_tpu_torch.parallel import make_stream_mesh  # noqa: E402
from h263_tpu_torch.testing import corpora as C  # noqa: E402
from h263_tpu_torch.testing import fuzz  # noqa: E402
from h263_tpu_torch.types import DecoderOption, H263Error  # noqa: E402
from h263_tpu_torch.utils import checkpoint as tck  # noqa: E402
from h263_tpu_torch.utils import trace  # noqa: E402
from test_torch_pool import _np  # noqa: E402

NONE = DecoderOption.NONE
SQ = (128, 96)       # the smallest plain-PTYPE size


# -- frames -------------------------------------------------------------------

def _bits(frame: bytes) -> str:
    return "".join(f"{b:08b}" for b in frame)


def _frame(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def with_header(frame: bytes, psbi=None, pei: bytes = b"") -> bytes:
    """An encoder's plain-PTYPE frame (CPM and PEI 0 at bits 48 and 49)
    with CPM on and PSBI `psbi`, and/or the PEI bytes `pei`."""
    b = _bits(frame)
    assert b[48:50] == "00"
    cpm = "0" if psbi is None else "1" + f"{psbi:02b}"
    return _frame(b[:48] + cpm + "".join("1" + f"{x:08b}" for x in pei)
                  + "0" + b[50:])


def flip_header_bits(rng, frame: bytes, k: int) -> bytes:
    """`frame` with `k` random bits of its first 56 flipped."""
    b = bytearray(frame)
    for p in rng.integers(0, min(56, 8 * len(b)), size=k):
        b[p // 8] ^= 0x80 >> (p % 8)
    return bytes(b)


def shifted(frame: bytes) -> bytes:
    """`frame` one bit later: its start code at bit 1, which the start-code
    search still finds (the reference's off-by-one)."""
    return _frame("0" + _bits(frame))


def gob_header(frame: bytes) -> bytes:
    """`frame` with a nonzero GOB number where its picture's GN 0 is."""
    b = _bits(frame)
    return _frame(b[:17] + "00011" + b[22:])


def std_gop(dims, n, seed):
    return C.build_corpus(*dims, n, seed=seed, standard=True)


# -- the prep against the Python loop -----------------------------------------

def _prep_native(dec, buffers):
    """The decoder's prep of one step (unsharded): (payload through the
    spare word, meta, first error, stage past the spare word)."""
    sh = dec._shards[0]
    skip = dec._skip_frame_bytes()
    bufs = [skip if b is None else bytes(b) for b in buffers]
    size = sum(max(len(b), len(skip)) + 4 for b in bufs) + 64
    flat = np.full(size, 0xA5, dtype=np.uint8)    # stale bytes
    meta = np.full((6, dec.n), -7, dtype=np.int32)
    words, err = dec._prepare_standard(sh, buffers, bufs, flat, meta)
    return (flat[:4 * words + 4].tobytes(), meta, err,
            flat[4 * words + 4:])


def _prep_python(dec, buffers):
    """The Python loop the native prep replaced, from the loop body: each
    lane's bytes padded to whole words back to back, and the spare word."""
    parts, woff, first = [], 0, None
    meta = np.zeros((6, dec.n), dtype=np.int32)
    for i, b in enumerate(buffers):
        data, rows, err = dec._prepare_lane(i, b)
        words = (len(data) + 3) // 4
        parts.append(bytes(data) + b"\0" * (4 * words - len(data)))
        meta[:4, i] = rows
        meta[5, i] = woff
        woff += words
        if first is None:
            first = err
    return b"".join(parts) + b"\0" * 4, meta, first


def _state(dec):
    return ([tck.picture_to_dict(p) for p in dec._pictures],
            [int(r) for r in dec._running], dec._last_quant.tolist(),
            dec._last_deblock.tolist())


def _err(e):
    return None if e is None else (type(e).__name__, str(e))


def run_prep_twins(dims, steps, options=NONE, **kw):
    """Drive a native and a Python-loop decoder alike through `steps`
    (lists of buffers, None absent), equal after every step.  Returns the
    lanes handed back per step and the errors."""
    n = len(steps[0])
    fast = DeviceFrontendDecoder(n, *dims, options, device="cpu", **kw)
    slow = DeviceFrontendDecoder(n, *dims, options, device="cpu", **kw)
    punted, errs = [], []
    for t, bufs in enumerate(steps):
        before = trace.get_counters().get("std_python_header_lanes", 0)
        payload, meta, err, rest = _prep_native(fast, bufs)
        punted.append(trace.get_counters().get("std_python_header_lanes", 0)
                      - before)
        want_payload, want_meta, want_err = _prep_python(slow, bufs)
        assert payload == want_payload, f"step {t}"
        np.testing.assert_array_equal(meta, want_meta, err_msg=f"step {t}")
        assert not rest.any(), f"step {t}: stale bytes past the payload"
        assert _err(err) == _err(want_err), f"step {t}"
        assert _state(fast) == _state(slow), f"step {t}"
        errs.append(_err(err))
    return punted, errs


def test_plain_ptype_gops_stage_natively():
    steps = list(zip(*[std_gop(SQ, 5, 10 + i) for i in range(5)]))
    punted, errs = run_prep_twins(SQ, [list(s) for s in steps])
    assert punted == [0] * 5 and errs == [None] * 5


def test_qcif_gops_stage_natively():
    steps = list(zip(*[std_gop(C.QCIF, 3, 20 + i) for i in range(3)]))
    punted, _ = run_prep_twins(C.QCIF, [list(s) for s in steps])
    assert punted == [0] * 3


@pytest.mark.parametrize("psbi", [0, 1, 2, 3])
def test_cpm_with_psbi_stages_natively(psbi):
    gops = [std_gop(SQ, 3, 30 + i) for i in range(3)]
    steps = [[with_header(g[t], psbi=psbi) if i != 1 else g[t]
              for i, g in enumerate(gops)] for t in range(3)]
    punted, errs = run_prep_twins(SQ, steps)
    assert punted == [0] * 3 and errs == [None] * 3


def test_start_code_one_bit_in():
    """Headers whose start code begins at bit 1: plain ones (also with
    CPM) stage natively, with the start bit one later; one with PEI bytes
    is handed back."""
    gops = [std_gop(SQ, 3, 35 + i) for i in range(3)]
    steps = [[shifted(gops[0][t]), shifted(with_header(gops[1][t], psbi=1)),
              shifted(with_header(gops[2][t], pei=b"\x80"))]
             for t in range(3)]
    punted, errs = run_prep_twins(SQ, steps)
    assert punted == [1] * 3 and errs == [None] * 3


@pytest.mark.parametrize("psbi", [None, 2])
def test_pei_bytes_hand_the_lane_back(psbi):
    """A header with PEI bytes goes to Python (the native parse skips them,
    `Picture.extra` holds them), and so does only that lane; the stream's
    next plain header stages natively against the Python-parsed one."""
    gops = [std_gop(SQ, 4, 40 + i) for i in range(4)]
    steps = []
    for t in range(4):
        bufs = [g[t] for g in gops]
        if t in (0, 2):
            bufs[1] = with_header(bufs[1], psbi=psbi, pei=b"\x01\xfe")
            bufs[3] = with_header(bufs[3], pei=b"\x00")
        steps.append(bufs)
    punted, errs = run_prep_twins(SQ, steps)
    assert punted == [2, 0, 2, 0] and errs == [None] * 4


def test_plusptype_streams_return_to_plain_ptype():
    """umv_corpus: a PLUSPTYPE I-picture (handed back), its first plain P
    (handed back: the last header is not a plain PTYPE one), then plain
    Ps staged natively under the carried UMV; d3_corpus PLUSPTYPE
    throughout; an MQ picture, then plain Ps under the carried MQ."""
    umv = C.umv_corpus(*C.QCIF, 5)
    d3 = C.d3_corpus(*C.QCIF, 5)
    mq = [C.mq_picture(*C.QCIF)] + std_gop(C.QCIF, 5, 50)[1:]
    plain = std_gop(C.QCIF, 5, 51)
    steps = [[umv[t], d3[t], mq[t], plain[t]] for t in range(5)]
    punted, errs = run_prep_twins(C.QCIF, steps)
    assert punted == [3, 3, 1, 1, 1] and errs == [None] * 5


def test_a_format_change_and_other_dims():
    """A stream whose SQCIF picture is followed by a QCIF one (the
    reference's format-change refusal), and a fresh stream whose first
    frame is QCIF in an SQCIF bucket (the dims check), in Python; the
    lane after them stages natively."""
    a = std_gop(SQ, 3, 60)
    q = std_gop(C.QCIF, 3, 61)
    b = std_gop(SQ, 3, 62)
    steps = [[a[0], q[0], b[0]], [q[1], q[2], b[1]], [a[1], b[0], b[2]]]
    punted, errs = run_prep_twins(SQ, steps)
    assert punted == [1, 2, 0]
    assert errs[0][0] == "H263Error" and "resolution" in errs[0][1]
    assert errs[1][0] == "UnimplementedDecoding"


def test_an_over_cap_frame():
    g = [std_gop(SQ, 2, 70 + i) for i in range(3)]
    cap = max(len(f) for s in g for f in s)
    steps = [[g[0][0], g[1][0] + b"\0" * cap, g[2][0]],
             [g[0][1], g[1][1], g[2][1] + b"\0" * cap]]
    punted, errs = run_prep_twins(SQ, steps, max_frame_bytes=cap)
    assert punted == [1, 1]
    assert all(e and "exceeds transfer bucket" in e[1] for e in errs)


def test_masked_and_absent_lanes():
    """None lanes stage the skip frame against the stream's last header
    and commit nothing, natively; the UMV stream's absent lane parses its
    skip frame against its PLUSPTYPE header, in Python, and so does its
    next frame (the absent lane committed nothing)."""
    umv = C.umv_corpus(*SQ, 4)
    gops = [std_gop(SQ, 4, 80 + i) for i in range(3)]
    steps = []
    for t in range(4):
        bufs = [umv[t]] + [g[t] for g in gops]
        if t >= 1:
            bufs[t - 1] = None
        steps.append(bufs)
    steps.append([None] * 4)
    punted, errs = run_prep_twins(SQ, steps)
    assert punted == [1, 1, 1, 0, 0] and errs == [None] * 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flipped_and_cut_frames(seed):
    """The fuzz library's mutations (byte flips past the start code, cuts,
    spliced and garbage tails) on most lanes of every step."""
    rng = np.random.default_rng(90 + seed)
    gops = [std_gop(SQ, 6, 100 + 8 * seed + i) for i in range(8)]
    steps = []
    for t in range(6):
        bufs = [g[t] for g in gops]
        for i in range(8):
            if rng.random() < 0.6:
                bufs[i] = fuzz._mutate(rng, bufs[i],
                                       lambda: gops[0][int(rng.integers(6))])
        steps.append(bufs)
    punted, _ = run_prep_twins(SQ, steps)
    assert sum(punted) < 48


@pytest.mark.parametrize("seed", range(8))
def test_header_bits_flipped_at_random(seed):
    """One to three of the first 56 bits flipped on most lanes: reserved
    and changed formats, PLUSPTYPE, PB, split-screen and the other
    header options, CPM, PEI, the start code and GN, at random, against
    whatever header each stream holds by then."""
    rng = np.random.default_rng(110 + seed)
    dims = (SQ, C.QCIF)[seed % 2]
    gops = [std_gop(dims, 8, 120 + 8 * seed + i) for i in range(8)]
    steps = []
    for t in range(8):
        bufs = [g[t] for g in gops]
        for i in range(8):
            if rng.random() < 0.7:
                bufs[i] = flip_header_bits(rng, bufs[i],
                                           int(rng.integers(1, 4)))
        steps.append(bufs)
    punted, errs = run_prep_twins(dims, steps)
    assert 0 < sum(punted) < 64 and any(errs)


def test_gob_header_and_garbage():
    g = [std_gop(SQ, 2, 130 + i) for i in range(4)]
    steps = [[g[0][0], gob_header(g[1][0]), b"", b"\x00\x00\x80garbage"],
             [g[0][1], g[1][1], g[2][1], g[3][1]]]
    punted, errs = run_prep_twins(SQ, steps)
    assert punted == [3, 0]
    assert errs[0] == ("H263Error", "outside device front-end scope")


def test_custom_size_hands_every_lane_back():
    """48x32 has no plain-PTYPE format: every header (the skip frame's
    too) is PLUSPTYPE with CPFMT, so every lane takes the Python body."""
    gops = [std_gop((48, 32), 3, 140 + i) for i in range(3)]
    steps = [[g[t] for g in gops] for t in range(3)]
    steps[1][2] = None
    punted, errs = run_prep_twins((48, 32), steps)
    assert punted == [3, 3, 3] and errs == [None] * 3


def test_scalability_option_hands_every_lane_back():
    """With USE_SCALABILITY_MODE a plain header holds four more bits the
    native parse does not read: every lane takes the Python body."""
    gops = [std_gop(SQ, 2, 150 + i) for i in range(3)]
    steps = [[g[t] for g in gops] for t in range(2)]
    punted, _ = run_prep_twins(SQ, steps,
                               NONE | DecoderOption.USE_SCALABILITY_MODE)
    assert punted == [3, 3]


def test_mesh_shards_prep_their_own_lanes():
    """Over a two-shard mesh each shard's prep object covers its lanes;
    a step's staged lanes and state equal an unsharded decoder's."""
    gops = [std_gop(SQ, 3, 160 + i) for i in range(4)]
    umv = C.umv_corpus(*SQ, 3)
    mesh = make_stream_mesh(["cpu"] * 2)
    dec = DeviceFrontendDecoder(4, *SQ, NONE, mesh=mesh)
    one = DeviceFrontendDecoder(4, *SQ, NONE, device="cpu")
    assert [(sh.lo, sh.hi, sh.prep._n) for sh in dec._shards] == \
        [(0, 2, 2), (2, 4, 2)]
    for t in range(3):
        bufs = [gops[0][t], gops[1][t], umv[t], gops[3][t]]
        for sh in dec._shards:
            stage, meta, _ = _mesh_stage(dec, sh, bufs)
            ustage, umeta, _ = _mesh_stage(one, one._shards[0], bufs)
            for k in range(sh.hi - sh.lo):
                assert _lane(stage, meta, k) == \
                    _lane(ustage, umeta, sh.lo + k)
        assert _state(dec) == _state(one)


def _mesh_stage(dec, sh, bufs):
    """One shard's staged step, as `_stage_step` stages it (host side)."""
    skip = dec._skip_frame_bytes()
    mine = [skip if b is None else b for b in bufs[sh.lo:sh.hi]]
    flat = np.zeros(sum(len(b) + 4 for b in mine) + 4, dtype=np.uint8)
    meta = np.zeros((6, sh.hi - sh.lo), dtype=np.int32)
    _, err = dec._prepare_standard(sh, bufs, mine, flat, meta)
    return flat, meta, err


def _lane(flat, meta, k):
    off, nbits = int(meta[5, k]), int(meta[1, k])
    return (flat[4 * off:4 * off + nbits // 8].tobytes(),
            meta[:5, k].tolist())


# -- decode_step against the JAX decoder --------------------------------------

def _jax_twins(S, dims, **kw):
    return (JaxDevice(S, *dims, JaxOption.NONE, unroll=1, **kw),
            DeviceFrontendDecoder(S, *dims, NONE, device="cpu", **kw))


def _jax_step(jd, td, bufs, mask=None):
    """One step of both decoders, equal: the error's class and message,
    planes, statuses and header state."""
    errs = []
    for dec in (jd, td):
        try:
            dec.decode_step(bufs, mask=mask)
            errs.append(None)
        except (JaxH263Error, H263Error) as e:
            errs.append((type(e).__name__, str(e)))
    assert errs[0] == errs[1]
    for name in ("ref_y", "ref_cb", "ref_cr"):
        np.testing.assert_array_equal(_np(getattr(td, name)),
                                      _np(getattr(jd, name)), err_msg=name)
    np.testing.assert_array_equal(td.fetch_status(), jd.fetch_status())
    np.testing.assert_array_equal(td._last_quant, jd._last_quant)
    np.testing.assert_array_equal(td._last_deblock, jd._last_deblock)
    assert [int(r) for r in td._running] == [int(r) for r in jd._running]
    assert [tck.picture_to_dict(p) for p in td._pictures] == \
        [jck.picture_to_dict(p) for p in jd._pictures]
    return errs[1]


def _rgba_equal(jd, td):
    for deblock in (True, None):
        np.testing.assert_array_equal(_np(td.present_rgba(deblock)),
                                      np.asarray(jd.present_rgba(deblock)))


def test_decode_steps_match_jax():
    """128x96, 6 streams, 5 steps: plain GOPs with CPM and PEI lanes, a
    UMV stream, an MQ stream, masked and None lanes, an over-cap frame,
    flipped headers and cut frames."""
    rng = np.random.default_rng(170)
    gops = [std_gop(SQ, 5, 171 + i) for i in range(3)]
    umv = C.umv_corpus(*SQ, 5)
    mq = [C.mq_picture(*SQ)] + std_gop(SQ, 5, 175)[1:]
    jd, td = _jax_twins(6, SQ, max_frame_bytes=4096)
    raised = []
    for t in range(5):
        bufs = [gops[0][t], with_header(gops[1][t], psbi=t % 4),
                with_header(gops[2][t], pei=bytes([t, 7])), umv[t], mq[t],
                gops[0][t]]
        mask = None
        if t == 1:
            mask = [True, True, False, True, True, True]
            bufs[5] = None
        if t == 2:
            bufs[0] = flip_header_bits(rng, bufs[0], 2)
            bufs[5] = bufs[5][:len(bufs[5]) // 2]
        if t == 3:
            bufs[1] = bufs[1] + b"\0" * 5000
        raised.append(_jax_step(jd, td, bufs, mask))
    assert raised[3] is not None and "exceeds" in raised[3][1]
    _rgba_equal(jd, td)


def test_decode_steps_match_jax_qcif():
    gops = [std_gop(C.QCIF, 3, 180 + i) for i in range(2)]
    d3 = C.d3_corpus(*C.QCIF, 3)
    jd, td = _jax_twins(3, C.QCIF)
    for t in range(3):
        bufs = [gops[0][t], d3[t], with_header(gops[1][t], psbi=1,
                                               pei=b"\x42")]
        assert _jax_step(jd, td, bufs) is None
    assert (td.fetch_status() == 0).all()
    _rgba_equal(jd, td)


def test_decode_steps_over_a_mesh_match_jax():
    """A two-shard mesh: only shard 1 hands lanes back, both shards hold a
    failing lane, and the error raised is the lowest stream's."""
    gops = [std_gop(SQ, 3, 190 + i) for i in range(4)]
    umv = C.umv_corpus(*SQ, 3)
    jd = JaxDevice(4, *SQ, JaxOption.NONE, unroll=1)
    td = DeviceFrontendDecoder(4, *SQ, NONE,
                               mesh=make_stream_mesh(["cpu"] * 2))
    for t in range(3):
        bufs = [gops[0][t], gops[1][t], umv[t], gops[3][t]]
        if t == 1:
            bufs[1] = b"\x00\x00\x80garbage"
            bufs[3] = bufs[3] + b"\0" * 9000
        err = _jax_step(jd, td, bufs)
        assert (err is None) == (t != 1)
        if t == 1:      # stream 1's, not stream 3's over-cap error
            assert "exceeds transfer bucket" not in err[1]


def test_checkpoint_after_native_steps_loads_into_jax():
    """A blob saved after native steps (a PEI lane among them) holds the
    JAX decoder's own header state after the same steps; with the JAX-only
    knobs and members of the JAX decoder's blob added (its last buffers),
    it loads into the JAX decoder, and both decode on alike."""
    gops = [std_gop(SQ, 4, 200 + i) for i in range(2)]
    umv = C.umv_corpus(*SQ, 4)
    streams = [gops[0], [with_header(f, pei=b"\x09") for f in gops[1]], umv]
    jd, td = _jax_twins(3, SQ)
    for t in range(2):
        _jax_step(jd, td, [s[t] for s in streams])
    port_meta, z = tck._unpack(tck.save_device_frontend_state(td),
                               "device_frontend")
    jax_meta, jz = jck._unpack(jck.save_device_frontend_state(jd))
    for key in ("pictures", "running", "n", "w", "h", "decoder_options",
                "format_version", "kind", "has_status"):
        assert port_meta[key] == jax_meta[key], key
    for key in ("ref_y", "ref_cb", "ref_cr", "last_quant", "last_deblock",
                "status"):
        np.testing.assert_array_equal(z[key], jz[key], err_msg=key)
    members = {k: jz[k] for k in jz.files if k != "meta"}
    members.update({k: z[k] for k in z.files if k != "meta"})
    blob = jck._pack({**jax_meta, **port_meta}, members)
    resumed = jck.load_device_frontend_state(blob)
    for t in range(2, 4):
        _jax_step(resumed, td, [s[t] for s in streams])


# -- the binding --------------------------------------------------------------

def test_binding_checks_and_given_lanes():
    frames = std_gop(SQ, 2, 210)
    prep = native.StandardPrepBatch(2, *SQ, 4096)
    stage = np.zeros(4096, dtype=np.uint8)
    meta = np.zeros((6, 2), dtype=np.int32)
    with pytest.raises(ValueError):
        prep.prepare(frames[:1], stage, meta)
    with pytest.raises(ValueError):
        prep.prepare(frames, stage.view(np.int32), meta)
    with pytest.raises(ValueError):
        prep.prepare(frames, stage, np.zeros((5, 2), np.int32))
    with pytest.raises(ValueError, match="does not fit"):
        prep.prepare(frames, np.zeros(16, np.uint8), meta)
    assert prep.prepare(frames, stage, meta) == 0
    assert prep.words == sum((len(f) + 3) // 4 for f in frames)
    assert (prep.hdr[:, 8] == 1).all() and (prep.rc == 0).all()
    assert meta[:, 0].tolist()[1:] == [8 * len(frames[0]), 8, 4 + 0, 0, 0]
    # A given lane is staged as it is, with the caller's meta rows 0-3.
    prep.given[0] = 1
    meta[:4, 0] = (3, 24, 5, 6)
    assert prep.prepare([b"abc", frames[1]], stage, meta) == 0
    assert stage[:4].tobytes() == b"abc\0"
    assert meta[:, 0].tolist() == [3, 24, 5, 6, 0, 0] and meta[5, 1] == 1
    assert prep.words == 1 + (len(frames[1]) + 3) // 4
    # An over-cap lane and a PLUSPTYPE one are handed back, staging
    # nothing.
    prep.given[:] = 0
    small = native.StandardPrepBatch(2, *SQ, 64)
    assert small.prepare([frames[0], C.umv_corpus(*SQ, 1)[0]], stage,
                         meta) == 2
    assert small.rc.tolist() == [native.E_NEEDS_PYTHON] * 2
    assert small.words == 0 and not stage.any()
