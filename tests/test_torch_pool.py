"""The port's serving pool (`StreamPool(device="cpu")`) against the JAX
package's `StreamPool`, step for step, with the device front-end and with
the host front-end (`frontend=` named on both sides).

Both pools see the same membership calls and frames.  After every step the
two must agree on the error raised (by class), on every decoded stream's
planes, on each bucket's slots, free list, capacity, reference planes and
presentation state, and on `present_rgba` under each deblock setting.  The
cases are those of tests/test_pool.py: join, leave and slot recycling,
bucket growth, absent streams, rebucketing on an I-frame, refusal on a
P-frame, at an unbounded size and on a garbage body, error isolation across
buckets, unregistered ids; for host pools also the per-stream header state
and `decode_steps` as sequential steps; and rebucket I-frames fuzzed (cut,
byte-flipped) through both front-ends.  Standard H.263 pools
(`DecoderOption.NONE`) on both front-ends: churn, growth, absence, a
rebucket that carries UMV, a refused one, custom sizes, windows as steps,
the dims probe against the JAX probe, and fuzzed standard rebucket frames
(clean, cut, byte-flipped, PLUSPTYPE/CPFMT-mangled).  Sorenson host pools
switched to the device front-end mid-GOP, by hand and by the rate
trigger fed synthetic readings, against the JAX pool's switch.  Small dims
(48x32, 64x48, 128x96 and 176x144) and few bucket sizes keep the JAX
side's compiles few; `unroll=1` only shortens them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import h263_tpu.parallel.pool as j_pool  # noqa: E402
from h263_tpu.parallel.pool import StreamPool as JaxPool  # noqa: E402
from h263_tpu.testing import fuzz  # noqa: E402
from h263_tpu.types import DecoderOption as JaxOption  # noqa: E402
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu_torch.parallel import pool as t_pool  # noqa: E402
from h263_tpu_torch.parallel.pool import StreamPool  # noqa: E402
from h263_tpu_torch.testing import corpora as C  # noqa: E402
from h263_tpu_torch.testing.encoder import (  # noqa: E402
    BitWriter,
    MBSpec,
    encode_sorenson_picture,
    encode_standard_picture,
)
from h263_tpu_torch.utils import trace  # noqa: E402
from h263_tpu_torch.types import (  # noqa: E402
    DecoderOption,
    H263Error,
    PictureTypeCode,
)

A, B = (48, 32), (64, 48)


def gop(seed, dims, n=4):
    """An I-frame then P-frames: MVs, coefficients, uncoded macroblocks,
    a quantizer and deblocker flag that change from frame to frame."""
    w, h = dims
    rng = np.random.default_rng(seed)
    nmb = (-(-w // 16)) * (-(-h // 16))
    out = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6,
                blocks=[[(0, int(rng.integers(1, 20)))], [], [(1, -3)], [],
                        [], []]) for _ in range(nmb)],
        quantizer=int(rng.integers(1, 32)), deblocker=bool(seed % 2))]
    for tr in range(1, n):
        mbs = []
        for _ in range(nmb):
            if rng.random() < 0.2:
                mbs.append(MBSpec(kind="uncoded"))
                continue
            mbs.append(MBSpec(
                kind="inter",
                mvd=[(int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))],
                blocks=[[(0, int(rng.integers(1, 8)))], [], [], [], [], []]))
        out.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME, mbs, temporal_reference=tr,
            quantizer=int(rng.integers(1, 32)), deblocker=bool(tr % 2)))
    return out


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _picture_fields(pic):
    """A Picture of either package as plain values."""
    if pic is None:
        return None
    out = {}
    for name, v in vars(pic).items():
        if hasattr(v, "width_and_height"):
            v = v.width_and_height()
        elif hasattr(v, "value"):
            v = v.value
        out[name] = v
    return out


class Twin:
    """The JAX pool and the port's pool driven alike and compared; with
    `standard`, pools of standard H.263 streams."""

    def __init__(self, frontend="device", standard=False, **kw):
        # The JAX pool passes each decoder class the arguments it takes,
        # so `unroll` reaches device buckets only (after a switch too).
        extra = {"unroll": 1}
        self.standard = standard
        jopt, topt = ((JaxOption.NONE, DecoderOption.NONE) if standard else
                      (JaxOption.SORENSON_SPARK_BITSTREAM,
                       DecoderOption.SORENSON_SPARK_BITSTREAM))
        self.j = JaxPool(jopt, frontend=frontend, **extra, **kw)
        self.t = StreamPool(topt, frontend=frontend, device="cpu", **kw)

    def add(self, sid, dims):
        self.j.add_stream(sid, *dims)
        self.t.add_stream(sid, *dims)

    def remove(self, sid):
        self.j.remove_stream(sid)
        self.t.remove_stream(sid)

    def step(self, feed):
        """Step both; returns the port's result, or the error class name
        (with the partial results compared) when both raised."""
        res, errs = [], []
        for pool in (self.j, self.t):
            try:
                res.append(pool.decode_step(feed))
                errs.append(None)
            except (JaxH263Error, H263Error, KeyError) as e:
                res.append(getattr(e, "pool_step_result", None))
                errs.append(e)
        names = [e and type(e).__name__ for e in errs]
        assert names[0] == names[1], errs
        if res[0] is not None or res[1] is not None:
            assert sorted(res[0], key=repr) == sorted(res[1], key=repr)
            for sid in res[1]:
                for a, b in zip(res[0][sid], res[1][sid]):
                    np.testing.assert_array_equal(b, a, err_msg=str(sid))
        self.check_state()
        return res[1] if errs[1] is None else errs[1]

    def check_state(self):
        assert self.j.frontend == self.t.frontend
        assert self.j._dims == self.t._dims
        assert self.j._pending == self.t._pending
        assert list(self.j._buckets) == list(self.t._buckets)
        for key, jb in self.j._buckets.items():
            tb = self.t._buckets[key]
            assert (jb.slots, jb.free, jb.dec.n) == (tb.slots, tb.free,
                                                     tb.dec.n), key
            for name in ("ref_y", "ref_cb", "ref_cr"):
                np.testing.assert_array_equal(
                    _np(getattr(tb.dec, name)), _np(getattr(jb.dec, name)),
                    err_msg=f"{key} {name}")
            if self.t.frontend == "host":
                if self.standard:
                    # The port's standard rows ship full MVs from the start.
                    np.testing.assert_array_equal(tb.dec._std_prev_fmt,
                                                  jb.dec._std_prev_fmt)
                else:
                    assert tb.dec._mv_full == jb.dec._mv_full
                for i, (a, b) in enumerate(zip(tb.dec.states,
                                               jb.dec.states)):
                    assert (int(a.running_options), a.has_reference,
                            _picture_fields(a.last_header)) == (
                        int(b.running_options), b.has_reference,
                        _picture_fields(b.last_header)), (key, i)
                continue
            assert [int(r) for r in tb.dec._running] == \
                [int(r) for r in jb.dec._running], key
            assert [_picture_fields(p) for p in tb.dec._pictures] == \
                [_picture_fields(p) for p in jb.dec._pictures], key
            np.testing.assert_array_equal(tb.dec._last_quant,
                                          jb.dec._last_quant)
            np.testing.assert_array_equal(tb.dec._last_deblock,
                                          jb.dec._last_deblock)
            if jb.dec.last_status is not None:
                np.testing.assert_array_equal(tb.dec.fetch_status(),
                                              jb.dec.fetch_status())

    def present(self):
        for deblock in (True, None, False):
            jr = self.j.present_rgba(deblock)
            tr = self.t.present_rgba(deblock)
            assert sorted(jr, key=repr) == sorted(tr, key=repr)
            for sid in tr:
                np.testing.assert_array_equal(tr[sid].numpy(),
                                              np.asarray(jr[sid]),
                                              err_msg=f"{sid} {deblock}")


def test_join_leave_recycle_and_growth(frontend="device"):
    tw = Twin(frontend)
    f = {sid: gop(seed, A, n=5) for seed, sid in enumerate("abcd")}
    x, y = gop(9, B, n=5), gop(10, B, n=5)
    for sid in "ab":
        tw.add(sid, A)
    tw.add("x", B)
    tw.add("y", B)
    tw.step({"a": f["a"][0], "b": f["b"][0], "x": x[0], "y": y[0]})
    tw.add("c", A)                          # no free slot: A grows 2 -> 4
    tw.step({"a": f["a"][1], "b": f["b"][1], "c": f["c"][0], "x": x[1],
             "y": y[1]})
    assert tw.t._buckets[A].dec.n == 4
    tw.remove("b")                          # b's slot pads until reused
    out = tw.step({"a": f["a"][2], "c": f["c"][1], "x": x[2], "y": y[2]})
    assert set(out) == {"a", "c", "x", "y"}
    tw.add("d", A)                          # recycles a free slot
    tw.step({"a": f["a"][3], "c": f["c"][2], "d": f["d"][0], "x": x[3]})
    tw.present()
    tw.remove("x")
    tw.remove("y")                          # a bucket with no streams
    tw.step({"a": f["a"][4], "c": f["c"][3], "d": f["d"][1]})
    tw.present()


def test_absent_stream_keeps_state(frontend="device"):
    tw = Twin(frontend)
    fa, fb = gop(21, A, n=4), gop(22, A, n=4)
    tw.add("a", A)
    tw.add("b", A)
    tw.step({"a": fa[0], "b": fb[0]})
    for t in (1, 2):                        # b sits out two steps
        out = tw.step({"a": fa[t]})
        assert set(out) == {"a"}
        tw.present()
    tw.step({"a": fa[3], "b": fb[1]})       # b resumes with its frame 1
    tw.present()


def test_rebucket_on_an_iframe_and_before_the_first_step(frontend="device"):
    tw = Twin(frontend)
    xa, xb = gop(31, A, n=2), gop(32, B, n=3)
    ka, pa = gop(34, A, n=5), gop(35, A, n=2)
    o, q = gop(33, B, n=5), gop(36, B, n=2)
    tw.add("x", A)
    tw.add("k", A)
    tw.add("o", B)
    tw.add("q", B)
    tw.step({"x": xa[0], "k": ka[0], "o": o[0], "q": q[0]})
    tw.step({"x": xa[1], "k": ka[1], "o": o[1], "q": q[1]})
    tw.remove("q")
    # x moves to B on an I-frame, into q's recycled slot; p, registered at
    # a size no bucket has yet, sends its first frame at A's size and takes
    # the slot x left.
    tw.add("p", (32, 32))
    tw.step({"x": xb[0], "k": ka[2], "o": o[2], "p": pa[0]})
    assert tw.t._dims["x"] == B and tw.t._dims["p"] == A
    assert tw.t._buckets[A].slots["p"] == 0
    # As in the JAX pool, p's emptied pending list still finalizes: into a
    # bucket of no slots, which never steps.
    assert tw.t._buckets[(32, 32)].dec.n == 0
    tw.step({"x": xb[1], "k": ka[3], "o": o[3], "p": pa[1]})
    tw.step({"x": xb[2], "k": ka[4], "o": o[4]})
    tw.present()


def test_rebucket_refused_keeps_state(frontend="device"):
    """On a P-frame, at a size beyond max_dims and on a garbage body, the
    rebucket raises PictureFormatInvalid before the stream's state moves."""
    tw = Twin(frontend, max_dims=(64, 64))
    a, b, c = gop(41, A, n=4), gop(42, B, n=2), gop(43, A, n=4)
    tw.add("s", A)
    tw.add("t", A)
    tw.step({"s": a[0], "t": c[0]})
    err = tw.step({"s": b[1]})              # a P-frame at B's dims
    assert type(err).__name__ == "PictureFormatInvalid"
    w = BitWriter()
    for v, n in ((1, 17), (1, 5), (3, 8), (1, 3), (65535, 16), (65535, 16),
                 (0, 2), (0, 1), (9, 5), (0, 1)):
        w.write_bits(v, n)                  # I-frame header, 65535x65535
    err = tw.step({"s": w.to_bytes()})
    assert type(err).__name__ == "PictureFormatInvalid"
    assert "bound" in str(err)
    err = tw.step({"s": b[0][:10] + b"\xff" * 4})   # B I header, garbage
    assert type(err).__name__ == "PictureFormatInvalid"
    assert "validation" in str(err)
    assert tw.t._dims["s"] == A and (65535, 65535) not in tw.t._buckets
    tw.step({"s": a[1], "t": c[1]})         # continues from its own state
    tw.step({"s": a[2], "t": c[2]})
    tw.present()


def test_error_in_one_bucket_does_not_skip_the_others(frontend="device"):
    tw = Twin(frontend)
    a, a2 = gop(51, A, n=3), gop(54, A, n=3)
    b, c = gop(52, B, n=3), gop(53, B, n=3)
    tw.add("a", A)
    tw.add("a2", A)
    tw.add("b", B)
    tw.add("c", B)
    tw.step({"a": a[0], "a2": a2[0], "b": b[0], "c": c[0]})
    corrupt = a[1][:7]                # header cut short: the prep rejects it
    err = tw.step({"a": corrupt, "a2": a2[1], "b": b[1], "c": c[1]})
    assert isinstance(err, H263Error)
    assert set(err.pool_step_result) == {"b", "c"}
    flipped = bytearray(c[2])
    flipped[len(flipped) // 2] ^= 0x5A                # MB-layer damage
    tw.step({"a": a[2], "a2": a2[2], "b": b[2], "c": bytes(flipped)})
    tw.present()


def test_unregistered_ids_raise():
    tw = Twin()
    tw.add("a", A)
    err = tw.step({"a": b"", 5: b""})
    assert isinstance(err, KeyError) and "unregistered" in str(err)
    with pytest.raises(RuntimeError, match="duplicate"):
        tw.t.add_stream("a", *A)


def test_pool_options():
    with pytest.raises(ValueError):
        StreamPool(frontend="automaton", device="cpu")
    assert StreamPool(device="cpu").frontend == "device"
    assert StreamPool(frontend="host", device="cpu").frontend == "host"
    assert StreamPool(DecoderOption.NONE, device="cpu").decoder_options \
        == DecoderOption.NONE
    with pytest.raises(ValueError):         # the trigger: Sorenson only
        StreamPool(DecoderOption.NONE, frontend="host", device="cpu",
                   adaptive_frontend=True)
    if not torch.cuda.is_available():
        pool = StreamPool()                 # device="cuda" by default
        pool.add_stream("a", *A)
        with pytest.raises(RuntimeError, match="CUDA"):
            pool.decode_step({"a": gop(1, A, n=1)[0]})


def _validation_cases():
    """(frame, dims): frames a rebucket may bring, good and bad."""
    w, h = B
    nmb = (-(-w // 16)) * (-(-h // 16))
    i_frame, p_frame = gop(61, B, n=2)
    intra_p = encode_sorenson_picture(
        w, h, PictureTypeCode.P_FRAME,
        [MBSpec(kind="intra", intradc=[80] * 6)] * nmb)
    stuffed = encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="stuffing")] + [MBSpec(kind="intra", intradc=[8] * 6,
                                            blocks=[[(0, 90)], [], [], [],
                                                    [], []])] * nmb)
    cases = [i_frame, p_frame, intra_p, stuffed, gop(62, A, n=1)[0],
             i_frame[:9], i_frame[:len(i_frame) // 2], i_frame[:-1],
             i_frame + b"\xff\xff", b"\xff" * 30]
    rng = np.random.default_rng(63)
    for _ in range(4):
        f = bytearray(i_frame)
        f[int(rng.integers(8, len(f)))] ^= int(rng.integers(1, 256))
        cases.append(bytes(f))
    return cases


@pytest.mark.parametrize("k", range(14))
def test_rebucket_validation_agrees_with_the_host_parser(k):
    """The port validates a rebucket frame with its copies of the JAX
    package's host parsers, as the JAX pool does: they agree."""
    buf = _validation_cases()[k]
    dims = A if k == 4 else B
    jp = JaxPool(JaxOption.SORENSON_SPARK_BITSTREAM, frontend="device")
    tp = StreamPool(device="cpu")
    assert tp._validate_rebucket_frame(buf, *dims) == \
        jp._validate_rebucket_frame(buf, *dims)


def test_rebucket_validation_refuses_only_decode_errors(monkeypatch):
    """A decode error refuses the frame; any other fault of the parse (a
    failed native build, a bug) propagates instead of becoming a refusal."""
    import h263_tpu_torch.parallel.pool as pool_mod

    i_frame = gop(61, B, n=1)[0]
    tp = StreamPool(device="cpu")
    assert tp._validate_rebucket_frame(i_frame, *B)
    assert not tp._validate_rebucket_frame(i_frame[:9], *B)

    def broken(*args, **kwargs):
        raise RuntimeError("native library build failed")
    monkeypatch.setattr(pool_mod, "parse_frame_auto", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        tp._validate_rebucket_frame(i_frame, *B)


# -- host front-end pools ------------------------------------------------------

def test_host_pool_join_leave_recycle_and_growth():
    test_join_leave_recycle_and_growth("host")


def test_host_pool_absent_stream_keeps_state():
    test_absent_stream_keeps_state("host")


def test_host_pool_rebucket_on_an_iframe():
    test_rebucket_on_an_iframe_and_before_the_first_step("host")


def test_host_pool_rebucket_refused_keeps_state():
    test_rebucket_refused_keeps_state("host")


def test_host_pool_error_in_one_bucket_commits_nothing():
    """A corrupt frame makes its host bucket raise with nothing committed
    and no plane changed, while the other bucket steps."""
    test_error_in_one_bucket_does_not_skip_the_others("host")


def test_host_pool_decode_steps_are_sequential_steps():
    tw = Twin("host")
    fa, fb, fx = gop(71, A, n=4), gop(72, A, n=4), gop(73, B, n=4)
    for sid, dims in (("a", A), ("b", A), ("x", B)):
        tw.add(sid, dims)
    seq = StreamPool(frontend="host", device="cpu")
    for sid, dims in (("a", A), ("b", A), ("x", B)):
        seq.add_stream(sid, *dims)
    window = [{"a": fa[t], "b": fb[t], "x": fx[t]} for t in range(4)]
    del window[2]["b"]                      # b sits out a frame
    outs = [tw.j.decode_steps(window), tw.t.decode_steps(window)]
    tw.check_state()
    for t, feed in enumerate(window):
        step = seq.decode_step(feed)
        for sid in feed:
            for a, b, c in zip(outs[0][t][sid], outs[1][t][sid], step[sid]):
                np.testing.assert_array_equal(b, a, err_msg=f"{t} {sid}")
                np.testing.assert_array_equal(b, c, err_msg=f"{t} {sid}")
    tw.present()


def _fuzzed_rebucket_frames(seed, n):
    """I-frames at B's dims: clean, cut at random bytes, byte-flipped."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        f = gop(seed * 100 + k, B, n=1)[0]
        kind = k % 3
        if kind == 1:
            f = f[:int(rng.integers(6, len(f)))]
        elif kind == 2:
            b = bytearray(f)
            b[int(rng.integers(8, len(b)))] ^= int(rng.integers(1, 256))
            f = bytes(b)
        out.append(f)
    return out


@pytest.mark.parametrize("frontend", ["device", "host"])
def test_fuzzed_rebucket_frames_decide_alike(frontend):
    """A stream offered fuzzed rebucket I-frames: the port's pool and the
    JAX pool accept or refuse each alike and hold equal planes after; an
    accepted stream goes back to its first size on a clean I-frame."""
    tw = Twin(frontend)
    home = gop(81, A, n=2)
    other = gop(82, A, n=12)
    tw.add("s", A)
    tw.add("o", A)
    tw.step({"s": home[0], "o": other[0]})
    moved = 0
    for k, f in enumerate(_fuzzed_rebucket_frames(83, 10)):
        tw.step({"s": f, "o": other[1 + k]})
        if tw.t._dims["s"] == B:
            moved += 1
            tw.step({"s": gop(84 + k, A, n=1)[0]})
            assert tw.t._dims["s"] == A
    assert 3 <= moved < 10              # accepted and refused frames both
    tw.present()


# -- standard H.263 pools ------------------------------------------------------

SQ, QC = (128, 96), (176, 144)   # plain PTYPE sizes
CU, CU2 = (48, 32), (64, 48)     # custom sizes (PLUSPTYPE + CPFMT)
UMV = int(t_pool.PictureOption.UNRESTRICTED_MOTION_VECTORS)
# A transfer cap that keeps the JAX device buckets' payload ladder at two
# rungs (so few compiles); every frame here fits it.
STD_CAP = 2048


def std_gop(seed, dims, n=4, umv=False):
    """Light standard pictures (short lanes keep the CPU automatons quick):
    plain PTYPE at a CIF-family size, PLUSPTYPE + OPPTYPE + CPFMT at a
    custom one; an intra-DC I-frame, then sparse P-frames with MVs up to
    +-14 half-pels and quantizers that change.  With `umv` the I-frame is
    a PLUSPTYPE picture whose OPPTYPE sets UMV, which the plain-PTYPE
    P-frames carry."""
    w, h = dims
    rng = np.random.default_rng(seed)
    nmb = (-(-w // 16)) * (-(-h // 16))
    mbs = [MBSpec(kind="intra", intradc=[8 * int(rng.integers(1, 128))] * 6)
           for _ in range(nmb)]
    out = [C.plusptype_picture(w, h, PictureTypeCode.I_FRAME, mbs, umv=True,
                               quantizer=8, temporal_reference=0) if umv
           else encode_standard_picture(w, h, PictureTypeCode.I_FRAME, mbs)]
    for tr in range(1, n):
        mbs = [MBSpec(kind="uncoded") if rng.random() < 0.6 else MBSpec(
            kind="inter", mvd=[(int(rng.integers(-14, 15)),
                                int(rng.integers(-14, 15)))],
            blocks=[[(0, int(rng.integers(1, 9)))], [], [], [], [], []])
            for _ in range(nmb)]
        out.append(encode_standard_picture(
            w, h, PictureTypeCode.P_FRAME, mbs, temporal_reference=tr,
            quantizer=int(rng.integers(1, 32))))
    return out


@pytest.mark.parametrize("frontend", ["device", "host"])
def test_standard_pool_churn_rebucket_and_carried_options(frontend):
    """Host pools: plain-PTYPE streams (SQCIF, moving to QCIF), a stream
    whose PLUSPTYPE I-frame sets UMV and whose plain-PTYPE P-frames carry
    it, and a custom-size stream.  Device pools, whose plain automaton is
    slow on the CPU: custom sizes (48x32, moving to 64x48), the UMV
    stream's pictures PLUSPTYPE with table-D.3 MVDs.  Then an absent
    stream, a join that grows the bucket, a leave and a recycled slot.
    The UMV stream's I-frame at the other size is refused as the reference
    refuses any change of format against a stream's last picture
    (UnimplementedDecoding, its state kept); a joiner with no picture yet
    moves on an I-frame (for plain PTYPE, the probe says "changed");
    another joiner's P-frame at the other size is refused; and running
    options seeded into a joined slot carry into the new bucket."""
    tw = Twin(frontend, standard=True, max_frame_bytes=STD_CAP)
    home, away = (SQ, QC) if frontend == "host" else (CU, CU2)
    SQ_, QC_ = home, away
    a, b, c = (std_gop(seed, home, n=5) for seed in (1, 2, 3))
    u = (std_gop(4, home, n=5, umv=True) if frontend == "host"
         else C.d3_corpus(*home, 5, seed=4))
    q = std_gop(5, away, n=3)
    streams = (("a", home), ("b", home), ("u", home))
    if frontend == "host":
        streams += (("x", CU),)
    x = std_gop(6, CU, n=5)
    for sid, dims in streams:
        tw.add(sid, dims)

    def feed(t, **extra):
        out = {"a": a[t], "u": u[t], **extra}
        if frontend == "host":
            out["x"] = x[t]
        return out
    tw.step(feed(0, b=b[0]))
    tw.add("c", SQ_)                            # grows 3 -> 6
    tw.step(feed(1, c=c[0]))                    # b absent
    tw.step(feed(2, b=b[1], c=c[1]))
    tw.remove("b")
    tw.add("d", SQ_)                            # recycles b's slot
    if frontend == "host":
        assert t_pool._sniff_standard_probe(q[0], SQ) == "changed"
    err = tw.step(feed(3, c=c[2], u=q[0], d=q[0]))
    assert type(err).__name__ == "UnimplementedDecoding"
    assert tw.t._dims["u"] == SQ_ and tw.t._dims["d"] == QC_
    tw.add("e", SQ_)
    err = tw.step({"a": a[3], "e": q[1], "d": q[1]})
    assert type(err).__name__ == "PictureFormatInvalid"
    # Running options seeded into a joined slot (as a rebucket seeds
    # them) move with the stream when it changes size.
    tw.add("f", SQ_)
    for pool in (tw.j, tw.t):
        bucket = pool._buckets[SQ_]
        slot = bucket.slots["f"]
        if frontend == "host":
            bucket.dec.states[slot].running_options = type(
                bucket.dec.states[slot].running_options)(UMV)
        else:
            bucket.dec._running[slot] = type(bucket.dec._running[slot])(UMV)
    tw.step(feed(4, c=c[3], f=std_gop(7, QC_, n=1)[0], d=q[2]))
    assert tw.t._dims["f"] == QC_
    tw.present()


def test_standard_device_pool_windows_are_steps():
    tw = Twin("device", standard=True)
    fa, fb = std_gop(11, CU, n=4), std_gop(12, CU, n=4)
    tw.add("a", CU)
    tw.add("b", CU)
    window = [{"a": fa[t], "b": fb[t]} for t in range(4)]
    del window[1]["b"]
    before = trace.get_counters().get("pool_window_fallbacks", 0)
    outs = [tw.j.decode_steps(window), tw.t.decode_steps(window)]
    assert trace.get_counters()["pool_window_fallbacks"] == before + 1
    tw.check_state()
    for t, feed in enumerate(window):
        for sid in feed:
            for x, y in zip(outs[0][t][sid], outs[1][t][sid]):
                np.testing.assert_array_equal(y, x, err_msg=f"{t} {sid}")


def _probe_cases():
    """Headers of every kind the probe meets: the cases of
    tests/test_pool.py's probe test, the standard corpora, PLUSPTYPE
    recipes, the fuzz corpus's standard frames and their mutants, cut
    headers and Sorenson ones."""
    I_, P_ = PictureTypeCode.I_FRAME, PictureTypeCode.P_FRAME
    cases = [std_gop(21, dims, n=2)[k] for dims in (SQ, QC, (352, 288), CU)
             for k in (0, 1)]
    for dims in (SQ, QC, (352, 288), CU, (64, 48)):
        for ptype in (I_, P_):
            for kw in (dict(), dict(umv=True), dict(ufep=False),
                       dict(custom=True), dict(mq=True)):
                cases.append(C.plusptype_picture(*dims, ptype, **kw))
    rng = np.random.default_rng(22)
    for _ in range(20):
        base = fuzz._rand_frame(rng, *SQ, flavor="standard")
        cases.append(base)
        for _ in range(5):
            cases.append(fuzz._mutate(
                rng, base,
                lambda: fuzz._rand_frame(rng, *SQ, flavor="standard")))
    cases += [f[:k] for f in cases[:12] for k in (0, 3, 7, 8, 9)]
    cases += gop(23, A, n=2) + [bytes(rng.integers(0, 256, 12,
                                                   dtype=np.uint8))
                                for _ in range(10)]
    return cases


def test_standard_probe_matches_the_jax_probe():
    """The port's probe answers as the JAX one on every header, and never
    "unchanged" where the full header parse names other dims."""
    from h263_tpu.bitio import BitReader as JaxReader
    from h263_tpu.parser.picture import decode_picture as j_decode

    n_unchanged = 0
    for buf in _probe_cases():
        try:
            pic = j_decode(JaxReader(buf), JaxOption.NONE, None)
            dims = pic.format.width_and_height() if pic and pic.format \
                else None
        except Exception:
            dims = None
        for cur in (SQ, QC, (352, 288), CU, (120, 90)):
            got = t_pool._sniff_standard_probe(buf, cur)
            assert got == j_pool._sniff_standard_probe(buf, cur), \
                (buf.hex()[:24], cur)
            if got == "unchanged":
                n_unchanged += 1
                assert dims is None or dims == cur
    assert n_unchanged > 20
    assert t_pool._STD_FMT_DIMS == j_pool._STD_FMT_DIMS


def _fuzzed_standard_rebucket_frames(seed, n, dims=QC):
    """I-frames at `dims`: clean, cut at random bytes, byte-flipped, and
    PLUSPTYPE (+ CPFMT) pictures with header bits flipped."""
    rng = np.random.default_rng(seed)
    nmb = (-(-dims[0] // 16)) * (-(-dims[1] // 16))
    out = []
    for k in range(n):
        kind = k % 4
        if kind == 3:
            mbs = [MBSpec(kind="intra", intradc=[8 * int(rng.integers(1, 120))]
                          * 6) for _ in range(nmb)]
            f = bytearray(C.plusptype_picture(*dims, PictureTypeCode.I_FRAME,
                                              mbs, custom=bool(k % 8 == 3)))
            for _ in range(int(rng.integers(1, 3))):
                f[int(rng.integers(3, 11))] ^= 1 << int(rng.integers(0, 8))
            out.append(bytes(f))
            continue
        f = std_gop(seed * 100 + k, dims, n=1)[0]
        if kind == 1:
            f = f[:int(rng.integers(4, len(f)))]
        elif kind == 2:
            b = bytearray(f)
            b[int(rng.integers(4, len(b)))] ^= int(rng.integers(1, 256))
            f = bytes(b)
        out.append(f)
    return out


@pytest.mark.parametrize("frontend", ["device", "host"])
def test_fuzzed_standard_rebucket_frames_decide_alike(frontend):
    """Fuzzed rebucket I-frames, each the first frame of a stream that
    joined at another size (a stream with a picture cannot change format
    in the reference): the port's pool and the JAX pool accept or refuse
    each alike (the same error class) and hold equal planes and state
    after."""
    tw = Twin(frontend, standard=True, max_frame_bytes=STD_CAP)
    home, away = (SQ, QC) if frontend == "host" else (CU, CU2)
    other = std_gop(32, home, n=14)
    tw.add("o", home)
    tw.step({"o": other[0]})
    moved = 0
    for k, f in enumerate(_fuzzed_standard_rebucket_frames(33, 12, away)):
        sid = f"s{k}"
        tw.add(sid, home)
        tw.step({sid: f, "o": other[1 + k]})
        moved += tw.t._dims[sid] == away
        tw.remove(sid)
    assert 2 <= moved < 12
    tw.present()


def test_rebucket_validation_and_sniff_agree_on_fuzzed_standard_frames():
    """`_validate_rebucket_frame` and `_sniff` of the port decide as the
    JAX pool's on every fuzzed frame, whatever the parsers raise inside
    (the JAX pool refuses a frame on any exception there)."""
    frames = (_fuzzed_standard_rebucket_frames(41, 40)
              + _fuzzed_standard_rebucket_frames(42, 20, CU2) + _probe_cases())
    jp = JaxPool(JaxOption.NONE, frontend="device")
    tp = StreamPool(DecoderOption.NONE, device="cpu")
    for p in (jp, tp):
        p.add_stream("s", *SQ)
    for buf in frames:
        for dims in (QC, SQ):
            assert tp._validate_rebucket_frame(buf, *dims) == \
                jp._validate_rebucket_frame(buf, *dims), buf.hex()[:24]
        assert tp._sniff("s", buf) == jp._sniff("s", buf), buf.hex()[:24]


# -- the front-end switch ------------------------------------------------------

def test_switch_frontend_mid_gop_matches_jax():
    """A Sorenson host pool switched to the device front-end after its
    third step, beside the JAX pool switched alike: equal planes, the
    moved header state and RGBA at every later step."""
    tw = Twin("host")
    fa, fb = gop(91, A, n=6), gop(92, A, n=6)
    tw.add("a", A)
    tw.add("b", A)
    for t in range(3):
        tw.step({"a": fa[t], "b": fb[t]})
    before = trace.get_counters().get("pool_frontend_switches", 0)
    tw.j.switch_frontend("device")
    tw.t.switch_frontend("device")
    assert trace.get_counters()["pool_frontend_switches"] == before + 1
    assert tw.t.frontend == "device"
    tw.check_state()
    tw.present()
    tw.step({"a": fa[3]})                       # b absent
    tw.step({"a": fa[4], "b": fb[3]})
    tw.add("c", A)                              # a device bucket grows
    tw.step({"a": fa[5], "b": fb[4], "c": gop(94, A, n=1)[0]})
    tw.present()
    tw.t.switch_frontend("device")              # already there: no-op
    with pytest.raises(ValueError):
        tw.t.switch_frontend("host")
    std = StreamPool(DecoderOption.NONE, frontend="host", device="cpu")
    with pytest.raises(ValueError):
        std.switch_frontend("device")


def test_adaptive_trigger_switches_like_jax():
    """The rate trigger fed synthetic readings (healthy for 6 steps, then
    ten times slower): both pools switch at the same step, and every
    frame before and after equals the JAX pool's."""
    kw = dict(adaptive_frontend=True, degrade_ratio=4.0, adapt_min_samples=4)
    tw = Twin("host", **kw)
    n = 13
    streams = {"a": gop(101, A, n=n), "b": gop(102, A, n=n),
               "x": gop(103, B, n=n)}
    for sid in streams:
        tw.add(sid, A if sid != "x" else B)
    clock = {"t": 0}

    def stats(dec):
        return (1 << 20, 0.001 if clock["t"] < 6 else 0.010)
    tw.j._transfer_stats_fn = tw.t._transfer_stats_fn = stats
    switched = []
    for t in range(n):
        clock["t"] = t
        tw.step({sid: f[t] for sid, f in streams.items()})
        if tw.t.frontend == "device" and not switched:
            switched.append(t)
    assert switched and 6 <= switched[0] < n - 1
    assert tw.t._bw_samples == tw.j._bw_samples
    assert tw.t._bw_best == tw.j._bw_best
    tw.present()
    # Readings too small to estimate a rate are skipped.
    p = StreamPool(frontend="host", device="cpu", **kw)
    p._note_transfer(512, 0.001)
    p._note_transfer(1 << 20, 0.0)
    assert p._bw_samples == 0 and p._bw_ema is None
