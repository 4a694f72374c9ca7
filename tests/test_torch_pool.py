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
byte-flipped) through both front-ends.  Small dims (48x32 and 64x48) and
few bucket sizes keep the JAX side's compiles few; `unroll=1` only shortens
them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu.parallel.pool import StreamPool as JaxPool  # noqa: E402
from h263_tpu.types import DecoderOption as JaxOption  # noqa: E402
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu_torch.parallel.pool import StreamPool  # noqa: E402
from h263_tpu_torch.testing.encoder import (  # noqa: E402
    BitWriter,
    MBSpec,
    encode_sorenson_picture,
)
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
    """The JAX pool and the port's pool driven alike and compared."""

    def __init__(self, frontend="device", **kw):
        extra = {"unroll": 1} if frontend == "device" else {}
        self.frontend = frontend
        self.j = JaxPool(JaxOption.SORENSON_SPARK_BITSTREAM,
                         frontend=frontend, **extra, **kw)
        self.t = StreamPool(frontend=frontend, device="cpu", **kw)

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
            if self.frontend == "host":
                assert tb.dec._mv_full == jb.dec._mv_full
                for i, (a, b) in enumerate(zip(tb.dec.states,
                                               jb.dec.states)):
                    assert (int(a.running_options), a.has_reference,
                            _picture_fields(a.last_header)) == (
                        int(b.running_options), b.has_reference,
                        _picture_fields(b.last_header)), (key, i)
                continue
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
    with pytest.raises(ValueError):
        StreamPool(DecoderOption.NONE, device="cpu")
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
