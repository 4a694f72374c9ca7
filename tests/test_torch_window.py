"""The K-frame window of the port (`decode_steps` of `DeviceFrontendDecoder`
and of `StreamPool`, device="cpu") against the JAX package's windows and
against the port's own sequential `decode_step`, with zero tolerance:
planes, statuses, presentation state and error classes must be equal.

Also here: the window's automaton call over T*S lanes against T per-frame
calls, the `out=` planes of the reconstruction, and the stage timers of
`utils/trace.py`.  Sizes are small (48x32 and 32x32, S <= 6, T <= 5); the
JAX side runs on the CPU with `unroll=1`, and each JAX result is computed
once per module (the window shapes repeat, so its programs compile once).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu import H263Decoder  # noqa: E402
from h263_tpu.parallel.device_batch import (  # noqa: E402
    DeviceFrontendDecoder as JaxDecoder,
)
from h263_tpu.parallel.pool import StreamPool as JaxPool  # noqa: E402
from h263_tpu.types import DecoderOption as JaxOption  # noqa: E402
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu.utils import trace as jax_trace  # noqa: E402
from h263_tpu_torch import DeviceFrontendDecoder, StreamPool  # noqa: E402
from h263_tpu_torch.native import DevicePrepBatch  # noqa: E402
from h263_tpu_torch.ops.reconstruct_cuda import (  # noqa: E402
    reconstruct_from_dense_cuda,
)
from h263_tpu_torch.parser import automaton_cuda  # noqa: E402
from h263_tpu_torch.testing.corpora import rich_gop  # noqa: E402
from h263_tpu_torch.types import H263Error  # noqa: E402
from h263_tpu_torch.utils import trace  # noqa: E402

SORENSON = JaxOption.SORENSON_SPARK_BITSTREAM
W, H = 48, 32
S = 3


def _lists(seed, T=4, n=None):
    streams = [rich_gop(seed + i, W, H, n=n or T) for i in range(S)]
    return [[streams[i][t] for i in range(S)] for t in range(T)]


def _case(name):
    """The frame lists of each decoder case: T lists of S buffers."""
    lists = _lists(810)
    if name == "absent_and_corrupt":
        lists[1][1] = None                           # absent
        lists[2][1] = lists[2][1][:14]               # cut in the block layer
        lists[3][0] = None
    elif name == "header_reject":
        lists[1][0] = b"\x12\x34\x56"                # header garbage
    elif name == "over_cap":
        lists[2][2] = lists[2][2] + b"\x00" * 9000   # over the transfer cap
    elif name == "t1":
        lists = lists[:1]
    return lists


CASES = ["rich", "absent_and_corrupt", "header_reject", "over_cap", "t1"]
_jax_results: dict = {}


def _jax_window(name):
    """The JAX decoder's window on a case: (planes [T, S, ...] per plane,
    status [T, S], last quantizers, error class name), once per module."""
    if name not in _jax_results:
        dec = JaxDecoder(S, W, H, SORENSON, payload="ragged", unroll=1)
        err = None
        try:
            dec.decode_steps(_case(name))
        except JaxH263Error as e:
            err = type(e).__name__
        # After a raise the planes are still the window's: the last frame's
        # refs; the whole window is read from the status and the refs only.
        _jax_results[name] = (
            [np.asarray(p) for p in (dec.ref_y, dec.ref_cb, dec.ref_cr)],
            np.asarray(dec.last_status_steps), dec._last_quant.copy(),
            dec._last_deblock.copy(), err)
    return _jax_results[name]


def _port_window(lists):
    dec = DeviceFrontendDecoder(S, W, H, device="cpu")
    out, err = None, None
    try:
        out = dec.decode_steps(lists)
    except H263Error as e:
        err = type(e).__name__
    return dec, out, err


def _port_sequential(lists):
    """T decode_step calls: per frame the planes and status, and the
    decoder."""
    dec = DeviceFrontendDecoder(S, W, H, device="cpu")
    frames, errs = [], []
    for bufs in lists:
        try:
            dec.decode_step(bufs)
            errs.append(None)
        except H263Error as e:
            errs.append(type(e).__name__)
        frames.append((dec.ref_y, dec.ref_cb, dec.ref_cr, dec.last_status))
    return dec, frames, errs


@pytest.mark.parametrize("name", CASES)
def test_window_equals_jax_window_and_sequential_steps(name):
    lists = _case(name)
    T = len(lists)
    win, out, err = _port_window(lists)
    seq, frames, errs = _port_sequential(lists)
    # Every frame's planes and status equal the sequential steps'.
    status = win.last_status_steps
    assert tuple(status.shape) == (T, S)
    if out is not None:
        ys, cbs, crs = out
        assert tuple(ys.shape) == (T, S, H, W)
        for t, (y, cb, cr, st) in enumerate(frames):
            assert torch.equal(ys[t], y) and torch.equal(cbs[t], cb), t
            assert torch.equal(crs[t], cr), t
    for t, (y, cb, cr, st) in enumerate(frames):
        assert torch.equal(status[t], st), t
    assert torch.equal(win.last_status, status[T - 1])
    for a, b in zip((win.ref_y, win.ref_cb, win.ref_cr), frames[-1][:3]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(win._last_quant, seq._last_quant)
    np.testing.assert_array_equal(win._last_deblock, seq._last_deblock)
    # A header reject raises after the window has been dispatched.
    assert err == next((e for e in errs if e), None)
    assert (err is not None) == (name in ("header_reject", "over_cap"))
    # And the JAX package's window.
    jplanes, jstatus, jquant, jdeblock, jerr = _jax_window(name)
    assert err == jerr
    for a, b in zip((win.ref_y, win.ref_cb, win.ref_cr), jplanes):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(status.numpy(), jstatus)
    np.testing.assert_array_equal(win._last_quant, jquant)
    np.testing.assert_array_equal(win._last_deblock, jdeblock)


def test_absent_lanes_and_corruption_stay_in_their_lanes():
    _, (ys, _, _), _ = _port_window(_case("absent_and_corrupt"))
    _, (clean, _, _), _ = _port_window(_case("rich"))
    # An absent lane's planes do not move for that frame.
    assert torch.equal(ys[1, 1], ys[0, 1]) and torch.equal(ys[3, 0], ys[2, 0])
    # Lane 2 never differs from the clean window, lane 0 not before its
    # absence, lane 1 not before its absence.
    assert torch.equal(ys[:, 2], clean[:, 2])
    assert torch.equal(ys[:3, 0], clean[:3, 0])
    assert torch.equal(ys[0, 1], clean[0, 1])
    assert not torch.equal(ys[2, 1], clean[2, 1])


def test_header_reject_window_still_produces_planes():
    lists = _case("header_reject")
    win = DeviceFrontendDecoder(S, W, H, device="cpu")
    with pytest.raises(H263Error, match="frame 1 stream 0"):
        win.decode_steps(lists)
    ok = DeviceFrontendDecoder(S, W, H, device="cpu")
    ok.decode_steps(_case("rich"))
    # The neighbours decoded the whole window; the rejected lane kept its
    # frame 0 for frame 1 and went on from there.
    for lane in (1, 2):
        assert torch.equal(win.ref_y[lane], ok.ref_y[lane])
    assert not torch.equal(win.ref_y[0], ok.ref_y[0])


def _jax_sequence(key, run):
    if key not in _jax_results:
        dec = JaxDecoder(S, W, H, SORENSON, payload="ragged", unroll=1)
        run(dec)
        _jax_results[key] = [np.asarray(p)
                             for p in (dec.ref_y, dec.ref_cb, dec.ref_cr,
                                       dec.last_status)]
    return _jax_results[key]


def _assert_state(dec, jax_state, seq):
    for a, b, c in zip((dec.ref_y, dec.ref_cb, dec.ref_cr, dec.last_status),
                       jax_state,
                       (seq.ref_y, seq.ref_cb, seq.ref_cr, seq.last_status)):
        np.testing.assert_array_equal(a.numpy(), b)
        assert torch.equal(a, c)


def test_big_window_then_smaller_window_on_the_same_buffers():
    """A window of rich frames, then a window of skip frames only: the
    second must not see the first's payload bytes."""
    lists = _lists(950)
    small = [[None] * S, [None] * S]

    def run(dec):
        dec.decode_steps(lists[:2])
        dec.decode_steps(small)

    win = DeviceFrontendDecoder(S, W, H, device="cpu")
    run(win)
    seq, _, _ = _port_sequential(lists[:2] + small)
    _assert_state(win, _jax_sequence("big_then_small", run), seq)
    assert (win.last_status == 0).all()


def test_decode_step_after_a_window_continues_from_its_planes():
    lists = _lists(970, T=5)

    def run(dec):
        dec.decode_steps(lists[:4])
        dec.decode_step(lists[4])

    win = DeviceFrontendDecoder(S, W, H, device="cpu")
    run(win)
    assert win.last_status_steps is None
    seq, _, _ = _port_sequential(lists)
    _assert_state(win, _jax_sequence("step_after_window", run), seq)


def test_reset_slot_state_between_windows():
    lists = _lists(990, T=2)
    fresh = rich_gop(999, W, H, n=2)
    later = [list(b) for b in _lists(995, T=2)]
    for t in range(2):
        later[t][1] = fresh[t]                  # a new stream in slot 1

    def run(dec):
        dec.decode_steps(lists)
        dec.reset_slot_state(1)
        dec.decode_steps(later)

    win = DeviceFrontendDecoder(S, W, H, device="cpu")
    win.decode_steps(lists)
    win.reset_slot_state(1)
    assert (win.ref_y[1] == 0).all()
    assert (win.last_status_steps[:, 1] == 0).all()
    win.decode_steps(later)
    seq = DeviceFrontendDecoder(S, W, H, device="cpu")
    for bufs in lists:
        seq.decode_step(bufs)
    seq.reset_slot_state(1)
    for bufs in later:
        seq.decode_step(bufs)
    _assert_state(win, _jax_sequence("reset_between_windows", run), seq)


def test_window_argument_checks():
    dec = DeviceFrontendDecoder(S, W, H, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        dec.decode_steps([])
    with pytest.raises(ValueError, match="expected 3"):
        dec.decode_steps([[None] * S, [None] * 2])


# -- the window's automaton call -----------------------------------------------


def _window_meta(lists):
    """Stage T frames as decode_steps does: one flat payload, meta
    [T, 6, S] with row 5 rebased."""
    prep = DevicePrepBatch(len(lists[0]), W, H)
    parts, meta, woff = [], [], 0
    for bufs in lists:
        total = sum(((len(b) + 3) // 4) * 4 for b in bufs)
        stage = np.zeros(total, np.uint8)
        m = np.zeros((6, len(bufs)), np.int32)
        prep.prepare_ragged(bufs, stage, m)
        m[5] += woff
        woff += total // 4
        parts.append(stage)
        meta.append(m)
    parts.append(np.zeros(4, np.uint8))
    return (torch.as_tensor(np.concatenate(parts)).view(-1, 4),
            torch.as_tensor(np.stack(meta)))


def test_window_automaton_call_equals_per_frame_calls():
    lists = _case("absent_and_corrupt")
    lists[0][2] = lists[0][2][:30]
    for t in range(4):
        lists[t] = [b if b is not None else rich_gop(1, W, H, n=2)[1]
                    for b in lists[t]]
    payload, meta = _window_meta(lists)
    got = automaton_cuda.parse_assemble_cuda(payload, meta, mbh=2, mbw=3,
                                             width=W, height=H)
    assert tuple(got[0].shape) == (4, S, 6 * 6, 64)
    assert tuple(got[3].shape) == (4, S)
    for t in range(4):
        want = automaton_cuda.parse_assemble_cuda(payload, meta[t], mbh=2,
                                                  mbw=3, width=W, height=H)
        for a, b in zip(got, want):
            assert torch.equal(a[t], b), t
    assert (got[3] != 0).any() and (got[3] == 0).any()
    assert automaton_cuda.launches == 0       # the plain version ran


def test_automaton_wrapper_refuses_bad_window_meta():
    payload = torch.zeros((4, 4), dtype=torch.uint8)
    for shape in ((2, 5, 3), (2, 2, 6, 3), (6,)):
        with pytest.raises(ValueError, match="meta"):
            automaton_cuda.parse_assemble_cuda(
                payload, torch.zeros(shape, dtype=torch.int32), mbh=2, mbw=3)


# -- reconstruct into given planes ---------------------------------------------


def _recon_inputs(seed):
    rng = np.random.default_rng(seed)
    dense = torch.as_tensor(rng.integers(-60, 60, (2, 36, 64)).astype(
        np.int16))
    mvs = torch.as_tensor(rng.integers(-9, 10, (2, 2, 3, 4, 2)).astype(
        np.int16))
    inter = torch.as_tensor(rng.random((2, 2, 3)) < 0.7)
    refs = [torch.as_tensor(rng.integers(0, 256, (2, *hw), dtype=np.uint8))
            for hw in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    return dense, mvs, inter, refs


def test_reconstruct_out_writes_the_given_planes():
    dense, mvs, inter, refs = _recon_inputs(3)
    want = reconstruct_from_dense_cuda(dense, mvs, inter, *refs)
    batch = [torch.zeros((3, *r.shape), dtype=torch.uint8) for r in refs]
    out = tuple(b[1] for b in batch)
    got = reconstruct_from_dense_cuda(dense, mvs, inter, *refs, out=out)
    for g, o, w, b in zip(got, out, want, batch):
        assert g.data_ptr() == o.data_ptr()
        assert torch.equal(o, w)
        assert not b[0].any() and not b[2].any()  # only its slice written


def test_reconstruct_out_checks():
    dense, mvs, inter, refs = _recon_inputs(4)
    with pytest.raises(ValueError, match="overlaps"):
        reconstruct_from_dense_cuda(dense, mvs, inter, *refs,
                                    out=(refs[0], torch.empty_like(refs[1]),
                                         torch.empty_like(refs[2])))
    with pytest.raises(ValueError, match="out y"):
        reconstruct_from_dense_cuda(
            dense, mvs, inter, *refs,
            out=(torch.empty((2, H, W + 1), dtype=torch.uint8),
                 torch.empty_like(refs[1]), torch.empty_like(refs[2])))


# -- the pool's window ---------------------------------------------------------


def _pools(**kw):
    return (JaxPool(SORENSON, frontend="device", unroll=1, **kw),
            StreamPool(device="cpu", **kw))


def _mixed_traffic():
    corp = {"a": rich_gop(11, 48, 32, n=5), "b": rich_gop(12, 48, 32, n=5),
            "q": rich_gop(13, 32, 32, n=5)}
    dims = {"a": (48, 32), "b": (48, 32), "q": (32, 32)}
    dicts = []
    for t in range(4):                  # "b" absent at 2, "q" absent at 3
        d = {"a": corp["a"][t]}
        if t != 2:
            d["b"] = corp["b"][t]
        if t != 3:
            d["q"] = corp["q"][t]
        dicts.append(d)
    return dims, dicts, {sid: c[4] for sid, c in corp.items()}


def _assert_results(got, want, dicts):
    assert len(got) == len(want) == len(dicts)
    for t, d in enumerate(dicts):
        assert set(got[t]) == set(want[t]) == set(d), t
        for sid in d:
            for a, b in zip(got[t][sid], want[t][sid]):
                np.testing.assert_array_equal(a, b, err_msg=f"{sid}@{t}")


def test_pool_window_matches_jax_window_and_sequential_steps():
    dims, dicts, last = _mixed_traffic()
    jp, tp = _pools()
    seq = StreamPool(device="cpu")
    for pool in (jp, tp, seq):
        for sid, wh in dims.items():
            pool.add_stream(sid, *wh)
    got = tp.decode_steps(dicts)
    _assert_results(got, jp.decode_steps(dicts), dicts)
    _assert_results(got, [seq.decode_step(d) for d in dicts], dicts)
    # The pools' state is that of the sequential steps: one more step.
    a, b = tp.decode_step(last), seq.decode_step(last)
    for sid in last:
        for x, y in zip(a[sid], b[sid]):
            np.testing.assert_array_equal(x, y, err_msg=sid)
    for deblock in (True, None):
        ra, rb = tp.present_rgba(deblock), seq.present_rgba(deblock)
        for sid in ra:
            assert torch.equal(ra[sid], rb[sid]), sid


def test_pool_window_makes_one_window_per_bucket(monkeypatch):
    dims, dicts, _ = _mixed_traffic()
    pool = StreamPool(device="cpu")
    for sid, wh in dims.items():
        pool.add_stream(sid, *wh)
    pool.decode_step(dicts[0])                  # buckets made
    calls = []
    for key, bucket in pool._buckets.items():
        def window(frames, _orig=bucket.dec.decode_steps, _key=key):
            calls.append((_key, len(frames)))
            return _orig(frames)

        def step(*args, **kwargs):
            pytest.fail("a bucket stepped frame by frame")

        monkeypatch.setattr(bucket.dec, "decode_steps", window)
        monkeypatch.setattr(bucket.dec, "decode_step", step)
    pool.decode_steps(dicts[1:])
    assert sorted(calls) == [((32, 32), 3), ((48, 32), 3)]


def test_pool_window_resolution_change_falls_back_to_steps():
    small, big = rich_gop(41, 32, 32, n=2), rich_gop(42, 48, 32, n=3)
    dicts = [{"a": small[0]}, {"a": small[1]}, {"a": big[0]}, {"a": big[1]}]
    jp, tp = _pools()
    seq = StreamPool(device="cpu")
    for pool in (jp, tp, seq):
        pool.add_stream("a", 32, 32)
    before = trace.get_counters().get("pool_window_fallbacks", 0)
    got = tp.decode_steps(dicts)
    assert trace.get_counters()["pool_window_fallbacks"] == before + 1
    _assert_results(got, jp.decode_steps(dicts), dicts)
    _assert_results(got, [seq.decode_step(d) for d in dicts], dicts)
    assert got[-1]["a"][0].shape == (32, 48)


def test_pool_window_error_is_raised_after_every_bucket_stepped():
    dims, dicts, _ = _mixed_traffic()
    dicts[1]["a"] = dicts[1]["a"][:7]           # the prep rejects the header
    jp, tp = _pools()
    for pool in (jp, tp):
        for sid, wh in dims.items():
            pool.add_stream(sid, *wh)
    results = []
    for pool, exc in ((jp, JaxH263Error), (tp, H263Error)):
        with pytest.raises(exc) as info:
            pool.decode_steps(dicts)
        results.append(info.value.pool_window_results)
    # The failing bucket's planes are not attached; the other's are.
    want = [{sid: d[sid] for sid in d if sid == "q"} for d in dicts]
    _assert_results(results[1], results[0], want)


def test_pool_window_unknown_ids_raise_before_any_step():
    pool = StreamPool(device="cpu")
    pool.add_stream("a", W, H)
    with pytest.raises(KeyError, match="unregistered"):
        pool.decode_steps([{"a": rich_gop(1, n=1)[0]}, {"zz": b""}])
    assert not pool._buckets                    # nothing finalized or run
    assert pool.decode_steps([]) == []


def test_pool_window_needs_no_overflow_repair():
    """TestPoolMegastep.test_window_overflow_repaired_at_sync_point: there
    the JAX pool's small tape overflows and `resolve_overflows` replays the
    window.  The port has no tape: its window equals the numpy reference
    decoder with no repair."""
    from h263_tpu_torch.testing.encoder import (MBSpec,
                                                encode_sorenson_picture)
    from h263_tpu_torch.types import PictureTypeCode

    def frames(seed, n=4):                    # tests/test_pool.py::_frames
        rng = np.random.default_rng(seed)
        out = [encode_sorenson_picture(
            48, 32, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
             for _ in range(6)], temporal_reference=0)]
        for tr in range(1, n):
            out.append(encode_sorenson_picture(
                48, 32, PictureTypeCode.P_FRAME,
                [MBSpec(kind="inter", mvd=[(2, 0)],
                        blocks=[[(0, 3)], [], [], [], [], []])] * 6,
                temporal_reference=tr))
        return out

    streams = {"x": frames(31), "y": frames(32)}
    pool = StreamPool(device="cpu")
    for sid in streams:
        pool.add_stream(sid, 48, 32)
    outs = pool.decode_steps([{sid: f[t] for sid, f in streams.items()}
                              for t in range(4)])
    for sid, f in streams.items():
        oracle = H263Decoder(SORENSON, backend="numpy")
        for t in range(4):
            pic = oracle.decode_next_picture(f[t])
            y, cb, cr = outs[t][sid]
            np.testing.assert_array_equal(y, pic.as_luma(), err_msg=sid)
            np.testing.assert_array_equal(cb, pic.as_chroma_b())
            np.testing.assert_array_equal(cr, pic.as_chroma_r())


# -- stage timers --------------------------------------------------------------


@pytest.fixture
def tracing():
    trace.reset_metrics()
    jax_trace.reset_metrics()
    trace.trace_enabled(True)
    jax_trace.trace_enabled(True)
    try:
        yield
    finally:
        trace.trace_enabled(False)
        jax_trace.trace_enabled(False)
        trace.reset_metrics()
        jax_trace.reset_metrics()


def test_stage_timers_of_a_window_match_the_jax_names(tracing):
    lists = _case("rich")
    dec = DeviceFrontendDecoder(S, W, H, device="cpu")
    dec.decode_steps(lists)
    m = trace.get_metrics()
    for stage in ("host_parse", "transfer", "reconstruct_dispatch"):
        assert m[stage]["count"] == 1, stage
    assert "reclaim_wait" not in m       # no copy in flight on the CPU
    # The JAX decoder's window (compiled by the module's first window test
    # or here) records the same stages, in the same dict shape.
    _jax_window("rich")
    jd = JaxDecoder(S, W, H, SORENSON, payload="ragged", unroll=1)
    jax_trace.reset_metrics()
    jd.decode_steps(lists)
    jm = jax_trace.get_metrics()
    assert set(jm) == set(m)
    for stage in m:
        assert set(m[stage]) == set(jm[stage]) == {
            "count", "total_s", "mean_ms", "min_ms", "max_ms"}
    assert m["host_parse"]["total_s"] > 0
    assert 0 < m["host_parse"]["min_ms"] <= m["host_parse"]["max_ms"]


def test_stage_timers_of_steps(tracing):
    dec = DeviceFrontendDecoder(S, W, H, device="cpu")
    for bufs in _case("rich")[:2]:
        dec.decode_step(bufs)
    m = trace.get_metrics()
    assert {k: v["count"] for k, v in m.items()} == {
        "host_parse": 2, "transfer": 2, "reconstruct_dispatch": 2}
    t = trace.StageTimer("custom").start()
    t.stop()
    t.stop()                                   # a second stop records nothing
    assert trace.get_metrics()["custom"]["count"] == 1


def test_stage_timers_off_record_nothing():
    trace.reset_metrics()
    trace.trace_enabled(False)
    dec = DeviceFrontendDecoder(S, W, H, device="cpu")
    dec.decode_steps(_case("t1"))
    dec.decode_step(_case("t1")[0])
    trace.StageTimer("custom").start().stop()
    assert trace.get_metrics() == {}


def test_torch_profile_writes_a_trace(tmp_path):
    with trace.torch_profile(str(tmp_path)):
        torch.ones(4).add_(1)
    assert any(tmp_path.iterdir())
