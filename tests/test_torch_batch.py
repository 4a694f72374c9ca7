"""The port's host-front-end decoder (`BatchedStreamDecoder(device="cpu")`)
against the JAX package's `BatchedStreamDecoder`, step for step.

Both decoders see the same frames and masks.  After every step they agree
on the error raised (by class), the planes, each stream's header state
(running options, reference flag, last picture) and the MV row mode, and
on `present_rgba` under each deblock setting.  Cases: fuzzed multi-step
scenarios of the fused transport (`h263_tpu.testing.fuzz._rand_fused_gop`:
version, quantizer and density churn, INTER4V frames for the slim->full MV
flip, disposable P-frames, cut and byte-flipped frames, masks), the
disposable-P reference quirk, `PackOverflow` replayed on the dense
transport, a corrupt lane (nothing committed, no plane changed),
`submit_step` / `decode_stream_pipelined` against sequential steps and a
failed pipelined step, the counters and stage timers, and the host IDCT
classes of the dense transport against the classes derived from its
coefficients.  Zero tolerance.
"""

import dataclasses
import enum

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu.parallel.batch import BatchedStreamDecoder as JaxDecoder  # noqa: E402,E501
from h263_tpu.testing.fuzz import _rand_fused_gop  # noqa: E402
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu.utils import trace as jtrace  # noqa: E402
from h263_tpu_torch import BatchedStreamDecoder  # noqa: E402
from h263_tpu_torch.ops.idct import derive_classes  # noqa: E402
from h263_tpu_torch.parallel import batch as tbatch  # noqa: E402
from h263_tpu_torch.testing.corpora import rich_gop  # noqa: E402
from h263_tpu_torch.testing.encoder import (  # noqa: E402
    MBSpec,
    encode_sorenson_picture,
)
from h263_tpu_torch.types import (  # noqa: E402
    DecoderOption,
    H263Error,
    PictureTypeCode,
)
from h263_tpu_torch.utils import trace as ttrace  # noqa: E402

COUNTERS = ("frames_decoded", "steps", "steps_dense", "steps_fused",
            "steps_fused_flip", "pack_overflow_fallbacks", "transfer_bytes")


def _plain(v):
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def _states(dec):
    return [(int(s.running_options), s.has_reference, _plain(s.last_header))
            for s in dec.states]


class Twin:
    """The JAX decoder and the port's driven alike and compared."""

    def __init__(self, n, w, h, **kw):
        self.j = JaxDecoder(n, w, h, pallas="off", **kw)
        self.t = BatchedStreamDecoder(n, w, h, device="cpu", **kw)
        self.n = n

    def step(self, bufs, mask=None, transport="auto"):
        """Step both; the port's planes, or its error when both raised."""
        out = []
        for dec, err in ((self.j, JaxH263Error), (self.t, H263Error)):
            try:
                out.append(dec.decode_step(bufs, transport=transport,
                                           mask=mask))
            except err as e:
                out.append(e)
        a, b = out
        assert type(a).__name__ == type(b).__name__, (a, b)
        if not isinstance(b, Exception):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        self.check()
        return b

    def check(self):
        assert _states(self.t) == _states(self.j)
        assert self.t._mv_full == self.j._mv_full
        for name in ("ref_y", "ref_cb", "ref_cr"):
            np.testing.assert_array_equal(getattr(self.t, name).numpy(),
                                          np.asarray(getattr(self.j, name)))

    def present(self):
        for deblock in (None, True, False):
            np.testing.assert_array_equal(
                self.t.present_rgba(deblock).numpy(),
                np.asarray(self.j.present_rgba(deblock)))


@pytest.mark.parametrize("seed", range(4))
def test_fuzzed_scenarios_match_jax(seed):
    rng = np.random.default_rng(200 + seed)
    w, h = [(48, 48), (64, 48), (80, 64), (96, 64)][seed]
    S, T = int(rng.integers(2, 5)), int(rng.integers(6, 10))
    gops = [_rand_fused_gop(rng, w, h, T) for _ in range(S)]
    for s in range(S):
        for t in range(1, T):
            r = rng.random()
            buf = gops[s][t]
            if r < 0.08:
                gops[s][t] = buf[:int(rng.integers(4, len(buf) + 1))]
            elif r < 0.13:
                mut = bytearray(buf)
                mut[int(rng.integers(4, len(mut)))] ^= int(
                    rng.integers(1, 256))
                gops[s][t] = bytes(mut)
    tw = Twin(S, w, h)
    for t in range(T):
        mask = ([bool(x) for x in rng.random(S) < 0.7]
                if rng.random() < 0.25 else None)
        tw.step([g[t] for g in gops], mask=mask)
    tw.present()


def test_mv_flip_and_later_full_rows():
    """The first frame whose block MVs vary re-ships over the three-part
    transport; later parses write 8 B/MB rows."""
    n, w, h = 2, 64, 48
    nmb = 12
    rng = np.random.default_rng(9)
    frames = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
         for _ in range(nmb)])]
    for tr in range(1, 6):
        fourv = tr in (2, 4)
        frames.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter4v" if fourv and k % 2 else "inter",
                    mvd=[(int(rng.integers(-5, 6)), int(rng.integers(-5, 6)))
                         for _ in range(4 if fourv and k % 2 else 1)],
                    blocks=[[(0, int(rng.integers(1, 9)))], [], [], [], [],
                            []])
             for k in range(nmb)], temporal_reference=tr))
    tw = Twin(n, w, h)
    flips = ttrace.get_counters().get("steps_fused_flip", 0)
    for t, f in enumerate(frames):
        tw.step([f, frames[max(t - 1, 0)] if t < 2 else f])
        assert tw.t._mv_full == (t >= 2)
    assert ttrace.get_counters()["steps_fused_flip"] == flips + 1
    tw.present()


def test_disposable_pframe_reference_quirk():
    """tests/test_fused_transport.py::test_disposable_pframe_reference_quirk
    through both decoders: a P-frame after a disposable one predicts from
    the disposable frame."""
    n, w, h = 2, 64, 48
    nmb = 12
    rng = np.random.default_rng(17)

    def p_frame(kind, tr):
        if kind is PictureTypeCode.DISPOSABLE_P_FRAME:
            return encode_sorenson_picture(
                w, h, kind, [MBSpec(kind="uncoded")] * nmb,
                temporal_reference=tr, pad_bit=1)
        return encode_sorenson_picture(
            w, h, kind, [MBSpec(kind="inter", mvd=[(int(rng.integers(-4, 5)),
                                                     int(rng.integers(-4, 5)))],
                                blocks=[[(0, int(rng.integers(1, 9)))], [], [],
                                        [], [], []]) for _ in range(nmb)],
            temporal_reference=tr)

    frames = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
         for _ in range(nmb)])]
    for tr, kind in enumerate((PictureTypeCode.P_FRAME,
                               PictureTypeCode.DISPOSABLE_P_FRAME,
                               PictureTypeCode.P_FRAME,
                               PictureTypeCode.DISPOSABLE_P_FRAME,
                               PictureTypeCode.P_FRAME), start=1):
        frames.append(p_frame(kind, tr))
    tw = Twin(n, w, h)
    for f in frames:
        tw.step([f] * n)
        assert [s.has_reference for s in tw.t.states] == [True] * n
    tw.present()


def test_pack_overflow_replays_on_the_dense_transport():
    n, w, h = 3, 48, 32
    streams = [rich_gop(300 + i, w, h, n=4) for i in range(n)]
    tw = Twin(n, w, h, pack_cap=40)
    before = ttrace.get_counters().get("pack_overflow_fallbacks", 0)
    for t in range(4):
        tw.step([s[t] for s in streams], mask=[True, t != 2, True])
    assert ttrace.get_counters()["pack_overflow_fallbacks"] > before
    with pytest.raises(H263Error) as e:
        tw.t.decode_step([s[0] for s in streams], transport="packed")
    assert type(e.value).__name__ == "PackOverflow"
    tw.present()


def test_corrupt_lane_commits_nothing():
    n, w, h = 3, 48, 32
    streams = [rich_gop(400 + i, w, h, n=3) for i in range(n)]
    for transport in ("auto", "dense"):
        tw = Twin(n, w, h)
        tw.step([s[0] for s in streams], transport=transport)
        states, planes = _states(tw.t), tw.t.ref_y.clone()
        bad = [streams[0][1], streams[1][1][:12], streams[2][1]]
        err = tw.step(bad, transport=transport)
        assert isinstance(err, H263Error)
        assert _states(tw.t) == states and torch.equal(tw.t.ref_y, planes)
        tw.step([s[1] for s in streams], transport=transport)
        tw.present()


def test_pipelined_steps_equal_sequential_steps():
    n, w, h = 3, 48, 32
    streams = [rich_gop(500 + i, w, h, n=5) for i in range(n)]
    lists = [[s[t] for s in streams] for t in range(5)]
    seq = BatchedStreamDecoder(n, w, h, device="cpu")
    want = [tuple(p.clone() for p in seq.decode_step(b)) for b in lists]
    pipe = BatchedStreamDecoder(n, w, h, device="cpu")
    got = list(pipe.decode_stream_pipelined(iter(lists)))
    for g, ww in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, ww))
    futs = [BatchedStreamDecoder(n, w, h, device="cpu")]
    futs = [futs[0].submit_step(b) for b in lists]
    for f, ww in zip(futs, want):
        assert all(torch.equal(a, b) for a, b in zip(f.result(), ww))
    assert _states(pipe) == _states(seq)


def test_failed_pipelined_step_does_not_poison_its_buffer(monkeypatch):
    """tests/test_parallel.py::test_failed_step_does_not_poison_its_buffer:
    the failed step's error comes once through its future; re-submitting
    its frame and going on matches a clean decoder."""
    n, w, h = 2, 48, 32
    frames = rich_gop(600, w, h, n=5)
    calls = {"n": 0}

    def flaky(real):
        def fn(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 2:   # the second step's device stage fails
                raise RuntimeError("transient device failure")
            return real(*args, **kwargs)
        return fn

    for name in ("reconstruct_frame_packed_d24_fused",
                 "reconstruct_frame_packed_d24"):
        monkeypatch.setattr(tbatch, name, flaky(getattr(tbatch, name)))
    dec = BatchedStreamDecoder(n, w, h, device="cpu")
    golden = BatchedStreamDecoder(n, w, h, device="cpu")
    fut0 = dec.submit_step([frames[0]] * n)
    fut1 = dec.submit_step([frames[1]] * n)
    fut0.result()
    with pytest.raises(RuntimeError):
        fut1.result()
    outs = [tuple(p.clone() for p in golden.decode_step([f] * n))
            for f in frames]
    for t in (1, 2, 3, 4):
        y, cb, cr = dec.submit_step([frames[t]] * n).result()
        assert torch.equal(y, outs[t][0]), t


def test_counters_and_stage_timers_match_jax():
    n, w, h = 2, 48, 32
    streams = [rich_gop(700 + i, w, h, n=4) for i in range(n)]
    mods = (jtrace, ttrace)
    tw = Twin(n, w, h, pack_cap=40)
    tw.step([s[0] for s in streams])           # compile, build
    for m in mods:
        m.reset_metrics()
        m.trace_enabled(True)

    def shipped():
        """The bytes the port's last step should have copied: its whole
        staging rows (the JAX package copies their used prefix), with the
        full MVs and byte flags on the flip step; on the dense transport
        the JAX package's bytes less its host IDCT classes (n * 6 * nmb
        bytes), which the kernel derives from the coefficients."""
        d = tw.t
        if d.last_transfer_bytes != d._packed[d._packed_idx].fused_t.numel():
            p = d._packed[d._packed_idx]
            flip = p.fused_t.numel() + p.mvs_t.numel() * 2 + p.inter_t.numel()
            dense = tw.j.last_transfer_bytes - n * 36
            assert d.last_transfer_bytes in (flip, dense)
        return d.last_transfer_bytes

    sent = []
    try:
        for t in range(1, 4):
            tw.step([s[t] for s in streams], mask=[True, t != 2])
            sent.append(shipped())
        tw.step([s[0] for s in streams])       # I-frames overflow: dense
        assert shipped() == tw.j.last_transfer_bytes - n * 36
        sent.append(shipped())
    finally:
        for m in mods:
            m.trace_enabled(False)
    jc, tc = jtrace.get_counters(), ttrace.get_counters()
    dense_steps = tc.get("steps_dense", 0)
    assert dense_steps >= 1 and tc.get("steps_fused", 0) >= 1
    for k in COUNTERS[:-1]:
        assert tc.get(k, 0) == jc.get(k, 0), k
    assert tc["transfer_bytes"] == sum(sent)
    jm, tm = jtrace.get_metrics(), ttrace.get_metrics()
    for stage in ("host_parse", "bucket_slice", "transfer",
                  "reconstruct_dispatch"):
        assert tm[stage]["count"] == jm[stage]["count"], stage


def test_dense_host_classes_equal_derived_classes():
    """The native dense parse's IDCT classes equal the classes the fused
    kernel derives from the coefficients, on fuzzed GOPs."""
    rng = np.random.default_rng(800)
    w, h, n = 80, 64, 3
    gops = [_rand_fused_gop(rng, w, h, 6) for _ in range(n)]
    dec = BatchedStreamDecoder(n, w, h, device="cpu")
    checked = 0
    for t in range(6):
        try:
            dec.decode_step([g[t] for g in gops], transport="dense")
        except H263Error:
            continue
        b = dec._batches[dec._batch_idx]
        classes = np.concatenate([b.class_y.reshape(n, -1),
                                  b.class_cb.reshape(n, -1),
                                  b.class_cr.reshape(n, -1)], axis=1)
        np.testing.assert_array_equal(derive_classes(b.dense_t).numpy(),
                                      classes)
        checked += 1
    assert checked >= 3


def test_options():
    # Standard streams are served, with a skip frame of their own flavour.
    std = BatchedStreamDecoder(2, 48, 32, DecoderOption.NONE, device="cpu")
    assert std.skip_frame_bytes() != BatchedStreamDecoder(
        2, 48, 32, device="cpu").skip_frame_bytes()
    with pytest.raises(ValueError):
        BatchedStreamDecoder(2, 48, 32, device="cpu").decode_step(
            [b"", b""], transport="d24")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchedStreamDecoder(2, 48, 32)
