"""Checkpoints across the two packages (`h263_tpu_torch/utils/checkpoint.py`
against `h263_tpu/utils/checkpoint.py`, format v2).

A blob the JAX package writes mid-GOP for each of the four surfaces (the
single-stream decoder with either backend, the device front-end, the
batched host front-end, and pools on both front-ends with pending
registrations and free slots) loads into the port, and the port's
continued decode equals the JAX decoder's, plane for plane.  The port's
blobs round-trip within the port, a port decoder blob resumes in the JAX
decoder, and v1 blobs (pickles of the JAX package's classes) are refused.
The JAX-only constructor knobs of a JAX blob or a caller are dropped by
name; any other unknown keyword still raises.  The two batched decoders'
blobs move between sharded (`mesh=`) and unsharded decoders both ways.
All on the CPU.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu import DecoderOption as JOpt  # noqa: E402
from h263_tpu import H263Decoder as JaxDecoder  # noqa: E402
from h263_tpu import PictureTypeCode  # noqa: E402
from h263_tpu.parallel.batch import (  # noqa: E402
    BatchedStreamDecoder as JaxBatched,
)
from h263_tpu.parallel.device_batch import (  # noqa: E402
    DeviceFrontendDecoder as JaxDevice,
)
from h263_tpu.parallel.pool import StreamPool as JaxPool  # noqa: E402
from h263_tpu.testing.encoder import (  # noqa: E402
    MBSpec,
    encode_sorenson_picture,
)
from h263_tpu.utils import checkpoint as jck  # noqa: E402
from h263_tpu_torch import H263Decoder  # noqa: E402
from h263_tpu_torch.testing import corpora as C  # noqa: E402
from h263_tpu_torch.types import DecoderOption, PictureOption  # noqa: E402
from h263_tpu_torch.utils import checkpoint as tck  # noqa: E402

SOR = JOpt.SORENSON_SPARK_BITSTREAM
DEV = "cpu"


def _gop(seed, width=32, height=32, n=6, disposable_at=None):
    """I then P-frames with motion and residuals; an all-uncoded
    disposable P-frame at `disposable_at`, so that a state saved after it
    holds two pictures (the last and the reference)."""
    rng = np.random.default_rng(seed)
    nmb = (-(-width // 16)) * (-(-height // 16))
    frames = [encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6,
                blocks=[[(0, int(rng.integers(1, 9)))], [], [], [], [], []])
         for _ in range(nmb)], temporal_reference=0)]
    for tr in range(1, n):
        if tr == disposable_at:
            frames.append(encode_sorenson_picture(
                width, height, PictureTypeCode.DISPOSABLE_P_FRAME,
                [MBSpec(kind="uncoded")] * nmb, temporal_reference=tr,
                pad_bit=1))
            continue
        frames.append(encode_sorenson_picture(
            width, height, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter",
                    mvd=[(int(rng.integers(-9, 10)),
                          int(rng.integers(-9, 10)))],
                    blocks=[[(0, int(rng.integers(1, 6)))], [], [], [], [],
                            []])
             for _ in range(nmb)], temporal_reference=tr,
            quantizer=int(rng.integers(2, 20))))
    return frames


def _eq(a, b, tag=""):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=tag)


def _decoder_state(dec):
    return (dec.last_picture, dec.reference_picture,
            int(dec.running_options), sorted(dec.reference_states),
            int(dec.decoder_options))


# -- the single-stream decoder ---------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "jax"])
@pytest.mark.parametrize("stream", ["sorenson", "standard_umv"])
def test_jax_decoder_blob_resumes_in_the_port(backend, stream):
    if stream == "sorenson":
        opts, frames, cut = SOR, _gop(1, 48, 32, 6, disposable_at=2), 3
    else:  # the running options carry the UMV of the I-picture's OPPTYPE
        opts, frames, cut = JOpt.NONE, C.umv_corpus(176, 144, 4), 2
    jd = JaxDecoder(opts, backend=backend)
    for f in frames[:cut]:
        jd.decode_next_picture(f)
    port = tck.load_decoder_state(jck.save_decoder_state(jd), device=DEV)
    assert _decoder_state(port) == _decoder_state(jd)
    if stream == "sorenson":
        assert len(port.reference_states) == 2
    else:
        assert port.running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS
    assert port.get_last_picture().luma.device.type == DEV
    for t, f in enumerate(frames[cut:]):
        _eq(port.decode_next_picture(f).as_yuv(),
            jd.decode_next_picture(f).as_yuv(), f"frame {cut + t}")
        assert _decoder_state(port) == _decoder_state(jd)
    np.testing.assert_array_equal(port.last_picture_rgba(True),
                                  jd.last_picture_rgba(True))


def test_port_decoder_blob_round_trips_and_resumes_in_jax():
    frames = _gop(2, 40, 24, 7, disposable_at=3)
    whole = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEV)
    port = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=DEV)
    for f in frames[:4]:
        whole.decode_next_picture(f)
        port.decode_next_picture(f)
    blob = tck.save_decoder_state(port)
    again = tck.load_decoder_state(blob, device=DEV)
    jd = jck.load_decoder_state(blob, backend="numpy")
    assert _decoder_state(again) == _decoder_state(port)
    assert _decoder_state(jd) == _decoder_state(port)
    assert jck.load_decoder_state(blob).backend == "numpy"
    for t, f in enumerate(frames[4:]):
        want = whole.decode_next_picture(f).as_yuv()
        _eq(again.decode_next_picture(f).as_yuv(), want, f"port {t}")
        _eq(jd.decode_next_picture(f).as_yuv(), want, f"jax {t}")
    np.testing.assert_array_equal(again.last_picture_rgba(),
                                  jd.last_picture_rgba())


# -- the batched host front-end ---------------------------------------------


@pytest.mark.parametrize("standard", [False, True])
def test_jax_batched_blob_resumes_in_the_port(standard):
    if standard:
        opts, w, h = JOpt.NONE, 176, 144
        streams = [C.std_qcif_corpus()[:5], C.d3_corpus(176, 144, 5)]
        kw = {}
    else:  # the JAX decoder on another transport: dropped on load
        opts, w, h = SOR, 32, 32
        streams = [_gop(10 + i) for i in range(3)]
        kw = {"coef_transport": "split"}
    n = len(streams)
    jd = JaxBatched(n, w, h, opts, **kw)
    for t in range(3):
        jd.decode_step([s[t] for s in streams])
    port = tck.load_batched_state(jck.save_batched_state(jd), device=DEV)
    assert port.pack_cap == jd.pack_cap and port._mv_full == jd._mv_full
    np.testing.assert_array_equal(port._std_prev_fmt, jd._std_prev_fmt)
    for a, b in zip(port.states, jd.states):
        assert (int(a.running_options), a.has_reference) == (
            int(b.running_options), b.has_reference)
    for t in range(3, len(streams[0])):
        bufs = [s[t] for s in streams]
        _eq(port.decode_step(bufs), jd.decode_step(bufs), f"step {t}")

    again = tck.load_batched_state(tck.save_batched_state(port), device=DEV)
    _eq((again.ref_y, again.ref_cb, again.ref_cr),
        (port.ref_y, port.ref_cb, port.ref_cr))
    assert again._mv_full == port._mv_full


# -- the device front-end ----------------------------------------------------


def test_jax_device_frontend_blob_resumes_in_the_port():
    n = 3
    streams = [_gop(30 + i) for i in range(n)]
    jd = JaxDevice(n, 32, 32, SOR, pallas="off")
    for t in range(3):
        jd.decode_step([s[t] for s in streams])
    blob = jck.save_device_frontend_state(jd)
    meta, _ = jck._unpack(blob)
    assert {"tape_len", "harness", "unroll", "pallas", "payload",
            "buf_lens"} <= set(meta)
    port = tck.load_device_frontend_state(blob, device=DEV)
    assert port.max_frame_bytes == jd.max_frame_bytes
    np.testing.assert_array_equal(port._last_quant, jd._last_quant)
    np.testing.assert_array_equal(port._last_deblock, jd._last_deblock)
    np.testing.assert_array_equal(port.fetch_status(), jd.fetch_status())
    for t in range(3, 6):
        bufs = [s[t] for s in streams]
        _eq(port.decode_step(bufs), jd.decode_step(bufs), f"step {t}")

    again = tck.load_device_frontend_state(
        tck.save_device_frontend_state(port), device=DEV)
    _eq((again.ref_y, again.ref_cb, again.ref_cr),
        (port.ref_y, port.ref_cb, port.ref_cr))
    np.testing.assert_array_equal(again._last_quant, port._last_quant)
    np.testing.assert_array_equal(again.fetch_status(), port.fetch_status())
    # The JAX-only knobs go by name; another keyword raises.
    tck.load_device_frontend_state(blob, device=DEV, tape_len=9,
                                   harness="xla", unroll=2, pallas="off",
                                   payload="ragged")
    with pytest.raises(TypeError):
        tck.load_device_frontend_state(blob, device=DEV, bogus=1)


def test_port_standard_device_frontend_round_trip():
    """A standard device decoder's header state (last pictures, carried
    running options) survives a round trip within the port."""
    from h263_tpu_torch import DeviceFrontendDecoder

    streams = [C.umv_corpus(48, 32, 4), C.umv_corpus(48, 32, 4, seed=401)]

    whole = DeviceFrontendDecoder(2, 48, 32, DecoderOption.NONE, device=DEV)
    dec = DeviceFrontendDecoder(2, 48, 32, DecoderOption.NONE, device=DEV)
    for t in range(2):
        whole.decode_step([s[t] for s in streams])
        dec.decode_step([s[t] for s in streams])
    again = tck.load_device_frontend_state(
        tck.save_device_frontend_state(dec), device=DEV)
    assert again._running == dec._running and again._pictures == dec._pictures
    for t in range(2, 4):
        bufs = [s[t] for s in streams]
        _eq(again.decode_step(bufs), whole.decode_step(bufs), f"step {t}")


# -- mesh decoders -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["batched", "device_frontend"])
def test_blobs_move_between_mesh_and_unsharded_decoders(kind):
    """A JAX v2 blob resumes in a port decoder sharded over ["cpu"] * 4
    and continues as the JAX decoder does; that mesh decoder's blob
    resumes unsharded, and an unsharded blob over the mesh, each equal to
    the uninterrupted decode on the next frames."""
    from h263_tpu_torch import make_stream_mesh

    save, load = {
        "batched": (tck.save_batched_state, tck.load_batched_state),
        "device_frontend": (tck.save_device_frontend_state,
                            tck.load_device_frontend_state)}[kind]
    jax_save = {"batched": jck.save_batched_state,
                "device_frontend": jck.save_device_frontend_state}[kind]
    n = 4
    streams = [_gop(60 + i, n=5) for i in range(n)]
    jd = (JaxBatched(n, 32, 32, SOR) if kind == "batched"
          else JaxDevice(n, 32, 32, SOR, pallas="off"))
    for t in range(2):
        jd.decode_step([s[t] for s in streams])
    mesh = make_stream_mesh(["cpu"] * 4)
    sharded = load(jax_save(jd), mesh=mesh)
    assert sharded.mesh is mesh and len(sharded.ref_y) == 4
    if kind == "device_frontend":
        np.testing.assert_array_equal(sharded.fetch_status(),
                                      jd.fetch_status())
    bufs = [s[2] for s in streams]
    _eq(sharded.decode_step(bufs), jd.decode_step(bufs), "jax -> mesh")

    plain = load(save(sharded), device=DEV)       # mesh -> unsharded
    assert plain.mesh is None
    bufs = [s[3] for s in streams]
    _eq(plain.decode_step(bufs), jd.decode_step(bufs), "mesh -> unsharded")
    again = load(save(plain), mesh=mesh)          # unsharded -> mesh
    bufs = [s[4] for s in streams]
    _eq(again.decode_step(bufs), jd.decode_step(bufs), "unsharded -> mesh")
    _eq((again.ref_y, again.ref_cb, again.ref_cr),
        (jd.ref_y, jd.ref_cb, jd.ref_cr))


# -- pools -------------------------------------------------------------------


def _pool_traffic():
    gops = {"a": _gop(40), 5: _gop(41), "c": _gop(42, 48, 32),
            "d": _gop(43, 64, 48)}

    def build(pool):
        pool.add_stream("a", 32, 32)
        pool.add_stream(5, 32, 32)          # an int stream id
        pool.add_stream("c", 48, 32)
        for t in range(3):
            pool.decode_step({"a": gops["a"][t], 5: gops[5][t],
                              "c": gops["c"][t]})
        pool.remove_stream(5)               # leaves a free slot behind
        pool.add_stream("d", 64, 48)        # pending: never decoded yet
        return pool

    def step(t):
        return {"a": gops["a"][t], "c": gops["c"][t], "d": gops["d"][t - 3]}

    return build, step


def _same_membership(a, b):
    assert a._dims == b._dims and a._pending == b._pending
    assert sorted(a._buckets) == sorted(b._buckets)
    for key, bucket in b._buckets.items():
        assert a._buckets[key].slots == bucket.slots
        assert a._buckets[key].free == bucket.free


@pytest.mark.parametrize("frontend", ["host", "device"])
def test_jax_pool_blob_resumes_in_the_port(frontend):
    build, step = _pool_traffic()
    jp = build(JaxPool(frontend=frontend, pallas="off"))
    blob = jck.save_pool_state(jp)
    port = tck.load_pool_state(blob, device=DEV)
    assert port.frontend == frontend and port.device == DEV
    _same_membership(port, jp)
    for t in range(3, 5):
        want, got = jp.decode_step(step(t)), port.decode_step(step(t))
        for sid in ("a", "c", "d"):
            _eq(got[sid], want[sid], f"{sid} t={t}")
    with pytest.raises(TypeError):
        tck.load_pool_state(blob, device=DEV, bogus=1)


@pytest.mark.parametrize("frontend", ["host", "device"])
def test_port_pool_round_trip(frontend):
    from h263_tpu_torch import StreamPool

    build, step = _pool_traffic()
    whole = build(StreamPool(frontend=frontend, device=DEV))
    pool = build(StreamPool(frontend=frontend, device=DEV,
                            max_frame_bytes=4096))
    again = tck.load_pool_state(tck.save_pool_state(pool), device=DEV)
    _same_membership(again, pool)
    assert again.max_frame_bytes == 4096
    for t in range(3, 5):
        want, got = whole.decode_step(step(t)), again.decode_step(step(t))
        for sid in ("a", "c", "d"):
            _eq(got[sid], want[sid], f"{sid} t={t}")
    _eq([again.present_rgba()[s] for s in ("a", "c", "d")],
        [whole.present_rgba()[s] for s in ("a", "c", "d")])


# -- what the loaders refuse -------------------------------------------------


def test_v1_blobs_and_other_kinds_are_refused():
    v1 = pickle.dumps({"version": 1, "decoder_options": 1, "backend": "numpy",
                       "last_picture": None, "reference_picture": None,
                       "running_options": 0, "pictures": {}})
    for load in (tck.load_decoder_state, tck.load_batched_state,
                 tck.load_device_frontend_state, tck.load_pool_state):
        with pytest.raises(ValueError, match="v1"):
            load(v1)
    blob = tck.save_decoder_state(H263Decoder(device=DEV))
    with pytest.raises(ValueError, match="kind"):
        tck.load_batched_state(blob)
    assert tck.load_decoder_state(blob, device=DEV).get_last_picture() is None
