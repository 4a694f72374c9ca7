"""The port's stream sharding (`h263_tpu_torch/parallel/sharding.py`, `mesh=`
on both batched decoders) against the JAX package's sharded programs and
decoders on the conftest's 8 virtual XLA CPU devices, and against the
port's unsharded decoders, on CPU meshes (`["cpu"] * k`).  Zero tolerance:
planes, statuses, RGBA, error classes and the global stream index in each
error message."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from h263_tpu.ops.idct import derive_classes_jnp  # noqa: E402
from h263_tpu.parallel import BatchedStreamDecoder as JaxBatched  # noqa: E402
from h263_tpu.parallel import make_stream_mesh as jax_mesh  # noqa: E402
from h263_tpu.parallel import shard_present_fn as jax_present  # noqa: E402
from h263_tpu.parallel import shard_reconstruct_fn as jax_recon  # noqa: E402
from h263_tpu.parallel.device_batch import (  # noqa: E402
    DeviceFrontendDecoder as JaxDevice,
)
from h263_tpu.types import DecoderOption as JaxOption  # noqa: E402
from h263_tpu_torch import (  # noqa: E402
    BatchedStreamDecoder,
    DecoderOption,
    DeviceFrontendDecoder,
    StreamShards,
    make_stream_mesh,
    shard_present_fn,
    shard_reconstruct_fn,
)
from h263_tpu_torch.parallel.sharding import scatter  # noqa: E402
from h263_tpu_torch.testing.corpora import (  # noqa: E402
    build_corpus,
    d24_rows,
    rich_gop,
)
from test_parallel import _stream_frames  # noqa: E402


def _cpu_mesh(k):
    return make_stream_mesh(["cpu"] * k)


def _planes(dec):
    """A decoder's reference planes as numpy (StreamShards gathered)."""
    return [np.asarray(p) for p in (dec.ref_y, dec.ref_cb, dec.ref_cr)]


def _same(got, want, tag):
    for name, a, b in zip(("y", "cb", "cr"), got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{tag} {name}")


def _step(dec, *args, **kw):
    """decode_step's planes, or the error it raised."""
    try:
        return dec.decode_step(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared across decoders
        return e


def _same_outcome(outs, tag):
    """Every decoder raised the same class (the port's with the same
    message: the same global stream), or none raised."""
    errs = [o for o in outs if isinstance(o, Exception)]
    assert not errs or len(errs) == len(outs), (tag, outs)
    if errs:
        assert len({type(e).__name__ for e in errs}) == 1, (tag, errs)
        assert len({str(e) for e in errs[1:]}) == 1, (tag, errs)
    return bool(errs)


# -- the mesh ------------------------------------------------------------------


def test_make_stream_mesh_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_stream_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_stream_mesh(["cuda:0", "cuda:0"])
    mesh = make_stream_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.distinct == 1
    assert mesh.axis_names == ("stream",)
    assert mesh.shard_ranges(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_ranges(6)
    with pytest.raises(ValueError, match="divide"):
        BatchedStreamDecoder(6, 32, 32, mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        DeviceFrontendDecoder(8, 48, 32, device="cpu", mesh=mesh)


def test_stream_shards_gather_array_and_device_set():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (8, 5, 7), dtype=np.uint8)
    mesh = _cpu_mesh(4)
    s = scatter(mesh, a)            # as jit's in_shardings places an input
    assert isinstance(s, StreamShards) and len(s) == 4
    assert s.shape == (8, 5, 7) and s.dtype == torch.uint8
    assert s.device_set == {torch.device("cpu")}
    assert [t.shape[0] for t in s] == [2] * 4
    np.testing.assert_array_equal(np.asarray(s), a)
    np.testing.assert_array_equal(s.gather().numpy(), a)
    w = StreamShards([torch.as_tensor(a[:, :4]), torch.as_tensor(a[:, 4:])],
                     axis=1)
    assert w.shape == (8, 5, 7)
    np.testing.assert_array_equal(np.asarray(w), a)
    with pytest.raises(ValueError):
        scatter(_cpu_mesh(2), s)                # shards of another mesh


# -- the sharded programs ------------------------------------------------------


def _recon_inputs(mode, S=8, h=32, w=32, seed=5):
    """(port inputs, JAX inputs) of one reconstruction mode, as
    tests/test_parallel.py builds them."""
    rng = np.random.default_rng(seed)
    mbh, mbw = -(-h // 16), -(-w // 16)
    refs = [rng.integers(0, 256, (S, h, w), dtype=np.uint8)] + [
        rng.integers(0, 256, (S, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
        for _ in range(2)]
    mvs = rng.integers(-12, 13, (S, mbh, mbw, 4, 2)).astype(np.int16)
    inter = (rng.random((S, mbh, mbw)) < 0.6).astype(np.uint8)
    if mode == "dense":
        nmb = mbh * mbw
        dense = np.zeros((S, 6 * nmb, 64), dtype=np.int16)
        pick = rng.random((S, 6 * nmb, 64)) < 0.05
        dense[pick] = rng.integers(-300, 300, int(pick.sum()))
        dense[:, ::4, 0] = rng.integers(-900, 900, (S, -(-6 * nmb // 4)))
        y = dense[:, :4 * nmb].reshape(S, 2 * mbh, 2 * mbw, 64)
        cb = dense[:, 4 * nmb:5 * nmb].reshape(S, mbh, mbw, 64)
        cr = dense[:, 5 * nmb:].reshape(S, mbh, mbw, 64)
        jin = []
        for c in (y, cb, cr):
            jin += [c.reshape(*c.shape[:3], 8, 8),
                    np.asarray(derive_classes_jnp(jnp.asarray(c)))]
        return [dense, mvs, inter, *refs], [*jin, mvs, inter.astype(bool),
                                            *refs]
    if mode == "d24":
        rows = d24_rows(rng, S, 96, mbh, mbw)
        args = [rows, mvs, inter, *refs]
        return args, args
    rows = d24_rows(rng, S, 96, mbh, mbw, mv_full=(mode == "d24f_full"))
    return [rows, *refs], [rows, *refs]


@pytest.mark.parametrize("mode", ["dense", "d24", "d24f_slim", "d24f_full"])
def test_shard_reconstruct_fn_matches_jax(mode):
    packed = {"dense": False, "d24": "d24"}.get(mode, "d24f")
    mv_full = mode == "d24f_full"
    port_in, jax_in = _recon_inputs(mode)
    assert len(jax.devices()) == 8
    want = jax_recon(jax_mesh(), 32, 32, packed=packed, mv_full=mv_full)(
        *jax_in)
    got = shard_reconstruct_fn(_cpu_mesh(8), 32, 32, packed=packed,
                               mv_full=mv_full)(*port_in)
    assert all(isinstance(p, StreamShards) and len(p) == 8 for p in got)
    assert len(want[0].sharding.device_set) == 8
    _same(got, want, mode)


@pytest.mark.parametrize("packed", [True, "u32", "split", "d24F"])
def test_shard_reconstruct_fn_rejects_unknown_modes(packed):
    with pytest.raises(ValueError, match="packed"):
        shard_reconstruct_fn(_cpu_mesh(2), 32, 32, packed=packed)


def test_shard_present_fn_matches_jax():
    S, H, W = 8, 48, 48
    rng = np.random.default_rng(21)
    y = rng.integers(0, 255, (S, H, W)).astype(np.uint8)
    cb = rng.integers(0, 255, (S, H // 2, W // 2)).astype(np.uint8)
    cr = rng.integers(0, 255, (S, H // 2, W // 2)).astype(np.uint8)
    strength = rng.integers(1, 13, S).astype(np.int32)
    apply = rng.random(S) < 0.7
    want = np.asarray(jax_present(jax_mesh())(y, cb, cr, strength, apply))
    got = shard_present_fn(_cpu_mesh(8))(y, cb, cr, strength, apply)
    assert isinstance(got, StreamShards) and got.shape == (S, H, W, 4)
    np.testing.assert_array_equal(np.asarray(got), want)


# -- BatchedStreamDecoder over a mesh -------------------------------------------


def _jax_sharded_batched(n):
    mesh = jax_mesh()
    return JaxBatched(
        n, 32, 32, JaxOption.SORENSON_SPARK_BITSTREAM,
        reconstruct_fn=jax_recon(mesh, 32, 32),
        packed_reconstruct_fn=jax_recon(mesh, 32, 32, packed="d24"),
        fused_reconstruct_fns={m: jax_recon(mesh, 32, 32, packed="d24f",
                                            mv_full=m) for m in (False,
                                                                 True)})


def _host_states(dec):
    return [(int(s.running_options), s.has_reference,
             None if s.last_header is None else s.last_header.quantizer)
            for s in dec.states]


def test_batched_mesh_matches_jax_sharded_and_unsharded():
    """8 streams over a mesh of 4 (2 a shard) step for step against the
    JAX decoder with its sharded programs injected and the port's
    unsharded decoder: a masked slot, a cut lane at a shard boundary (the
    same class and global stream, nothing committed), the dense replay of
    a PackOverflow step, a slot of shard 2 reset and rejoined on an
    I-frame, present_rgba, and the planes scattered into a mesh of 2."""
    n = 8
    per = [_stream_frames(seed, n_p=4) for seed in range(n)]
    fresh = _stream_frames(99, n_p=0)[0]
    mesh = _cpu_mesh(4)
    decs = [_jax_sharded_batched(n),
            BatchedStreamDecoder(n, 32, 32, device="cpu"),
            BatchedStreamDecoder(n, 32, 32, mesh=mesh)]
    raised = []
    for t in range(5):
        bufs = [per[i][t] for i in range(n)]
        mask = None
        if t == 1:
            mask = [i != 5 for i in range(n)]
        if t == 2:
            bufs[4] = bufs[4][:7]                 # shard 2's first lane
        if t == 4:
            for d in decs:
                d.reset_slot_state(4)
            bufs[4] = fresh                       # rejoins on an I-frame
        outs = [_step(d, bufs, mask=mask) for d in decs]
        if _same_outcome(outs, f"t={t}"):
            raised.append(t)
            assert "stream 4" in str(outs[2])
        else:
            assert isinstance(outs[2][0], StreamShards)
            assert outs[2][0].device_set == {torch.device("cpu")}
            assert len(outs[2][0]) == 4
            _same(outs[2], outs[0], f"t={t} vs JAX")
            _same(outs[2], outs[1], f"t={t} vs unsharded")
        for d in decs[1:]:
            _same(_planes(d), _planes(decs[0]), f"t={t} planes")
            assert _host_states(d) == _host_states(decs[0]), t
    assert raised == [2]
    for deblock in (None, True):
        want = np.asarray(decs[0].present_rgba(deblock))
        got = decs[2].present_rgba(deblock)
        assert isinstance(got, StreamShards)
        np.testing.assert_array_equal(np.asarray(got), want)
        np.testing.assert_array_equal(decs[1].present_rgba(deblock).numpy(),
                                      want)

    # A PackOverflow step replays on the dense transport, shard by shard.
    small = [BatchedStreamDecoder(n, 32, 32, pack_cap=4, device="cpu"),
             BatchedStreamDecoder(n, 32, 32, pack_cap=4, mesh=mesh)]
    for t in range(2):
        outs = [d.decode_step([per[i][t] for i in range(n)]) for d in small]
        _same(outs[1], outs[0], f"overflow t={t}")

    # The planes of the mesh of 4 scattered into a mesh of 2.
    moved = BatchedStreamDecoder(n, 32, 32, mesh=_cpu_mesh(2))
    moved.load_state(*_planes(decs[2]))
    moved.states = copy.deepcopy(decs[2].states)
    moved._mv_full = decs[2]._mv_full
    bufs = [per[i][4] if i != 4 else _stream_frames(99, n_p=1)[1]
            for i in range(n)]
    _same(moved.decode_step(bufs), decs[1].decode_step(bufs), "moved")


def test_batched_mesh_standard_h263():
    """A standard-H.263 GOP (custom size: PLUSPTYPE headers through the
    Python replay) over a mesh of 2 equals the unsharded decoder, a cut
    lane at the boundary raising the same class and stream."""
    streams = [build_corpus(48, 32, 3, seed=1600 + i, standard=True)
               for i in range(4)]
    decs = [BatchedStreamDecoder(4, 48, 32, DecoderOption.NONE,
                                 device="cpu"),
            BatchedStreamDecoder(4, 48, 32, DecoderOption.NONE,
                                 mesh=_cpu_mesh(2))]
    for t in range(3):
        bufs = [s[t] for s in streams]
        if t == 1:
            bufs[2] = bufs[2][:len(bufs[2]) // 2]
        outs = [_step(d, bufs) for d in decs]
        if not _same_outcome(outs, f"t={t}"):
            assert t != 1
            _same(outs[1], outs[0], f"t={t}")
        _same(_planes(decs[1]), _planes(decs[0]), f"t={t} planes")


# -- DeviceFrontendDecoder over a mesh --------------------------------------------


def test_device_frontend_mesh_matches_jax_and_unsharded():
    """8 streams at 48x32 over a mesh of 2 against the JAX decoder and the
    port's unsharded one: cut lanes on both sides of the shard boundary
    (3 | 4), a header reject raised after every shard's dispatch with the
    global stream, a masked slot, a window of 2 frames (the JAX decoder
    steps through its frames: the window equals steps, test_torch_window),
    fetch_status, present_rgba, a slot of shard 1 reset, and load_state
    into a mesh of 4.  (The plain automaton runs once a shard, ~1 s a
    call here, so the mesh is small.)"""
    S, T = 8, 5
    streams = [rich_gop(500 + i, n=T) for i in range(S)]
    decs = [JaxDevice(S, 48, 32, JaxOption.SORENSON_SPARK_BITSTREAM),
            DeviceFrontendDecoder(S, 48, 32, device="cpu"),
            DeviceFrontendDecoder(S, 48, 32, mesh=_cpu_mesh(2))]

    def check(tag):
        for d in decs[1:]:
            _same(_planes(d), _planes(decs[0]), tag)
            np.testing.assert_array_equal(d.fetch_status(),
                                          decs[0].fetch_status())
            np.testing.assert_array_equal(d._last_quant, decs[0]._last_quant)

    for t in range(3):
        bufs = [s[t] for s in streams]
        mask = None
        if t == 1:
            bufs[3], bufs[4] = bufs[3][:14], bufs[4][:14]
            mask = [i != 6 for i in range(S)]
        if t == 2:
            bufs[5] = b"\x00\x01garbage"
        outs = [_step(d, bufs, mask=mask) for d in decs]
        assert _same_outcome(outs, f"t={t}") == (t == 2)
        if t == 2:
            assert "stream 5" in str(outs[2])
        check(f"t={t}")
        if t == 1:
            st = decs[2].fetch_status()
            assert st[3] != 0 and st[4] != 0 and (st[:3] == 0).all()
            assert isinstance(decs[2].last_status, StreamShards)

    lists = [[s[t] for s in streams] for t in (3, 4)]
    lists[1][6] = b"\x00\x01garbage"
    statuses = []
    for bufs in lists:
        _step(decs[0], bufs)
        statuses.append(decs[0].fetch_status())
    outs = []
    for d in decs[1:]:
        try:
            d.decode_steps(lists)
            outs.append(None)
        except Exception as e:  # noqa: BLE001
            outs.append(e)
    assert _same_outcome(outs, "window")
    assert "frame 1 stream 6" in str(outs[1])
    for d in decs[1:]:
        np.testing.assert_array_equal(np.asarray(d.last_status_steps),
                                      np.stack(statuses))
    assert decs[2].last_status_steps.axis == 1
    check("window")
    for deblock in (None, True):
        want = np.asarray(decs[0].present_rgba(deblock=deblock))
        for d in decs[1:]:
            np.testing.assert_array_equal(
                np.asarray(d.present_rgba(deblock=deblock)), want)

    for d in decs:
        d.reset_slot_state(5)
    check("reset")
    moved = DeviceFrontendDecoder(S, 48, 32, mesh=_cpu_mesh(4))
    moved.load_state(*_planes(decs[2]), decs[2]._last_quant,
                     decs[2]._last_deblock)
    _same(_planes(moved), _planes(decs[1]), "load_state")
    np.testing.assert_array_equal(
        np.asarray(moved.present_rgba(deblock=True)),
        decs[1].present_rgba(deblock=True).numpy())


def test_device_frontend_mesh_standard_h263():
    """DecoderOption.NONE over a mesh of 2: the Python header prep per
    shard, a stream whose header fails raising with its global index."""
    streams = [build_corpus(48, 32, 2, seed=1700 + i, standard=True)
               for i in range(4)]
    decs = [DeviceFrontendDecoder(4, 48, 32, DecoderOption.NONE,
                                  device="cpu"),
            DeviceFrontendDecoder(4, 48, 32, DecoderOption.NONE,
                                  mesh=_cpu_mesh(2))]
    for t in range(2):
        bufs = [s[t] for s in streams]
        if t == 1:
            bufs[3] = b"\x00\x01garbage"
        outs = [_step(d, bufs) for d in decs]
        assert _same_outcome(outs, f"t={t}") == (t == 1)
        _same(_planes(decs[1]), _planes(decs[0]), f"t={t}")
        np.testing.assert_array_equal(decs[1].fetch_status(),
                                      decs[0].fetch_status())


# -- the unsharded decoder is the mesh of one ---------------------------------


@pytest.mark.parametrize("cls", [BatchedStreamDecoder, DeviceFrontendDecoder])
def test_unsharded_decoder_is_the_mesh_of_one(cls):
    """Without `mesh=` a decoder runs the sharded programs over a mesh of
    its one device and hands out that shard's plain tensors; with a mesh
    of one device it hands out one-shard StreamShards, equal to them."""
    streams = [build_corpus(48, 32, 2, seed=1800 + i) for i in range(2)]
    plain = cls(2, 48, 32, device="cpu")
    meshed = cls(2, 48, 32, mesh=_cpu_mesh(1))
    assert plain.device == torch.device("cpu") and meshed.device is None
    for t in range(2):
        bufs = [s[t] for s in streams]
        got = plain.decode_step(bufs)
        want = meshed.decode_step(bufs)
        assert all(type(p) is torch.Tensor for p in got), t
        assert all(isinstance(p, StreamShards) and len(p) == 1
                   and p.devices == (torch.device("cpu"),) for p in want), t
        _same(got, want, f"t={t}")
    rgba = [d.present_rgba(deblock=True) for d in (plain, meshed)]
    assert type(rgba[0]) is torch.Tensor and isinstance(rgba[1], StreamShards)
    np.testing.assert_array_equal(rgba[0].numpy(), np.asarray(rgba[1]))
