"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

These tests need a CUDA device and skip without one.  They import neither
JAX nor the JAX package, so they also run where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from h263_tpu_torch import BatchedStreamDecoder  # noqa: E402
from h263_tpu_torch import DeviceFrontendDecoder  # noqa: E402
from h263_tpu_torch import DecoderOption, H263Decoder  # noqa: E402
from h263_tpu_torch import StreamShards, make_stream_mesh  # noqa: E402
from h263_tpu_torch.decoder.reconstruct import (  # noqa: E402
    present_rgba_batched,
)
from h263_tpu_torch.native import DevicePrepBatch  # noqa: E402
from h263_tpu_torch.ops import (  # noqa: E402
    d24_cuda,
    deblock_cuda,
    idct_cuda,
    present_cuda,
    reconstruct_cuda,
    yuv_cuda,
)
from h263_tpu_torch.ops.d24 import d24_to_dense, unpack_fused  # noqa: E402
from h263_tpu_torch.ops.deblock import deblock_batched  # noqa: E402
from h263_tpu_torch.ops.idct import idct_residual_fused  # noqa: E402
from h263_tpu_torch.ops.present import present_rgba_plain  # noqa: E402
from h263_tpu_torch.ops.reconstruct import (  # noqa: E402
    reconstruct_from_dense_plain,
)
from h263_tpu_torch.ops.yuv import yuv420_to_rgba  # noqa: E402
from h263_tpu_torch.parallel.pool import StreamPool  # noqa: E402
from h263_tpu_torch.parser import automaton_cuda  # noqa: E402
from h263_tpu_torch.parser import device_frontend as tdf  # noqa: E402
from h263_tpu_torch.testing.corpora import (  # noqa: E402
    d24_rows,
    resize_sequence,
    rich_gop,
)
from h263_tpu_torch.types import H263Error  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_idct_kernel_matches_plain(cuda):
    rng = np.random.default_rng(11)
    c = rng.integers(-2048, 2048, (3000, 64)).astype(np.int16)
    c[:1000, 1:] = 0                                    # DC
    c[1000:2000] *= (np.arange(64) % 8 == 0)            # VERT
    c[2000:2500] = 0                                    # ZERO
    c[2999] = 0
    c[2999, 2], c[2999, 3], c[2999, 18] = 735, -555, 215   # FMA block
    before = idct_cuda.launches
    got = idct_cuda.idct_residual_cuda(torch.as_tensor(c).to(cuda))
    assert idct_cuda.launches == before + 1
    got = got.cpu().numpy()
    np.testing.assert_array_equal(
        got, idct_residual_fused(torch.as_tensor(c)).numpy())
    assert got[2999].reshape(8, 8)[0, 2] == 28


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(16, 16), (33, 47), (144, 176), (145, 177),
                                  (288, 352)])
def test_reconstruct_kernel_matches_plain(cuda, size):
    """Every IDCT class and the FMA block in every plane, MVs of all four
    half-pel cases that reach outside every edge, 4V and INTRA macroblocks."""
    h, w = size
    rng = np.random.default_rng(h * 1000 + w)
    S = 5
    mbh, mbw = -(-h // 16), -(-w // 16)
    nblk = 6 * mbh * mbw
    dense = np.zeros((S, nblk, 64), dtype=np.int16)
    kind = rng.integers(0, 5, (S, nblk))
    dense[kind == 1, 0] = rng.integers(-2048, 2048, int((kind == 1).sum()))
    dense[kind == 2, ::8] = rng.integers(-400, 400, (int((kind == 2).sum()), 8))
    dense[kind == 3] = rng.integers(-300, 300, (int((kind == 3).sum()), 64))
    dense[kind == 4, :8] = rng.integers(-2048, 2048,
                                        (int((kind == 4).sum()), 8))
    for blk in (0, nblk - 1):
        dense[0, blk] = 0
        dense[0, blk, [2, 3, 18]] = 735, -555, 215          # FMA block
    reach = 2 * max(h, w) + 9
    mvs = rng.integers(-reach, reach + 1, (S, mbh, mbw, 4, 2)).astype(np.int16)
    mvs[1::2] = rng.integers(-9, 10, mvs[1::2].shape)
    inter = rng.random((S, mbh, mbw)) < 0.75
    inter[0, 0, 0] = False
    refs = [rng.integers(0, 256, (S, ph, pw), dtype=np.uint8)
            for ph, pw in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                           ((h + 1) // 2, (w + 1) // 2))]
    args = [torch.as_tensor(a) for a in (dense, mvs, inter, *refs)]
    before = reconstruct_cuda.launches
    got = reconstruct_cuda.reconstruct_from_dense_cuda(
        *[a.to(cuda) for a in args])
    assert reconstruct_cuda.launches == before + 1
    want = reconstruct_from_dense_plain(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    assert int(got[0][0, 0, 2]) == 28


@pytest.mark.gpu
def test_automaton_kernel_matches_plain(cuda):
    frames = []
    for seed in range(3):
        frames += rich_gop(seed)
    frames += [frames[1][:k] for k in range(8, len(frames[1]), 5)]
    S = len(frames)
    prep = DevicePrepBatch(S, 48, 32)
    total = sum(((len(f) + 3) // 4) * 4 for f in frames)
    stage = np.zeros((total // 4 + 1, 4), np.uint8)
    meta = np.zeros((6, S), np.int32)
    prep.prepare_ragged(frames, stage, meta)
    payload, dmeta = torch.as_tensor(stage), torch.as_tensor(meta)
    want = tdf.parse_assemble(payload, dmeta, mbh=2, mbw=3)
    got = automaton_cuda.parse_assemble_cuda(payload.to(cuda),
                                             dmeta.to(cuda), mbh=2, mbw=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    assert (want[3] != 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (9, 10), (17, 11), (32, 48),
                                   (145, 177), (288, 352), (720, 1280)])
def test_deblock_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(shape[1])
    S = 13
    planes = rng.integers(0, 256, (S, *shape), dtype=np.uint8)
    planes[::2] = planes[::2] // 16 * 16 + 5          # flat blocks, edges
    strength = np.arange(S, dtype=np.int32)
    apply = rng.random(S) < 0.7
    args = [torch.as_tensor(a) for a in (planes, strength, apply)]
    before = deblock_cuda.launches
    got = deblock_cuda.deblock_batched_cuda(*[a.to(cuda) for a in args])
    assert deblock_cuda.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  deblock_batched(*args).numpy())


def _present_inputs(shape, S=13):
    """Blocky and noisy lanes of a 4:2:0 picture, strengths 0-12, ~70% of
    the apply flags set."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    planes = [rng.integers(0, 256, (S, *hw), dtype=np.uint8)
              for hw in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                         ((h + 1) // 2, (w + 1) // 2))]
    for p in planes:
        p[::2] = p[::2] // 16 * 16 + 5                # flat blocks, edges
    strength = (np.arange(S) % 13).astype(np.int32)
    apply = rng.random(S) < 0.7
    apply[:3] = True
    return [torch.as_tensor(a) for a in (*planes, strength, apply)]


PRESENT_SHAPES = [(16, 16), (33, 47), (144, 176), (145, 177), (720, 1280)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PRESENT_SHAPES)
def test_present_kernel_matches_plain(cuda, shape):
    args = _present_inputs(shape)
    counted = (present_cuda, deblock_cuda, yuv_cuda)
    before = [m.launches for m in counted]
    got = present_rgba_batched(*[a.to(cuda) for a in args])
    # One launch of the fused kernel, none of the two it fuses.
    assert [m.launches for m in counted] == [before[0] + 1, *before[1:]]
    want = present_rgba_plain(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want != present_rgba_plain(*args[:4], torch.zeros_like(args[4]))
            ).any()                                   # the deblock acted


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PRESENT_SHAPES)
def test_one_pass_deblock_matches_plain_on_three_planes(cuda, shape):
    *planes, strength, apply = _present_inputs(shape)
    for p in planes:
        got = deblock_cuda.deblock_batched_cuda(
            p.to(cuda), strength.to(cuda), apply.to(cuda))
        np.testing.assert_array_equal(
            got.cpu().numpy(), deblock_batched(p, strength, apply).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(33, 47), (144, 176)])
def test_present_kernels_take_planes_at_any_address(cuda, shape):
    """Planes that start 1, 2 and 3 bytes into their storage: no row is
    aligned like the output's."""
    y, cb, cr, strength, apply = _present_inputs(shape, S=3)
    moved = []
    for k, p in enumerate((y, cb, cr), start=1):
        flat = torch.zeros(p.numel() + k, dtype=torch.uint8, device=cuda)
        flat[k:] = p.flatten().to(cuda)
        moved.append(flat[k:].view(p.shape))
    st, ap = strength.to(cuda), apply.to(cuda)
    np.testing.assert_array_equal(
        present_cuda.present_rgba_cuda(*moved, st, ap).cpu().numpy(),
        present_rgba_plain(y, cb, cr, strength, apply).numpy())
    np.testing.assert_array_equal(
        deblock_cuda.deblock_batched_cuda(moved[0], st, ap).cpu().numpy(),
        deblock_batched(y, strength, apply).numpy())


@pytest.mark.gpu
def test_ptxas_report_lists_the_present_kernels(cuda, capsys):
    from h263_tpu_torch.kernels import ptxas_report

    assert ptxas_report.main() == 0
    out = capsys.readouterr().out
    for kernel in ("deblock_kernel", "present_kernel"):
        lines = [ln for ln in out.splitlines() if kernel in ln]
        assert any("registers" in ln and "smem" in ln for ln in lines), out
        assert any("0 bytes spill stores" in ln for ln in lines), out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (17, 11), (9, 130), (145, 177),
                                   (288, 352)])
def test_yuv_kernel_matches_plain(cuda, shape):
    h, w = shape
    rng = np.random.default_rng(h + w)
    planes = [torch.as_tensor(rng.integers(0, 256, (5, *hw), dtype=np.uint8))
              for hw in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                         ((h + 1) // 2, (w + 1) // 2))]
    before = yuv_cuda.launches
    got = yuv_cuda.yuv420_to_rgba_cuda(*[p.to(cuda) for p in planes])
    assert yuv_cuda.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  yuv420_to_rgba(*planes).numpy())


@pytest.mark.gpu
def test_wrappers_refuse_tensors_on_two_devices(cuda):
    p = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        deblock_cuda.deblock_batched_cuda(
            p, torch.ones(2, dtype=torch.int32),
            torch.ones(2, dtype=torch.bool, device=cuda))
    c = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        yuv_cuda.yuv420_to_rgba_cuda(p, c, c)
    with pytest.raises(ValueError):
        present_cuda.present_rgba_cuda(
            p, c.to(cuda), c.to(cuda), torch.ones(2, dtype=torch.int32),
            torch.ones(2, dtype=torch.bool, device=cuda))


@pytest.mark.gpu
def test_cuda_decoder_matches_cpu_decoder(cuda):
    S = 4
    streams = [rich_gop(900 + i, n=3) for i in range(S)]
    gd = DeviceFrontendDecoder(S, 48, 32, device="cuda")
    cd = DeviceFrontendDecoder(S, 48, 32, device="cpu")
    for t in range(3):
        bufs = [s[t] for s in streams]
        for a, b in zip(gd.decode_step(bufs), cd.decode_step(bufs)):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    np.testing.assert_array_equal(gd.fetch_status(), cd.fetch_status())
    np.testing.assert_array_equal(gd.present_rgba(deblock=True).cpu().numpy(),
                                  cd.present_rgba(deblock=True).numpy())


@pytest.mark.gpu
def test_cuda_pool_matches_cpu_pool(cuda):
    pools = [StreamPool(), StreamPool(device="cpu")]
    a, b = rich_gop(1, n=3), rich_gop(2, 64, 48, n=3)
    x = rich_gop(3, 64, 48, n=2)
    for pool in pools:
        pool.add_stream("a", 48, 32)
        pool.add_stream("b", 64, 48)
    for t in range(3):
        feed = {"a": a[t], "b": b[t]}
        if t == 1:
            feed["a"] = x[0]                        # rebucket on an I-frame
        if t == 2:
            feed["a"] = x[1]
        outs = [pool.decode_step(feed) for pool in pools]
        for sid in feed:
            for g, c in zip(outs[0][sid], outs[1][sid]):
                np.testing.assert_array_equal(g, c)
        rgba = [pool.present_rgba(deblock=True) for pool in pools]
        for sid in rgba[1]:
            np.testing.assert_array_equal(rgba[0][sid].cpu().numpy(),
                                          rgba[1][sid].numpy())


def _window_lists(S, T, w=48, h=32, seed=1000):
    """T lists of S frames of rich GOPs, with an absent lane, a frame cut in
    the block layer and a header reject in the window."""
    streams = [rich_gop(seed + i, w, h, n=T) for i in range(S)]
    lists = [[streams[i][t] for i in range(S)] for t in range(T)]
    lists[1][0] = None
    lists[2][1] = streams[1][2][:14]
    lists[T - 1][2] = b"\x12\x34\x56"
    return lists


def _sequential(dec, lists):
    out = []
    for bufs in lists:
        try:
            dec.decode_step(bufs)
        except H263Error:
            pass
        out.append((dec.ref_y, dec.ref_cb, dec.ref_cr, dec.last_status))
    return out


@pytest.mark.gpu
def test_window_matches_sequential_steps_on_card(cuda):
    S, T = 5, 4
    lists = _window_lists(S, T)
    win = DeviceFrontendDecoder(S, 48, 32)
    cpu = DeviceFrontendDecoder(S, 48, 32, device="cpu")
    before = (automaton_cuda.launches, reconstruct_cuda.launches)
    with pytest.raises(H263Error, match="header rejected"):
        win.decode_steps(lists)
    # One automaton launch over T*S lanes, T reconstructions.
    assert (automaton_cuda.launches, reconstruct_cuda.launches) == (
        before[0] + 1, before[1] + T)
    ys, cbs, crs = win.ref_y, win.ref_cb, win.ref_cr
    seq = _sequential(DeviceFrontendDecoder(S, 48, 32), lists)
    with pytest.raises(H263Error, match="header rejected"):
        cpu.decode_steps(lists)
    for t, (y, cb, cr, st) in enumerate(seq):
        assert torch.equal(win.last_status_steps[t], st), t
    assert torch.equal(ys, seq[-1][0]) and torch.equal(cbs, seq[-1][1])
    assert torch.equal(crs, seq[-1][2])
    np.testing.assert_array_equal(win.ref_y.cpu().numpy(), cpu.ref_y.numpy())
    np.testing.assert_array_equal(win.last_status_steps.cpu().numpy(),
                                  cpu.last_status_steps.numpy())


@pytest.mark.gpu
def test_window_planes_equal_each_sequential_step(cuda):
    S, T = 6, 5
    lists = _window_lists(S, T, seed=1100)[:T - 1]     # no header reject
    win = DeviceFrontendDecoder(S, 48, 32)
    ys, cbs, crs = win.decode_steps(lists)
    seq = _sequential(DeviceFrontendDecoder(S, 48, 32), lists)
    for t, (y, cb, cr, st) in enumerate(seq):
        assert torch.equal(ys[t], y) and torch.equal(cbs[t], cb), t
        assert torch.equal(crs[t], cr), t
    # decode_step after the window continues from its last planes.
    nxt = [rich_gop(1200 + i, n=1)[0] for i in range(S)]
    seq_dec = DeviceFrontendDecoder(S, 48, 32)
    _sequential(seq_dec, lists + [nxt])
    win.decode_step(nxt)
    assert torch.equal(win.ref_y, seq_dec.ref_y)


@pytest.mark.gpu
def test_window_makes_no_synchronising_call(cuda):
    S, T = 4, 3
    lists = _window_lists(S, T, seed=1300)[:T - 1]
    dec = DeviceFrontendDecoder(S, 48, 32)
    dec.decode_step(lists[0])                  # tables and kernels loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            dec.decode_steps(lists)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_window_automaton_launch_equals_per_frame_launches_cif(cuda):
    """The launcher's chosen shape at 8 x 1024 CIF lanes (one launch)
    against 8 per-frame launches of 1024 lanes: equal outputs and steps."""
    from h263_tpu_torch.kernels import automaton_sweep

    payload, meta = automaton_sweep.window_inputs(
        torch, 8, 1024, True, np.random.default_rng(5))
    got = automaton_cuda._parse_assemble(payload, meta, 18, 22, 352, 288,
                                         (0, 0, 0))
    for t in range(8):
        want = automaton_cuda._parse_assemble(payload, meta[t], 18, 22, 352,
                                              288, (0, 0, 0))
        for a, b in zip(got, want):
            assert torch.equal(a[t], b), t
    assert (got[3] != 0).any() and (got[3] == 0).any()


@pytest.mark.gpu
def test_window_at_8192_cif_lanes_matches_sequential(cuda):
    from h263_tpu_torch.testing import corpora as C

    S, T = 1024, 8
    cif = [C.cif_corpus(k) for k in range(16)]
    lists = [[cif[i % 16][t] for i in range(S)] for t in range(T)]
    win = DeviceFrontendDecoder(S, 352, 288)
    ys, cbs, crs = win.decode_steps(lists)
    seq = DeviceFrontendDecoder(S, 352, 288)
    for t in range(T):
        y, cb, cr = seq.decode_step(lists[t])
        assert torch.equal(ys[t], y) and torch.equal(cbs[t], cb), t
        assert torch.equal(crs[t], cr), t
        assert torch.equal(win.last_status_steps[t], seq.last_status), t
    assert int((win.last_status_steps != 0).sum()) == 0


@pytest.mark.gpu
def test_cuda_pool_window_matches_cpu_pool_window(cuda):
    pools = [StreamPool(), StreamPool(device="cpu")]
    a, b = rich_gop(11, n=4), rich_gop(12, 64, 48, n=4)
    c = rich_gop(13, n=4)
    for pool in pools:
        pool.add_stream("a", 48, 32)
        pool.add_stream("b", 64, 48)
        pool.add_stream("c", 48, 32)
    dicts = [{"a": a[t], "b": b[t], **({"c": c[t]} if t != 2 else {})}
             for t in range(4)]
    outs = [pool.decode_steps(dicts) for pool in pools]
    for t in range(4):
        assert set(outs[0][t]) == set(outs[1][t]) == set(dicts[t])
        for sid in dicts[t]:
            for g, p in zip(outs[0][t][sid], outs[1][t][sid]):
                np.testing.assert_array_equal(g, p, err_msg=f"{sid}@{t}")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [3697, 4096, 4224, 8192, 14785, 16384])
def test_automaton_launches_at_every_lane_count(cuda, S):
    """The launcher's shape must fit the kernel's registers: before the
    register-aware rule, 3697-4224 lanes (29-32 lanes of a warp each on 132
    SMs, 928-1024 threads a block) and from 14785 lanes on (4 lanes per warp,
    904 threads and more) were refused with CUDA error 701.  Lanes repeat a
    set of 41 frames; each must equal that frame's lane of a small launch."""
    frames = []
    for seed in range(3):
        frames += rich_gop(seed)
    frames += [frames[1][:k] for k in range(8, len(frames[1]), 5)]
    n = len(frames)

    def launch(bufs):
        prep = DevicePrepBatch(len(bufs), 48, 32)
        total = sum(((len(f) + 3) // 4) * 4 for f in bufs)
        stage = np.zeros((total // 4 + 1, 4), np.uint8)
        meta = np.zeros((6, len(bufs)), np.int32)
        prep.prepare_ragged(bufs, stage, meta)
        return automaton_cuda.parse_assemble_cuda(
            torch.as_tensor(stage).to(cuda), torch.as_tensor(meta).to(cuda),
            mbh=2, mbw=3)

    small = launch(frames)
    big = launch([frames[i % n] for i in range(S)])
    idx = torch.arange(S, device=cuda) % n
    for a, b in zip(big, small):
        assert torch.equal(a, b.index_select(0, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(32, 48), (144, 176), (145, 177),
                                  (288, 352)])
@pytest.mark.parametrize("mv_full", [None, False, True])
def test_d24_kernel_matches_plain(cuda, size, mv_full):
    """Hand-made rows (entries at cursor -1, collisions, escapes, a tail
    past the last coefficient), alone (the flip step) or fused behind MVs
    and INTER bits; rows contiguous and rows lying apart (a strided view,
    as the flip step's entries inside the fused rows)."""
    h, w = size
    mbh, mbw = -(-h // 16), -(-w // 16)
    rng = np.random.default_rng(h * 7 + w + (mv_full is None) + 2 * bool(
        mv_full))
    rows = torch.as_tensor(d24_rows(rng, 7, 700, mbh, mbw, mv_full))
    wide = torch.zeros((7, rows.shape[1] + 13), dtype=torch.uint8)
    wide[:, 5:5 + rows.shape[1]] = rows
    for r in (rows.to(cuda), wide.to(cuda)[:, 5:5 + rows.shape[1]]):
        before = d24_cuda.launches
        if mv_full is None:
            got = (d24_cuda.d24_to_dense_cuda(r, mbh, mbw),)
            want = (d24_to_dense(rows, mbh, mbw),)
        else:
            got = d24_cuda.unpack_fused_cuda(r, mbh, mbw, mv_full)
            want = unpack_fused(rows, mbh, mbw, mv_full)
        assert d24_cuda.launches == before + 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    assert (want[0] != 0).any()


@pytest.mark.gpu
def test_cuda_batched_decoder_matches_cpu_decoder(cuda):
    """The host front-end on the card and on the CPU: planes, RGBA, the
    flip (4V frames), a PackOverflow step (small pack_cap), masks."""
    S, w, h = 4, 48, 32
    streams = [rich_gop(1400 + i, n=5) for i in range(S)]
    decs = [BatchedStreamDecoder(S, w, h, pack_cap=64, device=d)
            for d in ("cuda", "cpu")]
    before = d24_cuda.launches
    for t in range(5):
        bufs = [s[t] for s in streams]
        mask = [True, t != 2, True, True]
        outs = [d.decode_step(bufs, mask=mask) for d in decs]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    assert d24_cuda.launches > before
    np.testing.assert_array_equal(
        decs[0].present_rgba().cpu().numpy(), decs[1].present_rgba().numpy())


@pytest.mark.gpu
def test_batched_pipeline_makes_no_synchronising_call(cuda):
    S = 4
    streams = [rich_gop(1500 + i, n=5) for i in range(S)]
    lists = [[s[t] for s in streams] for t in range(5)]
    seq = BatchedStreamDecoder(S, 48, 32)
    want = [tuple(p.clone() for p in seq.decode_step(b)) for b in lists]
    dec = BatchedStreamDecoder(S, 48, 32)
    dec.decode_step(lists[0])              # tables and kernels loaded
    dec = BatchedStreamDecoder(S, 48, 32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tuple(p.clone() for p in out)
               for out in dec.decode_stream_pipelined(iter(lists))]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


# -- standard H.263 and the front-end switch ----------------------------------

def _std_streams(dims, n):
    from h263_tpu_torch.testing.corpora import build_corpus, d3_corpus

    streams = [build_corpus(*dims, n, seed=1600 + i, standard=True)
               for i in range(2)] + [d3_corpus(*dims, n, seed=1610)]
    cut = list(build_corpus(*dims, n, seed=1620, standard=True))
    cut[2] = cut[2][:len(cut[2]) // 2]           # cut after its header
    return streams + [cut]


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(48, 32), (128, 96)])
def test_cuda_standard_decoder_matches_cpu_decoder(cuda, dims):
    """DeviceFrontendDecoder(DecoderOption.NONE): custom sizes (PLUSPTYPE
    + CPFMT, table-D.3 MVDs) and a plain-PTYPE size, a cut lane, a masked
    step; planes, statuses and RGBA on the card equal the CPU's."""
    from h263_tpu_torch.types import DecoderOption

    streams = _std_streams(dims, 4)
    decs = [DeviceFrontendDecoder(4, *dims, DecoderOption.NONE, device=d)
            for d in ("cuda", "cpu")]
    before = automaton_cuda.launches
    for t in range(4):
        bufs = [s[t] for s in streams]
        mask = [True, t != 1, True, True]
        outs = [d.decode_step(bufs, mask=mask) for d in decs]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
        np.testing.assert_array_equal(decs[0].fetch_status(),
                                      decs[1].fetch_status())
    assert automaton_cuda.launches == before + 4
    np.testing.assert_array_equal(
        decs[0].present_rgba(deblock=True).cpu().numpy(),
        decs[1].present_rgba(deblock=True).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(48, 32), (128, 96)])
def test_cuda_standard_batched_decoder_matches_cpu_decoder(cuda, dims):
    """BatchedStreamDecoder(DecoderOption.NONE) on the card and the CPU:
    the native plain-PTYPE parse (128x96) and the Python header replay
    (PLUSPTYPE at 48x32), a masked slot, a PackOverflow step (small
    pack_cap); the copies' readings come from CUDA events."""
    from h263_tpu_torch.types import DecoderOption

    streams = _std_streams(dims, 4)[:3]
    decs = [BatchedStreamDecoder(3, *dims, DecoderOption.NONE, device=d)
            for d in ("cuda", "cpu")]
    small = [BatchedStreamDecoder(3, *dims, DecoderOption.NONE, pack_cap=16,
                                  device=d) for d in ("cuda", "cpu")]
    before = d24_cuda.launches
    for t in range(4):
        bufs = [s[t] for s in streams]
        mask = [True, t != 2, True]
        for pair in (decs, small):
            outs = [d.decode_step(bufs, mask=mask) for d in pair]
            for a, b in zip(*outs):
                np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    assert d24_cuda.launches >= before + 4
    torch.cuda.synchronize()
    decs[0].decode_step([s[3] for s in streams])
    assert decs[0].last_transfer_s > 0
    assert decs[0].last_transfer_bytes == sum(
        t.numel() * t.element_size() for t in (
            decs[0]._packed[0].rows_t, decs[0]._packed[0].mvs_t,
            decs[0]._packed[0].inter_t))


@pytest.mark.gpu
def test_cuda_switched_pool_matches_cpu_switched_pool(cuda):
    """A Sorenson host pool switched to the device front-end mid-GOP, on
    the card and on the CPU: every step's planes equal."""
    pools = [StreamPool(frontend="host"),
             StreamPool(frontend="host", device="cpu")]
    a, b = rich_gop(1700, n=5), rich_gop(1701, 64, 48, n=5)
    for p in pools:
        p.add_stream("a", 48, 32)
        p.add_stream("b", 64, 48)
    for t in range(5):
        if t == 2:
            for p in pools:
                p.switch_frontend("device")
        outs = [p.decode_step({"a": a[t], "b": b[t]}) for p in pools]
        for sid in ("a", "b"):
            for x, y in zip(outs[0][sid], outs[1][sid]):
                np.testing.assert_array_equal(x, y, err_msg=f"{t} {sid}")


@pytest.mark.gpu
@pytest.mark.parametrize("ref_hw,out_hw", [((24, 40), (58, 72)),
                                           ((58, 72), (22, 36)),
                                           ((145, 177), (288, 352)),
                                           ((288, 352), (145, 177))])
def test_reconstruct_kernel_with_a_reference_of_other_dims(cuda, ref_hw,
                                                           out_hw):
    """The single-stream decoder's call across a size change: output
    planes of `out_hw` predicted from references of `ref_hw`, MVs that
    reach past every edge of both, equal to the plain version."""
    rng = np.random.default_rng(sum(ref_hw) + 7 * sum(out_hw))
    (h, w), (rh, rw) = out_hw, ref_hw
    S, mbh, mbw = 3, -(-h // 16), -(-w // 16)
    dense = rng.integers(-300, 300, (S, 6 * mbh * mbw, 64)).astype(np.int16)
    dense[:, ::3] = 0
    dense[:, 1::3, 1:] = 0
    reach = 2 * max(h, w, rh, rw) + 9
    mvs = rng.integers(-reach, reach + 1, (S, mbh, mbw, 4, 2)).astype(
        np.int16)
    mvs[1] = rng.integers(-9, 10, mvs[1].shape)
    inter = rng.random((S, mbh, mbw)) < 0.8
    refs = [rng.integers(0, 256, (S, *hw), dtype=np.uint8)
            for hw in ((rh, rw), ((rh + 1) // 2, (rw + 1) // 2),
                       ((rh + 1) // 2, (rw + 1) // 2))]
    args = [torch.as_tensor(a) for a in (dense, mvs, inter, *refs)]
    want = reconstruct_from_dense_plain(*args, out_hw=out_hw)
    before = reconstruct_cuda.launches
    got = reconstruct_cuda.reconstruct_from_dense_cuda(
        *(a.to(cuda) for a in args), out_hw=out_hw)
    assert reconstruct_cuda.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.gpu
def test_cuda_single_decoder_matches_cpu_decoder_across_size_changes(cuda):
    """H263Decoder on the card and on the CPU over a short GOP through
    every kind of size change: planes and RGBA equal at every frame, and
    each frame launches the reconstruct kernel once."""
    gd = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM)
    cd = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device="cpu")
    assert gd.device.type == "cuda"
    for t, buf in enumerate(resize_sequence()):
        before = (reconstruct_cuda.launches, present_cuda.launches)
        g, c = gd.decode_next_picture(buf), cd.decode_next_picture(buf)
        assert g.luma.device.type == "cuda"
        for a, b in zip(g.as_yuv(), c.as_yuv()):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {t}")
        for deblock in (None, True, False):
            np.testing.assert_array_equal(gd.last_picture_rgba(deblock),
                                          cd.last_picture_rgba(deblock))
        assert (reconstruct_cuda.launches, present_cuda.launches) == (
            before[0] + 1, before[1] + 3)


# -- several cards, and meshes -------------------------------------------------


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda:1")


def _host(x):
    return (x.gather("cpu") if isinstance(x, StreamShards) else x.cpu())


def _run(dec, bufs, **kw):
    """decode_step's planes on the host, or the error's (class, text)."""
    try:
        return [_host(p) for p in dec.decode_step(bufs, **kw)]
    except H263Error as e:
        return (type(e).__name__, str(e))


def _gop_lists(S, T, seed):
    """T lists of S rich-GOP frames at 48x32, with lanes cut on both sides
    of the middle (a shard boundary of a two-shard mesh) in frame 2 and a
    header reject in frame 3."""
    streams = [rich_gop(seed + i, n=T) for i in range(S)]
    lists = [[s[t] for s in streams] for t in range(T)]
    mid = S // 2
    lists[2][mid - 1] = lists[2][mid - 1][:14]
    lists[2][mid] = lists[2][mid][:14]
    lists[3][mid + 1] = b"\x00\x01garbage"
    return lists


def _same_decoders(decs, lists, window=None, masks=()):
    """Step every decoder alike; planes, errors and statuses equal."""
    for t, bufs in enumerate(lists):
        mask = [i != 1 for i in range(len(bufs))] if t in masks else None
        outs = [_run(d, bufs, mask=mask) for d in decs]
        for o in outs[1:]:
            if isinstance(o, tuple):
                assert o == outs[0], t
            else:
                for a, b in zip(o, outs[0]):
                    assert torch.equal(a, b), t
        if hasattr(decs[0], "fetch_status"):
            for d in decs[1:]:
                np.testing.assert_array_equal(d.fetch_status(),
                                              decs[0].fetch_status())
    if window is not None:
        outs = []
        for d in decs:
            try:
                outs.append([_host(p) for p in d.decode_steps(window)])
            except H263Error as e:
                outs.append(str(e))
        for o in outs[1:]:
            if isinstance(o, str):
                assert o == outs[0]
            else:
                assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
        for d in decs[1:]:
            assert torch.equal(_host(d.last_status_steps),
                               _host(decs[0].last_status_steps))
    for deblock in (None, True):
        want = _host(decs[0].present_rgba(deblock=deblock))
        for d in decs[1:]:
            assert torch.equal(_host(d.present_rgba(deblock=deblock)), want)


@pytest.mark.gpu
@pytest.mark.parametrize("frontend", ["device", "host"])
def test_two_shard_mesh_on_one_card_equals_unsharded(cuda, frontend):
    """A mesh of two shards on cuda:0 against the unsharded decoder: cut
    lanes on both sides of the boundary, a header reject (its global
    stream), a masked slot, a window (device front-end), a PackOverflow
    step and the pipeline (host front-end), present_rgba."""
    S, T = 8, 6
    lists = _gop_lists(S, T, 2000)
    mesh = make_stream_mesh(["cuda:0", "cuda:0"])
    cls = DeviceFrontendDecoder if frontend == "device" else \
        BatchedStreamDecoder
    decs = [cls(S, 48, 32), cls(S, 48, 32, mesh=mesh)]
    assert decs[1].mesh.distinct == 1
    if frontend == "device":
        _same_decoders(decs, lists[:4], window=lists[4:], masks=(1,))
        return
    _same_decoders(decs, lists[:2] + [lists[4]], masks=(1,))
    small = [BatchedStreamDecoder(S, 48, 32, pack_cap=8),
             BatchedStreamDecoder(S, 48, 32, pack_cap=8, mesh=mesh)]
    _same_decoders(small, lists[:2])
    outs = [[[_host(p) for p in planes]
             for planes in d.decode_stream_pipelined(iter(lists[:2]))]
            for d in (BatchedStreamDecoder(S, 48, 32),
                      BatchedStreamDecoder(S, 48, 32, mesh=mesh))]
    for a, b in zip(*outs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_kernel_wrappers_on_the_second_card_equal_plain(two_cards):
    """Each wrapper launches on cuda:1 while cuda:0 is current, with its
    output on cuda:1 and equal to the plain version."""
    dev = two_cards
    assert torch.cuda.current_device() == 0
    rng = np.random.default_rng(31)
    c = torch.as_tensor(rng.integers(-900, 900, (500, 64)).astype(np.int16))
    got = idct_cuda.idct_residual_cuda(c.to(dev))
    assert got.device == dev
    assert torch.equal(got.cpu(), idct_residual_fused(c))

    S, h, w = 3, 48, 64
    mbh, mbw = 3, 4
    dense = torch.as_tensor(rng.integers(-200, 200, (S, 6 * mbh * mbw, 64)
                                         ).astype(np.int16))
    dense[:, ::2] = 0
    mvs = torch.as_tensor(rng.integers(-40, 41, (S, mbh, mbw, 4, 2)
                                       ).astype(np.int16))
    inter = torch.as_tensor(rng.random((S, mbh, mbw)) < 0.7)
    planes = [torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8))
              for shape in ((S, h, w), (S, h // 2, w // 2),
                            (S, h // 2, w // 2))]
    args = [dense, mvs, inter, *planes]
    got = reconstruct_cuda.reconstruct_from_dense_cuda(
        *(a.to(dev) for a in args))
    for a, b in zip(got, reconstruct_from_dense_plain(*args)):
        assert a.device == dev and torch.equal(a.cpu(), b)

    strength = torch.as_tensor(rng.integers(0, 13, S).astype(np.int32))
    apply = torch.as_tensor(rng.random(S) < 0.7)
    got = deblock_cuda.deblock_batched_cuda(planes[0].to(dev),
                                            strength.to(dev), apply.to(dev))
    assert torch.equal(got.cpu(), deblock_batched(planes[0], strength, apply))
    got = yuv_cuda.yuv420_to_rgba_cuda(*(p.to(dev) for p in planes))
    assert torch.equal(got.cpu(), yuv420_to_rgba(*planes))
    got = present_cuda.present_rgba_cuda(
        *(p.to(dev) for p in planes), strength.to(dev), apply.to(dev))
    assert torch.equal(got.cpu(), present_rgba_plain(*planes, strength,
                                                     apply))
    for mv_full in (None, False, True):
        rows = torch.as_tensor(d24_rows(rng, S, 300, mbh, mbw, mv_full))
        if mv_full is None:
            got = (d24_cuda.d24_to_dense_cuda(rows.to(dev), mbh, mbw),)
            want = (d24_to_dense(rows, mbh, mbw),)
        else:
            got = d24_cuda.unpack_fused_cuda(rows.to(dev), mbh, mbw, mv_full)
            want = unpack_fused(rows, mbh, mbw, mv_full)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))

    frames = rich_gop(41) + [rich_gop(42)[1][:15]]
    prep = DevicePrepBatch(len(frames), 48, 32)
    total = sum(((len(f) + 3) // 4) * 4 for f in frames)
    stage = np.zeros((total // 4 + 1, 4), np.uint8)
    meta = np.zeros((6, len(frames)), np.int32)
    prep.prepare_ragged(frames, stage, meta)
    stage, meta = torch.as_tensor(stage), torch.as_tensor(meta)
    got = automaton_cuda.parse_assemble_cuda(stage.to(dev), meta.to(dev),
                                             mbh=2, mbw=3)
    want = tdf.parse_assemble(stage, meta, mbh=2, mbw=3)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
def test_decoders_on_the_second_card_equal_the_first(two_cards):
    """device="cuda:1" decoders of each kind (a window included) equal
    cuda:0's at every frame, with cuda:0 current throughout."""
    S, T = 6, 6
    lists = _gop_lists(S, T, 2100)
    for cls in (DeviceFrontendDecoder, BatchedStreamDecoder):
        decs = [cls(S, 48, 32, device="cuda:0"),
                cls(S, 48, 32, device="cuda:1")]
        assert decs[1].ref_y.device == two_cards
        _same_decoders(decs, lists[:4], masks=(1,),
                       window=lists[4:] if cls is DeviceFrontendDecoder
                       else None)
    singles = [H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM,
                           device=d) for d in ("cuda:0", "cuda:1")]
    for t, buf in enumerate(resize_sequence()):
        pics = [d.decode_next_picture(buf) for d in singles]
        assert pics[1].luma.device == two_cards
        for a, b in zip(pics[0].as_yuv(), pics[1].as_yuv()):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {t}")
        np.testing.assert_array_equal(singles[0].last_picture_rgba(True),
                                      singles[1].last_picture_rgba(True))
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("frontend", ["device", "host"])
def test_mesh_over_every_card_equals_unsharded(two_cards, frontend):
    n = torch.cuda.device_count()
    S, T = 4 * n, 6
    lists = _gop_lists(S, T, 2200)
    mesh = make_stream_mesh()
    assert mesh.distinct == n
    cls = DeviceFrontendDecoder if frontend == "device" else \
        BatchedStreamDecoder
    decs = [cls(S, 48, 32), cls(S, 48, 32, mesh=mesh)]
    _same_decoders(decs, lists[:4], masks=(1,),
                   window=lists[4:] if frontend == "device" else None)
    assert decs[1].ref_y.device_set == set(mesh.devices)


@pytest.mark.gpu
def test_serving_pool_example_on_the_card(cuda):
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "h263_tpu_torch.examples.serving_pool",
         "--steps", "8"], cwd=str(root), capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(root)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "bit-exact against single-stream decoders" in proc.stdout


FUZZ_DEVICE_FLAVORS = ("d24", "device", "device_std", "device_umv", "fused")


def _fuzz_campaign(flavor, device, seed=5):
    """A small campaign of `testing/fuzz.py` on `device`: (total, notes,
    mismatches)."""
    import collections

    from h263_tpu_torch.testing import fuzz

    failures, notes = [], collections.Counter()
    total, fails = fuzz.run_campaign(
        seed=seed, n_base=3 if flavor == "fused" else 20,
        flavor=flavor, device=device, notes=notes,
        on_fail=lambda tag, why: failures.append((tag, why)))
    assert fails == len(failures)
    return total, dict(notes), failures


@pytest.mark.gpu
@pytest.mark.parametrize("flavor", FUZZ_DEVICE_FLAVORS)
def test_fuzz_campaign_on_the_card(cuda, flavor):
    """Each kernel flavor of the fuzz library on the card: no mismatch, and
    its kernels launched."""
    kernels_of = {"d24": (d24_cuda,), "fused": (d24_cuda, automaton_cuda,
                                                reconstruct_cuda)}
    mods = kernels_of.get(flavor, (automaton_cuda,))
    before = [m.launches for m in mods]
    total, _, failures = _fuzz_campaign(flavor, "cuda")
    assert not failures, failures[:5]
    assert total >= (18 if flavor == "fused" else 220)
    assert all(m.launches > b for m, b in zip(mods, before))


@pytest.mark.gpu
@pytest.mark.parametrize("flavor", ["device", "device_std", "device_umv"])
def test_fuzz_lanes_match_the_plain_automaton(cuda, flavor):
    """One automaton launch over a campaign's lanes equals its plain version
    on the CPU, tensor for tensor and status for status."""
    from h263_tpu_torch.testing import fuzz

    w, h = (128, 96) if flavor == "device_std" else (96, 80)
    cases = fuzz._cases_for(flavor, np.random.default_rng(3), 6, 9, w, h)
    payload, meta, _ = fuzz.device_lanes(cases, w, h)
    got = fuzz.launch_lanes(payload, meta, w, h, cuda)
    want = fuzz.launch_lanes(payload, meta, w, h, torch.device("cpu"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("flavor", ["d24", "device", "fused"])
def test_fuzz_campaign_on_the_second_card(two_cards, flavor):
    """The same campaign on cuda:1 and cuda:0: no mismatch on either, the
    same totals and outcomes."""
    one = _fuzz_campaign(flavor, "cuda:1")
    zero = _fuzz_campaign(flavor, "cuda:0")
    assert not one[2] and one == zero


# -- the reference implementation's own vectors (tests/ref_vectors/) on the
# card: the images and quartets tests/test_torch_reference_vectors.py holds
# the plain versions and the kernels' g++ host walks to.

def _ref_vectors(name):
    import json
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "ref_vectors" / name
    return json.loads(path.read_text())


def _yuv_image(idx):
    img = _ref_vectors("yuv.json")["images"][idx]
    w = img["y_width"]
    h = 0 if w == 0 else len(img["y"]) // w
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return ([torch.as_tensor(np.asarray(img[k], np.uint8).reshape(1, *hw))
             for k, hw in (("y", (h, w)), ("cb", (ch, cw)),
                           ("cr", (ch, cw)))],
            np.asarray(img["rgba"], np.uint8).reshape(1, h, w, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("idx", range(10))
def test_rgba_kernels_on_the_reference_images(cuda, idx):
    """bt601.rs's golden images through the YUV kernel and the present
    kernel (no deblock), exact."""
    planes, want = _yuv_image(idx)
    planes = [p.to(cuda) for p in planes]
    got = yuv_cuda.yuv420_to_rgba_cuda(*planes)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    got = present_cuda.present_rgba_cuda(
        *planes, torch.zeros(1, dtype=torch.int32, device=cuda),
        torch.zeros(1, dtype=torch.bool, device=cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_rgba_kernels_on_the_reference_scalar_anchors(cuda):
    """bt601.rs's scalar anchors, one 1x1 picture a lane."""
    cases = _ref_vectors("yuv.json")["scalar"]
    yuv = np.asarray([c["yuv"] for c in cases], np.uint8)
    planes = [torch.as_tensor(np.ascontiguousarray(yuv[:, k, None, None]))
              .to(cuda) for k in range(3)]
    want = np.asarray([c["rgb"] for c in cases], np.uint8)
    n = len(cases)
    for got in (yuv_cuda.yuv420_to_rgba_cuda(*planes),
                present_cuda.present_rgba_cuda(
                    *planes, torch.zeros(n, dtype=torch.int32, device=cuda),
                    torch.zeros(n, dtype=torch.bool, device=cuda))):
        got = got.cpu().numpy()
        np.testing.assert_array_equal(got[:, 0, 0, :3], want)
        assert (got[..., 3] == 255).all()


@pytest.mark.gpu
@pytest.mark.parametrize("strength", [4, 8, 12])
def test_deblock_kernels_on_the_reference_image(cuda, strength):
    """deblock.rs's 11x17 golden image at its strength through the deblock
    kernel; and as the luma of a picture with flat chroma (which the
    filter leaves alone) through the present kernel, whose RGBA must be the
    plain conversion of the golden deblocked luma."""
    img = _ref_vectors("deblock.json")["image"]
    w = img["width"]
    data = np.asarray(img["data"], np.uint8).reshape(1, -1, w)
    want = np.asarray(img["expected"][str(strength)],
                      np.uint8).reshape(1, -1, w)
    st = torch.tensor([strength], dtype=torch.int32, device=cuda)
    on = torch.ones(1, dtype=torch.bool, device=cuda)
    y = torch.as_tensor(data).to(cuda)
    got = deblock_cuda.deblock_batched_cuda(y, st, on)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    h = data.shape[1]
    c = torch.full((1, (h + 1) // 2, (w + 1) // 2), 140, dtype=torch.uint8)
    rgba = present_cuda.present_rgba_cuda(y, c.to(cuda), c.to(cuda), st, on)
    np.testing.assert_array_equal(
        rgba.cpu().numpy(), yuv420_to_rgba(torch.as_tensor(want), c, c))


@pytest.mark.gpu
def test_deblock_kernel_on_the_reference_quartets(cuda):
    """deblock.rs's quartet table, each quartet the rows 6-9 of a 10x1
    plane (its one edge in the reference's truncating zone), one lane a
    quartet at its own strength; reversed and inverted too."""
    quartets = _ref_vectors("deblock.json")["quartets"]
    st = torch.tensor([q["strength"] for q in quartets], dtype=torch.int32,
                      device=cuda)
    on = torch.ones(len(quartets), dtype=torch.bool, device=cuda)
    want = np.asarray([q["output"] for q in quartets], np.uint8)
    for flip in (False, True):
        for invert in (False, True):
            q = np.asarray([c["input"] for c in quartets], np.uint8)
            q = q[:, ::-1] if flip else q
            q = 255 - q if invert else q
            planes = np.full((len(quartets), 10, 1), 77, np.uint8)
            planes[:, 6:10, 0] = q
            got = deblock_cuda.deblock_batched_cuda(
                torch.as_tensor(planes).to(cuda), st, on).cpu().numpy()
            assert (got[:, :6] == 77).all()
            got = got[:, 6:10, 0]
            got = 255 - got if invert else got
            got = got[:, ::-1] if flip else got
            np.testing.assert_array_equal(
                got, want, err_msg=f"reversed {flip}, inverted {invert}")
