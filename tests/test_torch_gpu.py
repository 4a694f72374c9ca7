"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

These tests need a CUDA device and skip without one.  They import neither
JAX nor the JAX package, so they also run where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from h263_tpu_torch import DeviceFrontendDecoder  # noqa: E402
from h263_tpu_torch.native import DevicePrepBatch  # noqa: E402
from h263_tpu_torch.ops import (  # noqa: E402
    deblock_cuda,
    idct_cuda,
    reconstruct_cuda,
    yuv_cuda,
)
from h263_tpu_torch.ops.deblock import deblock_batched  # noqa: E402
from h263_tpu_torch.ops.idct import idct_residual_fused  # noqa: E402
from h263_tpu_torch.ops.reconstruct import (  # noqa: E402
    reconstruct_from_dense_plain,
)
from h263_tpu_torch.ops.yuv import yuv420_to_rgba  # noqa: E402
from h263_tpu_torch.parallel.pool import StreamPool  # noqa: E402
from h263_tpu_torch.parser import automaton_cuda  # noqa: E402
from h263_tpu_torch.parser import device_frontend as tdf  # noqa: E402
from h263_tpu_torch.testing.corpora import rich_gop  # noqa: E402


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
