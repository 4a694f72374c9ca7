"""Presentation in the port: the Annex-J deblock and BT.601 RGBA, held
against the JAX package exactly (every output is an integer).

* The deblock kernel's own arithmetic (`h263_tpu_torch/csrc/deblock.cuh`),
  built by g++ through a host loop that drives it pass by pass as the CUDA
  kernel does (tests/deblock_host.cpp), against `golden_deblock` on odd and
  even plane sizes, per-stream strengths 0-12 and apply flags.
* The plain versions the wrappers run on a CPU tensor against the Pallas
  kernels in interpret mode (as tests/test_pallas.py runs them) and
  against `deblock_jnp` / `yuv420_to_rgba_jnp`.
* `present_rgba_batched` against the JAX package's, and the wrappers'
  argument checks.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from h263_tpu.decoder import reconstruct as jrec  # noqa: E402
from h263_tpu.ops.deblock import deblock_jnp, golden_deblock  # noqa: E402
from h263_tpu.ops.deblock_pallas import deblock_pallas  # noqa: E402
from h263_tpu.ops.yuv import yuv420_to_rgba_jnp  # noqa: E402
from h263_tpu.ops.yuv_pallas import yuv420_to_rgba_pallas  # noqa: E402
from h263_tpu_torch.decoder import reconstruct as trec  # noqa: E402
from h263_tpu_torch.ops import deblock_cuda, yuv_cuda  # noqa: E402
from h263_tpu_torch.ops.deblock import deblock_batched  # noqa: E402
from h263_tpu_torch.ops.yuv import yuv420_to_rgba  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
S = 13                                   # one lane per strength 0..12
# Each shape costs an interpret-mode Pallas compile of 1.5-6 s on the CPU,
# so the Pallas kernels run on the odd-sized shapes only; every shape is
# held against the jnp versions.
PALLAS_SHAPES = {(17, 11), (9, 130)}


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _planes(shape, seed, s=S):
    """uint8 [s, h, w]: even lanes 8x8-blocky with small noise (where the
    filter acts), odd lanes uniform noise (where it clamps and wraps)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    by, bx = -(-h // 8), -(-w // 8)
    base = rng.integers(0, 256, (s, by, bx)).repeat(8, 1).repeat(8, 2)
    base = base[:, :h, :w] + rng.integers(-3, 4, (s, h, w))
    noise = rng.integers(0, 256, (s, h, w))
    even = (np.arange(s) % 2 == 0)[:, None, None]
    return np.clip(np.where(even, base, noise), 0, 255).astype(np.uint8)


def _strengths(seed, s=S):
    rng = np.random.default_rng(seed)
    strength = np.arange(s, dtype=np.int32) % 13
    apply = rng.random(s) < 0.7
    apply[:2] = True
    return strength, apply


def _golden_batched(planes, strength, apply):
    return np.stack([golden_deblock(p, int(st)) if a and st > 0 else p
                     for p, st, a in zip(planes, strength, apply)])


@pytest.fixture(scope="module")
def deblock_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("deblock") / "libdeblock.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-o", str(so), str(HERE / "deblock_host.cpp")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.h263_deblock_host.argtypes = [P, P, I, I, I, P, P]
    lib.h263_deblock_host.restype = I
    return lib


@pytest.mark.parametrize("shape", [(1, 1), (2, 17), (8, 8), (9, 10),
                                   (10, 9), (16, 16), (17, 11), (23, 37),
                                   (48, 9), (73, 89), (145, 177), (288, 352)])
def test_kernel_source_matches_golden(deblock_host, shape):
    planes = _planes(shape, seed=shape[0] * 1000 + shape[1])
    strength, apply = _strengths(shape[1])
    out = np.full_like(planes, 0x5A)
    rc = deblock_host.h263_deblock_host(
        planes.ctypes.data, out.ctypes.data, S, shape[0], shape[1],
        strength.ctypes.data, apply.astype(np.uint8).ctypes.data)
    assert rc == 0
    np.testing.assert_array_equal(out, _golden_batched(planes, strength,
                                                       apply))


@pytest.mark.parametrize("shape", [(17, 11), (48, 9)])
def test_plain_deblock_matches_pallas_and_jnp(shape):
    planes = _planes(shape, seed=shape[1])
    strength, apply = _strengths(shape[0])
    got = deblock_batched(_t(planes), _t(strength), _t(apply)).numpy()
    if shape in PALLAS_SHAPES:
        pallas = np.stack([
            np.asarray(deblock_pallas(p, int(st), interpret=True))
            if a and st > 0 else p
            for p, st, a in zip(planes, strength, apply)])
        np.testing.assert_array_equal(got, pallas)
    s3 = jnp.asarray(strength)[:, None, None]
    use = jnp.asarray(apply)[:, None, None] & (s3 > 0)
    jnp_out = np.asarray(jnp.where(use, deblock_jnp(planes, s3), planes))
    np.testing.assert_array_equal(got, jnp_out)
    assert (got != planes).any(axis=(1, 2)).sum() >= 4


@pytest.mark.parametrize("shape", [(16, 16), (17, 11), (9, 130)])
def test_plain_yuv_matches_pallas_and_jnp(shape):
    h, w = shape
    rng = np.random.default_rng(h * 31 + w)
    y = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    cb = rng.integers(0, 256, (3, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (3, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    got = yuv420_to_rgba(_t(y), _t(cb), _t(cr)).numpy()
    np.testing.assert_array_equal(got, np.asarray(yuv420_to_rgba_jnp(y, cb,
                                                                     cr)))
    for s in range(3 if shape in PALLAS_SHAPES else 0):
        np.testing.assert_array_equal(got[s], np.asarray(
            yuv420_to_rgba_pallas(y[s], cb[s], cr[s], interpret=True)))


@pytest.mark.parametrize("shape", [(32, 48), (145, 177)])
def test_present_rgba_batched_matches_jax_per_stream(shape):
    h, w = shape
    rng = np.random.default_rng(w)
    y = _planes(shape, seed=h)
    cb = _planes(((h + 1) // 2, (w + 1) // 2), seed=h + 1)
    cr = rng.integers(0, 256, cb.shape, dtype=np.uint8)
    strength, apply = _strengths(w)
    want = np.asarray(jax.jit(jrec.present_rgba_batched)(
        y, cb, cr, strength, apply))
    before = (deblock_cuda.launches, yuv_cuda.launches)
    got = trec.present_rgba_batched(_t(y), _t(cb), _t(cr), _t(strength),
                                    _t(apply)).numpy()
    np.testing.assert_array_equal(got, want)
    # A CPU tensor runs the plain versions: no kernel launch is counted.
    assert (deblock_cuda.launches, yuv_cuda.launches) == before


def _meta(*shape, dtype=torch.uint8):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_deblock_wrapper_checks_its_arguments():
    p = torch.zeros((2, 16, 16), dtype=torch.uint8)
    st = torch.ones(2, dtype=torch.int32)
    ap = torch.ones(2, dtype=torch.bool)
    bad = [
        (p.to(torch.int32), st, ap),                 # plane dtype
        (p[0], st, ap),                              # plane rank
        (p, st.to(torch.int64), ap),                 # strength dtype
        (p, st[:1], ap),                             # strength shape
        (p, st, ap.to(torch.uint8)),                 # apply dtype
        (_meta(2, 16, 16), st, ap),                  # devices differ
        (_meta(2, 16, 16), _meta(2, dtype=torch.int32),
         _meta(2, dtype=torch.bool)),                # not cpu, not cuda
    ]
    for args in bad:
        with pytest.raises(ValueError):
            deblock_cuda.deblock_batched_cuda(*args)


def test_yuv_wrapper_checks_its_arguments():
    y = torch.zeros((2, 17, 11), dtype=torch.uint8)
    c = torch.zeros((2, 9, 6), dtype=torch.uint8)
    bad = [
        (y.to(torch.int16), c, c),
        (y, c[:, :8], c),
        (y, c, c[:1]),
        (y[0], c[0], c[0]),
        (_meta(2, 17, 11), c, c),
        (_meta(2, 17, 11), _meta(2, 9, 6), _meta(2, 9, 6)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            yuv_cuda.yuv420_to_rgba_cuda(*args)
    out = yuv_cuda.yuv420_to_rgba_cuda(y, c, c)
    assert out.shape == (2, 17, 11, 4) and out.dtype == torch.uint8
