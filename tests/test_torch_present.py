"""Presentation in the port: the Annex-J deblock and BT.601 RGBA, held
against the JAX package exactly (every output is an integer).

* The one-pass deblock kernel's own source (`h263_tpu_torch/csrc/
  deblock_tile.cuh` over `deblock.cuh`), built by g++ through a host loop
  that walks it tile by tile as the CUDA kernel does (tests/deblock_host.cpp),
  against `golden_deblock` on odd and even plane sizes, one wider than a
  column tile, per-stream strengths 0-12 and apply flags.
* The fused presentation kernel's source (`present_tile.cuh`, `yuv.cuh`)
  the same way (tests/present_host.cpp) against the JAX package's
  `present_rgba_batched`; a copy of the headers whose tile grid cuts
  quartets must fail both comparisons.
* The plain versions the wrappers run on a CPU tensor against the Pallas
  kernels in interpret mode (as tests/test_pallas.py runs them) and
  against `deblock_jnp` / `yuv420_to_rgba_jnp`.
* `present_rgba_batched` and `present_rgba_plain` against the JAX
  package's, and the wrappers' argument checks.
"""

import ctypes
import functools
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
from h263_tpu_torch.ops import deblock_cuda, present_cuda, yuv_cuda  # noqa: E402
from h263_tpu_torch.ops.deblock import deblock_batched  # noqa: E402
from h263_tpu_torch.ops.present import present_rgba_plain  # noqa: E402
from h263_tpu_torch.ops.yuv import yuv420_to_rgba  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE.parent / "h263_tpu_torch" / "csrc"
TILE_HEADERS = ("deblock.cuh", "deblock_tile.cuh", "yuv.cuh",
                "present_tile.cuh")
THREADS = 256                            # a block of the kernels
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


def _build_host(tmp, src, entry):
    """g++ build of a host walk (tests/*_host.cpp); its entry point takes
    the kernel's arguments and the threads of a block."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = tmp / f"lib{entry}.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    fn = getattr(ctypes.CDLL(str(so)), entry)
    P, I = ctypes.c_void_p, ctypes.c_int
    n_planes = {"h263_deblock_host": 2, "h263_present_host": 4}[entry]
    fn.argtypes = [P] * n_planes + [I, I, I, P, P, I]
    fn.restype = I
    return fn


@pytest.fixture(scope="module")
def deblock_host(tmp_path_factory):
    return _build_host(tmp_path_factory.mktemp("deblock"),
                       HERE / "deblock_host.cpp", "h263_deblock_host")


@pytest.fixture(scope="module")
def present_host(tmp_path_factory):
    return _build_host(tmp_path_factory.mktemp("present"),
                       HERE / "present_host.cpp", "h263_present_host")


def run_deblock_host(fn, planes, strength, apply, threads=THREADS):
    out = np.full_like(planes, 0x5A)
    flags = apply.astype(np.uint8)
    rc = fn(planes.ctypes.data, out.ctypes.data, *planes.shape,
            strength.ctypes.data, flags.ctypes.data, threads)
    assert rc == 0
    return out


def run_present_host(fn, y, cb, cr, strength, apply, threads=THREADS):
    out = np.full((*y.shape, 4), 0x5A, dtype=np.uint8)
    flags = apply.astype(np.uint8)
    rc = fn(y.ctypes.data, cb.ctypes.data, cr.ctypes.data, out.ctypes.data,
            *y.shape, strength.ctypes.data, flags.ctypes.data, threads)
    assert rc == 0
    return out


@pytest.mark.parametrize("shape", [(1, 1), (2, 17), (8, 8), (9, 10),
                                   (10, 9), (16, 16), (17, 11), (23, 37),
                                   (48, 9), (73, 89), (145, 177), (288, 352),
                                   (24, 530)])
def test_kernel_source_matches_golden(deblock_host, shape):
    planes = _planes(shape, seed=shape[0] * 1000 + shape[1])
    strength, apply = _strengths(shape[1])
    want = _golden_batched(planes, strength, apply)
    np.testing.assert_array_equal(
        run_deblock_host(deblock_host, planes, strength, apply), want)
    # Any number of warps walks the same items.
    np.testing.assert_array_equal(
        run_deblock_host(deblock_host, planes, strength, apply, threads=32),
        want)
    # A plane that starts at an odd address: no row is aligned as the tile's.
    flat = np.zeros(planes.size + 3, dtype=np.uint8)
    shifted = flat[3:].reshape(planes.shape)
    shifted[:] = planes
    np.testing.assert_array_equal(
        run_deblock_host(deblock_host, shifted, strength, apply), want)


@functools.lru_cache(maxsize=None)
def _present_case(shape):
    """Inputs of one presentation and the JAX package's RGBA for them."""
    h, w = shape
    rng = np.random.default_rng(w)
    y = _planes(shape, seed=h)
    cb = _planes(((h + 1) // 2, (w + 1) // 2), seed=h + 1)
    cr = rng.integers(0, 256, cb.shape, dtype=np.uint8)
    strength, apply = _strengths(w)
    want = np.asarray(jax.jit(jrec.present_rgba_batched)(
        y, cb, cr, strength, apply))
    return (y, cb, cr, strength, apply), want


PRESENT_SHAPES = [(32, 48), (145, 177), (9, 130), (17, 11), (8, 8), (1, 1),
                  (24, 530)]


@pytest.mark.parametrize("shape", PRESENT_SHAPES)
def test_present_kernel_source_matches_jax(present_host, shape):
    args, want = _present_case(shape)
    np.testing.assert_array_equal(run_present_host(present_host, *args), want)
    np.testing.assert_array_equal(
        run_present_host(present_host, *args, threads=64), want)
    if min(shape) >= 16:
        assert (want != np.asarray(jax.jit(jrec.present_rgba_batched)(
            *args[:4], np.zeros_like(args[4])))).any()   # the deblock acted


@pytest.mark.parametrize("entry", ["h263_deblock_host", "h263_present_host"])
def test_mutation_a_grid_that_cuts_quartets_fails(tmp_path, entry):
    """The comparison can see a tile grid that is not self-contained: a copy
    of the headers whose tile boundaries lie at multiples of the grid's step
    (shift 0), where each cuts the quartets of a horizontal edge, no longer
    matches the reference."""
    src = tmp_path / "h263_tpu_torch" / "csrc"
    src.mkdir(parents=True)
    for name in TILE_HEADERS:
        text = (CSRC / name).read_text()
        if name == "deblock_tile.cuh":
            for shift in ("kLumaShift = 4", "kChromaShift = 2"):
                assert text.count(shift) == 1
                text = text.replace(shift, shift[:-1] + "0")
        (src / name).write_text(text)
    (tmp_path / "tests").mkdir()
    host = tmp_path / "tests" / (entry[5:] + ".cpp")
    host.write_text((HERE / host.name).read_text())
    fn = _build_host(tmp_path, host, entry)
    args, want = _present_case((145, 177))
    if entry == "h263_deblock_host":
        got = run_deblock_host(fn, args[0], *args[3:])
        want = _golden_batched(args[0], *args[3:])
    else:
        got = run_present_host(fn, *args)
    assert (got != want).any()


@pytest.mark.parametrize("shape", PRESENT_SHAPES)
def test_plain_present_matches_jax(shape):
    args, want = _present_case(shape)
    got = present_rgba_plain(*[_t(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, want)


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
    args, want = _present_case(shape)
    modules = (present_cuda, deblock_cuda, yuv_cuda)
    before = [m.launches for m in modules]
    got = trec.present_rgba_batched(*[_t(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, want)
    # A CPU tensor runs the plain versions: no kernel launch is counted.
    assert [m.launches for m in modules] == before


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


def test_present_wrapper_checks_its_arguments():
    y = torch.zeros((2, 17, 11), dtype=torch.uint8)
    c = torch.zeros((2, 9, 6), dtype=torch.uint8)
    st = torch.ones(2, dtype=torch.int32)
    ap = torch.ones(2, dtype=torch.bool)
    bad = [
        (y.to(torch.int16), c, c, st, ap),           # plane dtype
        (y, c[:, :8], c, st, ap),                    # chroma shape
        (y, c, c[:1], st, ap),
        (y[0], c[0], c[0], st, ap),                  # plane rank
        (y, c, c, st.to(torch.int64), ap),           # strength dtype
        (y, c, c, st[:1], ap),                       # strength shape
        (y, c, c, st, ap.to(torch.uint8)),           # apply dtype
        (y, c, c, st, ap[:1]),                       # apply shape
        (_meta(2, 17, 11), c, c, st, ap),            # devices differ
        (y, c, c, _meta(2, dtype=torch.int32), ap),
        (_meta(2, 17, 11), _meta(2, 9, 6), _meta(2, 9, 6),
         _meta(2, dtype=torch.int32),
         _meta(2, dtype=torch.bool)),                # not cpu, not cuda
    ]
    for args in bad:
        with pytest.raises(ValueError):
            present_cuda.present_rgba_cuda(*args)
    before = present_cuda.launches
    out = present_cuda.present_rgba_cuda(y, c, c, st, ap)
    assert out.shape == (2, 17, 11, 4) and out.dtype == torch.uint8
    assert present_cuda.launches == before           # a CPU tensor: plain
