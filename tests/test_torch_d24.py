"""The fused transport's unpack (`h263_tpu_torch/ops/d24.py`, the plain
version of the CUDA kernel `csrc/d24.cu`) against the JAX package.

* `d24_to_dense` against `h263_tpu/decoder/reconstruct.py::d24_to_posval`
  with the scatter-add into zeroed coefficients (`mode="drop"`), on the
  rows the native fused parse writes for fuzzed GOPs and on hand-made rows
  (entries at cursor -1, collisions, escapes, a tail past the last
  coefficient).
* The kernel's own arithmetic (`csrc/d24.cuh`), built here by g++ through
  a host loop (tests/d24_host.cpp), against the plain version.
* The fused reconstruction, slim and full MV rows, at QCIF and 177x145:
  the port's `reconstruct_frame_packed_d24_fused` against the planes of
  the JAX one.

Zero tolerance: integer arithmetic throughout.
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
from h263_tpu.native import bindings as jnative  # noqa: E402
from h263_tpu.testing.fuzz import _rand_fused_gop  # noqa: E402
from h263_tpu_torch.decoder import reconstruct as trec  # noqa: E402
from h263_tpu_torch.ops.d24 import (  # noqa: E402
    ZIGZAG_U8,
    d24_to_dense,
    fused_sections,
    unpack_fused,
)
from h263_tpu_torch.testing.corpora import d24_rows  # noqa: E402
from test_torch_reference_native import require_reference_native  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
SIZES = [(48, 32), (176, 144), (177, 145)]


def _jax_dense(rows, mbh, mbw):
    pos, val = jrec.d24_to_posval(jnp.asarray(rows), mbh, mbw)
    n = 6 * mbh * mbw * 64
    dense = jax.vmap(lambda d, p, v: d.at[p].add(v, mode="drop"))(
        jnp.zeros((rows.shape[0], n), jnp.int16), pos, val)
    return np.asarray(dense).reshape(rows.shape[0], -1, 64)


def _parser_rows(w, h, mv_stride, seed, n_streams=3, n_frames=6):
    """Fused rows the JAX package's native parse writes for fuzzed GOPs:
    [(rows uint8 [n, used bytes], mvs int16, inter uint8)] per frame."""
    require_reference_native()
    rng = np.random.default_rng(seed)
    gops = [_rand_fused_gop(rng, w, h, n_frames) for _ in range(n_streams)]
    mbw, mbh = -(-w // 16), -(-h // 16)
    nmb = mbw * mbh
    cap = 16 * nmb
    ladder = np.array([cap], dtype=np.int32)
    fused = np.zeros((n_streams, sum(fused_sections(nmb, mv_stride == 8))
                      + 3 * cap), dtype=np.uint8)
    mvs = np.zeros((n_streams, mbh, mbw, 4, 2), dtype=np.int16)
    inter = np.ones((n_streams, mbh, mbw), dtype=np.uint8)
    p = jnative.SorensonFusedBatchParser(
        n_streams, w, h, fused, mv_stride, mvs, inter,
        np.zeros((nmb, 4, 2), dtype=np.int16), cap, ladder)
    out = []
    for t in range(n_frames):
        try:
            _, _, _, cut = p.parse([g[t] for g in gops], [True] * n_streams)
        except jnative.H263Error:
            continue
        used = sum(fused_sections(nmb, mv_stride == 8)) + 3 * cut
        out.append((fused[:, :used].copy(), mvs.copy(), inter.copy()))
    assert out
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("rows", ["parser", "handmade"])
def test_d24_to_dense_matches_jax(size, rows):
    w, h = size
    mbh, mbw = -(-h // 16), -(-w // 16)
    nmb = mbh * mbw
    if rows == "parser":
        off = sum(fused_sections(nmb, False))
        cases = [r[:, off:] for r, _, _ in _parser_rows(w, h, 2, w + h)]
    else:
        cases = [d24_rows(np.random.default_rng(w * h + k), 5, 400, mbh, mbw)
                 for k in range(3)]
    for r in cases:
        got = d24_to_dense(torch.as_tensor(r), mbh, mbw).numpy()
        np.testing.assert_array_equal(got, _jax_dense(r, mbh, mbw))
        assert got.any()


def test_handmade_rows_hold_every_edge():
    """The hand-made rows reach each edge of the unpack."""
    mbh, mbw = 9, 11
    r = d24_rows(np.random.default_rng(3), 4, 600, mbh, mbw)
    e = r.reshape(4, -1, 3).astype(np.int64)
    w = (e[..., 0] << 16) | (e[..., 1] << 8) | e[..., 2]
    cursor = np.cumsum(w >> 12, axis=1) - 1
    val = w & 0xFFF
    assert ((cursor < 0) & (val != 0)).any()
    assert (cursor >= 6 * mbh * mbw * 64).any()
    live = (cursor >= 0) & (val != 0)
    assert ((np.diff(cursor, axis=1) == 0) & live[:, 1:]
            & live[:, :-1]).any()


@pytest.fixture(scope="module")
def host_unpack(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("d24") / "libd24host.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-o", str(so), str(HERE / "d24_host.cpp")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(so)).h263_d24_unpack_host
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, ctypes.c_int64, I, I, I, I, I, P, P, P, P]
    fn.restype = I
    return fn


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mv_full", [None, False, True])
def test_kernel_source_matches_plain(host_unpack, size, mv_full):
    w, h = size
    mbh, mbw = -(-h // 16), -(-w // 16)
    nmb = mbh * mbw
    rows = d24_rows(np.random.default_rng(w + h), 6, 500, mbh, mbw, mv_full)
    pitch = rows.shape[1] + 5          # rows lying apart, as in the card's
    wide = np.zeros((6, pitch), dtype=np.uint8)
    wide[:, :rows.shape[1]] = rows
    dense = np.full((6, 6 * nmb, 64), 77, dtype=np.int16)
    mvs = np.full((6, mbh, mbw, 4, 2), 77, dtype=np.int16)
    inter = np.full((6, mbh, mbw), 77, dtype=np.uint8)
    stride = 0 if mv_full is None else 8 if mv_full else 2
    head = sum(fused_sections(nmb, bool(mv_full))) if stride else 0
    assert host_unpack(wide.ctypes.data, pitch, (rows.shape[1] - head) // 3,
                       stride, 6, mbh, mbw, ZIGZAG_U8.ctypes.data,
                       dense.ctypes.data, mvs.ctypes.data,
                       inter.ctypes.data) == 0
    t = torch.as_tensor(rows)
    if mv_full is None:
        np.testing.assert_array_equal(dense, d24_to_dense(t, mbh, mbw))
    else:
        want = unpack_fused(t, mbh, mbw, mv_full)
        for got, ref in zip((dense, mvs, inter), want):
            np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("size", [(176, 144), (177, 145)])
@pytest.mark.parametrize("mv_full", [False, True])
@pytest.mark.parametrize("rows", ["parser", "handmade"])
def test_fused_reconstruction_matches_jax(size, mv_full, rows):
    w, h = size
    mbh, mbw = -(-h // 16), -(-w // 16)
    rng = np.random.default_rng(w * 3 + h + mv_full)
    if rows == "parser":
        cases = [r for r, _, _ in _parser_rows(w, h, 8 if mv_full else 2,
                                               w + 2 * h + mv_full)][:3]
    else:
        cases = [d24_rows(rng, 3, 300, mbh, mbw, mv_full)]
    jfn = jrec.get_packed_d24_fused_reconstruct_fn(h, w, mv_full, "off")
    for r in cases:
        s = r.shape[0]
        refs = [rng.integers(0, 256, (s, ph, pw), dtype=np.uint8)
                for ph, pw in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                               ((h + 1) // 2, (w + 1) // 2))]
        want = jfn(jnp.asarray(r), *map(jnp.asarray, refs))
        got = trec.reconstruct_frame_packed_d24_fused(
            torch.as_tensor(r), *map(torch.as_tensor, refs), mv_full=mv_full,
            mbh=mbh, mbw=mbw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("size", [(176, 144), (177, 145)])
def test_flip_step_reconstruction_matches_jax(size):
    """The flip step's transport: delta24 entries beside full int16 MVs and
    byte flags, as `reconstruct_frame_packed_d24`."""
    w, h = size
    mbh, mbw = -(-h // 16), -(-w // 16)
    off = sum(fused_sections(mbh * mbw, False))
    rng = np.random.default_rng(w + h)
    jfn = jrec.get_packed_d24_reconstruct_fn(h, w, "off")
    for r, mvs, inter in _parser_rows(w, h, 2, 5 * w + h)[:3]:
        s = r.shape[0]
        refs = [rng.integers(0, 256, (s, ph, pw), dtype=np.uint8)
                for ph, pw in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                               ((h + 1) // 2, (w + 1) // 2))]
        coef = np.ascontiguousarray(r[:, off:])
        want = jfn(jnp.asarray(coef), jnp.asarray(mvs), jnp.asarray(inter),
                   *map(jnp.asarray, refs))
        got = trec.reconstruct_frame_packed_d24(
            *map(torch.as_tensor, (coef, mvs, inter, *refs)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
