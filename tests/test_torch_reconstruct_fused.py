"""The fused reconstruction kernel's own source, checked on the CPU.

`h263_tpu_torch/csrc/idct.cuh` and `reconstruct.cuh` hold the arithmetic the
CUDA kernel `csrc/reconstruct.cu` runs.  Built here by g++ (with
`-ffp-contract=off`: the IDCT rounds every product) through a host loop that
drives them block by block over whole frames (tests/reconstruct_host.cpp),
they are held against the JAX package's `reconstruct_from_dense`, through
the Pallas IDCT in interpret mode and through its plain branch, and against
the port's plain version.  Zero tolerance: each frame is the next one's
prediction.  This tests the kernel's source; it is not a CPU path of the port.
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

from h263_tpu.decoder import reconstruct as jrec  # noqa: E402
from h263_tpu_torch.ops import reconstruct_cuda  # noqa: E402
from h263_tpu_torch.ops.idct import BASIS_F32  # noqa: E402
from h263_tpu_torch.ops.reconstruct import (  # noqa: E402
    reconstruct_from_dense_plain,
)

HERE = pathlib.Path(__file__).resolve().parent
HOST_SRC = HERE / "reconstruct_host.cpp"
CSRC = HERE.parent / "h263_tpu_torch" / "csrc"
BASIS = np.ascontiguousarray(BASIS_F32, dtype=np.float32)
# The interpret-mode Pallas IDCT costs a compile per shape on the CPU, so it
# runs on the two small sizes; every size is held against the plain branch.
PALLAS_SIZES = {(16, 16), (33, 47)}


def _build(tmp, src, name, extra=()):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = tmp / name
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-Wall", "-Wextra",
         "-Werror", "-shared", "-fPIC", *extra, "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.h263_reconstruct_host.argtypes = [P] * 9 + [I] * 5 + [P]
    lib.h263_reconstruct_host.restype = I
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("recon"), HOST_SRC, "librecon.so")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def make_frame(seed, S, h, w):
    """Inputs from a seed: every IDCT class in every plane, the FMA block,
    MVs of all four half-pel cases that reach outside every edge and corner,
    4V macroblocks, INTRA macroblocks beside INTER ones."""
    rng = np.random.default_rng(seed)
    mbh, mbw = -(-h // 16), -(-w // 16)
    nmb = mbh * mbw
    dense = np.zeros((S, 6 * nmb, 64), dtype=np.int16)
    kind = rng.integers(0, 6, (S, 6 * nmb))
    n = int((kind == 1).sum())
    dense[kind == 1, 0] = rng.integers(-2048, 2048, n)               # DC
    n = int((kind == 2).sum())
    dense[kind == 2, ::8] = rng.integers(-400, 400, (n, 8))          # VERT
    n = int((kind == 3).sum())
    dense[kind == 3] = rng.integers(-300, 300, (n, 64))              # FULL
    n = int((kind == 4).sum())
    dense[kind == 4, :8] = rng.integers(-2048, 2048, (n, 8))         # row 0
    sparse = np.argwhere(kind == 5)
    for s, b in sparse:
        dense[s, b, rng.integers(0, 64, 3)] = rng.integers(-500, 500, 3)
    dense[0, 0] = 0                                   # the FMA block
    dense[0, 0, [2, 3, 18]] = 735, -555, 215
    dense[-1, -1] = dense[0, 0]                       # and in Cr

    reach = 2 * max(h, w) + 9
    mvs = np.zeros((S, mbh, mbw, 4, 2), dtype=np.int16)
    mode = rng.integers(0, 4, (S, mbh, mbw))
    one = rng.integers(-9, 10, (S, mbh, mbw, 1, 2))
    far = rng.integers(-reach, reach + 1, (S, mbh, mbw, 1, 2))
    four = rng.integers(-40, 41, (S, mbh, mbw, 4, 2))
    mvs[:] = np.where((mode == 0)[..., None, None], one, mvs)
    mvs[:] = np.where((mode == 1)[..., None, None], far, mvs)
    mvs[:] = np.where((mode == 2)[..., None, None], four, mvs)       # 4V
    # Every half-pel case at every corner: stream 0's corner macroblocks
    # point out of the picture, diagonally, by whole and half samples.
    for r, c, sy, sx in ((0, 0, -1, -1), (0, -1, -1, 1), (-1, 0, 1, -1),
                         (-1, -1, 1, 1)):
        mvs[0, r, c] = [[sx * 37, sy * 37], [sx * 36, sy * 37],
                        [sx * 37, sy * 36], [sx * 36, sy * 36]]
    inter = rng.random((S, mbh, mbw)) < 0.75
    inter[0, 0, 0] = inter[0, -1, -1] = inter[0, 0, -1] = inter[0, -1, 0] = True
    ch, cw = (h + 1) // 2, (w + 1) // 2
    refs = [rng.integers(0, 256, (S, ph, pw), dtype=np.uint8)
            for ph, pw in ((h, w), (ch, cw), (ch, cw))]
    return dense, mvs, inter, refs


def run_host(lib, dense, mvs, inter, refs):
    S, mbh, mbw = inter.shape
    h, w = refs[0].shape[1:]
    outs = [np.full_like(r, 0x5A) for r in refs]
    inter_u8 = np.ascontiguousarray(inter.astype(np.uint8))
    rc = lib.h263_reconstruct_host(
        dense.ctypes.data, mvs.ctypes.data, inter_u8.ctypes.data,
        *(r.ctypes.data for r in refs), *(o.ctypes.data for o in outs),
        S, mbh, mbw, h, w, BASIS.ctypes.data)
    assert rc == 0
    return outs


def jax_planes(dense, mvs, inter, refs, pallas):
    fn = jax.jit(lambda *a: jrec.reconstruct_from_dense(*a, pallas=pallas))
    return [np.asarray(p) for p in fn(dense, mvs, inter, *refs)]


@pytest.mark.parametrize("size", [(16, 16), (33, 47), (144, 176),
                                  (145, 177)])
def test_kernel_source_matches_jax(host_lib, size):
    h, w = size
    S = 3 if h < 100 else 2
    dense, mvs, inter, refs = make_frame(h * 1000 + w, S, h, w)
    got = run_host(host_lib, dense, mvs, inter, refs)
    modes = ["off"] + (["interpret"] if size in PALLAS_SIZES else [])
    for pallas in modes:
        want = jax_planes(dense, mvs, inter, refs, pallas)
        for name, a, b in zip(("y", "cb", "cr"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {pallas}")
    # The FMA block: strict rounding gives residual 28 at (0, 2).
    if not inter[0, 0, 0]:
        assert got[0][0, 0, 2] == 28


@pytest.mark.parametrize("size", [(16, 16), (144, 176), (145, 177)])
def test_kernel_source_matches_the_plain_port(host_lib, size):
    h, w = size
    dense, mvs, inter, refs = make_frame(h + w, 2, h, w)
    got = run_host(host_lib, dense, mvs, inter, refs)
    want = reconstruct_from_dense_plain(
        _t(dense), _t(mvs), _t(inter), *(_t(r) for r in refs))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def test_fma_block_in_an_intra_macroblock_gives_28(host_lib):
    """{735, -555, 215}: 28 with every product rounded, 27 with an FMA."""
    dense = np.zeros((1, 6, 64), dtype=np.int16)
    dense[0, 0, [2, 3, 18]] = 735, -555, 215
    mvs = np.zeros((1, 1, 1, 4, 2), dtype=np.int16)
    inter = np.zeros((1, 1, 1), dtype=bool)
    refs = [np.full((1, 16, 16), 99, np.uint8), np.zeros((1, 8, 8), np.uint8),
            np.zeros((1, 8, 8), np.uint8)]
    y = run_host(host_lib, dense, mvs, inter, refs)[0]
    assert y[0, 0, 2] == 28
    want = jax_planes(dense, mvs, inter, refs, "interpret")[0]
    np.testing.assert_array_equal(y, want)


def test_all_four_halfpel_cases_at_every_edge(host_lib):
    """A lone INTER macroblock per stream with one MV, stepping through
    whole/half positions in x and y, far enough to clamp at each edge."""
    h, w = 16, 32
    cases = [(mx, my) for mx in (-70, -3, -2, -1, 0, 1, 2, 3, 69)
             for my in (-41, -1, 0, 1, 40)]
    S = len(cases)
    rng = np.random.default_rng(5)
    dense = np.zeros((S, 12, 64), dtype=np.int16)
    mvs = np.zeros((S, 1, 2, 4, 2), dtype=np.int16)
    for s, mv in enumerate(cases):
        mvs[s, :, :, :] = mv
    inter = np.ones((S, 1, 2), dtype=bool)
    refs = [rng.integers(0, 256, (S, ph, pw), dtype=np.uint8)
            for ph, pw in ((h, w), (8, 16), (8, 16))]
    got = run_host(host_lib, dense, mvs, inter, refs)
    want = jax_planes(dense, mvs, inter, refs, "off")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mutation_dropping_the_halfpel_rounding_fails(tmp_path):
    """The comparison can see a one-LSB fault: a copy of reconstruct.cuh
    whose half-pel average drops its rounding term (the `+ 1` of the
    two-sample average, the `+ 2` of the four-sample one, which are one
    constant in the kernel's formula) no longer matches."""
    src = tmp_path / "h263_tpu_torch" / "csrc"
    src.mkdir(parents=True)
    text = (CSRC / "reconstruct.cuh").read_text()
    rounding = "two = 0x0002000200020002ull"
    assert text.count(rounding) == 1
    (src / "reconstruct.cuh").write_text(
        text.replace(rounding, "two = 0"))
    (src / "idct.cuh").write_text((CSRC / "idct.cuh").read_text())
    (tmp_path / "tests").mkdir()
    host = tmp_path / "tests" / HOST_SRC.name
    host.write_text(HOST_SRC.read_text())
    lib = _build(tmp_path, host, "libmutant.so")
    dense, mvs, inter, refs = make_frame(3, 2, 33, 47)
    got = run_host(lib, dense, mvs, inter, refs)
    want = jax_planes(dense, mvs, inter, refs, "off")
    assert any((a != b).any() for a, b in zip(got, want))


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_arguments():
    dense, mvs, inter, refs = make_frame(9, 2, 33, 47)
    args = [_t(a) for a in (dense, mvs, inter, *refs)]
    before = reconstruct_cuda.launches
    got = reconstruct_cuda.reconstruct_from_dense_cuda(*args)
    assert reconstruct_cuda.launches == before       # no kernel ran
    want = jax_planes(dense, mvs, inter, refs, "off")
    for a, b, r in zip(got, want, args[3:]):
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.data_ptr() != r.data_ptr()          # never in place
    bad = [
        (0, args[0].to(torch.int32)),                # dense dtype
        (0, args[0][:, :-1]),                        # dense shape
        (1, args[1][..., :1]),                       # mvs shape
        (2, args[2].to(torch.int32)),                # inter dtype
        (2, args[2][0]),                             # inter rank
        (3, args[3][:, :16, :16]),                   # picture vs chroma
        (4, args[4].to(torch.int16)),                # plane dtype
        (5, torch.empty(args[5].shape, dtype=torch.uint8,
                        device="meta")),             # devices differ
    ]
    for i, t in bad:
        broken = list(args)
        broken[i] = t
        with pytest.raises(ValueError):
            reconstruct_cuda.reconstruct_from_dense_cuda(*broken)
    with pytest.raises(ValueError):                  # grid too small
        reconstruct_cuda.reconstruct_from_dense_cuda(
            args[0][:, :24], args[1][:, :2, :2], args[2][:, :2, :2],
            *args[3:])


# -- a reference of other dims (the single-stream decoder across a size
# change): the JAX single decoder's `get_reconstruct_fn(h, w)`.

REF_OUT = [((33, 47), (58, 72)), ((58, 72), (33, 47)), ((16, 16), (40, 24)),
           ((145, 177), (144, 176)), ((24, 40), (24, 72))]


def make_resized(seed, S, ref_hw, out_hw):
    """make_frame's inputs at the output's grid, with reference planes of
    `ref_hw` and MVs that reach past every edge of both pictures."""
    dense, mvs, inter, _ = make_frame(seed, S, *out_hw)
    rng = np.random.default_rng(seed + 1)
    rh, rw = ref_hw
    reach = 2 * max(*ref_hw, *out_hw) + 9
    far = rng.integers(-reach, reach + 1, mvs.shape).astype(np.int16)
    mvs = np.where(rng.random(mvs.shape[:3])[..., None, None] < 0.3, far, mvs)
    refs = [rng.integers(0, 256, (S, ph, pw), dtype=np.uint8)
            for ph, pw in ((rh, rw), ((rh + 1) // 2, (rw + 1) // 2),
                           ((rh + 1) // 2, (rw + 1) // 2))]
    return dense, mvs.astype(np.int16), inter, refs


def run_host_ref(lib, dense, mvs, inter, refs, out_hw):
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.h263_reconstruct_host_ref
    fn.argtypes = [P] * 9 + [I] * 7 + [P]
    fn.restype = I
    S, mbh, mbw = inter.shape
    h, w = out_hw
    rh, rw = refs[0].shape[1:]
    outs = [np.full((S, *hw), 0x5A, np.uint8)
            for hw in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                       ((h + 1) // 2, (w + 1) // 2))]
    inter_u8 = np.ascontiguousarray(inter.astype(np.uint8))
    assert fn(dense.ctypes.data, mvs.ctypes.data, inter_u8.ctypes.data,
              *(r.ctypes.data for r in refs), *(o.ctypes.data for o in outs),
              S, mbh, mbw, h, w, rh, rw, BASIS.ctypes.data) == 0
    return outs


def jax_single(dense, mvs, inter, refs, out_hw):
    """The JAX single decoder's program, `get_reconstruct_fn(h, w)`, one
    stream at a time, with the classes derived from the dense blocks."""
    from h263_tpu.ops.idct import derive_classes_jnp

    S, mbh, mbw = inter.shape
    nmb = mbh * mbw
    fn = jrec.get_reconstruct_fn(*out_hw)
    outs = [[], [], []]
    for s in range(S):
        cls = np.asarray(derive_classes_jnp(dense[s:s + 1]))[0]
        y, cb, cr = fn(
            dense[s, :4 * nmb].reshape(2 * mbh, 2 * mbw, 8, 8),
            cls[:4 * nmb].reshape(2 * mbh, 2 * mbw),
            dense[s, 4 * nmb:5 * nmb].reshape(mbh, mbw, 8, 8),
            cls[4 * nmb:5 * nmb].reshape(mbh, mbw),
            dense[s, 5 * nmb:].reshape(mbh, mbw, 8, 8),
            cls[5 * nmb:].reshape(mbh, mbw),
            mvs[s], inter[s], refs[0][s], refs[1][s], refs[2][s])
        for o, p in zip(outs, (y, cb, cr)):
            o.append(np.asarray(p))
    return [np.stack(o) for o in outs]


@pytest.mark.parametrize("ref_hw,out_hw", REF_OUT)
def test_kernel_source_with_a_reference_of_other_dims_matches_jax(
        host_lib, ref_hw, out_hw):
    dense, mvs, inter, refs = make_resized(sum(ref_hw) * 7 + sum(out_hw), 2,
                                           ref_hw, out_hw)
    got = run_host_ref(host_lib, dense, mvs, inter, refs, out_hw)
    want = jax_single(dense, mvs, inter, refs, out_hw)
    plain = reconstruct_from_dense_plain(
        _t(dense), _t(mvs), _t(inter), *(_t(r) for r in refs),
        out_hw=out_hw)
    for name, a, b, c in zip(("y", "cb", "cr"), got, want, plain):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c.numpy(), err_msg=name)


def test_mutation_striding_the_reference_by_the_output_width_fails(tmp_path):
    """The comparison sees a kernel that walks the reference with the
    output's row stride: a copy of reconstruct.cuh whose predict_row is
    handed the output's dims no longer matches."""
    src = tmp_path / "h263_tpu_torch" / "csrc"
    src.mkdir(parents=True)
    text = (CSRC / "reconstruct.cuh").read_text()
    call = "predict_row(ref, rh, rw, x0,"
    assert text.count(call) == 1
    (src / "reconstruct.cuh").write_text(
        text.replace(call, "predict_row(ref, h, w, x0,"))
    (src / "idct.cuh").write_text((CSRC / "idct.cuh").read_text())
    (tmp_path / "tests").mkdir()
    host = tmp_path / "tests" / HOST_SRC.name
    host.write_text(HOST_SRC.read_text())
    lib = _build(tmp_path, host, "libmutant.so",
                 extra=("-Wno-unused-parameter",))
    dense, mvs, inter, refs = make_resized(5, 2, (24, 40), (40, 72))
    got = run_host_ref(lib, dense, mvs, inter, refs, (40, 72))
    want = jax_single(dense, mvs, inter, refs, (40, 72))
    assert any((a != b).any() for a, b in zip(got, want))


def test_wrapper_takes_output_dims_on_cpu():
    dense, mvs, inter, refs = make_resized(11, 2, (24, 40), (40, 72))
    args = [_t(a) for a in (dense, mvs, inter, *refs)]
    got = reconstruct_cuda.reconstruct_from_dense_cuda(*args,
                                                       out_hw=(40, 72))
    assert [tuple(p.shape) for p in got] == [(2, 40, 72), (2, 20, 36),
                                             (2, 20, 36)]
    want = jax_single(dense, mvs, inter, refs, (40, 72))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    out = [torch.empty_like(p) for p in got]
    reconstruct_cuda.reconstruct_from_dense_cuda(*args, out=out,
                                                 out_hw=(40, 72))
    for a, b in zip(out, got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):     # out of the references' shapes
        reconstruct_cuda.reconstruct_from_dense_cuda(
            *args, out=[torch.empty_like(r) for r in args[3:]],
            out_hw=(40, 72))
    with pytest.raises(ValueError):     # beyond the macroblock grid
        reconstruct_cuda.reconstruct_from_dense_cuda(*args, out_hw=(49, 72))
