"""The port's pointer helper (`h263_tpu_torch/native/fastcall.cpp`, the
module `h263_torch_fastcall`) and the three native batch calls that
marshal their buffers through it.  Exact equality throughout.

* `gather_ptrs` against the ctypes marshalling it replaces, at S = 0, 1, 7
  and 1024 with empty `bytes` among the buffers; a `bytearray` or a
  `memoryview` raises `TypeError`, there and at each call site.
* `DevicePrepBatch.prepare_ragged`, the fused host parse
  (`SorensonFusedBatchParser`) and the standard host parse
  (`StandardBatchParser`) on the same seeded buffers against the JAX
  package's, which marshal through its own `h263_fastcall`: every output
  array, return code and error.
* The module's build: named by its source's and flags' hash plus the
  interpreter's extension suffix, loaded beside the JAX package's module in
  one process, built once, and a failed build raising.  (The read-only
  package directory's build into the cache: `test_torch_install.py`.)
"""

import ctypes
import sysconfig

import numpy as np
import pytest

from h263_tpu.native import bindings as jn
from h263_tpu_torch import native
from h263_tpu_torch.ops.d24 import fused_sections
from h263_tpu_torch.testing import corpora
from test_torch_reference_native import require_reference_native

QCIF = corpora.QCIF


def _ctypes_marshal(buffers):
    """(pointers, lengths) as the ctypes marshalling gives them."""
    n = len(buffers)
    arr = (ctypes.c_char_p * n)(*buffers)
    ptrs = np.frombuffer(ctypes.string_at(ctypes.addressof(arr), 8 * n),
                         dtype=np.uint64)
    return ptrs, np.array([len(b) for b in buffers], dtype=np.uint64), arr


def _seeded_buffers(rng, n):
    """n buffers drawn from the QCIF corpora's frames, with empty ones,
    cut ones and random bytes among them."""
    frames = [f for k in range(corpora.N_QCIF_CORPORA)
              for f in corpora.qcif_corpus(k)]
    out = []
    for _ in range(n):
        roll = rng.random()
        f = frames[int(rng.integers(len(frames)))]
        out.append(b"" if roll < 0.1 else
                   f[:int(rng.integers(1, len(f)))] if roll < 0.2 else
                   rng.integers(0, 256, int(rng.integers(1, 64)),
                                dtype=np.uint8).tobytes() if roll < 0.3
                   else f)
    return out


@pytest.mark.parametrize("S", [0, 1, 7, 1024])
def test_gather_ptrs_equals_the_ctypes_marshalling(S):
    rng = np.random.default_rng(S)
    bufs = _seeded_buffers(rng, S)
    if S:
        bufs[S // 2] = b""
    gather = native.fastcall().gather_ptrs
    ptrs = np.full(S, 7, np.uint64)
    lens = np.full(S, 7, np.uint64)
    assert gather(bufs, ptrs.ctypes.data, lens.ctypes.data) is None
    want_ptrs, want_lens, _keep = _ctypes_marshal(bufs)
    np.testing.assert_array_equal(ptrs, want_ptrs)
    np.testing.assert_array_equal(lens, want_lens)


@pytest.mark.parametrize("kind", [bytearray, memoryview])
def test_gather_ptrs_refuses_a_buffer_that_is_not_bytes(kind):
    ptrs, lens = np.zeros(3, np.uint64), np.zeros(3, np.uint64)
    with pytest.raises(TypeError, match="bytes"):
        native.fastcall().gather_ptrs([b"ab", kind(b"cd"), b"ef"],
                                      ptrs.ctypes.data, lens.ctypes.data)


# -- the three call sites against the JAX package's ---------------------------

def _prep(mod, bufs, w, h, cap):
    n = len(bufs)
    prep = (mod.DevicePrepBatch(n, w, h, cap) if mod is jn
            else mod.DevicePrepBatch(n, w, h))
    prep.hdr[:] = -7
    prep.rc[:] = -7
    stage = np.full(cap, 0xAB, dtype=np.uint8)
    meta = np.full((6, n), -7, dtype=np.int32)
    failed = prep.prepare_ragged(bufs, stage, meta)
    return failed, stage, meta, prep.hdr.copy(), prep.rc.copy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_prepare_ragged_equals_the_jax_package(seed, n):
    require_reference_native()
    bufs = _seeded_buffers(np.random.default_rng([seed, n]), n)
    cap = sum((len(b) + 3) // 4 * 4 for b in bufs) + 4
    got = _prep(native, bufs, *QCIF, cap)
    want = _prep(jn, bufs, *QCIF, cap)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def _fused(mod, n, w, h, cap):
    nmb = (-(-w // 16)) * (-(-h // 16))
    fused = np.full((n, sum(fused_sections(nmb, True)) + 3 * cap), 0xAB,
                    dtype=np.uint8)
    mvs = np.full((n, nmb * 8), -7, dtype=np.int16)
    inter = np.full((n, nmb), 9, dtype=np.uint8)
    ladder = np.array([256, cap], dtype=np.int32)
    p = mod.SorensonFusedBatchParser(n, w, h, fused, 8, mvs, inter,
                                     np.zeros(nmb * 8, np.int16), cap,
                                     ladder)
    return p, (fused, mvs, inter)


def _outcome(fn):
    """fn()'s result, or its error's class name and message."""
    try:
        return fn(), None
    except Exception as e:      # noqa: BLE001 - compared across packages
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fused_parse_equals_the_jax_package(seed):
    """A GOP of seeded QCIF corpora on 16 lanes, step by step; seed 3 cuts
    one lane of one step, which both raise on, naming the same stream."""
    require_reference_native()
    rng = np.random.default_rng(seed)
    gops = [corpora.qcif_corpus(int(k)) for k in rng.integers(0, 4, 16)]
    cap = 2048
    (pj, bj), (pt, bt) = (_fused(m, 16, *QCIF, cap)
                          for m in (jn, native.bindings))
    for t in range(corpora.GOP):
        bufs = [g[t] for g in gops]
        if seed == 3 and t == 5:
            bufs[9] = bufs[9][:len(bufs[9]) // 3]
        has_ref = np.full(16, t > 0)
        got, err = _outcome(lambda: pt.parse(bufs, has_ref))
        want, werr = _outcome(lambda: pj.parse(bufs, has_ref))
        assert err == werr
        assert (err is not None) == (seed == 3 and t == 5)
        if err:
            assert err[1].startswith("stream 9:")
            continue
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)


def _standard(mod, n, w, h, cap):
    nmb = (-(-w // 16)) * (-(-h // 16))
    pack = np.full((n, 3 * cap), 0xAB, dtype=np.uint8)
    mvs = np.full((n, nmb * 8), -7, dtype=np.int16)
    inter = np.full((n, nmb), 9, dtype=np.uint8)
    scratch = np.zeros(nmb * 8, np.int16)
    p = (mod.StandardBatchParser(n, w, h, pack, mvs, inter, scratch,
                                 transport="d24") if mod is jn
         else mod.StandardBatchParser(n, w, h, pack, mvs, inter, scratch))
    return p, (pack, mvs, inter)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_standard_parse_equals_the_jax_package(seed):
    """A GOP of the standard QCIF corpus on 8 lanes at seeded phases of
    the GOP's P-frames, the I-frame first; seed 2 gives one lane a
    PLUSPTYPE picture, which both hand to the Python parser."""
    require_reference_native()
    rng = np.random.default_rng(seed)
    gop = corpora.std_qcif_corpus()
    cap = 2048
    (pj, bj), (pt, bt) = (_standard(m, 8, *QCIF, cap)
                          for m in (jn, native.bindings))
    for t in range(corpora.GOP):
        bufs = [gop[0] if t == 0 else gop[int(rng.integers(1, len(gop)))]
                for _ in range(8)]
        if seed == 2 and t == 4:
            bufs[3] = corpora.mq_picture(*QCIF)
        has_ref = np.full(8, t > 0)
        for p in (pj, pt):
            p.prev_running[:] = 0
            p.prev_fmt[:] = -1 if t == 0 else 2
        got, err = _outcome(lambda: pt.parse(bufs, has_ref))
        want, werr = _outcome(lambda: pj.parse(bufs, has_ref))
        assert err == werr
        assert (err is not None) == (seed == 2 and t == 4)
        if err:
            assert err == ("NeedsPythonHeader", "3")
            continue
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", [bytearray, memoryview])
@pytest.mark.parametrize("site", ["prepare_ragged", "fused", "standard"])
def test_each_call_site_refuses_a_buffer_that_is_not_bytes(site, kind):
    frames = corpora.qcif_corpus(0) if site != "standard" else \
        corpora.std_qcif_corpus()
    bufs = [frames[0], kind(frames[0])]
    if site == "prepare_ragged":
        prep = native.DevicePrepBatch(2, *QCIF)
        call = lambda: prep.prepare_ragged(  # noqa: E731
            bufs, np.zeros(1 << 16, np.uint8), np.zeros((6, 2), np.int32))
    else:
        p, _ = (_fused(native.bindings, 2, *QCIF, 2048) if site == "fused"
                else _standard(native.bindings, 2, *QCIF, 2048))
        call = lambda: p.parse(bufs, np.zeros(2, bool))  # noqa: E731
    with pytest.raises(TypeError, match="bytes"):
        call()


# -- the build ----------------------------------------------------------------

def test_the_module_is_the_ports_beside_the_jax_packages():
    """Both packages' modules load into one process, each under its own
    name and from its own file."""
    require_reference_native()
    mod = native.fastcall()
    assert mod.__name__ == native.FASTCALL_MODULE == "h263_torch_fastcall"
    assert jn._fastcall.__name__ == "h263_fastcall"
    assert mod.__file__ != jn._fastcall.__file__
    assert mod.__file__ == str(native._fastcall_path())
    assert native.fastcall_source() == native.SRC.with_name("fastcall.cpp")


def test_module_name_follows_source_and_flags(monkeypatch, tmp_path):
    """The file is `h263_torch_fastcall_<hash>` plus the interpreter's
    extension suffix, the hash over the source and the flags (the include
    directory's among them): an edit or another flag names a new file in
    the same directory."""
    src = tmp_path / "fastcall.cpp"
    src.write_bytes(native.fastcall_source().read_bytes())
    monkeypatch.setattr(native, "SRC", tmp_path / "entropy.cpp")
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    p1 = native._fastcall_path()
    assert p1.name.startswith("h263_torch_fastcall_")
    assert p1.name.endswith(sysconfig.get_config_var("EXT_SUFFIX"))
    assert p1.parent == tmp_path / "build"
    with open(src, "a") as f:
        f.write("// edited\n")
    p2 = native._fastcall_path()
    monkeypatch.setattr(native, "FASTCALL_FLAGS",
                        native.FASTCALL_FLAGS + ["-g"])
    p3 = native._fastcall_path()
    assert len({p1, p2, p3}) == 3 and p2.parent == p3.parent == p1.parent
    assert f"-I{sysconfig.get_paths()['include']}" in native._fastcall_flags()


def test_build_once_then_load(monkeypatch, tmp_path):
    """A scratch build: g++ once, the module loads and gathers, a second
    call builds nothing, and the directory holds the module and the
    lock."""
    (tmp_path / "fastcall.cpp").write_bytes(
        native.fastcall_source().read_bytes())
    monkeypatch.setattr(native, "SRC", tmp_path / "entropy.cpp")
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "last_fastcall_build_seconds", None)
    path = native.build_fastcall()
    assert native.last_fastcall_build_seconds is not None
    assert sorted(p.name for p in path.parent.iterdir()) == [".lock",
                                                             path.name]
    monkeypatch.setattr(native, "last_fastcall_build_seconds", None)
    assert native.build_fastcall() == path
    assert native.last_fastcall_build_seconds is None
    mod = native._load_fastcall(path)
    ptrs, lens = np.zeros(2, np.uint64), np.zeros(2, np.uint64)
    bufs = [b"abc", b""]
    mod.gather_ptrs(bufs, ptrs.ctypes.data, lens.ctypes.data)
    np.testing.assert_array_equal(lens, [3, 0])
    np.testing.assert_array_equal(ptrs, _ctypes_marshal(bufs)[0])


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    (tmp_path / "fastcall.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", tmp_path / "entropy.cpp")
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_fastcall()
    assert [f.name for f in (tmp_path / "build").iterdir()] == [".lock"]
