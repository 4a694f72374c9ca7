"""The port's native header prep and its two builders.

* `h263_tpu_torch.native.DevicePrepBatch.prepare_ragged` against the JAX
  package's `h263_device_prepare_ragged` on the same lanes: meta, headers,
  return codes and staged bytes, for good, truncated, wrong-dims, garbage
  and over-cap lanes.  The JAX package's source (`h263_tpu/native/
  entropy.cpp` with a `tables.h` generated by its own `gen_tables`) is
  built here into a private directory, so that this comparison does not
  depend on the package's shared build directory.
* The prep's builder: a library named by the hash of its source and flags,
  built once under a lock by concurrent processes, a failed build raising.
* The kernel loader (`h263_tpu_torch.kernels`): one compiler process per
  source, all running at once, then one link; a failing source raises.
  A stand-in compiler takes nvcc's place here: this machine has none.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from h263_tpu.native import gen_tables
from h263_tpu_torch import kernels
from h263_tpu_torch import native
from h263_tpu_torch.testing.encoder import MBSpec, encode_sorenson_picture
from h263_tpu_torch.types import PictureTypeCode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(ROOT, "h263_tpu", "native")


@pytest.fixture(scope="module")
def jax_prep(tmp_path_factory):
    """h263_device_prepare_ragged from the JAX package's own source."""
    d = tmp_path_factory.mktemp("jax_native")
    shutil.copy(os.path.join(JAX_NATIVE, "entropy.cpp"), d / "entropy.cpp")
    gen_tables.main(str(d / "tables.h"))
    so = d / "libentropy.so"
    proc = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-pthread",
                           str(d / "entropy.cpp"), "-o", str(so)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    fn = lib.h263_device_prepare_ragged
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, P,
                   ctypes.c_int64, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def _frames(w, h, seed):
    rng = np.random.default_rng(seed)
    nmb = (-(-w // 16)) * (-(-h // 16))
    i = encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6,
                blocks=[[(0, int(rng.integers(1, 9)))], [], [], [], [], []])
         for _ in range(nmb)], quantizer=int(rng.integers(1, 32)))
    p = encode_sorenson_picture(
        w, h, PictureTypeCode.P_FRAME,
        [MBSpec(kind="inter", mvd=[(1, -1)], blocks=[[(0, 2)], [], [], [],
                                                     [], []])] * nmb,
        temporal_reference=1, deblocker=True, extra=b"\x05\x07")
    dp = encode_sorenson_picture(w, h, PictureTypeCode.DISPOSABLE_P_FRAME,
                                 [MBSpec(kind="uncoded")] * nmb, version=0,
                                 pad_bit=1)
    return i, p, dp


def _lanes(case, w, h):
    i, p, dp = _frames(w, h, 3)
    other = _frames(w + 16, h, 4)[0]
    custom = encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[64] * 6)] * ((-(-w // 16))
                                                    * (-(-h // 16))),
        force_custom_dims=True)
    return {
        "good": [i, p, dp, custom, i, p],
        "truncated": [i[:0], i[:1], i[:3], i[:5], i[:8], p[:len(p) // 2],
                      i],
        "wrong_dims": [other, i, other[:6], p],
        "garbage": [b"\xff" * 40, b"\x00\x01garbage", b"\x00\x00\x80" + i,
                    p, bytes(13)],
        "mixed": [i, b"", other, p[:7], dp, b"\x00" * 3, custom],
    }[case]


def _prepare(fn, bufs, w, h, cap):
    n = len(bufs)
    stage = np.full(cap, 0xAB, dtype=np.uint8)
    meta = np.full((6, n), -7, dtype=np.int32)
    hdr = np.full((n, 8), -7, dtype=np.int32)
    rc = np.full(n, -7, dtype=np.int32)
    ptrs = (ctypes.c_char_p * n)(*bufs)
    lens = np.array([len(b) for b in bufs], dtype=np.uint64)
    failed = fn(ctypes.addressof(ptrs), lens.ctypes.data, n, w, h,
                stage.ctypes.data, stage.nbytes, meta.ctypes.data,
                hdr.ctypes.data, rc.ctypes.data)
    return failed, stage, meta, hdr, rc


@pytest.mark.parametrize("case", ["good", "truncated", "wrong_dims",
                                  "garbage", "mixed"])
@pytest.mark.parametrize("dims", [(48, 32), (176, 144), (352, 288)])
@pytest.mark.parametrize("cap", ["exact", "short"])
def test_prepare_ragged_matches_the_jax_package(jax_prep, case, dims, cap):
    w, h = dims
    bufs = _lanes(case, w, h)
    need = sum(((len(b) + 3) // 4) * 4 for b in bufs)
    nbytes = need + 4 if cap == "exact" else max(4, (need // 2) // 4 * 4)
    want = _prepare(jax_prep, bufs, w, h, nbytes)

    prep = native.DevicePrepBatch(len(bufs), w, h)
    prep.hdr[:] = -7          # lanes the prep does not parse keep these
    prep.rc[:] = -7
    stage = np.full(nbytes, 0xAB, dtype=np.uint8)
    meta = np.full((6, len(bufs)), -7, dtype=np.int32)
    failed = prep.prepare_ragged(bufs, stage, meta)
    assert failed == want[0]
    np.testing.assert_array_equal(stage, want[1])
    np.testing.assert_array_equal(meta, want[2])
    np.testing.assert_array_equal(prep.hdr, want[3])
    np.testing.assert_array_equal(prep.rc, want[4])
    if cap == "short":
        assert (prep.rc == native.E_INVALID_BITSTREAM).any()


def test_prepare_ragged_rejects_bad_arguments():
    prep = native.DevicePrepBatch(2, 48, 32)
    ok_stage, ok_meta = np.zeros(64, np.uint8), np.zeros((6, 2), np.int32)
    with pytest.raises(ValueError):
        prep.prepare_ragged([b""], ok_stage, ok_meta)
    with pytest.raises(ValueError):
        prep.prepare_ragged([b"", b""], np.zeros(64, np.int32), ok_meta)
    with pytest.raises(ValueError):
        prep.prepare_ragged([b"", b""], ok_stage, np.zeros((5, 2), np.int32))
    assert prep.prepare_ragged([b"", b""], ok_stage, ok_meta) == 2


# -- the prep's builder --------------------------------------------------------

def test_library_name_follows_source_and_flags(monkeypatch, tmp_path):
    src = tmp_path / "prep.cpp"
    src.write_text("int x;\n")
    monkeypatch.setattr(native, "SRC", src)
    p1 = native._library_path()
    src.write_text("int y;\n")
    p2 = native._library_path()
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-g"])
    assert len({p1, p2, native._library_path()}) == 3


def test_concurrent_builders_share_one_library(tmp_path):
    """More builders than cores race on one empty build directory: every
    one loads the same complete library, and no temporary file is left."""
    build = tmp_path / "build"
    # The module alone, without the package (whose import loads torch).
    code = textwrap.dedent(f"""
        import importlib.util
        from pathlib import Path
        spec = importlib.util.spec_from_file_location(
            "prep", {native.__file__!r})
        n = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(n)
        n.BUILD = Path({str(build)!r})
        n.lib()
        print(n._library_path())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2 * os.cpu_count())]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    built = sorted(f.name for f in build.iterdir())
    assert built == [".lock", os.path.basename(paths.pop())]


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "prep.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert [f.name for f in (tmp_path / "build").iterdir()] == [".lock"]


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "SRC", tmp_path / "prep.cpp")
    (tmp_path / "prep.cpp").write_text("int x;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()


# -- the kernel loader ---------------------------------------------------------

FAKE_NVCC = """#!{python}
# Stand-in for nvcc: `-c -o OBJ SRC` copies SRC into OBJ after a pause
# (a source holding "#error" fails); `-shared -o LIB OBJS` concatenates.
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[-1]
    text = open(src).read()
    time.sleep(0.4)
    if "#error" in text:
        print(f"{{src}}: error", file=sys.stderr)
        sys.exit(2)
    open(out, "w").write(text)
else:
    objs = [a for a in args if a.endswith(".o")]
    open(out, "w").write("".join(open(o).read() for o in objs))
"""


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    src = tmp_path / "csrc"
    src.mkdir()
    for k in range(4):
        (src / f"k{k}.cu").write_text(f"kernel {k}\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "build")
    return src


def test_loader_compiles_every_source_at_once_then_links(fake_nvcc):
    t0 = time.perf_counter()
    so = kernels.build()
    took = time.perf_counter() - t0
    assert took < 4 * 0.4, f"{took:.2f} s: the compiles ran one by one"
    assert so.read_text() == "".join(f"kernel {k}\n" for k in range(4))
    assert sorted(f.name for f in so.parent.iterdir()) == [".lock", so.name]
    assert kernels.build() == so             # built once


def test_loader_raises_naming_the_failing_source(fake_nvcc):
    (fake_nvcc / "k2.cu").write_text("#error broken\n")
    with pytest.raises(RuntimeError, match="k2.cu"):
        kernels.build()
    assert [f.name for f in kernels.BUILD.iterdir()] == [".lock"]
