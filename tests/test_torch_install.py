"""The port as a user installs it: the wheel built from the tree, the build
directories of its two libraries, and the installed copy run outside the
repo on the CPU.

* The wheel holds every file the port opens at run time (the native
  library's `entropy.cpp` and `tables.h`, the CUDA sources, the sweep
  program, the reference digests), byte-equal to the tree's.
* `native.pick_build_dir`, which both builders use, against the JAX
  package's `bindings._pick_build_dir` in the same situations: a writable
  package directory is used; an unwritable one is used read-only when it
  holds the library of the current sources, and otherwise the per-user
  cache (`$XDG_CACHE_HOME`, `~/.cache` by default).  As root, chmod does
  not stop a write, so the writability probe is made to refuse the package
  directory, as the JAX package's tests do.
* Both builders in the fallback directory: the g++ build, and the nvcc
  build through the stand-in nvcc of `test_torch_native.py`, each with its
  lock there; failed builds still raise with the compiler's output; more
  builders than cores racing on one empty cache build once.
* A `pip install --target` of the wheel, run in a subprocess whose only
  path to the port is the install: `python -m h263_tpu_torch selftest`
  (read-only, building into the cache) and `decode` of the QCIF fixture,
  every frame equal to its `ff_qcif` digests; `jax` and `h263_tpu` stay
  unimported.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import numpy as np
import pytest

from h263_tpu_torch import kernels, native
from h263_tpu_torch.testing.corpora import planes_digest
from test_torch_native import FAKE_NVCC

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "h263_tpu_torch"
QCIF = ROOT / "tests" / "fixtures" / "ffmpeg_flv1_qcif.flv"
N_FRAMES = 6


def _runtime_files():
    """Every file of the port that is not Python (and not a build output):
    what it reads at run time."""
    return sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*")
                  if p.is_file() and p.suffix not in (".py", ".pyc")
                  and "build" not in p.relative_to(PORT).parts
                  and "__pycache__" not in p.parts)


RUNTIME_FILES = _runtime_files()


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The wheel `pip wheel` builds from a copy of the tree (pip writes
    `build/` and `*.egg-info` into the tree it builds)."""
    d = tmp_path_factory.mktemp("wheel")
    src = d / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    for pkg in ("h263_tpu", "h263_tpu_torch"):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=shutil.ignore_patterns(
            "build", "__pycache__", "*.egg-info"))
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(src), "--no-deps",
         "--no-build-isolation", "--no-index", "-q", "-w", str(d / "dist")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (whl,) = (d / "dist").glob("*.whl")
    return whl


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed with `pip install --target` (no console script
    is needed: the subprocesses run `python -m`)."""
    site = tmp_path_factory.mktemp("site")
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
         "-q", "--target", str(site), str(wheel)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return site


# -- the wheel -----------------------------------------------------------------

def test_the_runtime_files_are_the_expected_ones():
    for rel in ("h263_tpu_torch/native/entropy.cpp",
                "h263_tpu_torch/native/std_prep.cpp",
                "h263_tpu_torch/native/tables.h",
                "h263_tpu_torch/testdata/reference_digests.json",
                "h263_tpu_torch/kernels/present_sweep.cu",
                "h263_tpu_torch/csrc/automaton.cu",
                "h263_tpu_torch/csrc/automaton_lane.cuh"):
        assert rel in RUNTIME_FILES
    assert len([r for r in RUNTIME_FILES if "/csrc/" in r]) >= 14


@pytest.mark.parametrize("rel", RUNTIME_FILES)
def test_wheel_ships_the_file_byte_equal(wheel, rel):
    with zipfile.ZipFile(wheel) as z:
        assert rel in z.namelist(), f"{rel} is not in {wheel.name}"
        assert z.read(rel) == (ROOT / rel).read_bytes()


def test_library_name_follows_every_source(monkeypatch, tmp_path):
    """The native library is built from entropy.cpp and std_prep.cpp
    beside it, and named by both: an edit to std_prep.cpp names a new
    library in the same directory."""
    assert native.sources() == [PORT / "native" / "entropy.cpp",
                                PORT / "native" / "std_prep.cpp"]
    for name in ("entropy.cpp", "std_prep.cpp", "tables.h"):
        shutil.copy(PORT / "native" / name, tmp_path / name)
    monkeypatch.setattr(native, "SRC", tmp_path / "entropy.cpp")
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    assert native.sources() == [tmp_path / "entropy.cpp",
                                tmp_path / "std_prep.cpp"]
    before = native._library_path()
    with open(tmp_path / "std_prep.cpp", "a") as f:
        f.write("// edited\n")
    after = native._library_path()
    assert before != after and before.parent == after.parent


# -- the build directories -----------------------------------------------------

def _refuse(monkeypatch, *dirs):
    """The writability probe says no for `dirs` (and anything below)."""
    real = native._writable
    dirs = [Path(d) for d in dirs]

    def probe(d):
        d = Path(d)
        if any(d == x or x in d.parents for x in dirs):
            return False
        return real(d)

    monkeypatch.setattr(native, "_writable", probe)


@pytest.fixture
def own(monkeypatch, tmp_path):
    """A package directory of its own for both builders, a source for the
    native one, and an empty XDG cache."""
    pkg = tmp_path / "pkg"
    (pkg / "native").mkdir(parents=True)
    src = pkg / "native" / "entropy.cpp"
    src.write_text('extern "C" int h263_probe() { return 7; }\n')
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD", pkg / "native" / "build")
    monkeypatch.setattr(kernels, "BUILD", pkg / "kernels" / "build")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    return pkg


def _lib_name(which):
    return (native._library_path().name if which == "native"
            else f"libh263cuda_{kernels._digest()}.so")


def _picked(which):
    return (native._library_path().parent if which == "native"
            else kernels.build_dir(_lib_name("kernels")))


def _own_dir(which):
    return native.BUILD if which == "native" else kernels.BUILD


@pytest.mark.parametrize("which", ["native", "kernels"])
def test_writable_package_directory_is_used(own, which):
    assert _picked(which) == _own_dir(which)
    assert [p.name for p in _own_dir(which).iterdir()] == []   # probe gone


@pytest.mark.parametrize("which", ["native", "kernels"])
def test_prebuilt_library_of_the_current_sources_is_reused(
        own, monkeypatch, tmp_path, which):
    """The image built by one user and run by another: the library is
    loaded from the read-only package directory, and nothing compiles."""
    d = _own_dir(which)
    d.mkdir(parents=True)
    (d / _lib_name(which)).write_text("prebuilt\n")
    _refuse(monkeypatch, own)
    assert _picked(which) == d
    monkeypatch.setenv("PATH", str(tmp_path / "no_compiler"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_compiler"))
    built = native.build() if which == "native" else kernels.build()
    assert built == d / _lib_name(which)
    assert not (tmp_path / "xdg").exists()


@pytest.mark.parametrize("which", ["native", "kernels"])
def test_prebuilt_library_of_other_sources_is_not_reused(
        own, monkeypatch, tmp_path, which):
    d = _own_dir(which)
    d.mkdir(parents=True)
    stale = ("libh263entropy_0123456789abcdef.so" if which == "native"
             else "libh263cuda_0123456789abcdef.so")
    (d / stale).write_text("built from other sources\n")
    _refuse(monkeypatch, own)
    assert _picked(which) == tmp_path / "xdg" / "h263_tpu_torch" / which


@pytest.mark.parametrize("which", ["native", "kernels"])
@pytest.mark.parametrize("xdg", ["set", "empty", "unset"])
def test_unwritable_package_directory_falls_back_to_the_cache(
        own, monkeypatch, tmp_path, which, xdg):
    _refuse(monkeypatch, own)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg == "unset":
        monkeypatch.delenv("XDG_CACHE_HOME")
    elif xdg == "empty":
        monkeypatch.setenv("XDG_CACHE_HOME", "")
    base = tmp_path / ("xdg" if xdg == "set" else "home/.cache")
    assert _picked(which) == base / "h263_tpu_torch" / which
    assert not _own_dir(which).exists()


def test_scratch_builds_of_the_tools_need_a_writable_directory(
        own, monkeypatch, tmp_path):
    """`kernels.build_dir()` (the sweep, build-time and ptxas tools) never
    picks a read-only package directory, library or not."""
    assert kernels.build_dir() == kernels.BUILD
    (kernels.BUILD / _lib_name("kernels")).write_text("prebuilt\n")
    _refuse(monkeypatch, own)
    assert kernels.build_dir() == tmp_path / "xdg" / "h263_tpu_torch" / \
        "kernels"


def test_writability_probe(tmp_path):
    """A directory that can be made and written is writable and keeps no
    probe; one under a file is not, whoever asks."""
    assert native._writable(tmp_path / "a" / "b")
    assert list((tmp_path / "a" / "b").iterdir()) == []
    (tmp_path / "f").write_text("")
    assert not native._writable(tmp_path / "f" / "build")


@pytest.mark.parametrize("situation", ["writable", "prebuilt", "neither"])
def test_the_rule_is_the_jax_packages(monkeypatch, tmp_path, situation):
    """The same three situations through the JAX package's picker and the
    port's: the same choice, the package directory or the cache."""
    from h263_tpu.native import bindings

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    jdir = tmp_path / "jax_pkg"
    jdir.mkdir()
    monkeypatch.setattr(bindings, "_DIR", str(jdir))
    pdir = tmp_path / "port_pkg"
    name = "libh263entropy_0123456789abcdef.so"
    if situation == "prebuilt":
        (jdir / "build").mkdir()
        (jdir / "build" / "libh263entropy.so").write_text("")
        (pdir / "build").mkdir(parents=True)
        (pdir / "build" / name).write_text("")
    if situation != "writable":
        real_makedirs = os.makedirs

        def makedirs(d, *a, **k):
            if str(d) == str(jdir / "build"):
                raise OSError(30, "Read-only file system")
            return real_makedirs(d, *a, **k)

        monkeypatch.setattr(bindings.os, "makedirs", makedirs)
        _refuse(monkeypatch, pdir)
    jax_own = bindings._pick_build_dir() == str(jdir / "build")
    port = native.pick_build_dir(pdir / "build", name, "native")
    assert jax_own == (port == pdir / "build")
    assert jax_own == (situation != "neither")
    if not jax_own:
        assert port == tmp_path / "xdg" / "h263_tpu_torch" / "native"


# -- builds in the fallback directory ------------------------------------------

def test_gxx_build_lands_in_the_cache(own, monkeypatch, tmp_path):
    _refuse(monkeypatch, own)
    so = native.build()
    cache = tmp_path / "xdg" / "h263_tpu_torch" / "native"
    assert so.parent == cache
    assert sorted(p.name for p in cache.iterdir()) == [".lock", so.name]
    assert native.build() == so                       # built once
    assert not native.BUILD.exists()


def test_failed_gxx_build_in_the_cache_raises(own, monkeypatch, tmp_path):
    native.SRC.write_text("this is not C++\n")
    _refuse(monkeypatch, own)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    cache = tmp_path / "xdg" / "h263_tpu_torch" / "native"
    assert [p.name for p in cache.iterdir()] == [".lock"]


def test_concurrent_builders_share_one_cache_build(tmp_path):
    """More builders than cores start at once with the package directory
    refused and one empty cache, as a service's workers start: one
    library, built once, and no temporary file left."""
    src = tmp_path / "prep.cpp"
    src.write_text("int x;\n")
    own = tmp_path / "pkg_build"
    # The module alone, without the package (whose import loads torch).
    code = textwrap.dedent(f"""
        import importlib.util
        from pathlib import Path
        spec = importlib.util.spec_from_file_location(
            "prep", {native.__file__!r})
        n = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(n)
        n.SRC, n.BUILD = Path({str(src)!r}), Path({str(own)!r})
        n._writable = lambda d: Path(d) != n.BUILD
        print(n.build(), n.last_build_seconds is not None)
    """)
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path / "xdg"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2 * os.cpu_count())]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = [o[0].split() for o in outs]
    assert len({path for path, _ in lines}) == 1
    assert [built for _, built in lines].count("True") == 1
    cache = tmp_path / "xdg" / "h263_tpu_torch" / "native"
    assert sorted(f.name for f in cache.iterdir()) == [
        ".lock", Path(lines[0][0]).name]
    assert Path(lines[0][0]).parent == cache and not own.exists()


@pytest.fixture
def stand_in_nvcc(own, monkeypatch, tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    src = tmp_path / "csrc"
    src.mkdir()
    for k in range(3):
        (src / f"k{k}.cu").write_text(f"kernel {k}\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    _refuse(monkeypatch, own)
    return src


def test_kernel_build_lands_in_the_cache(stand_in_nvcc, tmp_path):
    so = kernels.build()
    cache = tmp_path / "xdg" / "h263_tpu_torch" / "kernels"
    assert so.parent == cache
    assert so.read_text() == "".join(f"kernel {k}\n" for k in range(3))
    assert sorted(p.name for p in cache.iterdir()) == [".lock", so.name]
    assert kernels.build() == so
    assert not kernels.BUILD.exists()


def test_failed_kernel_build_in_the_cache_raises(stand_in_nvcc, tmp_path):
    (stand_in_nvcc / "k1.cu").write_text("#error broken\n")
    with pytest.raises(RuntimeError, match="k1.cu"):
        kernels.build()
    cache = tmp_path / "xdg" / "h263_tpu_torch" / "kernels"
    assert [p.name for p in cache.iterdir()] == [".lock"]


# -- the installed copy on the CPU ---------------------------------------------

# Runs `python -m h263_tpu_torch <args>` from the install at argv[1]; with
# argv[2] == "ro" the writability probe refuses the package directory first.
# Prints the modules of the JAX package that were imported and the files
# of the port's modules.
RUNNER = r"""
import json, os, runpy, sys
site, mode, args = sys.argv[1], sys.argv[2], sys.argv[3:]
import h263_tpu_torch
from h263_tpu_torch import native
pkg = os.path.dirname(h263_tpu_torch.__file__)
if mode == "ro":
    real = native._writable
    native._writable = lambda d: (False if str(d).startswith(pkg)
                                  else real(d))
sys.argv = ["h263_tpu_torch", *args]
rc = 0
try:
    runpy.run_module("h263_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
print("REPORT " + json.dumps({
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "h263_tpu")),
    "files": sorted({getattr(m, "__file__", None) or ""
                     for k, m in list(sys.modules.items())
                     if k.split(".")[0] == "h263_tpu_torch"}),
    "native": str(native._library_path())}))
sys.exit(rc)
"""


def _run_installed(site, tmp_path, mode, *args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XDG_CACHE_HOME")}
    env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(tmp_path / "xdg"),
               PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-c", RUNNER, str(site), mode,
                           *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    (line,) = [x for x in proc.stdout.splitlines()
               if x.startswith("REPORT ")]
    report = json.loads(line[len("REPORT "):])
    assert report["jax"] == [], report["jax"]
    assert report["files"] and all(
        f.startswith(str(site) + os.sep) for f in report["files"]), \
        report["files"]
    return proc.stdout, report


def test_installed_selftest_builds_into_the_cache(installed, tmp_path):
    out, report = _run_installed(installed, tmp_path, "ro", "selftest",
                                 "--device", "cpu")
    assert "selftest OK: decoded 3 synthetic frames on cpu" in out
    cache = tmp_path / "xdg" / "h263_tpu_torch" / "native"
    assert Path(report["native"]).parent == cache
    assert Path(report["native"]).exists()
    assert not (installed / "h263_tpu_torch" / "native" / "build").exists()


def test_installed_decode_equals_the_digests(installed, tmp_path):
    flv = tmp_path / "in.flv"
    shutil.copy(QCIF, flv)
    out, _ = _run_installed(installed, tmp_path, "rw", "decode", str(flv),
                            "-o", str(tmp_path / "out"), "--fmt", "npz",
                            "--max-frames", str(N_FRAMES), "--device", "cpu")
    assert f"decoded {N_FRAMES} frames" in out
    want = json.loads((ROOT / "h263_tpu_torch" / "testdata" /
                       "reference_digests.json").read_text())
    want = want["sequences"]["ff_qcif"]["planes"][:N_FRAMES]
    with np.load(tmp_path / "out" / "frames.npz") as z:
        got = [planes_digest(*(z[f"{k}_{t:05d}"] for k in ("y", "cb", "cr")))
               for t in range(N_FRAMES)]
    assert got == want
