"""The JAX package's native library, steadied as the port's reference.

`h263_tpu.native.bindings.ensure_built()` builds `libh263entropy.so` and
the `h263_fastcall` module into one directory with no lock between
processes, and keeps a failed load for the life of the process. Under
`pytest -n 6` every worker builds at once while it collects
`tests/test_native.py`. A worker that loads a library another worker is
still writing keeps `NATIVE_AVAILABLE = False`: its JAX decoders then take
the Python parser, and the port's differential tests there fail or compare
against the wrong path.

Importing this module heals the worker. Under a file lock of its own it
loads the library again, and the fastcall module, until both load or a
timeout passes. xdist collects every module before a worker runs a test,
and the modules that need the native reference import
`require_reference_native` from here, so each worker is healed before its
first test. The heal never hands the reference another path: when the
library cannot load, it leaves the state as it found it and
`require_reference_native` fails with `RACE`.

`tests/test_native.py` decides its skip while it is imported, so
`tests/before_test_native/test_torch_heal_first.py`, which pytest collects
before it, imports the heal first: each worker then builds or loads under
the lock, one at a time, and none loses the race at all.

The reproducer, alone: `python -m pytest -q -p no:cacheprovider
tests/test_torch_reference_native.py -k racing`. The race as the tier-1
run meets it, over fresh copies of the tree:
`python tests/stress_reference_native.py --out DIR`.
"""

import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import pytest

from h263_tpu.native import bindings as jnative

ROOT = Path(__file__).resolve().parents[1]

RACE = ("the JAX package's native library (h263_tpu/native/bindings.py) did "
        "not load: its build races between pytest-xdist workers, and the heal "
        "in tests/test_torch_reference_native.py timed out")


def _healed(bindings):
    return bindings.NATIVE_AVAILABLE is True and bindings._fastcall is not None


def lock_path(build_dir):
    """The heal's lock file: in the temp dir, one per build directory."""
    key = hashlib.sha256(os.path.realpath(build_dir).encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(), f"h263_tpu_native_{key}.lock")


def heal_reference_native(bindings=jnative, timeout_s=120.0):
    """Load `bindings`' library and fastcall module again until both load.

    Returns whether they did. On a timeout, `NATIVE_AVAILABLE` and
    `_fastcall` are put back as they were found."""
    if _healed(bindings):
        return True
    found = bindings.NATIVE_AVAILABLE, bindings._fastcall
    deadline = time.monotonic() + timeout_s
    with open(lock_path(bindings._BUILD_DIR), "a") as fh:
        while True:
            try:
                fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.05)
        try:
            while True:
                if bindings.NATIVE_AVAILABLE is not True:
                    bindings.NATIVE_AVAILABLE = None
                    bindings.ensure_built()
                if bindings.NATIVE_AVAILABLE and bindings._fastcall is None:
                    bindings._fastcall = bindings._build_fastcall()
                if _healed(bindings):
                    return True
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.5)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    bindings.NATIVE_AVAILABLE, bindings._fastcall = found
    return False


def require_reference_native(bindings=jnative, timeout_s=120.0):
    """Heal if needed, then fail with `RACE` unless both the native library
    and the fastcall module loaded."""
    heal_reference_native(bindings, timeout_s)
    assert bindings.NATIVE_AVAILABLE is True, RACE
    assert bindings._fastcall is not None, RACE + " (h263_fastcall)"


heal_reference_native(jnative)


def _bindings_copy(name):
    """A second module object of the JAX package's bindings.py, with state
    of its own, beside the real package."""
    spec = importlib.util.spec_from_file_location(
        f"h263_tpu.native.{name}", jnative.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_this_worker_loads_the_reference_native():
    require_reference_native()
    assert jnative._lib is not None
    assert jnative._fastcall.__name__ == "h263_fastcall"


def test_one_lock_per_build_dir_outside_the_package(tmp_path):
    ours = lock_path(jnative._BUILD_DIR)
    assert lock_path(_bindings_copy("_lock_probe")._BUILD_DIR) == ours
    assert lock_path(tmp_path) != ours
    assert Path(ours).parent == Path(tempfile.gettempdir())


def test_heal_reloads_a_poisoned_worker():
    """A worker whose first load failed: the heal loads the built library."""
    mod = _bindings_copy("_poisoned")
    mod.NATIVE_AVAILABLE = False
    assert mod.ensure_built() is False  # the poison is kept
    assert heal_reference_native(mod, timeout_s=60)
    assert mod.NATIVE_AVAILABLE is True and mod._lib is not None
    assert mod._fastcall is not None
    require_reference_native(mod, timeout_s=1)


def test_heal_gives_up_loudly_when_the_build_cannot_run(tmp_path,
                                                        monkeypatch):
    """No g++ on PATH: the heal returns within its timeout, leaves the
    state as it found it, and never takes another path."""
    mod = _bindings_copy("_no_compiler")
    build = tmp_path / "build"
    mod._BUILD_DIR = str(build)
    mod._LIB_PATH = str(build / "libh263entropy.so")
    (tmp_path / "bin").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    assert mod.ensure_built() is False
    t0 = time.monotonic()
    assert heal_reference_native(mod, timeout_s=1.5) is False
    assert time.monotonic() - t0 < 1.5 + 2.0
    assert mod.NATIVE_AVAILABLE is False
    assert mod._lib is None and mod._fastcall is None
    assert not (build / "libh263entropy.so").exists()
    with pytest.raises(AssertionError, match="races between pytest-xdist"):
        require_reference_native(mod, timeout_s=0.5)
    assert mod.NATIVE_AVAILABLE is False
    os.unlink(lock_path(build))


_CHILD = textwrap.dedent("""
    import os, sys, time
    copy, tests, barrier, n = sys.argv[1:5]
    sys.path[:0] = [copy, tests]
    from h263_tpu.native import bindings
    assert bindings._DIR.startswith(copy), bindings._DIR
    open(os.path.join(barrier, str(os.getpid())), "w").close()
    t_end = time.monotonic() + 20
    while len(os.listdir(barrier)) < int(n) and time.monotonic() < t_end:
        time.sleep(0.005)
    first = bindings.ensure_built()
    from test_torch_reference_native import heal_reference_native
    heal_reference_native(bindings, timeout_s=60)
    print(first, bindings.NATIVE_AVAILABLE, bindings._fastcall is not None)
""")


def test_six_racing_builds_all_heal(tmp_path):
    """Six processes build one fresh copy of the JAX package at once, as
    six xdist workers do: after the heal, each has both libraries."""
    copy = tmp_path / "copy"
    shutil.copytree(ROOT / "h263_tpu", copy / "h263_tpu", ignore=(
        shutil.ignore_patterns("build", "__pycache__")))
    barrier = tmp_path / "barrier"
    barrier.mkdir()
    n = 6
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(copy), str(ROOT / "tests"),
         str(barrier), str(n)],
        cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
            p.wait()
    # The first, unhealed call is random and is not asserted.
    assert [o[1:] for o in outs] == [["True", "True"]] * n, outs
    build = copy / "h263_tpu" / "native" / "build"
    assert (build / "libh263entropy.so").exists()
    Path(lock_path(build)).unlink(missing_ok=True)  # no heal: no lock
