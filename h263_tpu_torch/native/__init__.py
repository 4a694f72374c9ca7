"""The port's native host library, built by g++ at first use from two
sources and bound with ctypes: `entropy.cpp`, a byte-for-byte copy of
`h263_tpu/native/entropy.cpp` with its VLC tables `tables.h` (written by
`gen_tables.py` from the port's `vlc_tables.py`), and `std_prep.cpp`, the
port's own.  It holds the host entropy decoder (the dense parse and the
fused batch parse of `bindings.py`) and the header prep of the device
front-end: Sorenson (`DevicePrepBatch` below, entropy.cpp) and standard
H.263 (`StandardPrepBatch`, std_prep.cpp).

The library is `libh263entropy_<hash>.so`, the hash taken over the sources
and the compiler flags, so an edited source builds anew and a built one is
never rebuilt.  It goes where `pick_build_dir` says: `native/build/` when
that is writable (a checkout, a user's own install); that directory
read-only when it already holds the library of the current sources (an
image built by one user and run by another); otherwise
`$XDG_CACHE_HOME/h263_tpu_torch/native` (`~/.cache` by default), as for a
read-only site-packages.  Concurrent builders (test workers, processes of
one host) take an `fcntl` lock on `.lock` in the chosen directory, compile
to a per-process temporary file there and `os.replace` it into place, so
no process ever loads a partly written library.  A failed build raises
with g++'s output; there is no fallback.  Importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "entropy.cpp"
# The sources beside SRC compiled with it into the one library.
EXTRA_SOURCES = ("std_prep.cpp",)
BUILD = Path(__file__).resolve().parent / "build"
# The JAX package's flags: the decoder is integer code, so they do not
# change its results.
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

# Error codes of entropy.cpp.
E_EOF = -100
E_INVALID_BITSTREAM = -10
E_NEEDS_PYTHON = 100

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_U64 = ctypes.c_uint64
# C entry points: name -> argtypes (every pointer c_void_p, so that no
# address is cut to 32 bits); each returns int.
SIGNATURES = {
    # (buffers, lengths, n, expected w, h, flat stage, stage bytes,
    #  meta [6][n], hdr [n][8], rc [n])
    "h263_device_prepare_ragged": [_P, _P, _I32, _I32, _I32, _P,
                                   ctypes.c_int64, _P, _P, _P],
    # (joined frames, offsets [n + 1], n, expected w, h, lane cap,
    #  prev_fmt [n], prev_running [n], given [n], flat stage, stage bytes,
    #  meta [6][n], hdr [n][10], rc [n])
    "h263_device_prepare_standard_ragged": [
        ctypes.c_char_p, _P, _I32, _I32, _I32, ctypes.c_int64, _P, _P, _P,
        _P, ctypes.c_int64, _P, _P, _P],
    # (data, nbytes, start_bit, w, h, ptype, flags, version, quant, range x,
    #  range y, coeffs/class y, cb, cr, mvs, inter, pred_scratch, pack_pos,
    #  pack_val, pack_cap, pack_count, end_bit, mvs_slim, mv8, inter_bits,
    #  mv8_stride, mb_flags)
    "h263_parse_frame": [_P, _U64, _U64, _I32, _I32, _I32, _I32, _I32, _I32,
                         _I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I32, _P, _P, _P, _P, _P, _I32, _P],
    # (buffers, lengths, n, w, h, xflags, has_reference, hdr [n][8], mvs,
    #  inter, fused rows, row bytes, mv8 stride, pred_scratch, pack_cap,
    #  ladder, n_ladder, counts, flags, cut, failed stream)
    "h263_sorenson_decode_batch_fused": [_P, _P, _I32, _I32, _I32, _I32, _P,
                                         _P, _P, _P, _P, ctypes.c_int64,
                                         _I32, _P, _I32, _P, _I32, _P, _P,
                                         _P, _P],
    # (buffers, lengths, n, w, h, xflags, has_reference, prev_running,
    #  prev_fmt, hdr [n][10], mvs, mvs_slim, inter, pred_scratch, pack,
    #  pack_val, pack_cap, counts, flags, failed stream)
    "h263_standard_decode_batch": [_P, _P, _I32, _I32, _I32, _I32, _P, _P,
                                   _P, _P, _P, _P, _P, _P, _P, _P, _I32, _P,
                                   _P, _P],
    # (OPPTYPE mask out, MPPTYPE mask out)
    "h263_option_masks": [_P, _P],
    "h263_abi_version": [],
}
ABI_VERSION = 6

_lock = threading.Lock()
_lib = None
last_build_seconds = None     # g++'s seconds, in the process that built


def _writable(d: Path) -> bool:
    """Whether `d` exists or can be made, and a file can be created in it."""
    try:
        d.mkdir(parents=True, exist_ok=True)
        fd, probe = tempfile.mkstemp(prefix=".writable.", dir=d)
        os.close(fd)
        os.unlink(probe)
        return True
    except OSError:
        return False


def pick_build_dir(own: Path, library, cache: str) -> Path:
    """Where a library of the port is built or loaded from: `own` (a
    `build/` inside the package) when it is writable; `own` when it already
    holds the file `library` (prebuilt, loaded read-only); otherwise
    `$XDG_CACHE_HOME/h263_tpu_torch/<cache>`, `~/.cache` when the variable
    is unset or empty.  With `library` None (a scratch build), `own` only
    when it is writable.  The rule of the JAX package's
    `bindings._pick_build_dir`, with the library named by its sources."""
    if _writable(own):
        return own
    if library is not None and (own / library).exists():
        return own
    base = (os.environ.get("XDG_CACHE_HOME")
            or os.path.join(os.path.expanduser("~"), ".cache"))
    return Path(base) / "h263_tpu_torch" / cache


def sources() -> list:
    """The sources compiled into the library: SRC and those of
    EXTRA_SOURCES that lie beside it."""
    extra = (SRC.with_name(name) for name in EXTRA_SOURCES)
    return [SRC, *(p for p in extra if p.exists())]


def _library_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(GXX_FLAGS).encode())
    for p in (*sources(), SRC.with_name("tables.h")):
        if p.exists():
            h.update(p.read_bytes())
    name = f"libh263entropy_{h.hexdigest()[:16]}.so"
    return pick_build_dir(BUILD, name, "native") / name


def build() -> Path:
    """Compile the sources unless the library for their current content
    exists; returns the library's path."""
    global last_build_seconds

    so = _library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library of "
                           "h263_tpu_torch needs a C++ compiler")
    build_dir = so.parent
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if so.exists():           # built by another process meanwhile
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, *GXX_FLAGS, *map(str, sources()), "-o", str(tmp)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        last_build_seconds = time.perf_counter() - t0
    return so


def ensure_built() -> bool:
    """The JAX package's name for building and loading the library: True,
    or raises as `lib()` does (the port has no Python fallback, so there
    is no `NATIVE_AVAILABLE`)."""
    lib()
    return True


def lib() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            if handle.h263_abi_version() != ABI_VERSION:
                raise RuntimeError("native library ABI version mismatch")
            _lib = handle
        return _lib


class DevicePrepBatch:
    """Batched Sorenson header parse + payload staging for `n` lanes of one
    resolution: one native call per step.  After `prepare_ragged`, `hdr`
    (int32 [n, 8]: version, temporal reference, width, height, ptype,
    deblocker flag, quantizer, format) and `rc` (int32 [n], 0 = ok) hold
    each lane's header and result."""

    __slots__ = ("_n", "_w", "_h", "_lengths", "hdr", "rc")

    def __init__(self, n: int, width: int, height: int):
        lib()
        self._n, self._w, self._h = n, width, height
        self._lengths = np.zeros(n, dtype=np.uint64)
        self.hdr = np.zeros((n, 8), dtype=np.int32)
        self.rc = np.zeros(n, dtype=np.int32)

    def prepare_ragged(self, buffers, stage: np.ndarray,
                       meta: np.ndarray) -> int:
        """Pack every lane's word-aligned payload back to back into the flat
        uint8 `stage` (any shape; its size is the cap) and fill `meta`
        (int32 [6, n]: start bit, nbits, quant0, ptype, v1, word offset).
        `buffers` are `bytes`.  Returns the number of failed lanes."""
        n = self._n
        if len(buffers) != n:
            raise ValueError(f"expected {n} buffers, got {len(buffers)}")
        if stage.dtype != np.uint8 or not stage.flags["C_CONTIGUOUS"]:
            raise ValueError("stage must be a C-contiguous uint8 array")
        if (meta.shape != (6, n) or meta.dtype != np.int32
                or not meta.flags["C_CONTIGUOUS"]):
            raise ValueError(f"meta must be C-contiguous int32 [6, {n}]")
        ptrs = (ctypes.c_char_p * n)(*buffers)
        self._lengths[:] = [len(b) for b in buffers]
        failed = lib().h263_device_prepare_ragged(
            ctypes.addressof(ptrs), self._lengths.ctypes.data, n, self._w,
            self._h, stage.ctypes.data, stage.nbytes, meta.ctypes.data,
            self.hdr.ctypes.data, self.rc.ctypes.data)
        return int(failed)


class StandardPrepBatch:
    """Batched standard H.263 (plain PTYPE) header parse + payload staging
    for `n` lanes of one resolution, frames of at most `lane_cap` bytes:
    one native call per step (std_prep.cpp).  Before each `prepare` the
    caller fills `prev_fmt` (each lane's previous PTYPE format code: -1
    none, -2 a header only the Python parser takes), `prev_running` (its
    running options) and `given` (nonzero: stage the lane's buffer as it
    is, with the meta rows 0-3 already in `meta`).  After it, `hdr` (int32
    [n, 10]: TR, width, height, ptype, header options, quantizer, CPM,
    PSBI, format code, running options) and `rc` (int32 [n]: 0 staged,
    `E_NEEDS_PYTHON` handed back with nothing staged) hold each lane's
    result, and `words` the payload's words."""

    __slots__ = ("_n", "_w", "_h", "_cap", "_offsets", "hdr", "rc",
                 "prev_fmt", "prev_running", "given", "words")

    def __init__(self, n: int, width: int, height: int, lane_cap: int):
        lib()
        self._n, self._w, self._h, self._cap = n, width, height, lane_cap
        self._offsets = np.zeros(n + 1, dtype=np.int64)
        self.hdr = np.zeros((n, 10), dtype=np.int32)
        self.rc = np.zeros(n, dtype=np.int32)
        self.prev_fmt = np.full(n, -1, dtype=np.int32)
        self.prev_running = np.zeros(n, dtype=np.uint32)
        self.given = np.zeros(n, dtype=np.uint8)
        self.words = 0

    def prepare(self, buffers, stage: np.ndarray, meta: np.ndarray) -> int:
        """Pack every staged lane's word-aligned payload back to back, in
        lane order, into the flat uint8 `stage` (its size is the cap; the
        bytes past the last lane are zeroed) and fill `meta` (int32 [6, n]:
        start bit, nbits, quant0, ptype word, v1, word offset).  `buffers`
        are `bytes`.  Returns the number of lanes handed back."""
        n = self._n
        if len(buffers) != n:
            raise ValueError(f"expected {n} buffers, got {len(buffers)}")
        if stage.dtype != np.uint8 or not stage.flags["C_CONTIGUOUS"]:
            raise ValueError("stage must be a C-contiguous uint8 array")
        if (meta.shape != (6, n) or meta.dtype != np.int32
                or not meta.flags["C_CONTIGUOUS"]):
            raise ValueError(f"meta must be C-contiguous int32 [6, {n}]")
        lengths = np.fromiter(map(len, buffers), dtype=np.int64, count=n)
        np.cumsum(lengths, out=self._offsets[1:])
        punted = lib().h263_device_prepare_standard_ragged(
            b"".join(buffers), self._offsets.ctypes.data, n, self._w,
            self._h, self._cap, self.prev_fmt.ctypes.data,
            self.prev_running.ctypes.data, self.given.ctypes.data,
            stage.ctypes.data, stage.nbytes, meta.ctypes.data,
            self.hdr.ctypes.data, self.rc.ctypes.data)
        if punted < 0:
            raise ValueError(f"the lanes' payload does not fit the stage's "
                             f"{stage.nbytes} bytes")
        self.words = int(np.sum((lengths + 3) // 4, where=self.rc == 0))
        return int(punted)


def __getattr__(name):
    # `bindings` imports `lib` from this package, so it is imported at
    # first use rather than here; this module also loads on its own, by
    # path, where a relative import has no package.
    if name == "parse_frame_native":
        from .bindings import parse_frame_native
        return parse_frame_native
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DevicePrepBatch", "StandardPrepBatch", "build", "ensure_built",
           "lib", "parse_frame_native", "sources"]
