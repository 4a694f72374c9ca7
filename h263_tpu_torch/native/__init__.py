"""The port's native host library: `entropy.cpp`, a byte-for-byte copy of
`h263_tpu/native/entropy.cpp` with its VLC tables `tables.h` (written by
`gen_tables.py` from the port's `vlc_tables.py`), built by g++ at first use
and bound with ctypes.  It holds the host entropy decoder (the dense parse
and the fused batch parse of `bindings.py`) and the header prep of the
device front-end (`DevicePrepBatch` below).

The library goes to `native/build/libh263entropy_<hash>.so`, the hash taken
over the sources and the compiler flags, so an edited source builds anew
and a built one is never rebuilt.  Concurrent builders (test workers,
processes of one host) take an `fcntl` lock on `build/.lock`, compile to a
per-process temporary file and `os.replace` it into place, so no process
ever loads a partly written library.  A failed build raises with g++'s
output; there is no fallback.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "entropy.cpp"
BUILD = Path(__file__).resolve().parent / "build"
# The JAX package's flags: the decoder is integer code, so they do not
# change its results.
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

# Error codes of entropy.cpp.
E_EOF = -100
E_INVALID_BITSTREAM = -10

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


def _library_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(GXX_FLAGS).encode())
    for p in (SRC, SRC.with_name("tables.h")):
        if p.exists():
            h.update(p.read_bytes())
    return BUILD / f"libh263entropy_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile entropy.cpp unless the library for its current content
    exists; returns the library's path."""
    so = _library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library of "
                           "h263_tpu_torch needs a C++ compiler")
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if so.exists():           # built by another process meanwhile
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    return so


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
