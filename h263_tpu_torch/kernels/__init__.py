"""Build and load the port's hand-written CUDA kernels.

Every `h263_tpu_torch/csrc/*.cu` is compiled by its own nvcc process, all
started together, and the objects are linked into ONE shared library with a
plain C interface, at first use, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -c csrc/<name>.cu         (one per source, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \
         kernels/build/libh263cuda_<hash>.so *.o

`-fmad=false` keeps nvcc from contracting a multiply and an add into one FMA
(the IDCT must round every product, like the reference).  The library's name
carries a hash of every source's content and the flags, so an edited source
rebuilds.  Concurrent builders take an `fcntl` lock on `build/.lock`; the
objects and the library are written into a temporary directory and the
library is `os.replace`d into place.  There is no
fallback: a missing nvcc or a failed build raises with the compiler's
output.  Importing this module builds nothing.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes.  Every pointer and the stream are
# c_void_p (a plain int would be cut to 32 bits); each returns cudaError_t.
SIGNATURES = {
    # (coeffs int16 [n,64], out int32 [n,64], n, basis f32 [64] on the
    #  device, stream)
    "h263_idct_residual": [_P, _P, ctypes.c_int64, _P, _P],
    # (payload u8, payload_bytes, meta int32 [S/frame_lanes, 6,
    #  frame_lanes], S lanes, frame_lanes, mbh, mbw, ext_x, ext_y, tables
    #  int32, dense, mvs, inter, status, lanes_per_warp, lanes_per_block,
    #  shared_tables (all 0: chosen from S), stream)
    "h263_automaton": [_P, ctypes.c_int64, _P, _I, _I, _I, _I, _I, _I, _P,
                       _P, _P, _P, _P, _I, _I, _I, _P],
    # (planes u8 [S,h,w], out u8 [S,h,w], S, h, w, strength int32 [S],
    #  apply u8 [S], stream)
    "h263_deblock": [_P, _P, _I, _I, _I, _P, _P, _P],
    # (y u8 [S,h,w], cb, cr u8 [S,ch,cw], out u8 [S,h,w,4], S, h, w, stream)
    "h263_yuv_rgba": [_P, _P, _P, _P, _I, _I, _I, _P],
    # (y u8 [S,h,w], cb, cr u8 [S,ch,cw], out u8 [S,h,w,4], S, h, w,
    #  strength int32 [S], apply u8 [S], stream)
    "h263_present_rgba": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # (dense int16 [S,6*nmb,64], mvs int16 [S,mbh,mbw,4,2], inter u8
    #  [S,mbh,mbw], ref y/cb/cr u8, out y/cb/cr u8, S, mbh, mbw, h, w,
    #  basis f32 [64] on the device, stream)
    "h263_reconstruct": [_P] * 9 + [_I] * 5 + [_P, _P],
    # (rows u8 [S, L], row pitch in bytes, entries per row, MV bytes per MB
    #  (2 or 8; 0: the rows hold entries alone and only dense is written),
    #  S, mbh, mbw, zigzag u8 [64] on the device, dense int16 [S,6*nmb,64],
    #  mvs int16 [S,mbh,mbw,4,2], inter u8 [S,mbh,mbw], stream)
    "h263_d24_unpack": [_P, ctypes.c_int64, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P],
}

_lock = threading.Lock()
_lib = None
_tables: dict = {}
last_build_seconds = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of h263_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME or PATH)")


def run_all(cmds) -> None:
    """Run every command at once; raise with each failing one's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc {proc.returncode}): "
                          f"{' '.join(map(str, cmd))}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def compile_commands(nvcc: str, outdir: Path, lib: Path) -> tuple:
    """(one compile command per source, the link command) into `outdir`."""
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [outdir / f"{src.stem}.o" for src in srcs]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(srcs, objs)]
    return compiles, [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                      *map(str, objs)]


def build() -> Path:
    """Compile the kernels if the library for the current sources is absent;
    returns its path."""
    global last_build_seconds

    digest = _digest()
    so = BUILD / f"libh263cuda_{digest}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if so.exists():              # built by another process meanwhile
            return so
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
            tmp_so = Path(tmp) / so.name
            compiles, link = compile_commands(nvcc, Path(tmp), tmp_so)
            run_all(compiles)
            run_all([link])
            os.replace(tmp_so, so)
        last_build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def device_table(name: str, array, device):
    """The constant table `array` (numpy) as a tensor on `device`: uploaded
    once per device and kept, so a launch only passes its pointer."""
    import torch

    key = (name, str(device))
    t = _tables.get(key)
    if t is None:
        t = torch.as_tensor(array).to(device)
        _tables[key] = t
    return t


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
