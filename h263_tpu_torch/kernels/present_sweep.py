"""Time the launch shapes of the one-pass deblock and the fused present
kernel, beside the card's bare data movement, at S = 1024 CIF frames.

    python3 -m h263_tpu_torch.kernels.present_sweep

Builds `kernels/present_sweep.cu` (a program of its own over the headers of
`csrc/`) with nvcc into a temporary directory under `build_dir()`
(`kernels/build/`, or the per-user cache when that is read-only), prints
the card's name and power limit, and runs it: the device-to-device copy of
the planes, a write-only and a pass-through kernel as yardsticks, then one
line per shape (tile rows, threads, resident blocks per SM) with the times of
the deblock of three planes and of the present, with and without any stream
filtered.  Every shape must give the first one's output.  Needs nvcc and a
card.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

from . import NVCC_FLAGS, _nvcc, build_dir


def main() -> int:
    nvcc = _nvcc()
    src = Path(__file__).resolve().parent / "present_sweep.cu"
    work = build_dir()
    work.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        exe = Path(tmp) / "present_sweep"
        flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        build = subprocess.run([nvcc, *flags, "-o", str(exe), str(src)],
                               capture_output=True, text=True)
        if build.returncode != 0:
            print(build.stdout, build.stderr, file=sys.stderr)
            return 1
        return subprocess.run([str(exe)], timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())
