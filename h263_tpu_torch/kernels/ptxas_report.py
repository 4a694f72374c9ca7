"""Print what ptxas says of every kernel: registers, shared memory, stack
frame and spills (`nvcc -Xptxas -v`), one source after another with its
compile time, into a temporary directory under `build_dir()` (`kernels/build/`,
or the per-user cache when that is read-only).  Needs nvcc.

    python3 -m h263_tpu_torch.kernels.ptxas_report
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import _nvcc, build_dir, compile_commands


def main() -> int:
    nvcc = _nvcc()
    work = build_dir()
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        compiles, _ = compile_commands(nvcc, Path(tmp), Path(tmp) / "lib.so")
        for cmd in compiles:
            t0 = time.perf_counter()
            proc = subprocess.run([*cmd, "-Xptxas", "-v"],
                                  capture_output=True, text=True)
            print(f"{Path(cmd[-1]).name}: {time.perf_counter() - t0:.1f} s, "
                  f"rc {proc.returncode}")
            if proc.returncode != 0:
                print(proc.stderr)
                return 1
            name = None
            for line in proc.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                elif "registers" in line or "spill" in line:
                    print(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
