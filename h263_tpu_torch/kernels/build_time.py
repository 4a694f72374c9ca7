"""Time the kernel build: every source compiled one after another, then all
at once as `build()` does (each followed by the link), into temporary
directories under `kernels/build/`; prints one JSON line.  Needs nvcc.

    python3 -m h263_tpu_torch.kernels.build_time
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

from . import BUILD, _nvcc, compile_commands, run_all


def main() -> int:
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {}
    for mode in ("one_by_one", "all_at_once", "one_by_one", "all_at_once"):
        with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
            compiles, link = compile_commands(nvcc, Path(tmp),
                                              Path(tmp) / "lib.so")
            t0 = time.perf_counter()
            if mode == "one_by_one":
                for cmd in compiles:
                    run_all([cmd])
            else:
                run_all(compiles)
            run_all([link])
            out.setdefault(mode + "_s", []).append(time.perf_counter() - t0)
    out["sources"] = len(compiles)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
