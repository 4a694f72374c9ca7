"""Build the JAX package's native library before `tests/test_native.py`
is collected.

pytest collects a directory's entries in name order, so this directory
comes before `tests/test_native.py`, whose `skipif` builds and loads the
library while the module is imported, in every xdist worker at once.
Importing the heal here first makes each worker build, or load, under the
heal's lock, one worker at a time, so none loads a half-written library:
`test_native.py` then finds it loaded and runs in every worker.
"""

import sys
from pathlib import Path

TESTS = str(Path(__file__).resolve().parents[1])
if TESTS not in sys.path:
    sys.path.insert(0, TESTS)

from test_torch_reference_native import require_reference_native  # noqa: E402


def test_the_reference_native_loaded_before_test_native():
    require_reference_native()
