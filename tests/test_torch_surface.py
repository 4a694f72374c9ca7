"""The port's import surface: a caller that renames `h263_tpu` to
`h263_tpu_torch` in an import gets the same names.

For the package and each sub-package, the names the JAX package exports
(its `__all__`, or else its public module-level names) must all be
exported by the port's counterpart, less the names that ROADMAP Queue 1
lists as not to be ported.  A name added to a JAX `__init__` fails here
until it is ported or listed below with its reason.
"""

import importlib
import pathlib
import subprocess
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SUBPACKAGES = ("decoder", "io", "native", "ops", "parallel", "parser",
               "testing", "utils")

# ROADMAP Queue 1, "Not to be ported", as it applies to the package
# `__init__`s.
NOT_PORTED = {
    # The port's native library builds or raises; it has no switch and no
    # Python fallback to report.
    "native": {"NATIVE_AVAILABLE"},
    # It only forces the non-fused transport, which the port does not have.
    "testing": {"build_batched_decoder"},
}


def exported(module) -> set:
    names = getattr(module, "__all__", None)
    if names is not None:
        return set(names)
    return {k for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
            and k != "annotations"}


def test_every_subpackage_of_the_jax_package_is_listed():
    on_disk = sorted(p.parent.name for p in
                     (ROOT / "h263_tpu").glob("*/__init__.py"))
    assert tuple(on_disk) == SUBPACKAGES


@pytest.mark.parametrize("sub", ("",) + SUBPACKAGES)
def test_port_exports_the_jax_names(sub):
    j = importlib.import_module("h263_tpu" + (f".{sub}" if sub else ""))
    t = importlib.import_module("h263_tpu_torch" + (f".{sub}" if sub else ""))
    want = exported(j) - NOT_PORTED.get(sub, set())
    missing = sorted(want - exported(t))
    assert not missing, f"h263_tpu_torch.{sub} lacks {missing}"
    for name in exported(t):
        assert hasattr(t, name), f"h263_tpu_torch.{sub}.__all__ names {name}"


def test_not_ported_names_are_exported_by_the_jax_package():
    for sub, names in NOT_PORTED.items():
        j = importlib.import_module(f"h263_tpu.{sub}")
        assert names <= exported(j), sub


@pytest.mark.parametrize("sub", ("native", "parser", "utils"))
def test_subpackage_imports_first_in_a_fresh_process(sub):
    """No import cycle: `native/__init__` imports `bindings`, which imports
    it back, and `parser/__init__` now imports the host parsers."""
    code = (f"import h263_tpu_torch.{sub} as m, sys\n"
            f"print(sorted(m.__all__))\n"
            f"print([k for k in sys.modules if k.split('.')[0] in "
            f"('jax', 'h263_tpu')])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_the_roadmap_imports_work():
    from h263_tpu_torch.native import ensure_built, parse_frame_native
    from h263_tpu_torch.parser import FrameData, decode_picture, parse_frame
    from h263_tpu_torch.utils import get_counters

    assert ensure_built() is True
    assert callable(parse_frame_native) and callable(parse_frame)
    assert callable(decode_picture) and FrameData.__name__ == "FrameData"
    assert isinstance(get_counters(), dict)
