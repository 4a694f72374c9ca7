"""The port stands alone: no module of `h263_tpu_torch` and not
`chip_smoke.py` imports JAX or the JAX package `h263_tpu`.

A subprocess imports every module of the port and then looks at
`sys.modules`; an AST scan reads every import statement of the port's
sources and of `chip_smoke.py`, including those inside functions, which
the subprocess would not reach.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "h263_tpu_torch"
SOURCES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "h263_tpu")


def test_importing_every_module_leaves_out_jax_and_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import h263_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    h263_tpu_torch.__path__, 'h263_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'h263_tpu'))\n"
        "print(' '.join(mods))\n"
        "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    mods, bad = proc.stdout.strip().splitlines()
    mods = set(mods.split())
    assert len(mods) >= 30 and bad == "[]", proc.stdout
    # The single-stream slice's modules, the sharding, the examples and the
    # fuzz library are among those imported.
    assert {"h263_tpu_torch.decoder.state", "h263_tpu_torch.decoder.picture",
            "h263_tpu_torch.io.stream", "h263_tpu_torch.utils.checkpoint",
            "h263_tpu_torch.__main__", "h263_tpu_torch.parallel.sharding",
            "h263_tpu_torch.examples.decode_flv",
            "h263_tpu_torch.examples.batched_streams",
            "h263_tpu_torch.examples.serving_pool",
            "h263_tpu_torch.testing.fuzz"} <= mods, sorted(mods)


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_nothing_of_jax_or_the_jax_package(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                found.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            found.append(node.args[0].value)
    assert not found, f"{rel} imports {found}"


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script exits nonzero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (ROOT / "chip_smoke.py").read_bytes())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
