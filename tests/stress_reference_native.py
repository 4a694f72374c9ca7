"""Stress the JAX package's native build race as the tier-1 run meets it.

Each run copies the tree (the files git would commit, so with no native
build directory), makes `h263_tpu/native/tables.h` older than its source,
as a fresh checkout may leave it, and runs pytest in the copy with the
tier-1 options: `JAX_PLATFORMS=cpu`, `-m 'not slow' -n 6 --dist loadfile
-p no:randomly`. This file is also the pytest plugin of those runs: for
every xdist worker it logs whether the JAX package's library and fastcall
module had loaded once `tests/test_native.py` was collected (its `skipif`
builds and loads them at import), and after collection.

    python tests/stress_reference_native.py --runs 5 --out DIR
    python tests/stress_reference_native.py --runs 1 --out DIR tests/
    python tests/stress_reference_native.py --rev HEAD~1 --runs 2 --out DIR

With no paths it runs the files that use the JAX native library. `--rev`
copies a commit (`git archive`) in place of the working tree. It prints
one JSON object a run: the exit code, the junit counts, the skips of
`tests/test_native.py`, the first failures, and the workers' states. The
output of a run that fails is kept in `DIR/tree_*.log`.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NATIVE_FILES = [  # in the order pytest collects `tests/`
    "tests/before_test_native/test_torch_heal_first.py",
    "tests/test_device_frontend.py", "tests/test_native.py",
    "tests/test_parallel.py", "tests/test_robustness.py",
    "tests/test_torch_d24.py", "tests/test_torch_decoder.py",
    "tests/test_torch_fastcall.py", "tests/test_torch_native_entropy.py",
    "tests/test_torch_reference_native.py",
]
LOG_ENV = "STRESS_REFERENCE_NATIVE_LOG"

# -- the plugin, loaded in each pytest process by `-p` ------------------------

_seen = {}


def _state():
    from h263_tpu.native import bindings

    return [bindings.NATIVE_AVAILABLE, bindings._fastcall is not None]


def pytest_collectreport(report):
    if report.nodeid == "tests/test_native.py":
        _seen["after_test_native"] = _state()


def pytest_collection_finish(session):
    log = os.environ.get(LOG_ENV)
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if log and worker:
        with open(log, "a") as f:
            f.write(json.dumps({"worker": worker, **_seen,
                                "after_collection": _state()}) + "\n")


# -- the runs -----------------------------------------------------------------

def _copy_tree(dst, rev):
    if rev:
        archive = subprocess.run(["git", "archive", rev], cwd=ROOT, check=True,
                                 capture_output=True).stdout
        subprocess.run(["tar", "-xf", "-", "-C", str(dst)], input=archive,
                       check=True)
        return
    names = subprocess.run(
        ["git", "ls-files", "-co", "--exclude-standard", "-z"], cwd=ROOT,
        check=True, capture_output=True).stdout.split(b"\0")
    for name in filter(None, names):
        src = ROOT / os.fsdecode(name)
        if src.is_file():
            (dst / src.relative_to(ROOT)).parent.mkdir(parents=True,
                                                       exist_ok=True)
            shutil.copy2(src, dst / src.relative_to(ROOT))


def _junit(path):
    suite = ET.parse(path).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = {k: int(suite.get(k)) for k in ("tests", "errors", "failures",
                                        "skipped")}
    n["passed"] = n["tests"] - n["errors"] - n["failures"] - n["skipped"]
    failed, native_skipped = [], 0
    for case in suite.iter("testcase"):
        if case.find("failure") is not None or case.find("error") is not None:
            failed.append(f"{case.get('classname')}::{case.get('name')}")
        cls = case.get("classname", "")
        if (cls == "tests.test_native" or cls.startswith("tests.test_native.")
                ) and case.find("skipped") is not None:
            native_skipped += 1
    return n, native_skipped, failed


def run_once(out, rev, paths, timeout_s):
    tree = Path(tempfile.mkdtemp(prefix="tree_", dir=out))
    plugin = Path(tempfile.mkdtemp(prefix="plugin_", dir=out))
    shutil.copy2(__file__, plugin / "stress_reference_native.py")
    log, xml = tree.with_suffix(".workers"), tree.with_suffix(".xml")
    try:
        _copy_tree(tree, rev)
        for build in ("h263_tpu/native/build", "h263_tpu_torch/native/build",
                      "h263_tpu_torch/kernels/build"):
            shutil.rmtree(tree / build, ignore_errors=True)
        paths = [p for p in paths if (tree / p).exists()]
        later = time.time() + 1
        os.utime(tree / "h263_tpu" / "vlc_tables.py", (later, later))
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   ALLOW_MULTIPLE_LIBTPU_LOAD="1", PYTHONPATH=str(plugin),
                   **{LOG_ENV: str(log)})
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", *paths, "-q", "-m", "not slow",
             "-p", "no:cacheprovider", "-p", "xdist", "-n", "6", "--dist",
             "loadfile", "-p", "no:randomly", "-p", "stress_reference_native",
             f"--junitxml={xml}"],
            cwd=tree, env=env, capture_output=True, text=True,
            timeout=timeout_s)
        counts, native_skipped, failed = _junit(xml)
        if proc.returncode:
            out.joinpath(tree.name + ".log").write_text(proc.stdout)
        workers = [json.loads(line) for line in log.read_text().splitlines()]
        return {"rc": proc.returncode,
                "seconds": round(time.monotonic() - t0, 1), **counts,
                "test_native_skipped": native_skipped,
                "workers_not_loaded_after_test_native": sum(
                    w.get("after_test_native") != [True, True]
                    for w in workers),
                "workers_not_loaded_after_collection": sum(
                    w["after_collection"] != [True, True] for w in workers),
                "workers": len(workers), "failed": failed[:10]}
    finally:
        for p in (tree, plugin, log, xml):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            elif p.exists():
                p.unlink()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=NATIVE_FILES)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", required=True,
                    help="a directory for the copies (emptied after each run) "
                    "and the output of failed runs")
    ap.add_argument("--rev", help="copy this commit instead of the working "
                    "tree")
    ap.add_argument("--timeout", type=float, default=1470)
    args = ap.parse_args()
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    for k in range(args.runs):
        res = run_once(out, args.rev, args.paths, args.timeout)
        print(json.dumps({"run": k + 1, "rev": args.rev or "working tree",
                          **res}), flush=True)


if __name__ == "__main__":
    main()
