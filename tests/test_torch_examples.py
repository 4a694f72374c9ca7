"""The port's example programs (`h263_tpu_torch/examples/`) run on the CPU
at a tiny size, each as `python -m h263_tpu_torch.examples.<name>` in a
subprocess: each checks its own output against the single-stream decoder
and exits 0.  (The device front-end pool takes ~40 s of plain automaton
here, so the pool runs with the host front-end; the card runs the device
one, tests/test_torch_gpu.py.)"""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("argv,says", [
    (["decode_flv", "--selftest"], "selftest OK: decoded 3 synthetic frames"),
    (["batched_streams", "--streams", "4", "--frames", "3", "--size",
      "64x48", "--shard"], "on 2 shards on 1 distinct device(s)"),
    (["serving_pool", "--steps", "8", "--frontend", "host"],
     "bit-exact against single-stream decoders"),
])
def test_example_runs_on_the_cpu(argv, says, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", f"h263_tpu_torch.examples.{argv[0]}",
         *argv[1:], "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert says in proc.stdout, proc.stdout
