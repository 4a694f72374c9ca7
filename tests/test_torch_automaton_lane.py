"""The CUDA automaton's own source, checked on the CPU.

`h263_tpu_torch/csrc/automaton_lane.cuh` is the per-lane body the CUDA
kernel runs.  Built here by g++ through a small C++ host loop
(tests/automaton_lane_host.cpp, no torch headers) and loaded with ctypes,
it is held against the JAX package's parse_frames_device + assemble on the
corpora of tests/test_torch_device_frontend.py.  This tests the kernel's
source; it is not a CPU path of the port.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu.parser import device_frontend as df  # noqa: E402
from h263_tpu.parser.mvpred import _extended_range_for_dim  # noqa: E402
from h263_tpu_torch.parser.automaton_cuda import TABLES  # noqa: E402
import test_torch_device_frontend as corpora  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
HOST_SRC = HERE / "automaton_lane_host.cpp"


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("lane") / "liblane.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-o", str(so), str(HOST_SRC)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.h263_automaton_host.argtypes = [P, ctypes.c_int64, P, I, I, I, I, I,
                                        P, P, P, P, P]
    lib.h263_automaton_host.restype = I
    return lib


def run_lane(lib, cases, width, height):
    mbh, mbw = -(-height // 16), -(-width // 16)
    payload, meta = corpora.ragged_inputs(cases)
    S, nmb = meta.shape[1], mbh * mbw
    dense = np.zeros((S, 6 * nmb, 64), np.int16)
    mvs = np.zeros((S, mbh, mbw, 4, 2), np.int16)
    inter = np.ones((S, mbh, mbw), np.uint8)
    status = np.zeros(S, np.int32)
    rc = lib.h263_automaton_host(
        payload.ctypes.data, payload.nbytes, meta.ctypes.data, S, mbh, mbw,
        _extended_range_for_dim(width, True),
        _extended_range_for_dim(height, False), TABLES.ctypes.data,
        dense.ctypes.data, mvs.ctypes.data, inter.ctypes.data,
        status.ctypes.data)
    assert rc == 0
    return dense, mvs, inter.astype(bool), status


def assert_lane_matches_jax(lib, cases, width, height):
    cases = corpora.jax_scope(cases)
    want = corpora.run_jax(cases, width, height)
    got = run_lane(lib, cases, width, height)
    for name, a, b in zip(("dense", "mvs", "inter", "status"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert not (got[3] == df.ST_TAPE_OVERFLOW).any()
    return got[3]


def test_rich_gops(lane_lib):
    status = assert_lane_matches_jax(
        lane_lib, corpora.rich_cases() + corpora.corrupt_cases(), 48, 32)
    assert (status == 0).any() and (status != 0).any()


def test_standard_h263(lane_lib):
    assert_lane_matches_jax(lane_lib, corpora.standard_cases(), 128, 96)


def test_umv_plusptype(lane_lib):
    assert_lane_matches_jax(lane_lib, corpora.umv_cases(), 176, 144)


@pytest.mark.parametrize("flavor,seed", [
    ("device", 12), ("device_std", 52), ("device_umv", 72)])
def test_fuzz_corpus(lane_lib, flavor, seed):
    cases, w, h = corpora.fuzz_cases(flavor, seed)
    assert_lane_matches_jax(lane_lib, cases, w, h)


def test_lane_matches_the_plain_port_at_cif(lane_lib):
    """At the main path's size (CIF: a 22-macroblock MV ring), the lane body
    and the port's plain automaton agree on a P-frame and two cuts."""
    from h263_tpu_torch.testing.corpora import build_corpus

    p = build_corpus(352, 288, 2, seed=3)[1]
    cases = [corpora.header_case(b) for b in (p, p[:60], p[:700])]
    got = run_lane(lane_lib, cases, 352, 288)
    want = corpora.run_port(cases, 352, 288)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[3][0] == 0
