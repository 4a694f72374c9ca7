"""The port's differential fuzz library (`h263_tpu_torch/testing/fuzz.py`)
against the JAX package's (`h263_tpu/testing/fuzz.py`), on the CPU.

* Every generator gives the JAX generator's bytes from the same
  `np.random.Generator` state, and leaves the generator in the same state
  (`_rand_umv_case` also an equal `Picture`; `_mutate` with a shared
  `other_frame`; the "fused" scenarios' streams, steps and masks).
* Each flavor's campaign with `device="cpu"` (the kernels' plain versions)
  at the JAX tests' seeds finds no mismatch, with the JAX campaign's total;
  per case, the host and d24 flavors' verdicts equal the JAX `_agree*`
  verdicts (`tests/test_torch_fuzz_device.py` does so for the automaton).
* A planted divergence is caught, so the harness can fail.
* The command line: `--device cpu`, and a refusal without CUDA.

Zero tolerance throughout.
"""

import collections
import dataclasses
import enum
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import h263_tpu.testing as jtesting  # noqa: E402
from h263_tpu.testing import fuzz as J  # noqa: E402
from h263_tpu.types import DecoderOption as JOpt  # noqa: E402
from h263_tpu.types import PictureOption as JRun  # noqa: E402
from h263_tpu_torch.native import bindings  # noqa: E402
from h263_tpu_torch.parser.device_frontend import ST_TAPE_OVERFLOW  # noqa: E402
from h263_tpu_torch.testing import fuzz as F  # noqa: E402
from h263_tpu_torch.types import DecoderOption as Opt  # noqa: E402
from h263_tpu_torch.types import (  # noqa: E402
    InvalidMvd,
    PictureOption,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _norm(x):
    """A value of either package as plain data: enums by name, dataclasses
    field by field."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def _both(fn_port, fn_jax, seed):
    """Each side's output from a fresh generator of `seed`, and whether
    both generators end in the same state."""
    rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    a, b = fn_port(rp), fn_jax(rj)
    return a, b, rp.bit_generator.state == rj.bit_generator.state


GENERATORS = {
    "frame_sorenson_96x80": (lambda r: F._rand_frame(r, 96, 80),
                             lambda r: J._rand_frame(r, 96, 80)),
    "frame_standard_128x96": (
        lambda r: F._rand_frame(r, 128, 96, "standard"),
        lambda r: J._rand_frame(r, 128, 96, "standard")),
    "frame_standard_cif": (
        lambda r: F._rand_frame(r, 352, 288, "standard"),
        lambda r: J._rand_frame(r, 352, 288, "standard")),
    "d24_96x80": (lambda r: F._rand_d24_frame(r, 96, 80),
                  lambda r: J._rand_d24_frame(r, 96, 80)),
    "d24_cif": (lambda r: F._rand_d24_frame(r, 352, 288),
                lambda r: J._rand_d24_frame(r, 352, 288)),
    "fused_gop_64x48": (lambda r: F._rand_fused_gop(r, 64, 48, 8),
                        lambda r: J._rand_fused_gop(r, 64, 48, 8)),
    "umv_case_96x80": (lambda r: F._rand_umv_case(r, 96, 80)[0],
                       lambda r: J._rand_umv_case(r, 96, 80)[0]),
}


@pytest.mark.parametrize("seed", [0, 1, 7, 2026])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_bytes_equal_jax(name, seed):
    a, b, same_state = _both(*GENERATORS[name], seed)
    assert a == b
    assert same_state


@pytest.mark.parametrize("seed", [0, 3, 17, 71])
def test_umv_case_picture_equal_jax(seed):
    (ba, pa), (bb, pb), same_state = _both(
        lambda r: F._rand_umv_case(r, 96, 80),
        lambda r: J._rand_umv_case(r, 96, 80), seed)
    assert ba == bb and same_state
    assert _norm(pa) == _norm(pb)


@pytest.mark.parametrize("seed", [0, 5, 9, 31, 123, 2026])
def test_mutate_equal_jax_with_a_shared_other_frame(seed):
    """Each mutation kind (flip, cut, splice, garbage tail), the splice
    taking the same other frame on both sides."""
    base = F._rand_frame(np.random.default_rng(seed), 96, 80)
    other = F._rand_d24_frame(np.random.default_rng(seed + 1), 96, 80)
    rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(40):
        assert F._mutate(rp, base, lambda: other) == J._mutate(
            rj, base, lambda: other)
    assert rp.bit_generator.state == rj.bit_generator.state


def _jax_fused_steps(monkeypatch, seed, n_base):
    """The JAX "fused" campaign with both of its decoders stubbed out (each
    step returns zero planes on both, so every step agrees): its total and
    the (frames, mask) of every step its fused decoder was given."""
    steps = []

    class Stub:
        def __init__(self, S, w, h, log):
            self.planes = (np.zeros((S, h, w), np.uint8),) + (
                np.zeros((S, (h + 1) // 2, (w + 1) // 2), np.uint8),) * 2
            self.log = log

        def decode_step(self, bufs, mask=None):
            self.log.append((list(bufs), mask))
            return self.planes

    monkeypatch.setattr(
        jtesting, "build_batched_decoder",
        lambda S, w, h, opts, *, fused, **kw: Stub(S, w, h,
                                                   steps if fused else []))
    total, fails = J.run_campaign(seed=seed, n_base=n_base, flavor="fused")
    assert fails == 0
    return total, steps


def test_fused_scenario_draws_equal_jax(monkeypatch):
    total, jax_steps = _jax_fused_steps(monkeypatch, 31, 8)
    rng = np.random.default_rng(31)
    steps = []
    for _ in range(8):
        w, h = F.FUSED_DIMS[int(rng.integers(0, len(F.FUSED_DIMS)))]
        S, T, gops, masks = F._fused_case(rng, w, h)
        steps += [([gops[s][t] for s in range(S)], masks[t])
                  for t in range(T)]
    assert len(steps) == total == len(jax_steps)
    assert steps == jax_steps


HOST_CAMPAIGNS = [
    ("sorenson", dict(seed=20260816, n_base=15)),
    ("standard", dict(seed=8, n_base=12)),
    ("umv", dict(seed=17, n_base=12)),
    ("d24", dict(seed=3, n_base=12)),
]


@pytest.mark.parametrize("flavor,kw", HOST_CAMPAIGNS,
                         ids=[f for f, _ in HOST_CAMPAIGNS])
def test_campaign_matches_jax(flavor, kw):
    """The JAX tests' seeds and budgets (tests/test_native.py)."""
    failures = []
    total, fails = F.run_campaign(
        flavor=flavor, device="cpu",
        on_fail=lambda tag, why: failures.append((tag, why)), **kw)
    jtotal, jfails = J.run_campaign(flavor=flavor, on_fail=lambda *a: None,
                                    **kw)
    assert fails == 0, failures[:5]
    assert jfails == 0
    assert total == jtotal == kw["n_base"] * 11


DEVICE_CAMPAIGNS = [
    ("device", dict(seed=11, n_base=8, mutations_per_base=5)),
    ("device_std", dict(seed=51, n_base=6, mutations_per_base=5)),
    ("device_umv", dict(seed=71, n_base=6, mutations_per_base=5)),
]


@pytest.mark.parametrize("flavor,kw", DEVICE_CAMPAIGNS,
                         ids=[f for f, _ in DEVICE_CAMPAIGNS])
def test_device_campaign_on_the_plain_automaton(flavor, kw):
    """The JAX tests' seeds and budgets (tests/test_device_frontend.py),
    every case one lane of one call of the plain automaton; the total is
    the one those tests assert of the JAX campaign."""
    failures = []
    notes = collections.Counter()
    total, fails = F.run_campaign(
        flavor=flavor, device="cpu", notes=notes,
        on_fail=lambda tag, why: failures.append((tag, why)), **kw)
    assert fails == 0, failures[:5]
    assert total == kw["n_base"] * (kw["mutations_per_base"] + 1)
    assert set(notes) <= {"header-reject"}


def test_fused_campaign_matches_jax_steps(monkeypatch):
    """The JAX test's seed (tests/test_native.py), its first scenario (96x64,
    8 steps): three decoders on the CPU, no mismatch, the JAX campaign's
    steps."""
    jtotal, _ = _jax_fused_steps(monkeypatch, 31, 1)
    failures = []
    total, fails = F.run_campaign(
        seed=31, n_base=1, flavor="fused", device="cpu",
        on_fail=lambda tag, why: failures.append((tag, why)))
    assert fails == 0, failures[:5]
    assert total == jtotal


def test_fused_scenario_refusals_the_device_front_end_lacks(monkeypatch):
    """The same seed's third scenario (48x48): a stream refused for want of
    a reference picture (the device front-end decodes it: "no-reference")
    and a corrupt header that declares other dims (InvalidBitstream in the
    native header parse, PictureFormatInvalid in the Python one:
    "header-dims"), with no mismatch and the JAX scenario's steps."""
    jtotal, _ = _jax_fused_steps(monkeypatch, 31, 3)
    rng = np.random.default_rng(31)
    steps = 0
    for _ in range(2):       # the draws of scenarios 0 and 1
        w, h = F.FUSED_DIMS[int(rng.integers(0, len(F.FUSED_DIMS)))]
        steps += F._fused_case(rng, w, h)[1]
    w, h = F.FUSED_DIMS[int(rng.integers(0, len(F.FUSED_DIMS)))]
    failures = []
    notes = collections.Counter()
    cases, fails = F._fused_scenario(
        rng, w, h, lambda tag, why: failures.append((tag, why)), CPU, notes)
    assert (w, h) == (48, 48)
    assert fails == 0, failures
    assert steps + cases == jtotal
    assert notes["no-reference"] > 0 and notes["header-dims"] > 0, notes


def _host_cases(flavor, seed, n_base=4, mutations=4):
    """(port case, JAX case) pairs of a host flavor, each side from its own
    generators: (buf, width, height, opts, running, pic)."""
    rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    w, h = (128, 96) if flavor == "standard" else (96, 80)
    out = []
    for _ in range(n_base):
        if flavor == "umv":
            pb, ppic = F._rand_umv_case(rp, w, h)
            jb, jpic = J._rand_umv_case(rj, w, h)
            prun = PictureOption.UNRESTRICTED_MOTION_VECTORS
            jrun = JRun.UNRESTRICTED_MOTION_VECTORS
            pmake = lambda: F._rand_umv_case(rp, w, h)[0]  # noqa: E731
            jmake = lambda: J._rand_umv_case(rj, w, h)[0]  # noqa: E731
            popt, jopt = Opt.NONE, JOpt.NONE
        else:
            fl = "standard" if flavor == "standard" else "sorenson"
            prun, jrun = PictureOption.NONE, JRun.NONE
            if flavor == "standard" and rp.random() < 0.5:
                prun = PictureOption.UNRESTRICTED_MOTION_VECTORS
            if flavor == "standard" and rj.random() < 0.5:
                jrun = JRun.UNRESTRICTED_MOTION_VECTORS
            gen = F._rand_d24_frame if flavor == "d24" else (
                lambda r, w, h, _f=fl: F._rand_frame(r, w, h, _f))
            jgen = J._rand_d24_frame if flavor == "d24" else (
                lambda r, w, h, _f=fl: J._rand_frame(r, w, h, _f))
            pb, jb, ppic, jpic = gen(rp, w, h), jgen(rj, w, h), None, None
            pmake = lambda: gen(rp, w, h)  # noqa: E731
            jmake = lambda: jgen(rj, w, h)  # noqa: E731
            popt = Opt.NONE if flavor == "standard" else \
                Opt.SORENSON_SPARK_BITSTREAM
            jopt = JOpt.NONE if flavor == "standard" else \
                JOpt.SORENSON_SPARK_BITSTREAM
        bufs = [(pb, jb)] + [(F._mutate(rp, pb, pmake),
                              J._mutate(rj, jb, jmake))
                             for _ in range(mutations)]
        out += [((a, w, h, popt, prun, ppic), (b, w, h, jopt, jrun, jpic))
                for a, b in bufs]
    return out


@pytest.mark.parametrize("flavor,seed", [("sorenson", 20260816), ("sorenson", 4),
                                         ("standard", 8), ("umv", 17),
                                         ("d24", 3), ("d24", 12)])
def test_case_verdicts_equal_jax(flavor, seed):
    """Per case, the port's `_agree` / `_agree_d24` verdict and error
    classes are the JAX one's."""
    for p, j in _host_cases(flavor, seed):
        assert p[0] == j[0]
        if flavor == "d24":
            got = F._agree_d24(p[0], p[1], p[2], device="cpu")
            want = J._agree_d24(j[0], j[1], j[2])
        else:
            got, want = F._agree(*p), J._agree(*j)
        assert got == want, (got, want)


def test_planted_divergence_is_caught(monkeypatch):
    """A native parse with one coefficient flipped: the campaign reports
    the mismatch with its tag."""
    real = bindings.parse_frame_native

    def flipped(*args, **kw):
        frame, end = real(*args, **kw)
        frame.coeffs_y.reshape(-1)[0] ^= 1
        return frame, end

    monkeypatch.setattr(bindings, "parse_frame_native", flipped)
    failures = []
    total, fails = F.run_campaign(
        seed=20260816, n_base=3, flavor="sorenson",
        on_fail=lambda tag, why: failures.append((tag, why)))
    assert total == 33 and fails > 0
    assert ("base[0]", "tensor coeffs_y differs") in failures


def test_planted_automaton_divergence_is_caught(monkeypatch):
    """An automaton call whose lanes all report InvalidMvd: every case the
    Python parser decodes, or fails with another class, is a mismatch."""
    real = F.launch_lanes

    def bad_status(*args, **kw):
        dense, mvs, inter, status = real(*args, **kw)
        return dense, mvs, inter, np.full_like(status, 4)   # ST_BAD_MVD

    monkeypatch.setattr(F, "launch_lanes", bad_status)
    failures = []
    total, fails = F.run_campaign(
        seed=11, n_base=2, mutations_per_base=2, flavor="device",
        device="cpu", on_fail=lambda tag, why: failures.append((tag, why)))
    assert total == 6 and fails > 0
    assert failures[0] == ("base[0]", "python=ok device_status=4")


def test_step_bound_is_a_mismatch_and_the_classes_map():
    ok, why = F.device_verdict((None, InvalidMvd), None, None, None,
                               ST_TAPE_OVERFLOW)
    assert not ok and "step bound" in why
    ok, why = F.device_verdict((None, InvalidMvd), None, None, None, 4)
    assert ok and why == "python=InvalidMvd device_status=4"


def test_device_checks_a_case_past_the_jax_transfer_bucket():
    """A frame with a 4 KB zero tail, past the JAX module's 4096-byte
    bucket (which it skipped): the port checks it, lane against parser."""
    buf = F._rand_d24_frame(np.random.default_rng(2), 96, 80) + bytes(4200)
    assert len(buf) > 4096 and J._agree_device(buf, 96, 80) == (True, "")
    payload, meta, preps = F.device_lanes(
        [(buf, Opt.SORENSON_SPARK_BITSTREAM, None, None)], 96, 80)
    assert preps[0] is not None and meta[1, 0] == 8 * len(buf)
    ok, why = F._agree_device(buf, 96, 80, device="cpu")
    assert ok and why == ("python=InvalidMacroblockHeader device_status=2")


def test_device_flavors_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for flavor in F.DEVICE_FLAVORS:
        with pytest.raises(RuntimeError, match="CUDA"):
            F.run_campaign(n_base=1, flavor=flavor)
    # The host flavors ignore `device`.
    assert F.run_campaign(n_base=1, mutations_per_base=1) == (2, 0)


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "h263_tpu_torch.testing.fuzz",
                           *argv], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_on_the_cpu():
    proc = _cli("0", "2", "sorenson", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        "fuzz campaign (sorenson): 22 cases, 0 mismatches"


def test_cli_device_flavor_needs_cuda_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = _cli("0", "2", "device")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "fuzz campaign" not in proc.stdout
    proc = _cli("0", "1", "device", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        "fuzz campaign (device): 11 cases, 0 mismatches"
