"""The port's automaton verdicts (`h263_tpu_torch.testing.fuzz.
_agree_device_batch`, the plain automaton on the CPU) against the JAX
package's `_agree_device` (its jitted automaton on the CPU, as its own
tests run it), case by case, for the three device flavors.

Every case list is drawn on both sides from the same seed, each with its
own generators, in the JAX campaign's order (bytes held equal).  All three
flavors run at 128x96 (a CIF-family size, which the standard flavor needs),
so the JAX side compiles its automaton once for the file (30-80 s on a
CPU).  The verdicts must be equal: (ok, "python=<class> device_status=<n>")
for every case whose header parses; a header the host rejects is out of
scope on both sides ((True, "") in the JAX module, (True, "header-reject")
in the port).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu.testing import fuzz as J  # noqa: E402
from h263_tpu.types import DecoderOption as JOpt  # noqa: E402
from h263_tpu.types import PictureOption as JRun  # noqa: E402
from h263_tpu_torch.testing import fuzz as F  # noqa: E402

W, H = 128, 96
CPU = torch.device("cpu")


def _jax_std_gen(rng):
    """The JAX campaign's device_std generator (run_campaign), JAX types."""
    run = (JRun.UNRESTRICTED_MOTION_VECTORS if rng.random() < 0.5
           else JRun.NONE)
    if rng.random() < 0.25:
        run |= JRun.MODIFIED_QUANTIZATION
    buf = J._rand_frame(rng, W, H, flavor="standard")
    if rng.random() < 0.4:
        gn = int(rng.choice([0, 15, 1, 5, 14]))
        code = bytes([0, 0, 0x80 | (gn << 2) | int(rng.integers(0, 4))])
        if rng.random() < 0.3:
            code = b"\x00" + code
        at = int(rng.integers(6, max(7, len(buf))))
        buf = buf[:at] + code + buf[at:]
    return buf, JOpt.NONE, run, None


def _jax_umv_gen(rng):
    buf, pic = J._rand_umv_case(rng, W, H)
    return buf, JOpt.NONE, JRun.UNRESTRICTED_MOTION_VECTORS, pic


JAX_GENS = {
    "device": lambda rng: (J._rand_d24_frame(rng, W, H),
                           JOpt.SORENSON_SPARK_BITSTREAM, None, None),
    "device_std": _jax_std_gen,
    "device_umv": _jax_umv_gen,
}


def _jax_cases(flavor, seed, n_base, mutations):
    """The JAX campaign's cases: per base, the base then its mutants, which
    keep the base's header context."""
    rng = np.random.default_rng(seed)
    gen = JAX_GENS[flavor]
    cases = []
    for _ in range(n_base):
        base = gen(rng)
        cases.append(base)
        for _ in range(mutations):
            cases.append((J._mutate(rng, base[0], lambda: gen(rng)[0]),
                          *base[1:]))
    return cases


@pytest.mark.parametrize("flavor,seed", [("device", 11), ("device", 12),
                                         ("device_std", 51),
                                         ("device_std", 52),
                                         ("device_umv", 71)])
def test_device_verdicts_equal_jax(flavor, seed):
    n_base, mutations = 3, 4
    cases = F._cases_for(flavor, np.random.default_rng(seed), n_base,
                         mutations, W, H)
    jcases = _jax_cases(flavor, seed, n_base, mutations)
    assert [c[0] for c in cases] == [c[0] for c in jcases]
    got = F._agree_device_batch(cases, W, H, CPU)
    for k, ((buf, opts, run, pic), v) in enumerate(zip(jcases, got)):
        want = J._agree_device(buf, W, H, opts, running=run, pic=pic)
        if v == (True, "header-reject"):
            assert want == (True, ""), (k, want)
        elif want == (True, "overflow-skip"):
            assert v[0], (k, v)      # a JAX tape limit; the port checks it
        else:
            assert v == want, (k, v, want)
