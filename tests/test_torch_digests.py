"""The reference digests that `chip_smoke.py` holds the port's output
against, recomputed from the JAX package's numpy reference decoder.

`h263_tpu_torch/testdata/reference_digests.json` holds, for every stream of
`h263_tpu_torch.testing.corpora.reference_sequences` and every frame, the
SHA-256 of the decoded planes and of the deblocked BT.601 RGBA (Sorenson
streams decoded as Sorenson Spark, the standard ones `s{k}`, `sq0`, `u0`
and `d0` with `DecoderOption.NONE`).  The streams: 41 of 8 frames (the CIF
fixture's first 8, FMA, the corpora), the 60-frame soak chains `soak48`
(48x48), `soak_cif_a` and `soak_cif_b` (CIF), and every frame of the 13
ffmpeg fixtures as `ff_<name>` (QCIF to 1408x1152, up to 120 frames).  The
card's machine has no JAX, so chip_smoke reads this file instead of running
the reference decoder; this test keeps the file tied to the reference.

The numpy decoder takes ~0.2 s a QCIF frame here, ~0.5-0.9 s a CIF frame
of the corpora and 1.4 s one of a CIF soak chain (its motion compensation
is a Python loop per pixel), 3.5 s a 1280x720 frame and 5.8 s a 1408x1152
frame.  So a run recomputes the fixture, the FMA sequence, c0, q0, s0,
sq0, u0, d0 and soak48, and one more CIF, QCIF and standard CIF corpus and
one ffmpeg fixture or CIF soak chain that change with the day
(`of_the_day`): every sequence is recomputed within 15 days, and
chip_smoke holds the port against every one on each run.  To recompute all
of them (~10 min), or write the file anew (after a change to the corpora):

    python tests/test_torch_digests.py --check
    python tests/test_torch_digests.py --write
"""

import datetime
import json
import pathlib
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h263_tpu import DecoderOption, H263Decoder  # noqa: E402
from h263_tpu.ops.deblock import QUANT_TO_STRENGTH, golden_deblock  # noqa: E402
from h263_tpu.ops.yuv import golden_yuv420_to_rgba  # noqa: E402
from h263_tpu_torch.testing import corpora  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"
# The sequences of each kind that rotate with the day.
ROTATIONS = {
    "c": [f"c{k}" for k in range(1, corpora.N_CIF_CORPORA)],
    "q": [f"q{k}" for k in range(1, corpora.N_QCIF_CORPORA)],
    "s": [f"s{k}" for k in range(1, corpora.N_STD_CORPORA)],
    # The ffmpeg fixtures and the CIF soak chains share one rotation: a
    # CIF soak chain alone costs ~85 s here (1.4 s a frame), a fixture
    # 2-30 s, so a run recomputes one of the 15.
    "long": ([f"ff_{name}" for name in corpora.FIXTURE_DIMS]
             + list(corpora.SOAK_CIF_SEEDS)),
}
NAMES = (["fixture", "fma"]
         + [f"c{k}" for k in range(corpora.N_CIF_CORPORA)]
         + [f"q{k}" for k in range(corpora.N_QCIF_CORPORA)]
         + [f"s{k}" for k in range(corpora.N_STD_CORPORA)]
         + ["sq0", "u0", "d0", "soak48"] + list(corpora.SOAK_CIF_SEEDS)
         + [f"ff_{name}" for name in corpora.FIXTURE_DIMS])


def of_the_day(kind: str) -> str:
    """The sequence of `kind` (a key of `ROTATIONS`) that today's run
    recomputes."""
    names = ROTATIONS[kind]
    return names[datetime.date.today().toordinal() % len(names)]


def reference_digests(width, height, frames, standard=False) -> dict:
    """Digests of one stream through the numpy reference decoder: planes
    per frame, and RGBA deblocked at the frame's own strength."""
    dec = H263Decoder(DecoderOption.NONE if standard
                      else DecoderOption.SORENSON_SPARK_BITSTREAM,
                      backend="numpy")
    planes, rgba = [], []
    for f in frames:
        pic = dec.decode_next_picture(f)
        yuv = [np.asarray(a) for a in pic.as_yuv()]
        planes.append(corpora.planes_digest(*yuv))
        strength = int(QUANT_TO_STRENGTH[pic.as_header().quantizer & 31])
        if strength > 0:
            yuv = [golden_deblock(a, strength) for a in yuv]
        rgba.append(corpora.rgba_digest(golden_yuv420_to_rgba(*yuv)))
    return {"width": width, "height": height, "planes": planes,
            "rgba": rgba}


@pytest.fixture(scope="module")
def sequences():
    return corpora.reference_sequences(FIXTURES)


@pytest.fixture(scope="module")
def committed():
    return corpora.load_digests()


def test_digest_file_names_every_sequence(sequences, committed):
    assert sorted(committed) == sorted(sequences) == sorted(NAMES)
    for name, (w, h, frames) in sequences.items():
        want = (len(frames) if name.startswith("ff_") else
                corpora.SOAK_FRAMES if name.startswith("soak") else
                corpora.GOP)
        assert len(frames) == want, name
        assert (committed[name]["width"], committed[name]["height"]) == \
            (w, h), name
        assert len(committed[name]["planes"]) == len(
            committed[name]["rgba"]) == want, name
    assert len(sequences["ff_longgop"][2]) == 120
    assert sequences["ff_cif16"][:2] == (1408, 1152)


# id -> the sequence, or the kind of ROTATIONS whose sequence of the day.
CASES = {"fixture": "fixture", "fma": "fma", "c0": "c0", "q0": "q0",
         "cif-of-the-day": "c", "qcif-of-the-day": "q", "s0": "s0",
         "sq0": "sq0", "u0": "u0", "d0": "d0", "std-of-the-day": "s",
         "soak48": "soak48", "long-of-the-day": "long"}


@pytest.mark.parametrize("name", list(CASES))
def test_digests_match_the_numpy_reference_decoder(name, sequences,
                                                   committed):
    name = of_the_day(CASES[name]) if name.endswith("-of-the-day") \
        else CASES[name]
    w, h, frames = sequences[name]
    assert reference_digests(w, h, frames, corpora.is_standard(name)) == \
        committed[name], name


def test_digests_change_with_one_pixel():
    y = np.zeros((4, 6), np.uint8)
    c = np.zeros((2, 3), np.uint8)
    d0 = corpora.planes_digest(y, c, c)
    y[3, 5] = 1
    assert corpora.planes_digest(y, c, c) != d0
    assert corpora.planes_digest(y.T.copy(), c, c) != corpora.planes_digest(
        y, c, c)


def main(argv) -> int:
    if argv[1:] not in (["--write"], ["--check"]):
        print(__doc__)
        return 2
    seqs = corpora.reference_sequences(FIXTURES)
    t0 = time.perf_counter()
    made = {}
    for name in NAMES:
        made[name] = reference_digests(*seqs[name], corpora.is_standard(name))
        print(f"{name}: {len(seqs[name][2])} frames, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if argv[1] == "--check":
        committed = corpora.load_digests()
        bad = [name for name in NAMES if made[name] != committed.get(name)]
        print(f"{len(NAMES) - len(bad)} of {len(NAMES)} sequences match; "
              f"differ: {bad}")
        return 1 if bad else 0
    out = {"format": "sha256 of the numpy reference decoder's planes (y, cb,"
                     " cr with shapes) and deblocked BT.601 RGBA per frame",
           "sequences": made}
    corpora.DIGESTS.parent.mkdir(parents=True, exist_ok=True)
    corpora.DIGESTS.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {corpora.DIGESTS}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
