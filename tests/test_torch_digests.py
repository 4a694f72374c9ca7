"""The reference digests that `chip_smoke.py` holds the port's output
against, recomputed from the JAX package's numpy reference decoder.

`h263_tpu_torch/testdata/reference_digests.json` holds, for every stream of
`h263_tpu_torch.testing.corpora.reference_sequences` and every frame, the
SHA-256 of the decoded planes and of the deblocked BT.601 RGBA (Sorenson
streams decoded as Sorenson Spark, the standard ones `s{k}`, `sq0`, `u0`
and `d0` with `DecoderOption.NONE`).  The card's machine has no JAX, so
chip_smoke reads this file instead of running the reference decoder; this
test keeps the file tied to the reference.

The numpy decoder takes ~0.5 s a CIF frame here (its motion compensation is
a Python loop per pixel), ~70 s for all 16 CIF corpora.  So a run recomputes
the fixture, the FMA sequence, c0, q0, s0, sq0, u0 and d0, and one more
CIF, QCIF and standard CIF corpus that change with the day: every corpus is
recomputed within 15 days, and chip_smoke holds the port against every one
on each run.  To recompute all of them, or write the file anew (after a
change to the corpora):

    python tests/test_torch_digests.py --check
    python tests/test_torch_digests.py --write
"""

import datetime
import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h263_tpu import DecoderOption, H263Decoder  # noqa: E402
from h263_tpu.ops.deblock import QUANT_TO_STRENGTH, golden_deblock  # noqa: E402
from h263_tpu.ops.yuv import golden_yuv420_to_rgba  # noqa: E402
from h263_tpu_torch.testing import corpora  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "ffmpeg_flv1_cif.flv"
NAMES = (["fixture", "fma"]
         + [f"c{k}" for k in range(corpora.N_CIF_CORPORA)]
         + [f"q{k}" for k in range(corpora.N_QCIF_CORPORA)]
         + [f"s{k}" for k in range(corpora.N_STD_CORPORA)]
         + ["sq0", "u0", "d0"])


def of_the_day(kind: str) -> str:
    """The CIF ("c"), QCIF ("q") or standard CIF ("s") corpus, other than
    the first, that today's run recomputes."""
    n = {"c": corpora.N_CIF_CORPORA, "q": corpora.N_QCIF_CORPORA,
         "s": corpora.N_STD_CORPORA}[kind]
    return f"{kind}{1 + datetime.date.today().toordinal() % (n - 1)}"


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
    return corpora.reference_sequences(FIXTURE)


@pytest.fixture(scope="module")
def committed():
    return corpora.load_digests()


def test_digest_file_names_every_sequence(sequences, committed):
    assert sorted(committed) == sorted(sequences) == sorted(NAMES)
    for name, (w, h, frames) in sequences.items():
        assert len(frames) == corpora.GOP, name


@pytest.mark.parametrize("name", ["fixture", "fma", "c0", "q0",
                                  "cif-of-the-day", "qcif-of-the-day",
                                  "s0", "sq0", "u0", "d0",
                                  "std-of-the-day"])
def test_digests_match_the_numpy_reference_decoder(name, sequences,
                                                   committed):
    if name.endswith("-of-the-day"):
        name = of_the_day(name[0])
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
    seqs = corpora.reference_sequences(FIXTURE)
    if argv[1] == "--check":
        committed = corpora.load_digests()
        bad = [name for name in NAMES
               if reference_digests(*seqs[name], corpora.is_standard(name))
               != committed.get(name)]
        print(f"{len(NAMES) - len(bad)} of {len(NAMES)} sequences match; "
              f"differ: {bad}")
        return 1 if bad else 0
    out = {"format": "sha256 of the numpy reference decoder's planes (y, cb,"
                     " cr with shapes) and deblocked BT.601 RGBA per frame",
           "sequences": {name: reference_digests(*seqs[name],
                                                 corpora.is_standard(name))
                         for name in NAMES}}
    corpora.DIGESTS.parent.mkdir(parents=True, exist_ok=True)
    corpora.DIGESTS.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {corpora.DIGESTS}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
