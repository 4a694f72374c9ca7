"""The synthetic streams `chip_smoke.py` decodes, and the digests that hold
its output against the reference decoder.

The streams are made from seeds with the port's own encoder, so the same
bytes come out on any machine.  `reference_sequences` names every stream
whose decoded planes and RGBA have a SHA-256 digest in
`testdata/reference_digests.json`; the digests are those of the JAX
package's numpy reference decoder (`tests/test_torch_digests.py` recomputes
the file from it and asserts that it is unchanged).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from ..io.flv import iter_flv_video_tags
from ..types import PictureTypeCode
from .encoder import MBSpec, encode_sorenson_picture

DIGESTS = Path(__file__).resolve().parent.parent / "testdata" / \
    "reference_digests.json"

CIF = (352, 288)
QCIF = (176, 144)
GOP = 8
CIF_SEED = 7        # corpus k of CIF is seeded CIF_SEED + k
QCIF_SEED = 100     # corpus k of QCIF is seeded QCIF_SEED + k
N_CIF_CORPORA = 16
N_QCIF_CORPORA = 4


def build_corpus(width: int, height: int, n_frames: int, seed: int):
    """One I-frame, then P-frames with mixed MVs, coefficients and uncoded
    macroblocks (the recipe of bench.py's build_corpus)."""
    rng = np.random.default_rng(seed)
    mbw, mbh = -(-width // 16), -(-height // 16)
    mbs = []
    for _ in range(mbw * mbh):
        dc = int(rng.integers(1, 128)) * 8
        acs = [(int(rng.integers(0, 3)), int(rng.integers(1, 10)))
               for _ in range(int(rng.integers(1, 5)))]
        mbs.append(MBSpec(kind="intra", intradc=[dc] * 6,
                          blocks=[acs, [], [], [], [], []]))
    frames = [encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME, mbs, temporal_reference=0)]
    for tr in range(1, n_frames):
        mbs = []
        for _ in range(mbw * mbh):
            if rng.random() < 0.2:
                mbs.append(MBSpec(kind="uncoded"))
                continue
            mvd = (int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
            acs = [(int(rng.integers(0, 4)), int(rng.integers(1, 8)))
                   for _ in range(int(rng.integers(0, 4)))]
            mbs.append(MBSpec(kind="inter", mvd=[mvd],
                              blocks=[acs, [], [], [], [], []]))
        frames.append(encode_sorenson_picture(
            width, height, PictureTypeCode.P_FRAME, mbs,
            temporal_reference=tr & 0xFF))
    return frames


def rich_gop(seed, width=48, height=32, n=5, version=1):
    """A GOP exercising intra/inter/uncoded/stuffing MBs, 4V, DQUANT,
    short + both escape widths, and zigzag-overflow discards (the recipe of
    the JAX package's tests/test_device_frontend.py::rich_gop)."""
    max_escape = 500 if version == 1 else 127
    rng = np.random.default_rng(seed)
    mbw, mbh = width // 16, height // 16
    nmb = mbw * mbh

    def intra_mb():
        dcs = [int(rng.integers(1, 128)) * 8 for _ in range(6)]
        if rng.random() < 0.2:
            dcs[0] = 1024
        blocks = [[], [], [], [], [], []]
        for b in range(6):
            if rng.random() < 0.5:
                evs = []
                for _ in range(int(rng.integers(1, 4))):
                    evs.append((int(rng.integers(0, 5)),
                                int(rng.integers(1, 7)) * (1 if rng.random() < .5 else -1)))
                blocks[b] = evs
        return MBSpec(kind="intra", intradc=dcs, blocks=blocks,
                      dquant=int(rng.integers(-2, 3)) if rng.random() < .3 else 0)

    frames = [encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME,
        [intra_mb() for _ in range(nmb)], temporal_reference=0,
        version=version, quantizer=int(rng.integers(2, 14)))]

    for tr in range(1, n):
        mbs = []
        for _ in range(nmb):
            roll = rng.random()
            if roll < 0.15:
                mbs.append(MBSpec(kind="uncoded"))
                continue
            if roll < 0.25:
                mbs.append(intra_mb())
                continue
            blocks = [[], [], [], [], [], []]
            for b in range(6):
                if rng.random() < 0.45:
                    evs = []
                    for _ in range(int(rng.integers(1, 4))):
                        lvl = int(rng.integers(1, 30))
                        if rng.random() < 0.25:
                            lvl = int(rng.integers(64, max_escape))  # escapes
                        evs.append((int(rng.integers(0, 9)),
                                    lvl * (1 if rng.random() < .5 else -1)))
                    blocks[b] = evs
            if rng.random() < 0.1:
                # Zigzag overflow: run past position 63 discards the block.
                blocks[0] = [(40, 3), (40, 5)]
            four_v = rng.random() < 0.25
            mvd = [(int(rng.integers(-12, 13)), int(rng.integers(-12, 13)))
                   for _ in range(4 if four_v else 1)]
            mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks,
                              dquant=int(rng.integers(-2, 3)) if rng.random() < .3 else 0))
        if rng.random() < 0.2:
            mbs.insert(int(rng.integers(0, nmb)), MBSpec(kind="stuffing"))
        frames.append(encode_sorenson_picture(
            width, height, PictureTypeCode.P_FRAME, mbs,
            temporal_reference=tr, version=version,
            quantizer=int(rng.integers(2, 14))))
    return frames


def fma_sequence(width: int, height: int, n_frames: int):
    """I-frame of DC 1024, then a P-frame whose first block holds
    {735, -555, 215} (pixel (0, 2) = 128 + 28 = 156 with strict f32
    rounding, 155 under FMA), then uncoded P-frames."""
    nmb = (-(-width // 16)) * (-(-height // 16))
    f0 = encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[1024] * 6)] * nmb,
        temporal_reference=0)
    f1 = encode_sorenson_picture(
        width, height, PictureTypeCode.P_FRAME,
        [MBSpec(kind="inter", mvd=[(0, 0)],
                blocks=[[(5, 73), (0, -55), (5, 21)], [], [], [], [], []])]
        + [MBSpec(kind="uncoded")] * (nmb - 1),
        quantizer=5, temporal_reference=1)
    rest = [encode_sorenson_picture(
        width, height, PictureTypeCode.P_FRAME,
        [MBSpec(kind="uncoded")] * nmb, quantizer=5,
        temporal_reference=tr) for tr in range(2, n_frames)]
    return [f0, f1] + rest


def cif_corpus(k: int):
    return build_corpus(*CIF, GOP, seed=CIF_SEED + k)


def qcif_corpus(k: int):
    return build_corpus(*QCIF, GOP, seed=QCIF_SEED + k)


def fixture_frames(flv_path) -> list:
    """The picture payloads of an FLV file."""
    return [t.payload for t in iter_flv_video_tags(Path(flv_path).read_bytes())]


def reference_sequences(cif_fixture_flv) -> dict:
    """{name: (width, height, frames)} of every stream with digests."""
    seqs = {"fixture": (*CIF, fixture_frames(cif_fixture_flv)[:GOP]),
            "fma": (*CIF, fma_sequence(*CIF, GOP))}
    for k in range(N_CIF_CORPORA):
        seqs[f"c{k}"] = (*CIF, cif_corpus(k))
    for k in range(N_QCIF_CORPORA):
        seqs[f"q{k}"] = (*QCIF, qcif_corpus(k))
    return seqs


def planes_digest(y, cb, cr) -> str:
    """SHA-256 over the shapes and bytes of one frame's uint8 planes."""
    h = hashlib.sha256()
    for a in (y, cb, cr):
        a = np.ascontiguousarray(a, dtype=np.uint8)
        h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


def rgba_digest(rgba) -> str:
    """SHA-256 over the shape and bytes of one uint8 [H, W, 4] picture."""
    a = np.ascontiguousarray(rgba, dtype=np.uint8)
    h = hashlib.sha256(np.asarray(a.shape, dtype=np.int64).tobytes())
    h.update(a.tobytes())
    return h.hexdigest()


def load_digests() -> dict:
    """{name: {"width", "height", "planes": [hex] * GOP, "rgba": [hex] *
    GOP}}: frame t's planes, and its RGBA deblocked at the strength of its
    own quantizer (`present_rgba(deblock=True)` after frame t)."""
    with open(DIGESTS) as fh:
        return json.load(fh)["sequences"]


def d24_rows(rng, S: int, K: int, mbh: int, mbw: int, mv_full=None):
    """uint8 rows of K hand-made delta24 entries each, over every edge of
    the unpack: leading entries at cursor -1 (dropped), entries that meet
    at one position (their values add modulo 2^16), value-0 escapes of the
    largest delta, values of both signs and a tail that walks past the
    last coefficient (dropped).  With `mv_full` (True or False) each row
    starts with random int8 MVs (8 or 2 B/MB) and INTER bits, as a fused
    row."""
    nmb = mbh * mbw
    delta = rng.choice([0, 1, 1, 1, 2, 3, 16, 383], size=(S, K))
    val = rng.integers(-2048, 2048, (S, K))
    val[rng.random((S, K)) < 0.1] = 0
    delta[:, :3] = 0                       # cursor -1: dropped
    escape = rng.random((S, K)) < 0.02
    delta[escape], val[escape] = 4095, 0
    delta[:, -K // 8:] = 4095              # past the last coefficient
    w = (delta << 12) | (val & 0xFFF)
    rows = np.stack([(w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF],
                    axis=-1).astype(np.uint8).reshape(S, 3 * K)
    if mv_full is None:
        return rows
    head = rng.integers(0, 256, (S, (8 if mv_full else 2) * nmb
                                 + (nmb + 7) // 8), dtype=np.uint8)
    return np.concatenate([head, rows], axis=1)
