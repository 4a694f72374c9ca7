"""The synthetic streams `chip_smoke.py` decodes, and the digests that hold
its output against the reference decoder.

The streams are made from seeds with the port's own encoder, so the same
bytes come out on any machine.  `reference_sequences` names every stream
whose decoded planes and RGBA have a SHA-256 digest in
`testdata/reference_digests.json`; the digests are those of the JAX
package's numpy reference decoder (`tests/test_torch_digests.py` recomputes
the file from it and asserts that it is unchanged), with
`DecoderOption.NONE` for the standard streams (`is_standard`): `s{k}`,
`sq0`, `u0` and `d0`.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from ..io.flv import iter_flv_video_tags
from ..types import PictureTypeCode
from .encoder import (
    _STANDARD_FORMAT_BITS,
    BitWriter,
    MBSpec,
    encode_macroblock,
    encode_sorenson_picture,
    encode_standard_picture,
)

DIGESTS = Path(__file__).resolve().parent.parent / "testdata" / \
    "reference_digests.json"

CIF = (352, 288)
QCIF = (176, 144)
GOP = 8
CIF_SEED = 7        # corpus k of CIF is seeded CIF_SEED + k
QCIF_SEED = 100     # corpus k of QCIF is seeded QCIF_SEED + k
N_CIF_CORPORA = 16
N_QCIF_CORPORA = 4
STD_SEED = 300      # standard corpus k of CIF is seeded STD_SEED + k
N_STD_CORPORA = 16
STD_QCIF_SEED = 350  # sq0
UMV_SEED = 400      # u0
D3_SEED = 500       # d0


def build_corpus(width: int, height: int, n_frames: int, seed: int,
                 standard: bool = False):
    """One I-frame, then P-frames with mixed MVs, coefficients and uncoded
    macroblocks (the recipe of bench.py's build_corpus), in Sorenson
    pictures or, with `standard`, standard ones (plain PTYPE at a
    CIF-family size)."""
    encode = encode_standard_picture if standard else encode_sorenson_picture
    rng = np.random.default_rng(seed)
    mbw, mbh = -(-width // 16), -(-height // 16)
    mbs = []
    for _ in range(mbw * mbh):
        dc = int(rng.integers(1, 128)) * 8
        acs = [(int(rng.integers(0, 3)), int(rng.integers(1, 10)))
               for _ in range(int(rng.integers(1, 5)))]
        mbs.append(MBSpec(kind="intra", intradc=[dc] * 6,
                          blocks=[acs, [], [], [], [], []]))
    frames = [encode(
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
        frames.append(encode(
            width, height, PictureTypeCode.P_FRAME, mbs,
            temporal_reference=tr & 0xFF))
    return frames


def plusptype_picture(width: int, height: int, picture_type, mbs=(), *,
                      umv: bool = False, mq: bool = False, ufep: bool = True,
                      custom: bool = False, quantizer: int = 9,
                      temporal_reference: int = 5):
    """A standard picture with a PLUSPTYPE header, the recipe of the JAX
    package's tests (`tests/test_plusptype.py::_plusptype_header`,
    `tests/test_device_frontend.py::TestCarriedOptionsGate._plusptype_qcif`):
    UFEP 001 with an OPPTYPE whose source format is the standard code of a
    CIF-family size, else (or with `custom`) custom with CPFMT, and whose
    options set UMV
    (with UUI '1': the extended range) and MODIFIED_QUANTIZATION on
    request; or UFEP 000 (no OPPTYPE: the format and options carry from
    the stream's last picture).  `mbs` are coded after the header, their
    MVDs in table D.3 when `umv` (the PLUSPTYPE coding)."""
    fmt = None if custom else _STANDARD_FORMAT_BITS.get((width, height))
    w = BitWriter()
    w.write_bits(1, 17)                   # PSC
    w.write_bits(0, 5)                    # GN
    w.write_bits(temporal_reference & 0xFF, 8)
    w.write_code("10000")                 # PTYPE: '10' + no split/doc/freeze
    w.write_code("111")                   # source format 7 => PLUSPTYPE
    if ufep:
        w.write_code("001")               # UFEP: OPPTYPE present
        w.write_bits(6 if fmt is None else fmt, 3)   # 6: custom (CPFMT)
        w.write_bits(0, 1)                # custom PCF off
        w.write_bits(1 if umv else 0, 1)  # UMV (Annex D)
        w.write_bits(0, 8)                # SAC..AIV off
        w.write_bits(1 if mq else 0, 1)   # MODIFIED_QUANTIZATION
        w.write_code("1000")              # mandatory tail
    else:
        w.write_code("000")               # UFEP: no OPPTYPE
    w.write_code("000" if picture_type is PictureTypeCode.I_FRAME
                 else "001")              # MPPTYPE: I / P
    w.write_code("000")                   # rprp/rru/rounding off
    w.write_code("001")                   # mandatory tail
    w.write_bits(0, 1)                    # CPM off
    if ufep and fmt is None:
        # CPFMT: PAR=0001 (square), PWI, '1', PHI
        w.write_bits(0b0001, 4)
        w.write_bits(width // 4 - 1, 9)
        w.write_bits(1, 1)
        w.write_bits(height // 4, 9)
    if ufep and umv:
        w.write_bits(1, 1)                # UUI: '1' => extended range
    w.write_bits(quantizer, 5)            # PQUANT
    w.write_bits(0, 1)                    # PEI end
    for mb in mbs:
        encode_macroblock(w, mb, picture_type, None, umv_d3=umv)
    return w.to_bytes()


def _intra_mbs(rng, nmb):
    return [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6,
                   blocks=[[(int(rng.integers(0, 3)),
                             int(rng.integers(1, 10)))], [], [], [], [], []])
            for _ in range(nmb)]


def _inter_mbs(rng, nmb, reach):
    mbs = []
    for _ in range(nmb):
        if rng.random() < 0.2:
            mbs.append(MBSpec(kind="uncoded"))
            continue
        mvd = (int(rng.integers(-reach, reach + 1)),
               int(rng.integers(-reach, reach + 1)))
        acs = [(int(rng.integers(0, 4)), int(rng.integers(1, 8)))
               for _ in range(int(rng.integers(0, 4)))]
        mbs.append(MBSpec(kind="inter", mvd=[mvd],
                          blocks=[acs, [], [], [], [], []]))
    return mbs


def umv_corpus(width: int = 352, height: int = 288, n_frames: int = 8,
               seed: int = UMV_SEED):
    """A PLUSPTYPE I-picture whose OPPTYPE sets UMV, then plain-PTYPE
    P-frames: their own headers carry no UMV, so they decode under the
    carried option with the range rule of UMV without PLUSPTYPE (the
    automaton's ptype +8).  MVDs up to +-14 half-pels let predictions leave
    the picture."""
    rng = np.random.default_rng(seed)
    nmb = (-(-width // 16)) * (-(-height // 16))
    frames = [plusptype_picture(width, height, PictureTypeCode.I_FRAME,
                                _intra_mbs(rng, nmb), umv=True, quantizer=8,
                                temporal_reference=0)]
    for tr in range(1, n_frames):
        frames.append(encode_standard_picture(
            width, height, PictureTypeCode.P_FRAME,
            _inter_mbs(rng, nmb, 14), temporal_reference=tr))
    return frames


def d3_corpus(width: int = 176, height: int = 144, n_frames: int = 8,
              seed: int = D3_SEED):
    """PLUSPTYPE pictures throughout, every OPPTYPE setting UMV with the
    extended range: MVDs in table D.3 (the automaton's ptype +16 +32), up
    to +-40 half-pels."""
    rng = np.random.default_rng(seed)
    nmb = (-(-width // 16)) * (-(-height // 16))
    frames = [plusptype_picture(width, height, PictureTypeCode.I_FRAME,
                                _intra_mbs(rng, nmb), umv=True, quantizer=8,
                                temporal_reference=0)]
    for tr in range(1, n_frames):
        frames.append(plusptype_picture(
            width, height, PictureTypeCode.P_FRAME, _inter_mbs(rng, nmb, 40),
            umv=True, quantizer=8, temporal_reference=tr))
    return frames


def mq_picture(width: int = 352, height: int = 288, seed: int = 600):
    """A PLUSPTYPE I-picture whose OPPTYPE sets MODIFIED_QUANTIZATION, with
    coded macroblocks: the reference does not implement its MB layer, so
    the picture fails (UnimplementedDecoding) and decodes as the identity
    frame, and the option carries into the stream's later pictures."""
    rng = np.random.default_rng(seed)
    nmb = (-(-width // 16)) * (-(-height // 16))
    return plusptype_picture(width, height, PictureTypeCode.I_FRAME,
                             _intra_mbs(rng, nmb), mq=True, quantizer=8,
                             temporal_reference=0)


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


def std_corpus(k: int):
    return build_corpus(*CIF, GOP, seed=STD_SEED + k, standard=True)


def std_qcif_corpus():
    return build_corpus(*QCIF, GOP, seed=STD_QCIF_SEED, standard=True)


def is_standard(name: str) -> bool:
    """Whether the digest sequence `name` is standard H.263 (decoded with
    `DecoderOption.NONE`) rather than Sorenson."""
    return name[0] in "sud"


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
    for k in range(N_STD_CORPORA):
        seqs[f"s{k}"] = (*CIF, std_corpus(k))
    seqs["sq0"] = (*QCIF, std_qcif_corpus())
    seqs["u0"] = (*CIF, umv_corpus(*CIF, GOP))
    seqs["d0"] = (*QCIF, d3_corpus(*QCIF, GOP))
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
