"""The port's stream input (`h263_tpu_torch/io/stream.py`) against the JAX
package's: the frame segmenter yields the same pictures, bytes for bytes,
under random chunkings of the same streams (both flavours, garbage ahead
of the first start code, standard GOB headers that must not split a
picture), and `decode_stream` equals frame-by-frame decoding.
"""

import io

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu import DecoderOption as JOpt  # noqa: E402
from h263_tpu import H263Decoder as JaxDecoder  # noqa: E402
from h263_tpu.io import stream as jstream  # noqa: E402
from h263_tpu_torch import DecoderOption, H263Decoder  # noqa: E402
from h263_tpu_torch.io import stream as tstream  # noqa: E402
from h263_tpu_torch.testing import corpora as C  # noqa: E402

GOP = C.rich_gop(5, 48, 32, 5)
STD = C.std_qcif_corpus()[:3]
# A standard byte-aligned GOB header (GN 1): a resync point inside a
# picture, not a picture boundary.
GOB = b"\x00\x00\x84\x20"
STREAMS = {
    "sorenson": b"".join(GOP),
    "sorenson_garbage_ahead": b"\x13\x00\x07garbage" + b"".join(GOP),
    "standard_with_gob_headers": b"".join(f + GOB + b"\xaa" for f in STD),
}


def _segment(mod, blob, cuts, flavor):
    seg = mod.FrameSegmenter(flavor=flavor)
    got, pos = [], 0
    for cut in sorted(set(cuts)) + [len(blob)]:
        seg.feed(blob[pos:cut])
        pos = cut
        got.extend(seg.frames())
    got.extend(seg.finish())
    return got, seg.bytes_discarded, seg.buffered


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(name=st.sampled_from(sorted(STREAMS)),
       cuts=st.lists(st.integers(min_value=0, max_value=4000), max_size=24))
def test_segmenter_matches_jax_under_random_chunkings(name, cuts):
    blob = STREAMS[name]
    cuts = [c % (len(blob) + 1) for c in cuts]
    flavor = "standard" if name.startswith("standard") else "sorenson"
    got = _segment(tstream, blob, cuts, flavor)
    want = _segment(jstream, blob, cuts, flavor)
    assert got == want
    assert len(got[0]) == (len(STD) if flavor == "standard" else len(GOP))


@pytest.mark.parametrize("chunk", [1, 5, 333, 1 << 16])
def test_iter_stream_frames_matches_jax_from_a_file(chunk):
    blob = STREAMS["sorenson_garbage_ahead"]
    got = list(tstream.iter_stream_frames(io.BytesIO(blob), chunk))
    want = list(jstream.iter_stream_frames(io.BytesIO(blob), chunk))
    assert got == want and len(got) == len(GOP)


@pytest.mark.parametrize("flavor,frames", [("sorenson", GOP),
                                           ("standard", STD)])
def test_decode_stream_equals_frame_by_frame(flavor, frames):
    """Odd-sized chunks through the port's decode_stream, against the
    port's and the JAX decoder's frame-by-frame planes; the flavour comes
    from the decoder's options."""
    opts = (DecoderOption.SORENSON_SPARK_BITSTREAM if flavor == "sorenson"
            else DecoderOption.NONE)
    blob = b"".join(frames)
    chunks = [blob[i:i + 37] for i in range(0, len(blob), 37)]
    streamed = list(tstream.decode_stream(
        chunks, H263Decoder(opts, device="cpu")))
    one = H263Decoder(opts, device="cpu")
    ref = JaxDecoder(JOpt(int(opts)), backend="numpy")
    assert len(streamed) == len(frames)
    for pic, buf in zip(streamed, frames):
        want = one.decode_next_picture(buf).as_yuv()
        jax_want = ref.decode_next_picture(buf).as_yuv()
        for a, b, c in zip(pic.as_yuv(), want, jax_want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_segmenter_limits_and_flavors_match_jax():
    for mod in (tstream, jstream):
        with pytest.raises(ValueError):
            mod.FrameSegmenter(flavor="mpeg")
        seg = mod.FrameSegmenter(max_buffer=16)
        with pytest.raises(MemoryError):
            seg.feed(b"\x01" * 17)
    assert tstream._FLAVOR_MASKS == jstream._FLAVOR_MASKS
