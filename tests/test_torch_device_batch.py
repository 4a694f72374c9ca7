"""The port's DeviceFrontendDecoder (device="cpu") vs the JAX package's,
step for step: planes, statuses, error classes and RGBA, exactly."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu import DecoderOption, H263Decoder  # noqa: E402
from h263_tpu.io.flv import iter_flv_video_tags  # noqa: E402
from h263_tpu.parallel.device_batch import (  # noqa: E402
    DeviceFrontendDecoder as JaxDecoder,
)
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu_torch import DeviceFrontendDecoder  # noqa: E402
from h263_tpu_torch.types import H263Error  # noqa: E402
from test_device_frontend import rich_gop  # noqa: E402

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"


def _step_both(jd, td, bufs, mask=None):
    """One decode_step on both decoders; returns (planes_jax, planes_port,
    error class name or None) after asserting both raised alike."""
    errs = []
    for dec in (jd, td):
        try:
            dec.decode_step(bufs, mask=mask)
            errs.append(None)
        except (JaxH263Error, H263Error) as e:
            errs.append(type(e).__name__)
    assert errs[0] == errs[1]
    pj = [np.asarray(p) for p in (jd.ref_y, jd.ref_cb, jd.ref_cr)]
    pt = [p.numpy() for p in (td.ref_y, td.ref_cb, td.ref_cr)]
    return pj, pt, errs[0]


def _assert_planes(pj, pt, tag):
    for name, a, b in zip(("y", "cb", "cr"), pt, pj):
        np.testing.assert_array_equal(a, b, err_msg=f"{tag} {name}")


def test_gop_with_absent_overcap_and_corrupt_lanes():
    S, T = 6, 4
    streams = [rich_gop(100 + i, n=T) for i in range(S)]
    jd = JaxDecoder(S, 48, 32, SORENSON)
    td = DeviceFrontendDecoder(S, 48, 32, SORENSON, device="cpu")
    raised = []
    for t in range(T):
        bufs = [streams[i][t] for i in range(S)]
        mask = None
        if t == 1:
            bufs[1] = None                           # absent lane
            bufs[4] = bufs[4][:14]                   # cut in the block layer
        if t == 2:
            bufs[2] = bufs[2] + b"\x00" * 9000       # over the transfer cap
            mask = [True] * S
            mask[5] = False                          # masked-off lane
        pj, pt, err = _step_both(jd, td, bufs, mask)
        raised.append(err)
        _assert_planes(pj, pt, f"t={t}")
        np.testing.assert_array_equal(td.fetch_status(), jd.fetch_status())
        np.testing.assert_array_equal(td._last_quant, jd._last_quant)
        if t == 1:
            assert td.fetch_status()[4] != 0         # isolated to its lane
            assert (np.delete(td.fetch_status(), 4) == 0).all()
    assert raised[2] == "H263Error"  # the over-cap frame, after dispatch
    for deblock in (True, None):
        np.testing.assert_array_equal(
            td.present_rgba(deblock=deblock).numpy(),
            np.asarray(jd.present_rgba(deblock=deblock)))


def test_header_reject_raises_after_dispatch_and_lane_keeps_planes():
    S = 3
    streams = [rich_gop(300 + i, n=2) for i in range(S)]
    td = DeviceFrontendDecoder(S, 48, 32, SORENSON, device="cpu")
    y0 = td.decode_step([s[0] for s in streams])[0].numpy().copy()
    bad = [streams[0][1], b"\x00\x01garbage", streams[2][1]]
    with pytest.raises(H263Error):
        td.decode_step(bad)
    y1 = td.ref_y.numpy()
    np.testing.assert_array_equal(y1[1], y0[1])     # identity frame
    assert not np.array_equal(y1[0], y0[0])          # neighbours decoded


def test_load_state_continues_a_gop_mid_way():
    S, T, k = 4, 5, 2
    streams = [rich_gop(700 + i, n=T) for i in range(S)]
    jd = JaxDecoder(S, 48, 32, SORENSON)
    for t in range(k):
        jd.decode_step([s[t] for s in streams])
    td = DeviceFrontendDecoder(S, 48, 32, SORENSON, device="cpu")
    td.load_state(np.asarray(jd.ref_y), np.asarray(jd.ref_cb),
                  np.asarray(jd.ref_cr), jd._last_quant, jd._last_deblock)
    for t in range(k, T):
        pj, pt, _ = _step_both(jd, td, [s[t] for s in streams])
        _assert_planes(pj, pt, f"t={t}")
    np.testing.assert_array_equal(td.present_rgba(deblock=True).numpy(),
                                  np.asarray(jd.present_rgba(deblock=True)))
    with pytest.raises(ValueError):
        td.load_state(np.zeros((S, 8, 8), np.uint8), np.asarray(jd.ref_cb),
                      np.asarray(jd.ref_cr))


def test_reset_slot_state_clears_one_lane():
    S = 2
    streams = [rich_gop(40 + i, n=2) for i in range(S)]
    td = DeviceFrontendDecoder(S, 48, 32, SORENSON, device="cpu")
    y, _, _ = td.decode_step([s[0] for s in streams])
    kept = y.numpy().copy()
    td.reset_slot_state(1)
    assert (td.ref_y[1] == 0).all() and (td.ref_cb[1] == 0).all()
    np.testing.assert_array_equal(td.ref_y[0].numpy(), kept[0])
    np.testing.assert_array_equal(y.numpy(), kept)   # returned planes kept
    assert td._last_quant[1] == 8 and td.fetch_status()[1] == 0


def test_qcif_fixture_matches_numpy_decoder_and_golden():
    """The ffmpeg QCIF fixture through the port: equal to the numpy
    reference decoder exactly, and to ffmpeg's golden luma within the
    repo's documented tolerance (tests/test_real_corpus.py: |dY| <= 1,
    >= 98% exact).  The I-frame and the first P-frames keep it short."""
    tags = [t.payload for t in iter_flv_video_tags(
        (FIX / "ffmpeg_flv1_qcif.flv").read_bytes())]
    golden = np.load(FIX / "ffmpeg_flv1_qcif_golden.npz")["luma"]
    td = DeviceFrontendDecoder(2, 176, 144, SORENSON, device="cpu")
    ref = H263Decoder(SORENSON, backend="numpy")
    for t, payload in enumerate(tags[:3]):
        y, cb, cr = td.decode_step([payload, None if t % 2 else payload])
        pic = ref.decode_next_picture(payload)
        assert (td.fetch_status() == 0).all()
        for a, b in zip((y, cb, cr), pic.as_yuv()):
            np.testing.assert_array_equal(a[0].numpy(), b,
                                          err_msg=f"frame {t}")
        d = np.abs(y[0].numpy().astype(np.int32) - golden[t])
        assert d.max() <= 1 and (d == 0).mean() >= 0.98, f"frame {t}"


def test_port_imports_no_jax():
    """The port runs in a process that never imports JAX or the JAX
    package."""
    code = (
        "import sys, numpy as np\n"
        "from h263_tpu_torch import DeviceFrontendDecoder\n"
        "from h263_tpu_torch.testing.encoder import MBSpec, "
        "encode_sorenson_picture\n"
        "from h263_tpu_torch.types import PictureTypeCode\n"
        "f = encode_sorenson_picture(32, 32, PictureTypeCode.I_FRAME,\n"
        "    [MBSpec(kind='intra', intradc=[64] * 6)] * 4,\n"
        "    temporal_reference=0)\n"
        "d = DeviceFrontendDecoder(2, 32, 32, device='cpu')\n"
        "y, cb, cr = d.decode_step([f, None])\n"
        "d.present_rgba()\n"
        "assert int(y[0, 0, 0]) == 8, int(y[0, 0, 0])   # DC 64 -> 8\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'h263_tpu' not in sys.modules, 'h263_tpu was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFrontendDecoder(2, 48, 32, device="cuda")
    # A standard decoder has no window (its headers chain on the host).
    with pytest.raises(ValueError):
        DeviceFrontendDecoder(2, 48, 32, DecoderOption.NONE,
                              device="cpu").decode_steps([[None, None]])
