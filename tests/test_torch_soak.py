"""Long-GOP drift soak through every path of the port: a 60-frame P-chain
amplifies any one-LSB divergence, since every frame is the next frame's
prediction.  The port of tests/test_soak.py.

The stream is `corpora.soak_gop(42)` (48x48, byte-equal to the JAX soak's
`_rich_gop(42)`, held in test_torch_tables.py): intra macroblocks in
P-frames, 4V, DQUANT churn, escapes, uncoded gaps.  Every path of the port
decodes it on `device="cpu"`, which runs the kernels' plain versions, and
every frame's luma, Cb and Cr must equal the JAX numpy reference decoder's
on the same bytes, with zero tolerance, and the `soak48` reference digests:

- `H263Decoder`;
- `BatchedStreamDecoder`, on the packed (fused d24) and on the dense
  transport;
- `DeviceFrontendDecoder` as windows of 8 (60 = 7 * 8 + 4: the last window
  is not aligned to the GOP) and as steps;
- `StreamPool(frontend="device")`.

The plain automaton costs ~1 s a call here, whatever the lane count, so the
device front-end's paths share one memo of its results per lane (`LaneMemo`):
the automaton is a function of the lane's payload words and meta alone,
both in the key, so a lane that another path has parsed is looked up and
any lane whose prep differs in one bit is parsed anew.  The windows run
first and parse every frame; the steps and the pool then reuse them.

Also the port of `test_presentation_drift`: after 20 frames of
`soak_gop(7)`, the RGBA of each path (deblock forced on, forced off) equals
the numpy decoder's `last_picture_rgba`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu import DecoderOption as JOpt  # noqa: E402
from h263_tpu import H263Decoder as JaxDecoder  # noqa: E402
from h263_tpu_torch import (  # noqa: E402
    BatchedStreamDecoder,
    DecoderOption,
    DeviceFrontendDecoder,
    H263Decoder,
    StreamPool,
)
from h263_tpu_torch.parser import automaton_cuda  # noqa: E402
from h263_tpu_torch.testing import corpora  # noqa: E402

SOR = DecoderOption.SORENSON_SPARK_BITSTREAM
W = H = 48
WINDOW = 8
PATHS = ("single", "batched-packed", "batched-dense", "device-windows",
         "device-steps", "pool-device")


class LaneMemo:
    """Stands in for the plain automaton (`device_frontend.parse_assemble`,
    as `automaton_cuda` calls it on a CPU tensor): each lane's outputs are
    kept under the key (its payload words, its meta rows 0-4, the picture's
    dims), and only lanes not yet seen are parsed, in one call."""

    def __init__(self, fn):
        self.fn, self.outs, self.parsed = fn, {}, 0

    def __call__(self, payload_u8, meta, *, mbh, mbw, width=None,
                 height=None):
        words = payload_u8.reshape(-1, 4).numpy()
        keys = []
        for lane in meta.t().tolist():
            start, nbits, quant, ptype, v1, base = lane
            end = base + (nbits + 31) // 32
            assert end <= len(words), "a lane's words past the payload"
            keys.append((words[base:end].tobytes(), start, nbits, quant,
                         ptype, v1, mbh, mbw, width, height))
        todo = sorted({i for i, k in enumerate(keys) if k not in self.outs})
        if todo:
            out = self.fn(payload_u8, meta[:, todo].contiguous(), mbh=mbh,
                          mbw=mbw, width=width, height=height)
            for j, i in enumerate(todo):
                self.outs[keys[i]] = tuple(t[j] for t in out)
            self.parsed += len(todo)
        return tuple(torch.stack([self.outs[k][n] for k in keys])
                     for n in range(4))


@pytest.fixture(scope="module")
def memo():
    m = LaneMemo(automaton_cuda.parse_assemble)
    mp = pytest.MonkeyPatch()
    mp.setattr(automaton_cuda, "parse_assemble", m)
    yield m
    mp.undo()


@pytest.fixture(scope="module")
def frames():
    return corpora.soak_gop(corpora.SOAK_SEED)


@pytest.fixture(scope="module")
def reference(frames):
    """The JAX numpy decoder's (y, cb, cr) of every frame."""
    dec = JaxDecoder(JOpt.SORENSON_SPARK_BITSTREAM, backend="numpy")
    out = []
    for buf in frames:
        pic = dec.decode_next_picture(buf)
        out.append(tuple(np.asarray(a) for a in pic.as_yuv()))
    return out


def decode_path(path, frames):
    """Every frame's (y, cb, cr) as numpy through one path of the port, and
    the object that holds its last frame (for the RGBA)."""
    if path == "single":
        dec = H263Decoder(SOR, device="cpu")
        return [tuple(np.asarray(a) for a in
                      dec.decode_next_picture(buf).as_yuv())
                for buf in frames], dec
    if path.startswith("batched"):
        dec = BatchedStreamDecoder(1, W, H, device="cpu")
        transport = "dense" if path.endswith("dense") else "auto"
        return [tuple(p[0].numpy() for p in
                      dec.decode_step([buf], transport=transport))
                for buf in frames], dec
    if path == "device-windows":
        dec = DeviceFrontendDecoder(1, W, H, device="cpu")
        out = []
        for t0 in range(0, len(frames), WINDOW):
            win = frames[t0:t0 + WINDOW]
            ys, cbs, crs = dec.decode_steps([[buf] for buf in win])
            assert dec.last_status_steps.shape == (len(win), 1)
            assert not dec.last_status_steps.any()
            out += [(ys[t, 0].numpy(), cbs[t, 0].numpy(), crs[t, 0].numpy())
                    for t in range(len(win))]
        return out, dec
    if path == "device-steps":
        dec = DeviceFrontendDecoder(1, W, H, device="cpu")
        out = []
        for buf in frames:
            out.append(tuple(p[0].numpy() for p in dec.decode_step([buf])))
            assert int(dec.fetch_status()[0]) == 0
        return out, dec
    assert path == "pool-device"
    pool = StreamPool(frontend="device", device="cpu")
    pool.add_stream("soak", W, H)
    return [pool.decode_step({"soak": buf})["soak"] for buf in frames], pool


def rgba_of(path, holder, force):
    if path == "single":
        return holder.last_picture_rgba(force)
    if path == "pool-device":
        return holder.present_rgba(force)["soak"].numpy()
    return holder.present_rgba(force)[0].numpy()


@pytest.mark.parametrize("path", PATHS)
def test_60_frame_drift(path, frames, reference, memo):
    digests = corpora.load_digests()["soak48"]
    got, _ = decode_path(path, frames)
    assert len(got) == len(frames) == 60
    for t, (planes, want) in enumerate(zip(got, reference)):
        for name, a, b in zip(("luma", "Cb", "Cr"), planes, want):
            np.testing.assert_array_equal(
                a, b, err_msg=f"{path}: {name} drift at frame {t}")
        assert corpora.planes_digest(*planes) == digests["planes"][t], \
            (path, t)


@pytest.mark.parametrize("path", ("single", "batched-packed",
                                  "device-windows", "pool-device"))
def test_presentation_drift(path, memo):
    frames = corpora.soak_gop(7, n_frames=20)
    ref = JaxDecoder(JOpt.SORENSON_SPARK_BITSTREAM, backend="numpy")
    for buf in frames:
        ref.decode_next_picture(buf)
    _, holder = decode_path(path, frames)
    for force in (True, False):
        np.testing.assert_array_equal(rgba_of(path, holder, force),
                                      ref.last_picture_rgba(force),
                                      err_msg=f"{path}, deblock {force}")

