"""Serving-shaped example: a pool of streams of mixed resolutions with live
churn, on one device.

    python -m h263_tpu_torch.examples.serving_pool [--steps 10] \
        [--frontend device|host] [--device cuda]

Against `StreamPool`:
  * streams of two resolutions decode together (one lockstep bucket per
    resolution);
  * a stream joins mid-run and another leaves (slots recycled);
  * a stream skips steps (its slot decodes the skip frame, its state
    kept);
  * a stream changes resolution at an I-frame (rebucketed);
  * a window of frames (`decode_steps`), presentation, and a checkpoint
    of the whole pool resumed as a new pool.

Every decoded frame is checked bit-exact against a single-stream
`H263Decoder` of its own.  The bitstreams come from the test encoder, so
the example needs no input.
"""

from __future__ import annotations

import argparse

import numpy as np

from h263_tpu_torch import DecoderOption, H263Decoder, StreamPool
from h263_tpu_torch.testing.encoder import MBSpec, encode_sorenson_picture
from h263_tpu_torch.types import PictureTypeCode
from h263_tpu_torch.utils.checkpoint import load_pool_state, save_pool_state
from h263_tpu_torch.utils.trace import get_counters

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def make_gop(seed, w, h, n):
    rng = np.random.default_rng(seed)
    nmb = (-(-w // 16)) * (-(-h // 16))
    frames = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
         for _ in range(nmb)], temporal_reference=0)]
    for tr in range(1, n):
        frames.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter",
                    mvd=[(int(rng.integers(-4, 5)) * 2,
                          int(rng.integers(-4, 5)) * 2)],
                    blocks=[[(0, int(rng.integers(1, 6)))], [], [], [], [],
                            []])
             for _ in range(nmb)], temporal_reference=tr & 0xFF))
    return frames


class SimStream:
    """A stream with its own frames and its own single-stream decoder."""

    def __init__(self, seed, w, h, n, device):
        self.w, self.h = w, h
        self.frames = iter(make_gop(seed, w, h, n))
        self.oracle = H263Decoder(SORENSON, device=device)

    def next_frame(self):
        return next(self.frames, None)


def check(out, buffers, streams, tag) -> int:
    for sid, (y, _, _) in out.items():
        pic = streams[sid].oracle.decode_next_picture(buffers[sid])
        if not np.array_equal(y, pic.as_luma()):
            raise SystemExit(f"{sid} {tag}: differs from its single-stream "
                             f"decoder")
    return len(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--frontend", choices=("device", "host"),
                    default="device",
                    help="bucket decoders: the device entropy automaton "
                         "(default) or the host entropy parse")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:<k> or cpu")
    args = ap.parse_args(argv)

    pool = StreamPool(SORENSON, frontend=args.frontend, device=args.device)
    streams = {}

    def start(sid, seed, w, h):
        streams[sid] = SimStream(seed, w, h, args.steps + 8, args.device)
        pool.add_stream(sid, w, h)
        print(f"  + {sid} joined ({w}x{h})")

    start("news", 1, 176, 144)
    start("talk", 2, 176, 144)
    start("cam", 3, 128, 96)
    checked = 0
    for step in range(args.steps):
        if step == 2:
            start("late", 9, 128, 96)
        if step == 4:
            pool.remove_stream("talk")
            streams.pop("talk")
            print("  - talk left")
        if step == 6:
            streams["cam"] = SimStream(30, 176, 144, args.steps + 8,
                                       args.device)
            print("  ~ cam changes to 176x144 (an I-frame: rebucketed)")
        buffers = {}
        for sid, s in streams.items():
            if sid == "news" and step in (3, 5):
                continue            # news sits these steps out
            buf = s.next_frame()
            if buf is not None:
                buffers[sid] = buf
        # The result stays on the device until a stream's planes are read.
        out = pool.decode_step(buffers)
        checked += check(out, buffers, streams, f"step {step}")
        print(f"step {step}: decoded {sorted(out)}, all bit-exact")

    # A window of frames: one copy and one automaton launch per bucket on
    # a device pool (a host pool decodes it as steps).
    window = [{sid: s.next_frame() for sid, s in streams.items()}
              for _ in range(3)]
    for t, out in enumerate(pool.decode_steps(window)):
        checked += check(out, window[t], streams, f"window frame {t}")
    print(f"window: {len(window)} frames x {len(window[0])} streams, "
          f"bit-exact")

    rgba = pool.present_rgba(deblock=False)
    print(f"present_rgba: {({sid: tuple(a.shape) for sid, a in sorted(rgba.items())})}")

    # Suspend and resume the whole pool (membership, slots, each bucket's
    # decoder state) as a new pool, then decode one more step.
    blob = save_pool_state(pool)
    resumed = load_pool_state(blob, device=args.device)
    buffers = {sid: s.next_frame() for sid, s in streams.items()}
    checked += check(resumed.decode_step(buffers), buffers, streams,
                     "after resume")
    print(f"checkpoint: a {len(blob)}-byte pool snapshot resumed, "
          f"{len(buffers)} streams continued bit-exact")
    print(f"counters: {get_counters()}")
    print(f"OK: {checked} frames through the pool on {args.device}, "
          f"bit-exact against single-stream decoders")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
