"""Decode the Sorenson Spark video track of an FLV file to PPM frames.

    python -m h263_tpu_torch.examples.decode_flv input.flv out_dir \
        [--max-frames N] [--device cuda]
    python -m h263_tpu_torch.examples.decode_flv --selftest [--device cpu]

The single-stream decoder mirrors the reference decoder's API (h263-rs:
`H263State::decode_next_picture`); `--selftest` wraps a three-frame
synthetic GOP from the test encoder in an FLV in memory and decodes it, so
the example runs without an input file.
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from h263_tpu_torch import DecoderOption, H263Decoder
from h263_tpu_torch.io.flv import iter_flv_video_tags


def write_ppm(path: str, rgba: np.ndarray) -> None:
    h, w = rgba.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgba[:, :, :3]).tobytes())


def decode_flv(data: bytes, out_dir, max_frames, device) -> int:
    """Decode every video tag; write each picture's RGB when `out_dir`."""
    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, device=device)
    n = 0
    for tag in iter_flv_video_tags(data):
        if dec.decode_next_picture(tag.payload) is None:
            continue
        rgba = dec.last_picture_rgba()
        if out_dir is not None:
            write_ppm(os.path.join(out_dir, f"frame_{n:05d}.ppm"), rgba)
        n += 1
        if max_frames is not None and n >= max_frames:
            break
    return n


def synth_flv() -> bytes:
    """A minimal FLV wrapping a 3-frame synthetic QCIF Sorenson GOP."""
    from h263_tpu_torch.testing.encoder import MBSpec, encode_sorenson_picture
    from h263_tpu_torch.types import PictureTypeCode

    w, h, nmb = 176, 144, 11 * 9
    rng = np.random.default_rng(1)
    frames = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 120)) * 8] * 6)
         for _ in range(nmb)], quantizer=8)]
    for tr in (1, 2):
        frames.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, -2)])] * nmb, quantizer=8,
            temporal_reference=tr))
    out = bytearray(b"FLV\x01\x01\x00\x00\x00\x09\x00\x00\x00\x00")
    for i, payload in enumerate(frames):
        body = bytes([(1 if i == 0 else 2) << 4 | 2]) + payload  # type|codec
        out += bytes([9])                                # video tag
        out += struct.pack(">I", len(body))[1:]          # 24-bit size
        out += struct.pack(">I", 33 * i)[1:] + b"\0"     # ts24 + ext
        out += b"\0\0\0"                                 # stream id
        out += body
        out += struct.pack(">I", 11 + len(body))         # prev tag size
    return bytes(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("flv", nargs="?")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:<k> or cpu")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    if args.selftest:
        n = decode_flv(synth_flv(), None, None, args.device)
        if n != 3:
            raise SystemExit(f"selftest FAILED: decoded {n} of 3 frames")
        print(f"selftest OK: decoded 3 synthetic frames on {args.device}")
        return 0
    if not args.flv or not args.out_dir:
        ap.error("flv and out_dir required (or --selftest)")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.flv, "rb") as f:
        data = f.read()
    n = decode_flv(data, args.out_dir, args.max_frames, args.device)
    print(f"decoded {n} frames to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
