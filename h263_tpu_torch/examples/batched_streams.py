"""Throughput-shaped example: S concurrent Sorenson streams (CIF unless
`--size` says otherwise) decoded in lockstep by `BatchedStreamDecoder`, on
one device or sharded over several.

    python -m h263_tpu_torch.examples.batched_streams [--streams 64] \
        [--frames 12] [--shard] [--size 352x288] [--device cuda]

Every stream decodes one synthetic GOP from the test encoder (a service
feeds each stream's own buffers; the device work does not depend on the
content).  `--shard` splits the streams over `make_stream_mesh()`, every
visible card (with `--device cpu`, a mesh of two CPU shards).  The last
frame of the first and the last stream is checked against the
single-stream decoder; the rate printed is the named device's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from h263_tpu_torch import (
    BatchedStreamDecoder,
    DecoderOption,
    H263Decoder,
    make_stream_mesh,
)
from h263_tpu_torch.testing.encoder import MBSpec, encode_sorenson_picture
from h263_tpu_torch.types import PictureTypeCode


def synth_gop(w: int, h: int, n_frames: int) -> list:
    mbw, mbh = -(-w // 16), -(-h // 16)
    rng = np.random.default_rng(0)
    gop = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 120)) * 8] * 6)
         for _ in range(mbw * mbh)], quantizer=8)]
    for tr in range(1, n_frames):
        gop.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(1, 1)],
                    blocks=[[(0, 6)], [], [], [], [], []]
                    if k % 7 == 0 else [[], [], [], [], [], []])
             for k in range(mbw * mbh)], quantizer=8, temporal_reference=tr))
    return gop


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--shard", action="store_true",
                    help="shard the streams over every visible card")
    ap.add_argument("--size", default="352x288", help="WxH (default CIF)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:<k> or cpu")
    args = ap.parse_args(argv)
    if args.frames < 3:
        ap.error("--frames must be at least 3")
    w, h = map(int, args.size.split("x"))
    gop = synth_gop(w, h, args.frames)
    if args.shard:
        mesh = (make_stream_mesh(["cpu"] * 2) if args.device == "cpu"
                else make_stream_mesh())
        dec = BatchedStreamDecoder(args.streams, w, h, mesh=mesh)
        where = (f"{mesh.size} shards on {mesh.distinct} distinct "
                 f"device(s) ({', '.join(map(str, mesh.devices))})")
    else:
        dec = BatchedStreamDecoder(args.streams, w, h, device=args.device)
        where = str(dec.device)
    name = (torch.cuda.get_device_name(torch.device(args.device))
            if args.device != "cpu" else "cpu")
    print(f"decoding {args.streams} {w}x{h} streams on {where} ({name})")

    dec.decode_step([gop[0]] * args.streams)
    dec.decode_step([gop[1]] * args.streams)
    synchronize(args.device)
    t0 = time.perf_counter()
    for t in range(2, args.frames):
        y, cb, cr = dec.decode_step([gop[t]] * args.streams)
    synchronize(args.device)
    dt = time.perf_counter() - t0
    print(f"{args.streams * (args.frames - 2) / dt:.0f} frames/s on {name} "
          f"({1e3 * dt / (args.frames - 2):.2f} ms a step)")

    single = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM,
                         device=args.device)
    for buf in gop:
        pic = single.decode_next_picture(buf)
    ys = np.asarray(y) if args.shard else y.cpu().numpy()
    for s in (0, args.streams - 1):
        if not np.array_equal(ys[s], pic.as_luma()):
            raise SystemExit(f"stream {s} differs from the single-stream "
                             f"decoder")
    rgba = dec.present_rgba()
    print(f"streams 0 and {args.streams - 1} equal the single-stream "
          f"decoder; presented RGBA {tuple(rgba.shape)} {rgba.dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
