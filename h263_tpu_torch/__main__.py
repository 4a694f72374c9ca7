"""Command-line interface: ``python -m h263_tpu_torch <command>``, the
port of ``python -m h263_tpu``.

The reference is a library consumed by a host application (Ruffle) and has
no CLI; a standalone framework needs one.  Three commands cover the host
app's jobs end-to-end:

  decode  — demux (FLV) or segment (raw elementary stream), decode every
            picture with `H263Decoder`, write PPM frames (RGB of
            `last_picture_rgba`) / an npz of YUV planes, the files the JAX
            package's CLI writes.
  info    — header-only stream probe, the ``parser::decode_picture``
            dimension-sniffing use case (h263/src/lib.rs:11,
            state.rs:102-111) as a tool: per-picture type / dims / quant.
            Needs no card.
  selftest — synthesize a tiny in-memory GOP with the test encoder and
            round-trip it (no input file).

``--device cuda|cpu`` (default ``cuda``) takes the place of the JAX CLI's
``--backend numpy|jax``: ``cuda`` runs the reconstruct and present kernels
on the card and raises where there is none; ``cpu`` runs their plain
versions.  Batched serving belongs to `StreamPool`, not this tool.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .bitio import BitReader
from .decoder import H263Decoder
from .io.flv import iter_flv_video_tags
from .io.stream import FrameSegmenter
from .parser.picture import decode_picture
from .types import DecoderOption, H263Error, PictureTypeCode


def _iter_pictures(data: bytes, standard: bool = False):
    """Yield raw picture payloads from FLV (demux) or elementary stream."""
    if data[:3] == b"FLV":
        for tag in iter_flv_video_tags(data):
            yield tag.payload
        return
    # Feed in chunks so the segmenter's commit-free keeps memory bounded
    # by the largest picture (one whole-file feed would trip max_buffer on
    # big streams and make the per-frame prefix-free quadratic).
    seg = FrameSegmenter(flavor="standard" if standard else "sorenson")
    view = memoryview(data)
    for off in range(0, len(view), 1 << 20):
        seg.feed(view[off:off + (1 << 20)])
        yield from seg.frames()
    yield from seg.finish()


def _options(standard: bool) -> DecoderOption:
    return (DecoderOption.NONE if standard
            else DecoderOption.SORENSON_SPARK_BITSTREAM)


def _write_ppm(path: str, rgba: np.ndarray) -> None:
    h, w = rgba.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgba[:, :, :3]).tobytes())


def cmd_decode(args) -> int:
    data = _read_input(args.input)
    dec = H263Decoder(_options(args.standard), device=args.device)
    deblock = {"auto": None, "on": True, "off": False}[args.deblock]
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    n = errors = 0
    planes = []  # for npz: per-frame dict of arrays
    for payload in _iter_pictures(data, args.standard):
        if args.max_frames is not None and n >= args.max_frames:
            break
        try:
            pic = dec.decode_next_picture(payload)
        except H263Error as e:
            errors += 1
            print(f"frame {n}: decode error: {e}", file=sys.stderr)
            if not args.keep_going:
                break
            continue
        if pic is None:
            continue
        if args.out:
            if args.fmt == "ppm":
                rgba = np.asarray(dec.last_picture_rgba(deblock=deblock))
                _write_ppm(os.path.join(args.out, f"frame_{n:05d}.ppm"), rgba)
            else:
                y, cb, cr = pic.as_yuv()
                planes.append((y, cb, cr))
        n += 1
        if args.max_frames is not None and n >= args.max_frames:
            break

    if args.out and args.fmt == "npz" and planes:
        np.savez_compressed(
            os.path.join(args.out, "frames.npz"),
            **{f"{k}_{i:05d}": p
               for i, (y, cb, cr) in enumerate(planes)
               for k, p in (("y", y), ("cb", cb), ("cr", cr))})
    where = f" to {args.out}" if args.out else ""
    print(f"decoded {n} frames{where}"
          + (f" ({errors} errored)" if errors else ""))
    return 1 if (errors and n == 0) else 0


def cmd_info(args) -> int:
    data = _read_input(args.input)
    opts = _options(args.standard)
    prev = None
    counts: dict[str, int] = {}
    n = 0
    for payload in _iter_pictures(data, args.standard):
        if args.max_frames is not None and n >= args.max_frames:
            break
        try:
            hdr = decode_picture(BitReader(bytes(payload)), opts, prev)
        except H263Error as e:
            print(f"picture {n}: header error: {e}", file=sys.stderr)
            n += 1
            continue
        if hdr is None:
            continue
        fmt = hdr.format if hdr.format is not None else (
            prev.format if prev is not None else None)
        wh = fmt.width_and_height() if fmt is not None else None
        w, h = wh if wh is not None else ("?", "?")  # RESERVED formats
        t = hdr.picture_type
        tname = {PictureTypeCode.I_FRAME: "I",
                 PictureTypeCode.P_FRAME: "P",
                 PictureTypeCode.DISPOSABLE_P_FRAME: "D"}.get(t, t.name)
        counts[tname] = counts.get(tname, 0) + 1
        print(f"picture {n:4d}: {tname}  {w}x{h}  tr={hdr.temporal_reference:3d}"
              f"  quant={hdr.quantizer:2d}  bytes={len(payload)}"
              + (f"  opts={hdr.options!r}" if args.verbose else ""))
        prev = hdr
        n += 1
        if args.max_frames is not None and n >= args.max_frames:
            break
    total = sum(counts.values())
    summary = " ".join(f"{k}:{v}" for k, v in sorted(counts.items()))
    print(f"{total} pictures ({summary})")
    return 0 if total else 1


def cmd_selftest(args) -> int:
    from .testing.encoder import MBSpec, encode_sorenson_picture

    W, H, nmb = 176, 144, 11 * 9
    rng = np.random.default_rng(7)
    payloads = [encode_sorenson_picture(
        W, H, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 120)) * 8] * 6)
         for _ in range(nmb)], quantizer=8)]
    for tr in (1, 2):
        payloads.append(encode_sorenson_picture(
            W, H, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, -2)])] * nmb,
            quantizer=8, temporal_reference=tr))

    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM,
                      device=args.device)
    for p in payloads:
        pic = dec.decode_next_picture(p)
        assert pic is not None
    rgba = dec.last_picture_rgba()
    assert rgba is not None and rgba.shape == (H, W, 4)
    print(f"selftest OK: decoded 3 synthetic frames on {dec.device}")
    return 0


def _read_input(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m h263_tpu_torch",
        description="H.263 / Sorenson Spark decoder tools (PyTorch / CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    d = sub.add_parser("decode", help="decode an FLV or raw H.263 stream")
    d.add_argument("input", help="input file (.flv or elementary stream; - for stdin)")
    d.add_argument("-o", "--out", help="output directory (omit to just decode)")
    d.add_argument("--fmt", choices=("ppm", "npz"), default="ppm",
                   help="ppm = one RGB image per frame; npz = YUV planes")
    d.add_argument("--max-frames", type=int, default=None)
    d.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the card's kernels; cpu: their plain versions")
    d.add_argument("--deblock", choices=("auto", "on", "off"), default="auto",
                   help="auto follows the stream's deblocker flag")
    d.add_argument("--standard", action="store_true",
                   help="plain H.263 (default: Sorenson Spark)")
    d.add_argument("-k", "--keep-going", action="store_true",
                   help="skip frames that fail to decode")
    d.set_defaults(fn=cmd_decode)

    i = sub.add_parser("info", help="probe picture headers without decoding")
    i.add_argument("input")
    i.add_argument("--max-frames", type=int, default=None)
    i.add_argument("--standard", action="store_true")
    i.add_argument("-v", "--verbose", action="store_true")
    i.set_defaults(fn=cmd_info)

    s = sub.add_parser("selftest", help="decode a synthetic in-memory GOP")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    s.set_defaults(fn=cmd_selftest)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
