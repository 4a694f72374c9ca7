"""Minimal FLV demuxer for Sorenson Spark video tags (a copy of
`h263_tpu/io/flv.py`).

Sorenson Spark streams live inside FLV containers (codec id 2); the host
application in the reference's world (Ruffle) does this demuxing.  This
extracts exactly what the decoder needs: one H.263 picture buffer per video
tag, plus the frame-type hint, so real Flash video files can drive the
test-suite and benchmarks.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator


@dataclass(frozen=True)
class FlvVideoTag:
    timestamp_ms: int
    frame_type: int      # 1=key, 2=inter, 3=disposable inter (Spark)
    codec_id: int        # 2 = Sorenson Spark (H.263)
    payload: bytes       # the raw picture bitstream


def iter_flv_video_tags(data: bytes, codec_id: int = 2) -> Iterator[FlvVideoTag]:
    """Yield video tags from an FLV byte buffer.

    Non-video tags (audio, script data) are skipped; tags with a different
    codec id are skipped.  Malformed/truncated containers end the iteration
    rather than raising.
    """
    if len(data) < 13 or data[:3] != b"FLV":
        return
    header_len = struct.unpack(">I", data[5:9])[0]
    pos = header_len + 4  # skip header + first PreviousTagSize

    while pos + 11 <= len(data):
        tag_type = data[pos]
        size = int.from_bytes(data[pos + 1 : pos + 4], "big")
        ts = int.from_bytes(data[pos + 4 : pos + 7], "big")
        ts |= data[pos + 7] << 24  # extended timestamp byte
        body_start = pos + 11
        body_end = body_start + size
        if body_end > len(data):
            return  # truncated
        if tag_type == 9 and size >= 1:  # video
            vheader = data[body_start]
            frame_type = vheader >> 4
            tag_codec = vheader & 0x0F
            if tag_codec == codec_id and frame_type != 5:
                # frame_type 5 = video info/command frame: its body is a
                # command byte, not a picture payload.
                yield FlvVideoTag(ts, frame_type, tag_codec,
                                  data[body_start + 1 : body_end])
        pos = body_end + 4  # skip PreviousTagSize
