"""Container and stream I/O: feeding real-world bytes into the decoder."""

from .flv import FlvVideoTag, iter_flv_video_tags
from .stream import FrameSegmenter, decode_stream, iter_stream_frames

__all__ = [
    "FlvVideoTag",
    "FrameSegmenter",
    "decode_stream",
    "iter_flv_video_tags",
    "iter_stream_frames",
]
