"""Incremental (streaming) bitstream input: a copy of
`h263_tpu/io/stream.py`, whose `decode_stream` drives the port's decoder.

The reference decodes from any ``std::io::Read`` with incremental
buffering and commit-frees (reader.rs:15-30, 335-365): bytes are pulled
as the bit cursor advances, and committed prefixes are released.  The
decoders keep complete-frame buffers on the hot path (one host->device
copy per frame or step), so streaming is provided one level up: an
incremental **frame segmenter** that accumulates arriving bytes,
delimits pictures at their byte-aligned start codes (H.263 5.1.1 PSTUF
guarantees byte alignment of the PSC in transmitted streams), and frees
consumed prefixes — the same buffering contract, at the frame boundary
the decoders actually consume.

Use ``FrameSegmenter`` directly for custom pipelines, or
``decode_stream`` to drive a single-stream decoder from a file-like
object / chunk iterable.
"""

from __future__ import annotations

from typing import IO, Iterable, Iterator, Optional, Union


def _find_psc(buf: bytearray, start: int, third_mask: int,
              third_match: int) -> int:
    """Index of the next byte-aligned PICTURE start code at/after `start`.

    The PSC is 16 zero bits followed by a 1; byte aligned the third byte
    carries '1' + the next 5 code bits.  Those 5 bits distinguish a
    picture from the other same-prefix codes — standard GOB headers
    (GN 1-30), EOS — which must NOT split a frame (the decoder itself
    resynchronizes on mid-picture GOB headers, parser/frame.py).  The
    (mask, match) pair encodes the accepted third-byte set per flavor.
    Returns -1 if none is present.
    """
    i = start
    n = len(buf)
    while True:
        i = buf.find(b"\x00\x00", i)
        if i < 0 or i + 2 >= n:
            return -1
        if (buf[i + 2] & third_mask) == third_match:
            return i
        i += 1


#: flavor -> (third-byte mask, match).  Sorenson: 5 bits after the PSC are
#: the version (0 or 1) -> third byte 0x80-0x87.  Standard: they are GN=0
#: -> 0x80-0x83 (0x84-0x87 would be GOB #1, a mid-picture resync point).
_FLAVOR_MASKS = {
    "sorenson": (0xF8, 0x80),
    "standard": (0xFC, 0x80),
}


class FrameSegmenter:
    """Accumulate arriving bytes; yield complete picture payloads.

    feed(chunk) appends; frames() yields every COMPLETE picture currently
    buffered (a picture is complete when the next picture's start code has
    arrived); finish() yields the final, possibly unterminated picture at
    end of stream.  Consumed bytes are freed (commit), bounding memory to
    the largest in-flight picture plus one chunk.

    Bytes ahead of the first start code (garbage, container residue) are
    discarded — the same resynchronization the reference performs with its
    in-error unlimited start-code scan (reader.rs:236-256).
    """

    def __init__(self, max_buffer: int = 1 << 26, flavor: str = "sorenson"):
        """`flavor`: "sorenson" (the package default bitstream) or
        "standard" — standard H.263 needs the stricter boundary test so
        byte-aligned GOB headers don't split pictures."""
        if flavor not in _FLAVOR_MASKS:
            raise ValueError(f"unknown flavor {flavor!r}")
        self._mask, self._match = _FLAVOR_MASKS[flavor]
        self._buf = bytearray()
        self._synced = False
        self._scan_from = 0  # resume offset for boundary scanning
        self.max_buffer = max_buffer
        self.bytes_discarded = 0

    def _find(self, start: int) -> int:
        return _find_psc(self._buf, start, self._mask, self._match)

    def feed(self, chunk: bytes) -> None:
        self._buf += chunk
        if len(self._buf) > self.max_buffer:
            raise MemoryError(
                f"FrameSegmenter buffer exceeded {self.max_buffer} bytes "
                f"without a picture boundary")

    def _sync(self) -> bool:
        """Drop garbage ahead of the first start code; True once synced."""
        if self._synced:
            return True
        first = self._find(0)
        if first < 0:
            # Keep the last 2 bytes (a start code may straddle chunks).
            if len(self._buf) > 2:
                self.bytes_discarded += len(self._buf) - 2
                del self._buf[:-2]
            return False
        if first > 0:
            self.bytes_discarded += first
            del self._buf[:first]
        self._synced = True
        self._scan_from = 3  # skip past this frame's own start code
        return True

    def frames(self) -> Iterator[bytes]:
        """Yield each complete buffered picture; frees consumed bytes."""
        if not self._sync():
            return
        while True:
            nxt = self._find(self._scan_from)
            if nxt < 0:
                # Resume scanning where we stopped (minus straddle slack).
                self._scan_from = max(3, len(self._buf) - 2)
                return
            frame = bytes(self._buf[:nxt])
            del self._buf[:nxt]  # commit: free the consumed prefix
            self._scan_from = 3
            yield frame

    def finish(self) -> Iterator[bytes]:
        """Drain at end of stream: any still-buffered complete pictures,
        then the final (possibly unterminated) one.  Syncs first, so
        feed()-then-finish() with no frames() call in between still yields
        every picture; resets the segmenter for reuse."""
        if self._sync():
            yield from self.frames()
            if self._buf:
                frame = bytes(self._buf)
                self._buf = bytearray()
                yield frame
        else:
            self.bytes_discarded += len(self._buf)
            self._buf.clear()
        self._synced = False
        self._scan_from = 0

    @property
    def buffered(self) -> int:
        return len(self._buf)


def iter_stream_frames(source: Union[IO[bytes], Iterable[bytes]],
                       chunk_size: int = 1 << 16,
                       max_buffer: int = 1 << 26,
                       flavor: str = "sorenson") -> Iterator[bytes]:
    """Picture payloads from a file-like object or an iterable of chunks."""
    seg = FrameSegmenter(max_buffer=max_buffer, flavor=flavor)
    if hasattr(source, "read"):
        def chunks():
            while True:
                c = source.read(chunk_size)
                if not c:
                    return
                yield c
        it: Iterable[bytes] = chunks()
    else:
        it = source
    for chunk in it:
        seg.feed(chunk)
        yield from seg.frames()
    yield from seg.finish()


def decode_stream(source: Union[IO[bytes], Iterable[bytes]], decoder,
                  chunk_size: int = 1 << 16,
                  max_buffer: int = 1 << 26, flavor: str = None):
    """Decode a raw H.263 byte stream incrementally.

    Yields the decoder's DecodedPicture for each picture in the stream.
    `decoder` is an H263Decoder; `source` a binary file-like object or an
    iterable of byte chunks (sockets, HTTP bodies, ...).
    """
    if flavor is None:
        from ..types import DecoderOption

        opts = getattr(decoder, "decoder_options", None)
        flavor = ("sorenson" if opts is None
                  or opts & DecoderOption.SORENSON_SPARK_BITSTREAM
                  else "standard")
    for payload in iter_stream_frames(source, chunk_size, max_buffer,
                                      flavor=flavor):
        pic = decoder.decode_next_picture(payload)
        if pic is not None:
            yield pic
