"""Bit-granular reader over an in-memory H.263 bitstream.

A copy of `h263_tpu/bitio.py`, so that the port imports nothing of
the JAX package.

Design differs from the reference reader (h263/src/parser/reader.rs): instead
of a streaming VecDeque + bit-by-bit VLC tree walking, we hold the whole
buffer (frames arrive as complete FLV tag payloads in practice) and decode
VLCs with a single table lookup against a 2^maxlen prefix LUT (built in
vlc_tables.py).  Semantics are bit-for-bit identical:

* reads are MSB-first, zero-extended (reader.rs:94-134)
* signed reads sign-extend (reader.rs:176-205)
* start-code recognition enforces the <=8 stuffing-bit realignment rule, or
  scans without limit when resynchronizing after an error (reader.rs:240-258)
* reading past the end raises BitstreamExhausted (the reference's
  UnexpectedEof, which ends the current picture)
"""

from __future__ import annotations

from .types import BitstreamExhausted, InternalDecoderError, InvalidMvd

_MASK = [(1 << n) - 1 for n in range(65)]


class BitReader:
    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = len(data) * 8

    # -- primitives ---------------------------------------------------------

    def remaining(self) -> int:
        return self.nbits - self.pos

    def peek_bits(self, n: int) -> int:
        """Peek `n` bits (MSB-first) without advancing; raises at EOF."""
        pos = self.pos
        if pos + n > self.nbits:
            raise BitstreamExhausted()
        if n == 0:
            return 0
        byte0 = pos >> 3
        nbytes = ((pos & 7) + n + 7) >> 3
        word = int.from_bytes(self.data[byte0 : byte0 + nbytes], "big")
        shift = nbytes * 8 - (pos & 7) - n
        return (word >> shift) & _MASK[n]

    def peek_bits_padded(self, n: int) -> tuple[int, int]:
        """Peek up to `n` bits; zero-pad past EOF.

        Returns (value, available_bits).  Used by the LUT VLC decoder so a
        single lookup can be made near the end of the buffer.
        """
        pos = self.pos
        avail = self.nbits - pos
        if avail <= 0:
            return 0, 0
        if avail >= n:
            return self.peek_bits(n), n
        return self.peek_bits(avail) << (n - avail), avail

    def skip_bits(self, n: int) -> None:
        if self.pos + n > self.nbits:
            raise BitstreamExhausted()
        self.pos += n

    def read_bits(self, n: int) -> int:
        v = self.peek_bits(n)
        self.pos += n
        return v

    def read_signed_bits(self, n: int) -> int:
        """Read n bits and sign-extend (reader.rs:176-205)."""
        v = self.read_bits(n)
        if v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_u8(self) -> int:
        return self.read_bits(8)

    # -- alignment & start codes --------------------------------------------

    def realignment_bits(self) -> int:
        """Bits to skip to reach the next byte boundary (reader.rs:214-216)."""
        return (8 - (self.pos % 8)) % 8

    def recognize_start_code(self, in_error: bool = False):
        """Find the 17-bit picture/GOB start code ('0'*16 + '1').

        Returns the number of stuffing bits ahead of it (not consuming
        anything), or None if it is not within the allowed realignment
        distance.  With in_error=True the distance limit is dropped and the
        scan continues until a code is found or the buffer is exhausted
        (reader.rs:240-258).
        """
        max_skip = self.realignment_bits()
        skip = 0
        saved = self.pos
        try:
            while True:
                if self.peek_bits(17) == 1:
                    return skip
                # reader.rs:246 checks `skip > max_skip` AFTER a failed
                # peek at offset `skip`, so the reference accepts a start
                # code up to max_skip+1 bits ahead (its doc says "up to 8"),
                # including 1 bit ahead at an already-aligned position.
                # Bug-parity requires the same off-by-one.
                if not in_error and skip > max_skip:
                    return None
                self.pos += 1
                skip += 1
        finally:
            self.pos = saved

    # -- VLC ------------------------------------------------------------------

    def read_vlc(self, lut):
        """Decode one variable-length code using a PrefixLut.

        Mirrors the reference tree walker (reader.rs:272-290): consumes
        exactly the code's bits; raises BitstreamExhausted if the bitstream
        ends mid-code.
        """
        word, avail = self.peek_bits_padded(lut.maxlen)
        value, length = lut.table[word]
        if length > avail:
            # The tree walk would have consumed all remaining bits then hit
            # EOF.  Position is unspecified on error (callers use
            # transactions), so just raise.
            raise BitstreamExhausted()
        self.pos += length
        return value

    def read_umv(self) -> int:
        """Read an unrestricted motion vector (table D.3/H.263).

        Returns half-pel units; |value| >= 4096 is an error
        (reader.rs:298-324).
        """
        if self.read_bits(1) == 1:
            return 0
        mantissa = 0
        bulk = 1
        while bulk < 4096:
            code = self.read_bits(2)
            if code == 0b00:
                return mantissa + bulk
            if code == 0b10:
                return -(mantissa + bulk)
            if code == 0b01:
                mantissa <<= 1
            else:  # 0b11
                mantissa = (mantissa << 1) | 1
            bulk <<= 1
        raise InvalidMvd()

    # -- transactions ---------------------------------------------------------

    def checkpoint(self) -> int:
        return self.pos

    def rollback(self, checkpoint: int) -> None:
        if checkpoint > self.nbits:
            raise InternalDecoderError()
        self.pos = checkpoint

    def with_transaction(self, f):
        """Run `f(self)`; restore position if it raises (reader.rs:376-389)."""
        saved = self.pos
        try:
            return f(self)
        except Exception:
            self.pos = saved
            raise

    def with_transaction_union(self, f):
        """Like with_transaction, but a None result also rolls back
        (reader.rs:404-418)."""
        saved = self.pos
        try:
            result = f(self)
        except Exception:
            self.pos = saved
            raise
        if result is None:
            self.pos = saved
        return result
