"""Per-stream decoder state machine, PyTorch: the port of
`h263_tpu/decoder/state.py::H263Decoder`.

Parity with H263State (h263/src/decoder/state.rs): option carry-forward,
format inheritance, reference-picture management (I-frames clear the
backward reference; disposable frames never become references), and
whole-picture atomicity — a failed decode leaves reader and state untouched
(state.rs:119-137).

Per picture: the picture header parses on the host (`parser/picture.py`),
the macroblocks through the native entropy decoder (`parse_frame_auto`),
one pinned buffer of dense coefficients, MVs and INTER flags goes to the
device, and the fused reconstruct kernel (`csrc/reconstruct.cu`, one
stream) writes the new planes against the reference planes already there.
`last_picture_rgba` presents with the fused deblock + BT.601 kernel
(`csrc/present.cu`).  On `device="cpu"` both run their plain versions.

Stage timers (`utils/trace.py`, off unless enabled): `header_parse`,
`host_parse` (the macroblock layer), `transfer` (the staging copy),
`reconstruct_dispatch`.

Left out against the JAX package: `backend=` (the port's `device=` takes
its place) and `reconstruct_frame_numpy`, whose second role, the device
front-end's tape-overflow repair, has no tape to repair in the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import kernels
from ..bitio import BitReader
from ..ops.deblock import QUANT_TO_STRENGTH
from ..parser.frame import parse_frame_auto
from ..parser.picture import decode_picture
from ..types import (
    DecoderOption,
    MiddleOfBitstream,
    Picture,
    PictureFormatInvalid,
    PictureFormatMissing,
    PictureOption,
    PictureTypeCode,
    UncodedIFrameBlocks,
    carry_forward_options,
)
from ..utils.trace import trace_stage
from .picture import DecodedPicture
from .reconstruct import (
    FrameStaging,
    PresentParams,
    present_rgba_batched,
    reconstruct_frame_single,
)


class H263Decoder:
    """Stateful decoder for a single H.263 / Sorenson Spark stream, on
    `device` ("cuda", the default, or "cpu"; no fallback between them)."""

    def __init__(self, decoder_options: DecoderOption = DecoderOption.NONE,
                 *, device="cuda"):
        self.device = kernels.resolve_device(device)
        self.decoder_options = decoder_options
        self.last_picture: Optional[int] = None       # temporal reference
        self.reference_picture: Optional[int] = None  # temporal reference
        self.running_options = PictureOption.NONE
        self.reference_states: dict[int, DecodedPicture] = {}
        self._staging = FrameStaging(self.device)
        self._params = None  # PresentParams, at the first present

    # -- queries (state.rs:52-78) ------------------------------------------

    def is_sorenson(self) -> bool:
        return bool(self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM)

    def get_last_picture(self) -> Optional[DecodedPicture]:
        if self.last_picture is None:
            return None
        return self.reference_states.get(self.last_picture)

    def get_reference_picture(self) -> Optional[DecodedPicture]:
        # Parity quirk (state.rs:72-78): when a backward reference exists,
        # the picture actually returned is the *last* picture.
        if self.reference_picture is None:
            return None
        return self.reference_states.get(self.last_picture)

    def cleanup_buffers(self) -> None:
        keep = {}
        if self.last_picture is not None and self.last_picture in self.reference_states:
            keep[self.last_picture] = self.reference_states[self.last_picture]
        if self.reference_picture is not None and self.reference_picture in self.reference_states:
            keep[self.reference_picture] = self.reference_states[self.reference_picture]
        self.reference_states = keep

    def parse_picture(self, reader: BitReader,
                      previous_picture: Optional[Picture]) -> Optional[Picture]:
        return decode_picture(reader, self.decoder_options, previous_picture)

    # -- main entry (state.rs:138-489) ----------------------------------------

    def decode_next_picture(self, reader) -> DecodedPicture:
        """Decode one picture, advancing decoder state.

        `reader` may be a BitReader or bytes.  Returns the decoded picture
        (also retrievable via get_last_picture()), its planes on the
        decoder's device.  On error the reader position and all decoder
        state are left untouched.
        """
        if isinstance(reader, (bytes, bytearray, memoryview)):
            reader = BitReader(bytes(reader))
        saved_pos = reader.pos
        try:
            return self._decode_next_picture_inner(reader)
        except Exception:
            reader.pos = saved_pos
            raise

    def _decode_next_picture_inner(self, reader: BitReader) -> DecodedPicture:
        last = self.get_last_picture()
        with trace_stage("header_parse"):
            next_picture = self.parse_picture(
                reader, last.as_header() if last else None)
        if next_picture is None:
            raise MiddleOfBitstream()

        # Option carry-forward (state.rs:147-155) — the one shared rule.
        running = carry_forward_options(next_picture, self.running_options)

        # Format resolution / inheritance (state.rs:157-165).
        if next_picture.format is not None:
            fmt = next_picture.format
        elif next_picture.picture_type is PictureTypeCode.I_FRAME:
            raise PictureFormatMissing()
        elif last is not None:
            fmt = last.format
        else:
            raise PictureFormatMissing()

        wh = fmt.width_and_height()
        if wh is None:
            raise PictureFormatInvalid()
        w, h = wh
        if w <= 0 or h <= 0:
            raise PictureFormatInvalid()

        reference = self.get_reference_picture()

        with trace_stage("host_parse"):
            frame = parse_frame_auto(reader, next_picture,
                                     self.decoder_options, running, w, h)

        # INTER anywhere (incl. synthesized tail MBs) requires a reference
        # picture (gather.rs:149).
        if frame.inter.any() and reference is None:
            raise UncodedIFrameBlocks()

        refs = None if reference is None else (
            reference.luma, reference.chroma_b, reference.chroma_r)
        with trace_stage("reconstruct_dispatch"):
            y, cb, cr = reconstruct_frame_single(frame, refs, self._staging)
        decoded = DecodedPicture(next_picture, fmt, y, cb, cr)

        # Reference management (state.rs:464-483).
        if next_picture.picture_type is PictureTypeCode.I_FRAME:
            self.reference_picture = None
        this_tr = next_picture.temporal_reference
        self.last_picture = this_tr
        if not next_picture.picture_type.is_disposable():
            self.reference_picture = this_tr
        self.running_options = running
        self.reference_states[this_tr] = decoded
        self.cleanup_buffers()
        return decoded

    # -- presentation helpers (SURVEY.md §3.4) ---------------------------------

    def last_picture_rgba(self, deblock: Optional[bool] = None) -> Optional[np.ndarray]:
        """Convenience: last decoded picture as RGBA uint8 [h, w, 4], a
        numpy array (the present kernel's output, copied to the host).

        `deblock=None` honours the stream's advisory USE_DEBLOCKER flag;
        True/False force it.  Strength comes from the picture quantizer via
        Table J.2 (deblock.rs:5-8).
        """
        pic = self.get_last_picture()
        if pic is None:
            return None
        hdr = pic.as_header()
        if deblock is None:
            deblock = bool(hdr.options & PictureOption.USE_DEBLOCKER)
        strength = int(QUANT_TO_STRENGTH[hdr.quantizer & 31])
        if self._params is None:
            self._params = PresentParams(1, self.device)
        strength_d, flags_d = self._params.to_device(
            np.array([strength], dtype=np.int32),
            np.array([deblock], dtype=np.bool_))
        rgba = present_rgba_batched(pic.luma[None], pic.chroma_b[None],
                                    pic.chroma_r[None], strength_d, flags_d)
        return rgba[0].cpu().numpy()
