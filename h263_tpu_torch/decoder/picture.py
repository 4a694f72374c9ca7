"""Decoded picture container, PyTorch: the port of
`h263_tpu/decoder/picture.py` (parity with h263/src/decoder/picture.rs).

The planes are uint8 tensors on the decoder's device, so a P-frame chain
keeps its references on the card and motion compensation never goes
through host memory.  The `as_*` accessors return numpy copies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..types import Picture, SourceFormat


class DecodedPicture:
    """One decoded frame: header + Y/Cb/Cr planes.

    Luma is [h, w]; chroma planes are [ceil(h/2), ceil(w/2)]
    (picture.rs:39-58).
    """

    def __init__(self, picture_header: Picture, fmt: SourceFormat,
                 luma, chroma_b, chroma_r):
        self.picture_header = picture_header
        self.format = fmt
        self.luma = luma
        self.chroma_b = chroma_b
        self.chroma_r = chroma_r

    @staticmethod
    def dims(fmt: SourceFormat) -> Optional[tuple[int, int, int, int]]:
        wh = fmt.width_and_height()
        if wh is None:
            return None
        w, h = wh
        return w, h, (w + 1) // 2, (h + 1) // 2

    def as_header(self) -> Picture:
        return self.picture_header

    @property
    def width(self) -> int:
        return self.format.width_and_height()[0]

    @property
    def height(self) -> int:
        return self.format.width_and_height()[1]

    @staticmethod
    def _np(plane) -> np.ndarray:
        """A host copy of a plane (waits for the card)."""
        return plane.to("cpu", copy=True).numpy()

    def as_luma(self) -> np.ndarray:
        return self._np(self.luma)

    def as_chroma_b(self) -> np.ndarray:
        return self._np(self.chroma_b)

    def as_chroma_r(self) -> np.ndarray:
        return self._np(self.chroma_r)

    def as_yuv(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.as_luma(), self.as_chroma_b(), self.as_chroma_r()

    def luma_samples_per_row(self) -> int:
        return self.width

    def chroma_samples_per_row(self) -> int:
        return (self.width + 1) // 2
