"""Presentation, plain PyTorch: per-stream Annex-J deblock of the three
planes, then BT.601 RGBA.

Port of `h263_tpu/decoder/reconstruct.py::present_rgba_batched`, and the
plain version of the fused CUDA kernel (`ops/present_cuda.py`).
"""

from __future__ import annotations

from .deblock import deblock_batched
from .yuv import yuv420_to_rgba


def present_rgba_plain(y, cb, cr, strength, apply):
    """uint8 y [S, H, W], cb/cr [S, ceil(H/2), ceil(W/2)], int32 strength
    [S], bool apply [S] -> RGBA uint8 [S, H, W, 4]: stream s deblocked with
    strength[s] where apply[s] and strength[s] > 0."""
    y, cb, cr = (deblock_batched(p, strength, apply) for p in (y, cb, cr))
    return yuv420_to_rgba(y, cb, cr)
