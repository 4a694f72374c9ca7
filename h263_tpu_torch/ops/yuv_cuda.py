"""Wrapper of the CUDA BT.601 YUV -> RGBA kernel (`csrc/yuv.cu`).

It replaces the Pallas TPU kernel `h263_tpu/ops/yuv_pallas.py::_kernel`.
A CPU tensor goes to the plain version (`ops/yuv.py::yuv420_to_rgba`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .yuv import yuv420_to_rgba

# Kernel launches since the last reset (plain-version calls do not count).
launches = 0

_MAX_LANES = 65535   # the kernel's grid y dimension


def yuv420_to_rgba_cuda(y: torch.Tensor, cb: torch.Tensor,
                        cr: torch.Tensor) -> torch.Tensor:
    """uint8 y [S, H, W], cb/cr [S, ceil(H/2), ceil(W/2)] -> RGBA uint8
    [S, H, W, 4]."""
    global launches
    if y.dim() != 3 or any(t.dtype != torch.uint8 for t in (y, cb, cr)):
        raise ValueError("expected uint8 y [S, H, W] and chroma planes")
    S, h, w = y.shape
    cshape = (S, (h + 1) // 2, (w + 1) // 2)
    if tuple(cb.shape) != cshape or tuple(cr.shape) != cshape:
        raise ValueError(f"chroma planes must be {cshape}, got "
                         f"{tuple(cb.shape)} and {tuple(cr.shape)}")
    dev = y.device
    if cb.device != dev or cr.device != dev:
        raise ValueError("y, cb and cr must lie on one device")
    if dev.type == "cpu":
        return yuv420_to_rgba(y, cb, cr)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if S > _MAX_LANES:
        raise ValueError(f"{S} streams exceed the kernel's {_MAX_LANES}")
    if not (y.is_contiguous() and cb.is_contiguous() and cr.is_contiguous()):
        raise ValueError("y, cb and cr must be contiguous")
    out = torch.empty((S, h, w, 4), dtype=torch.uint8, device=dev)
    kernels.launch("h263_yuv_rgba", dev, y.data_ptr(), cb.data_ptr(),
                   cr.data_ptr(), out.data_ptr(), S, h, w)
    launches += 1
    return out
