"""Wrapper of the fused CUDA presentation kernel (`csrc/present.cu`).

It replaces, on the presentation path, the Pallas TPU kernels
`h263_tpu/ops/deblock_pallas.py::_make_kernel.kernel` and
`h263_tpu/ops/yuv_pallas.py::_kernel` as `present_rgba_batched` composed
them.  A CPU tensor goes to the plain version
(`ops/present.py::present_rgba_plain`); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .present import present_rgba_plain

# Kernel launches since the last reset (plain-version calls do not count).
launches = 0

_MAX_LANES = 65535   # the kernel's grid y dimension


def present_rgba_cuda(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                      strength: torch.Tensor,
                      apply: torch.Tensor) -> torch.Tensor:
    """uint8 y [S, H, W], cb/cr [S, ceil(H/2), ceil(W/2)], int32 strength
    [S], bool apply [S] -> RGBA uint8 [S, H, W, 4] (stream s deblocked where
    apply[s] and strength[s] > 0)."""
    global launches
    if y.dim() != 3 or any(t.dtype != torch.uint8 for t in (y, cb, cr)):
        raise ValueError("expected uint8 y [S, H, W] and chroma planes")
    S, h, w = y.shape
    cshape = (S, (h + 1) // 2, (w + 1) // 2)
    if tuple(cb.shape) != cshape or tuple(cr.shape) != cshape:
        raise ValueError(f"chroma planes must be {cshape}, got "
                         f"{tuple(cb.shape)} and {tuple(cr.shape)}")
    if strength.dtype != torch.int32 or tuple(strength.shape) != (S,):
        raise ValueError(f"strength must be int32 [{S}]")
    if apply.dtype != torch.bool or tuple(apply.shape) != (S,):
        raise ValueError(f"apply must be bool [{S}]")
    dev = y.device
    args = (y, cb, cr, strength, apply)
    if any(t.device != dev for t in args):
        raise ValueError("y, cb, cr, strength and apply must lie on one "
                         "device")
    if dev.type == "cpu":
        return present_rgba_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if S > _MAX_LANES:
        raise ValueError(f"{S} streams exceed the kernel's {_MAX_LANES}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("y, cb, cr, strength and apply must be contiguous")
    out = torch.empty((S, h, w, 4), dtype=torch.uint8, device=dev)
    kernels.launch("h263_present_rgba", dev, y.data_ptr(), cb.data_ptr(),
                   cr.data_ptr(), out.data_ptr(), S, h, w,
                   strength.data_ptr(), apply.data_ptr())
    launches += 1
    return out
