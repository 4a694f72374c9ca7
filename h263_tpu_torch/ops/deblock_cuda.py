"""Wrapper of the CUDA deblocking kernel (`csrc/deblock.cu`).

It replaces the Pallas TPU kernel `h263_tpu/ops/deblock_pallas.py::
_make_kernel.kernel`.  A CPU tensor goes to the plain version
(`ops/deblock.py::deblock_batched`); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .deblock import deblock_batched

# Kernel launches since the last reset (plain-version calls do not count).
launches = 0

_MAX_LANES = 65535   # the kernel's grid z dimension


def deblock_batched_cuda(planes: torch.Tensor, strength: torch.Tensor,
                         apply: torch.Tensor) -> torch.Tensor:
    """uint8 planes [S, H, W], int32 strength [S], bool apply [S] -> uint8
    [S, H, W] (stream s deblocked where apply[s] and strength[s] > 0)."""
    global launches
    if planes.dtype != torch.uint8 or planes.dim() != 3:
        raise ValueError(f"expected uint8 planes [S, H, W], got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    S, h, w = planes.shape
    if strength.dtype != torch.int32 or tuple(strength.shape) != (S,):
        raise ValueError(f"strength must be int32 [{S}]")
    if apply.dtype != torch.bool or tuple(apply.shape) != (S,):
        raise ValueError(f"apply must be bool [{S}]")
    dev = planes.device
    if strength.device != dev or apply.device != dev:
        raise ValueError("planes, strength and apply must lie on one device")
    if dev.type == "cpu":
        return deblock_batched(planes, strength, apply)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if S > _MAX_LANES:
        raise ValueError(f"{S} streams exceed the kernel's {_MAX_LANES}")
    if not (planes.is_contiguous() and strength.is_contiguous()
            and apply.is_contiguous()):
        raise ValueError("planes, strength and apply must be contiguous")
    out = torch.empty_like(planes)
    rc = kernels.lib().h263_deblock(
        planes.data_ptr(), out.data_ptr(), S, h, w, strength.data_ptr(),
        apply.data_ptr(), kernels.stream_handle(dev))
    kernels.check(rc, "h263_deblock")
    launches += 1
    return out
