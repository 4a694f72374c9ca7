"""Wrapper of the CUDA sparse-class IDCT kernel (`csrc/idct.cu`).

It replaces the Pallas TPU kernel `h263_tpu/ops/idct_pallas.py::_kernel`.
A CPU tensor goes to the plain version (`ops/idct.py::idct_residual_fused`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .idct import BASIS_F32, idct_residual_fused

# Kernel launches since the last reset (plain-version calls do not count).
launches = 0

_BASIS = np.ascontiguousarray(BASIS_F32, dtype=np.float32)


def idct_residual_cuda(dense: torch.Tensor) -> torch.Tensor:
    """int16 [..., NB, 64] -> int32 [..., NB, 64] clipped IDCT residuals."""
    global launches
    if dense.dtype != torch.int16 or dense.dim() < 2 or dense.shape[-1] != 64:
        raise ValueError(f"expected int16 [..., NB, 64], got "
                         f"{dense.dtype} {tuple(dense.shape)}")
    if dense.device.type == "cpu":
        return idct_residual_fused(dense)
    if dense.device.type != "cuda":
        raise ValueError(f"unsupported device {dense.device}")
    if not dense.is_contiguous():
        raise ValueError("dense coefficients must be contiguous")
    out = torch.empty(dense.shape, dtype=torch.int32, device=dense.device)
    n = dense.numel() // 64
    basis = kernels.device_table("idct_basis", _BASIS, dense.device)
    kernels.launch("h263_idct_residual", dense.device, dense.data_ptr(),
                   out.data_ptr(), n, basis.data_ptr())
    launches += 1
    return out
