"""Batched frame reconstruction and presentation, PyTorch.

Port of the device tail of `h263_tpu/decoder/reconstruct.py`:

    planes = clamp(halfpel_gather(ref, mv) + clipped_idct(coeffs), 0, 255)

`reconstruct_from_dense` runs the IDCT, the motion compensation and the
add-clamp as one CUDA kernel (`ops/reconstruct_cuda.py`), and
`present_rgba_batched` the deblock and BT.601 conversion through theirs
(`ops/deblock_cuda.py`, `ops/yuv_cuda.py`) — on a CUDA tensor the kernel, on
a CPU tensor its plain version — as the JAX package ran the Pallas kernels
on the TPU.  The plain reconstruction (`reconstruct_from_residuals`) lives in
`ops/reconstruct.py`.
"""

from __future__ import annotations

import torch

from ..ops.deblock_cuda import deblock_batched_cuda
from ..ops.reconstruct import reconstruct_from_residuals  # noqa: F401
from ..ops.reconstruct_cuda import reconstruct_from_dense_cuda
from ..ops.yuv_cuda import yuv420_to_rgba_cuda


def reconstruct_from_dense(dense, mvs, inter, ref_y, ref_cb, ref_cr):
    """Dense int16 [S, 6*nmb, 64] coefficients (luma block grid row-major,
    then Cb, then Cr; row-major within a block) + MVs + INTER flags +
    reference planes -> uint8 (y, cb, cr) planes."""
    return reconstruct_from_dense_cuda(dense, mvs, inter, ref_y, ref_cb,
                                       ref_cr)


def present_rgba_batched(y, cb, cr, strength, apply_deblock):
    """Optional per-stream deblock + BT.601 RGBA.  y uint8 [S, H, W]; cb/cr
    uint8 [S, ch, cw]; strength int32 [S]; apply_deblock bool [S] ->
    RGBA uint8 [S, H, W, 4]."""
    strength = strength.to(torch.int32).contiguous()
    apply_deblock = apply_deblock.to(torch.bool).contiguous()
    y, cb, cr = (deblock_batched_cuda(p.contiguous(), strength, apply_deblock)
                 for p in (y, cb, cr))
    return yuv420_to_rgba_cuda(y, cb, cr)
