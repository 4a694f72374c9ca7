"""Batched frame reconstruction and presentation, PyTorch.

Port of the device tail of `h263_tpu/decoder/reconstruct.py`:

    planes = clamp(halfpel_gather(ref, mv) + clipped_idct(coeffs), 0, 255)

`reconstruct_from_dense` runs the IDCT, the motion compensation and the
add-clamp as one CUDA kernel (`ops/reconstruct_cuda.py`), and
`present_rgba_batched` the deblock of the three planes and the BT.601
conversion as one more (`ops/present_cuda.py`) — on a CUDA tensor the
kernel, on a CPU tensor its plain version — where the JAX package ran its
Pallas kernels on the TPU.  The deblock and the conversion alone are
`ops/deblock_cuda.py` and `ops/yuv_cuda.py`.  The plain reconstruction
(`reconstruct_from_residuals`) lives in `ops/reconstruct.py`.
"""

from __future__ import annotations

import torch

from ..ops.present_cuda import present_rgba_cuda
from ..ops.reconstruct import reconstruct_from_residuals  # noqa: F401
from ..ops.reconstruct_cuda import reconstruct_from_dense_cuda


def reconstruct_from_dense(dense, mvs, inter, ref_y, ref_cb, ref_cr,
                           out=None):
    """Dense int16 [S, 6*nmb, 64] coefficients (luma block grid row-major,
    then Cb, then Cr; row-major within a block) + MVs + INTER flags +
    reference planes -> uint8 (y, cb, cr) planes, fresh or written into
    `out` = (y, cb, cr)."""
    return reconstruct_from_dense_cuda(dense, mvs, inter, ref_y, ref_cb,
                                       ref_cr, out=out)


def present_rgba_batched(y, cb, cr, strength, apply_deblock):
    """Optional per-stream deblock + BT.601 RGBA.  y uint8 [S, H, W]; cb/cr
    uint8 [S, ch, cw]; strength int32 [S]; apply_deblock bool [S] ->
    RGBA uint8 [S, H, W, 4]."""
    return present_rgba_cuda(
        y.contiguous(), cb.contiguous(), cr.contiguous(),
        strength.to(torch.int32).contiguous(),
        apply_deblock.to(torch.bool).contiguous())
