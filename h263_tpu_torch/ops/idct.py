"""Plain PyTorch 8x8 sparse-class IDCT residual (bit-exact with the reference).

Counterpart of `h263_tpu/ops/idct.py` (`idct_residual_jnp`,
`derive_classes_jnp`) and of the contract of the fused Pallas kernel
(`h263_tpu/ops/idct_pallas.py`): int16 [..., NB, 64] coefficients in, int32
[..., NB, 64] clipped residuals out, with the sparsity class derived from
the nonzero pattern.

Every product and every sum is its own eager op, so each rounds to f32 on
its own: no fused multiply-add can skip the product's rounding.  Do not
rewrite this with `matmul`, `einsum`, `addcmul` or `torch.compile`: they may
contract or reorder the accumulation, which moves `trunc()` by one LSB at
rounding boundaries (the FMA block {735, -555, 215} must give 28).
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import (
    BLOCK_CLASS_DC,
    BLOCK_CLASS_FULL,
    BLOCK_CLASS_VERT,
    BLOCK_CLASS_ZERO,
)

# The reference's precomputed f32 cosine basis (idct.rs:39-48); row 0 folds in
# the 1/sqrt(2) DC scaling.  BASIS[freq][x].
BASIS_F32 = np.array(
    [
        [0.70710677, 0.70710677, 0.70710677, 0.70710677,
         0.70710677, 0.70710677, 0.70710677, 0.70710677],
        [0.98078525, 0.8314696, 0.5555702, 0.19509023,
         -0.19509032, -0.55557036, -0.83146966, -0.9807853],
        [0.9238795, 0.38268343, -0.38268352, -0.9238796,
         -0.9238795, -0.38268313, 0.3826836, 0.92387956],
        [0.8314696, -0.19509032, -0.9807853, -0.55557,
         0.55557007, 0.98078525, 0.19509007, -0.8314698],
        [0.70710677, -0.70710677, -0.70710665, 0.707107,
         0.70710677, -0.70710725, -0.70710653, 0.7071068],
        [0.5555702, -0.9807853, 0.19509041, 0.83146936,
         -0.8314698, -0.19508928, 0.9807853, -0.55557007],
        [0.38268343, -0.9238795, 0.92387974, -0.3826839,
         -0.38268384, 0.9238793, -0.92387974, 0.3826839],
        [0.19509023, -0.55557, 0.83146936, -0.9807852,
         0.98078525, -0.83147013, 0.55557114, -0.19508967],
    ],
    dtype=np.float32,
)


def _idct1d_last(x, basis):
    """x[..., 8] -> out[..., 8], accumulated over frequency 0..7 in order."""
    acc = x[..., 0:1] * basis[0]
    for f in range(1, 8):
        acc = acc + x[..., f:f + 1] * basis[f]
    return acc


def _round_clip(v):
    bias = torch.where(v < 0, -0.5, 0.5).to(torch.float32)
    return torch.clamp(torch.trunc(v / 4.0 + bias), -256, 255).to(torch.int32)


def idct_residual(coeffs, classes):
    """Clipped IDCT residuals: coeffs [..., 8, 8], classes [...] -> int32
    [..., 8, 8].  Port of `idct_residual_jnp`."""
    basis = torch.as_tensor(BASIS_F32, device=coeffs.device)
    c = coeffs.to(torch.float32)

    stage_a = _idct1d_last(c, basis)                       # [..., y, i]
    stage_b = _idct1d_last(stage_a.transpose(-1, -2), basis)  # [..., x, y]
    full = _round_clip(stage_b.transpose(-1, -2))          # [..., y, x]

    wv = _idct1d_last(c[..., :, 0], basis) * basis[0, 0]   # [..., y]
    vert = _round_clip(wv)[..., :, None].expand(full.shape)

    dc = c[..., 0:1, 0:1]
    dcv = dc * 0.5 / 4.0
    bias = torch.where(dc < 0, -0.5, 0.5).to(torch.float32)
    dcr = torch.clamp(torch.trunc(dcv + bias), -256, 255).to(torch.int32)
    dcfull = dcr.expand(full.shape)

    cls = classes[..., None, None].to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=coeffs.device)
    return torch.where(cls == BLOCK_CLASS_FULL, full,
           torch.where(cls == BLOCK_CLASS_VERT, vert,
           torch.where(cls == BLOCK_CLASS_DC, dcfull, zero)))


def derive_classes(dense_blocks):
    """Sparsity classes from dense int16 [..., nb, 64] -> int8 [..., nb].
    Port of `derive_classes_jnp`."""
    nz = dense_blocks != 0
    any_nz = nz.any(dim=-1)
    off_row0 = nz[..., 8:].any(dim=-1)
    col_mask = (torch.arange(64, device=nz.device) % 8) != 0
    off_col0 = (nz & col_mask).any(dim=-1)
    cls = torch.where(
        ~any_nz, BLOCK_CLASS_ZERO,
        torch.where(~off_row0 & ~off_col0, BLOCK_CLASS_DC,
                    torch.where(~off_col0, BLOCK_CLASS_VERT,
                                BLOCK_CLASS_FULL)))
    return cls.to(torch.int8)


def idct_residual_fused(dense_blocks):
    """int16 [..., NB, 64] -> int32 [..., NB, 64], class derived inside: the
    contract of `idct_residual_pallas` and of the CUDA kernel
    (`ops/idct_cuda.py`), as plain tensor code."""
    classes = derive_classes(dense_blocks)
    blocks = dense_blocks.reshape(*dense_blocks.shape[:-1], 8, 8)
    return idct_residual(blocks, classes).reshape(dense_blocks.shape)
