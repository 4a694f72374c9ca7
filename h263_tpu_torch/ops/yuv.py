"""BT.601 YUV 4:2:0 -> RGBA in 16.16 fixed point, plain PyTorch.

Port of `h263_tpu/ops/yuv.py::yuv420_to_rgba_jnp`: studio swing to full
range, chroma replicated 2x, alpha 255.  Exact int32 arithmetic.
"""

from __future__ import annotations

import torch

# 16.16 fixed-point coefficients (those of `h263_tpu/ops/yuv.py`).
_GRAY = 76309    # (255/219) * 65536
_CR2R = 104597   # (255/224) * 1.402 * 65536
_CR2G = -53279   # -(255/224) * 1.402 * (0.299/0.587) * 65536
_CB2G = -25675   # -(255/224) * 1.772 * (0.114/0.587) * 65536
_CB2B = 132201   # (255/224) * 1.772 * 65536
_HALF = 32768


def yuv420_to_rgba(y, cb, cr):
    """y uint8 [..., H, W], cb/cr uint8 [..., H2, W2] -> uint8 [..., H, W, 4]."""
    h, w = y.shape[-2], y.shape[-1]
    dev = y.device
    yy = y.to(torch.int32) - 16
    iy = (torch.arange(h, device=dev) // 2)[:, None]
    ix = (torch.arange(w, device=dev) // 2)[None, :]
    cbx = cb.to(torch.int32)[..., iy, ix] - 128
    crx = cr.to(torch.int32)[..., iy, ix] - 128

    gray = yy * _GRAY
    r = (gray + crx * _CR2R + _HALF) >> 16
    g = (gray + crx * _CR2G + cbx * _CB2G + _HALF) >> 16
    b = (gray + cbx * _CB2B + _HALF) >> 16

    def clip(v):
        return v.clamp(0, 255).to(torch.uint8)

    a = torch.full(r.shape, 255, dtype=torch.uint8, device=dev)
    return torch.stack([clip(r), clip(g), clip(b), a], dim=-1)
