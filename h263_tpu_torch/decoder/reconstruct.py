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

The host front-end's transports reach `reconstruct_from_dense` through the
unpack kernel of `ops/d24_cuda.py`: `reconstruct_frame_packed_d24_fused`
takes the fused single-leaf rows, `reconstruct_frame_packed_d24` the
delta24 entries beside int16 MVs and byte flags (the MV-flip step).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.d24_cuda import d24_to_dense_cuda, unpack_fused_cuda
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


def reconstruct_frame_packed_d24(pack_u8, mvs, inter, ref_y, ref_cb, ref_cr):
    """Reconstruction from the delta24 transport: uint8 [S, 3K] entries,
    int16 MVs [S, mbh, mbw, 4, 2], INTER flags [S, mbh, mbw] -> uint8
    planes."""
    mbh, mbw = inter.shape[1:]
    return reconstruct_from_dense(d24_to_dense_cuda(pack_u8, mbh, mbw), mvs,
                                  inter, ref_y, ref_cb, ref_cr)


def reconstruct_frame_packed_d24_fused(buf, ref_y, ref_cb, ref_cr,
                                       mv_full: bool, mbh: int, mbw: int):
    """Reconstruction from the fused single-leaf transport: uint8 rows
    [S, mv_sz + ib_sz + 3K] of int8 MVs (2 B/MB slim, 8 B/MB with
    `mv_full`), the INTER bitmask (1 bit/MB, MSB-first) and delta24
    entries -> uint8 planes."""
    dense, mvs, inter = unpack_fused_cuda(buf, mbh, mbw, mv_full)
    return reconstruct_from_dense(dense, mvs, inter, ref_y, ref_cb, ref_cr)


def present_rgba_batched(y, cb, cr, strength, apply_deblock):
    """Optional per-stream deblock + BT.601 RGBA.  y uint8 [S, H, W]; cb/cr
    uint8 [S, ch, cw]; strength int32 [S]; apply_deblock bool [S] ->
    RGBA uint8 [S, H, W, 4]."""
    return present_rgba_cuda(
        y.contiguous(), cb.contiguous(), cr.contiguous(),
        strength.to(torch.int32).contiguous(),
        apply_deblock.to(torch.bool).contiguous())


class PresentParams:
    """The per-stream presentation parameters of a decoder's present
    calls, staged as bytes (int32 strength [n], then bool flags [n]) in one
    pinned buffer and copied with `non_blocking`; the event of the last copy
    guards the buffer's reuse, so the host never waits for the card."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self._host = torch.zeros(5 * n, dtype=torch.uint8,
                                 pin_memory=device.type == "cuda")
        self._copied = None

    def to_device(self, strength: np.ndarray, flags: np.ndarray):
        """(int32 strength [n], bool flags [n]) on the device."""
        n4 = 4 * self.n
        if self._copied is not None:
            self._copied.synchronize()
        host = self._host.numpy()
        host[:n4].view(np.int32)[:] = strength
        host[n4:] = flags
        dev = self._host.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return dev[:n4].view(torch.int32), dev[n4:].view(torch.bool)
