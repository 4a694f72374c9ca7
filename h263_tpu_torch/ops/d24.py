"""The fused transport's unpack, plain PyTorch: the plain version of the
CUDA kernel `csrc/d24.cu` (`ops/d24_cuda.py`).

Port of the XLA ops of `h263_tpu/decoder/reconstruct.py` around the
reconstruction of the host front-end: `d24_to_posval` with the scatter-add
into zeroed dense coefficients (`d24_to_dense`), and the bitcast MVs and
bit-unpacked INTER flags of `reconstruct_frame_packed_d24_fused`, slim MVs
broadcast to the four blocks (`unpack_fused`).  The tests and CPU tensors
use it, and the card compares the kernel with it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..vlc_tables import ZIGZAG_TO_ROWMAJOR

ZIGZAG_U8 = np.asarray(ZIGZAG_TO_ROWMAJOR, dtype=np.uint8)


def fused_sections(nmb: int, mv_full: bool):
    """(MV bytes, INTER-bitmask bytes) at the head of a fused row."""
    return (8 if mv_full else 2) * nmb, (nmb + 7) // 8


def d24_to_dense(pack_u8, mbh: int, mbw: int):
    """uint8 [S, 3K] rows of delta24 entries -> int16 dense coefficients
    [S, 6*nmb, 64] (luma block grid row-major, then Cb, then Cr; row-major
    within a block).  Entry k adds its sign-extended 12-bit value at the
    position of ordinal cursor (sum of deltas 0..k) - 1; a cursor < 0 or a
    position past the coefficients drops the entry, and entries that meet
    add modulo 2^16."""
    S = pack_u8.shape[0]
    nmb = mbh * mbw
    n = 6 * nmb * 64
    e = pack_u8.reshape(S, -1, 3).to(torch.int32)
    w = (e[..., 0] << 16) | (e[..., 1] << 8) | e[..., 2]
    v = w & 0xFFF
    val = v - ((v & 0x800) << 1)
    cursor = torch.cumsum(w >> 12, dim=1, dtype=torch.int32) - 1
    mb = cursor // 384
    rem = cursor - mb * 384
    b = rem >> 6
    rm = torch.as_tensor(ZIGZAG_U8, device=pack_u8.device).to(
        torch.int32)[rem & 63]
    r = mb // mbw
    c = mb - r * mbw
    luma = (2 * r + (b >> 1)) * (2 * mbw) + 2 * c + (b & 1)
    chroma = 4 * nmb + (b - 4) * nmb + r * mbw + c
    pos = torch.where(b < 4, luma, chroma) * 64 + rm
    pos = torch.where((cursor >= 0) & (pos < n), pos, n)   # n: dropped
    dense = torch.zeros((S, n + 1), dtype=torch.int32, device=pack_u8.device)
    dense.scatter_add_(1, pos.to(torch.int64), val)
    dense = ((dense[:, :n] + 32768) & 0xFFFF) - 32768
    return dense.to(torch.int16).reshape(S, 6 * nmb, 64)


def unpack_fused(buf, mbh: int, mbw: int, mv_full: bool):
    """uint8 [S, mv_sz + ib_sz + 3K] fused rows -> (dense int16
    [S, 6*nmb, 64], MVs int16 [S, mbh, mbw, 4, 2], INTER uint8
    [S, mbh, mbw])."""
    S = buf.shape[0]
    nmb = mbh * mbw
    mv_sz, ib_sz = fused_sections(nmb, mv_full)
    mvs = buf[:, :mv_sz].contiguous().view(torch.int8).to(torch.int16)
    mvs = mvs.reshape(S, mbh, mbw, -1, 2).expand(S, mbh, mbw, 4, 2)
    bits = buf[:, mv_sz:mv_sz + ib_sz]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=buf.device)
    inter = ((bits[:, :, None] >> shifts) & 1).reshape(S, ib_sz * 8)[:, :nmb]
    return (d24_to_dense(buf[:, mv_sz + ib_sz:], mbh, mbw),
            mvs.contiguous(), inter.reshape(S, mbh, mbw).contiguous())
