"""Wrapper of the fused transport's unpack kernel (`csrc/d24.cu`).

It has no TPU kernel to replace: the JAX package did this step in XLA ops
(`h263_tpu/decoder/reconstruct.py::reconstruct_frame_packed_d24_fused` and
`d24_to_posval`, with the scatter-add into zeroed coefficients).  The
kernel is bound by bytes, nearly all of them the dense coefficients it
writes whole: one thread block per stream zeroes the stream's row, then
scans the entries' deltas and adds each value at its position.  A CPU
tensor goes to the plain version (`ops/d24.py`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .d24 import ZIGZAG_U8, d24_to_dense, fused_sections, unpack_fused

# Kernel launches since the last reset (plain-version calls do not count).
launches = 0


def _check_rows(rows, width: int):
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be uint8 [S, L], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.shape[1] < width or (rows.shape[1] - width) % 3:
        raise ValueError(f"a row of {rows.shape[1]} bytes is not {width} "
                         f"bytes of MVs and flags + 3-byte entries")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    if rows.device.type == "cuda" and rows.stride(1) != 1:
        raise ValueError("rows must be contiguous within a row")
    return (rows.shape[1] - width) // 3


def _launch(rows, n_entries, mv_stride, mbh, mbw):
    global launches
    S, dev = rows.shape[0], rows.device
    nmb = mbh * mbw
    dense = torch.empty((S, 6 * nmb, 64), dtype=torch.int16, device=dev)
    mvs = inter = None
    if mv_stride:
        mvs = torch.empty((S, mbh, mbw, 4, 2), dtype=torch.int16, device=dev)
        inter = torch.empty((S, mbh, mbw), dtype=torch.uint8, device=dev)
    kernels.launch(
        "h263_d24_unpack", dev, rows.data_ptr(), rows.stride(0), n_entries,
        mv_stride, S, mbh, mbw,
        kernels.device_table("zigzag", ZIGZAG_U8, dev).data_ptr(),
        dense.data_ptr(), mvs.data_ptr() if mv_stride else None,
        inter.data_ptr() if mv_stride else None)
    launches += 1
    return dense, mvs, inter


def d24_to_dense_cuda(pack_u8, mbh: int, mbw: int):
    """uint8 [S, 3K] rows of delta24 entries (rows may lie apart, each
    contiguous) -> int16 dense coefficients [S, 6*nmb, 64]."""
    k = _check_rows(pack_u8, 0)
    if pack_u8.device.type == "cpu":
        return d24_to_dense(pack_u8, mbh, mbw)
    return _launch(pack_u8, k, 0, mbh, mbw)[0]


def unpack_fused_cuda(buf, mbh: int, mbw: int, mv_full: bool):
    """uint8 [S, mv_sz + ib_sz + 3K] fused rows -> (dense int16
    [S, 6*nmb, 64], MVs int16 [S, mbh, mbw, 4, 2], INTER uint8
    [S, mbh, mbw])."""
    k = _check_rows(buf, sum(fused_sections(mbh * mbw, mv_full)))
    if buf.device.type == "cpu":
        return unpack_fused(buf, mbh, mbw, mv_full)
    return _launch(buf, k, 8 if mv_full else 2, mbh, mbw)
