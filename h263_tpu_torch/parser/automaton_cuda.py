"""Wrapper of the CUDA entropy-automaton kernel (`csrc/automaton.cu`).

It replaces the TPU automaton (`docs/retired/parse_pallas.py::
parse_frames_pallas` around `h263_tpu/parser/device_frontend.py::make_step`,
which ran as an XLA while_loop) together with `assemble`.  A CPU tensor goes
to the plain version (`parser/device_frontend.py::parse_assemble`); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..vlc_tables import ZIGZAG_TO_ROWMAJOR
from .device_frontend import parse_assemble
from .tables import (
    CBPY_ARR,
    MCBPC_I_ARR,
    MCBPC_P_ARR,
    MVD_ARR,
    TCOEF_ARR,
    _extended_range_for_dim,
)

# Kernel launches since the last reset (plain-version calls do not count).
launches = 0

# Widest picture the kernel's per-lane MV ring holds (MAX_MBW in
# csrc/automaton_lane.cuh).
MAX_MBW = 128

# One concatenated table buffer, in the order automaton_lane.cuh expects.
TABLES = np.concatenate([MCBPC_I_ARR, MCBPC_P_ARR, CBPY_ARR, MVD_ARR,
                         TCOEF_ARR,
                         np.asarray(ZIGZAG_TO_ROWMAJOR, dtype=np.int32)]
                        ).astype(np.int32)


def parse_assemble_cuda(payload_u8: torch.Tensor, meta: torch.Tensor, *,
                        mbh: int, mbw: int, width=None, height=None):
    """Ragged uint8 payload [Nw, 4] + int32 meta [6, S] -> (dense int16
    [S, 6*nmb, 64], mvs int16 [S, mbh, mbw, 4, 2], inter bool [S, mbh, mbw],
    status int32 [S])."""
    return _parse_assemble(payload_u8, meta, mbh, mbw, width, height,
                           (0, 0, 0))[:4]


def _parse_assemble(payload_u8, meta, mbh, mbw, width, height, launch_shape):
    """`parse_assemble_cuda` with the kernel's launch shape (lanes per warp,
    lanes per block, tables in shared memory; zeros: chosen by the launcher
    from S) given, as `kernels/automaton_sweep.py` measures it.  On a CUDA
    tensor the result carries a fifth element: the steps each lane's
    automaton took, int32 [S]."""
    global launches
    if payload_u8.dtype != torch.uint8 or meta.dtype != torch.int32:
        raise ValueError("expected a uint8 payload and int32 meta")
    if meta.dim() != 2 or meta.shape[0] != 6:
        raise ValueError(f"meta must be [6, S], got {tuple(meta.shape)}")
    if payload_u8.numel() % 4 or payload_u8.numel() == 0:
        raise ValueError("payload must hold a whole, nonzero number of words")
    if payload_u8.device != meta.device:
        raise ValueError("payload and meta must lie on one device")
    dev = payload_u8.device
    if dev.type == "cpu":
        return parse_assemble(payload_u8, meta, mbh=mbh, mbw=mbw,
                              width=width, height=height)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if mbw > MAX_MBW:
        raise ValueError(f"picture {16 * mbw} pixels wide exceeds the "
                         f"kernel's {16 * MAX_MBW}")
    if not (payload_u8.is_contiguous() and meta.is_contiguous()):
        raise ValueError("payload and meta must be contiguous")
    if payload_u8.data_ptr() % 16:
        raise ValueError("the payload must be 16-byte aligned")
    S = meta.shape[1]
    nmb = mbh * mbw
    dense = torch.zeros((S, 6 * nmb, 64), dtype=torch.int16, device=dev)
    mvs = torch.zeros((S, mbh, mbw, 4, 2), dtype=torch.int16, device=dev)
    inter = torch.ones((S, mbh, mbw), dtype=torch.uint8, device=dev)
    status = torch.empty((2, S), dtype=torch.int32, device=dev)
    ext_x = _extended_range_for_dim(width if width else 16 * mbw, True)
    ext_y = _extended_range_for_dim(height if height else 16 * mbh, False)
    tables = kernels.device_table("automaton", TABLES, dev)
    rc = kernels.lib().h263_automaton(
        payload_u8.data_ptr(), payload_u8.numel(), meta.data_ptr(), S, mbh,
        mbw, ext_x, ext_y, tables.data_ptr(), dense.data_ptr(),
        mvs.data_ptr(), inter.data_ptr(), status.data_ptr(), *launch_shape,
        kernels.stream_handle(dev))
    kernels.check(rc, "h263_automaton")
    launches += 1
    return dense, mvs, inter.view(torch.bool), status[0], status[1]
