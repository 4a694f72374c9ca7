"""Wrapper of the CUDA entropy-automaton kernel (`csrc/automaton.cu`).

It replaces the TPU automaton (`docs/retired/parse_pallas.py::
parse_frames_pallas` around `h263_tpu/parser/device_frontend.py::make_step`,
which ran as an XLA while_loop) together with `assemble`.  A CPU tensor goes
to the plain version (`parser/device_frontend.py::parse_assemble`); a CUDA
tensor launches the kernel or raises.

A window of T frames (meta [T, 6, S], every frame's payload in the one flat
buffer) is one launch over T*S lanes, lane t*S + s: a frame's entropy decode
reads nothing of the frame before it, so the window's T frames run side by
side and only their reconstructions run in order.  `whole_step` is the
device half of a device-front-end step on one device: this kernel, then
the reconstruction.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..decoder.reconstruct import reconstruct_from_dense
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
    status int32 [S]).  With meta [T, 6, S] (a window: row 5 of frame t
    holds word offsets into the same payload) every output gains a leading
    [T] dimension, from one launch."""
    return _parse_assemble(payload_u8, meta, mbh, mbw, width, height,
                           (0, 0, 0))[:4]


def _parse_assemble(payload_u8, meta, mbh, mbw, width, height, launch_shape):
    """`parse_assemble_cuda` with the kernel's launch shape (lanes per warp,
    lanes per block, tables in shared memory; zeros: chosen by the launcher
    from the lane count) given, as `kernels/automaton_sweep.py` measures
    it.  On a CUDA tensor the result carries a fifth element: the steps each
    lane's automaton took, int32 [S] (or [T, S])."""
    global launches
    if payload_u8.dtype != torch.uint8 or meta.dtype != torch.int32:
        raise ValueError("expected a uint8 payload and int32 meta")
    if meta.dim() not in (2, 3) or meta.shape[-2] != 6:
        raise ValueError(f"meta must be [6, S] or [T, 6, S], got "
                         f"{tuple(meta.shape)}")
    if payload_u8.numel() % 4 or payload_u8.numel() == 0:
        raise ValueError("payload must hold a whole, nonzero number of words")
    if payload_u8.device != meta.device:
        raise ValueError("payload and meta must lie on one device")
    lead = tuple(meta.shape[:-2]) + (meta.shape[-1],)   # (S,) or (T, S)
    dev = payload_u8.device
    if dev.type == "cpu":
        # The plain version takes the window's lanes as one flat batch.
        flat = meta.transpose(0, 1).reshape(6, -1) if meta.dim() == 3 \
            else meta
        out = parse_assemble(payload_u8, flat, mbh=mbh, mbw=mbw,
                             width=width, height=height)
        return tuple(t.reshape(*lead, *t.shape[1:]) for t in out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if mbw > MAX_MBW:
        raise ValueError(f"picture {16 * mbw} pixels wide exceeds the "
                         f"kernel's {16 * MAX_MBW}")
    if not (payload_u8.is_contiguous() and meta.is_contiguous()):
        raise ValueError("payload and meta must be contiguous")
    if payload_u8.data_ptr() % 16:
        raise ValueError("the payload must be 16-byte aligned")
    S = int(np.prod(lead))                  # lanes of the launch, T * S
    nmb = mbh * mbw
    dense = torch.zeros((S, 6 * nmb, 64), dtype=torch.int16, device=dev)
    mvs = torch.zeros((S, mbh, mbw, 4, 2), dtype=torch.int16, device=dev)
    inter = torch.ones((S, mbh, mbw), dtype=torch.uint8, device=dev)
    status = torch.empty((2, S), dtype=torch.int32, device=dev)
    ext_x = _extended_range_for_dim(width if width else 16 * mbw, True)
    ext_y = _extended_range_for_dim(height if height else 16 * mbh, False)
    tables = kernels.device_table("automaton", TABLES, dev)
    kernels.launch(
        "h263_automaton", dev, payload_u8.data_ptr(), payload_u8.numel(),
        meta.data_ptr(), S, lead[-1], mbh, mbw, ext_x, ext_y,
        tables.data_ptr(), dense.data_ptr(), mvs.data_ptr(), inter.data_ptr(),
        status.data_ptr(), *launch_shape)
    launches += 1
    return tuple(t.view(*lead, *t.shape[1:]) for t in (
        dense, mvs, inter.view(torch.bool), status[0], status[1]))


def whole_step(payload, meta, ref_y, ref_cb, ref_cr, *, mbh, mbw, width,
               height):
    """The device half of a step on one device, the port's
    `make_whole_step`: a staged ragged payload (uint8 [Nw, 4]) and meta
    (int32 [6, S]) -> the entropy automaton -> the reconstruction against
    the reference planes -> (y, cb, cr, status).  With meta [T, 6, S] (a
    window) it is one automaton launch over T*S lanes, then T
    reconstructions in stream order, each against the frame before, into
    [T, S, ...] batches; status is then [T, S]."""
    dense, mvs, inter, status = parse_assemble_cuda(
        payload, meta, mbh=mbh, mbw=mbw, width=width, height=height)
    if meta.dim() == 2:
        return (*reconstruct_from_dense(dense, mvs, inter, ref_y, ref_cb,
                                        ref_cr), status)
    T, dev = meta.shape[0], payload.device
    ys = torch.empty((T, *ref_y.shape), dtype=torch.uint8, device=dev)
    cbs = torch.empty((T, *ref_cb.shape), dtype=torch.uint8, device=dev)
    crs = torch.empty_like(cbs)
    for t in range(T):
        reconstruct_from_dense(dense[t], mvs[t], inter[t], ref_y, ref_cb,
                               ref_cr, out=(ys[t], cbs[t], crs[t]))
        ref_y, ref_cb, ref_cr = ys[t], cbs[t], crs[t]
    return ys, cbs, crs, status
