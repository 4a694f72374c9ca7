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

The single-stream decoder reaches the same kernel at S = 1 through
`reconstruct_frame_single`: one parsed frame (`FrameData`) is staged as
one pinned buffer (`FrameStaging`), copied to the card once, and
reconstructed into the frame's dims against a reference that may keep the
previous picture's dims.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops.d24_cuda import d24_to_dense_cuda, unpack_fused_cuda
from ..ops.present_cuda import present_rgba_cuda
from ..ops.reconstruct import reconstruct_from_residuals  # noqa: F401
from ..ops.reconstruct_cuda import reconstruct_from_dense_cuda
from ..utils.trace import trace_stage


def reconstruct_from_dense(dense, mvs, inter, ref_y, ref_cb, ref_cr,
                           out=None, out_hw=None):
    """Dense int16 [S, 6*nmb, 64] coefficients (luma block grid row-major,
    then Cb, then Cr; row-major within a block) + MVs + INTER flags +
    reference planes -> uint8 (y, cb, cr) planes of luma dims `out_hw`
    (None: the references'), fresh or written into `out` = (y, cb, cr)."""
    return reconstruct_from_dense_cuda(dense, mvs, inter, ref_y, ref_cb,
                                       ref_cr, out=out, out_hw=out_hw)


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


def reconstruct_frame_single(frame, refs, staging):
    """The port's `get_reconstruct_fn(h, w)(...)` of the JAX single decoder:
    one parsed frame (`FrameData`: coefficients [by, bx, 8, 8] per plane,
    MVs int16 [mbh, mbw, 4, 2], INTER flags) and the reference planes
    (uint8 [rh, rw], [(rh+1)//2, (rw+1)//2] twice on `staging.device`, any
    dims; None: zero planes of the frame's dims, as for a first I-frame) ->
    the frame's three uint8 planes [h, w], [ch, cw], [ch, cw].  The dense
    tensor, the MVs and the flags reach the card in one copy
    (`staging.to_device`)."""
    h, w = frame.height, frame.width
    if refs is None:
        refs = tuple(torch.zeros(shape, dtype=torch.uint8,
                                 device=staging.device)
                     for shape in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                                   ((h + 1) // 2, (w + 1) // 2)))
    dense, mvs, inter = staging.to_device(frame)
    planes = reconstruct_from_dense(dense, mvs, inter,
                                    *(r[None] for r in refs), out_hw=(h, w))
    return tuple(p[0] for p in planes)


class FrameStaging:
    """One frame's dense coefficients, MVs and INTER flags staged as the
    bytes [int16 dense (6*nmb, 64) | int16 MVs (mbh, mbw, 4, 2) | uint8
    flags (mbh, mbw)] in a pinned host buffer (kept, and grown when a frame
    needs more), copied to the device in one `non_blocking` copy.  Two
    buffers take turns; the event recorded after a buffer's copy is
    synchronised before the buffer is written again, so the host never
    overwrites bytes a copy may still read.  Both sections before the flags
    are multiples of 16 bytes, so each view on the device is 16-byte
    aligned, as the reconstruct kernel needs."""

    def __init__(self, device):
        self.device = kernels.resolve_device(device)
        self._pin = self.device.type == "cuda"
        self._bufs = [None, None]
        self._copied = [None, None]
        self._i = 0

    def _next(self, nbytes: int) -> torch.Tensor:
        self._i ^= 1
        i = self._i
        if self._copied[i] is not None:
            self._copied[i].synchronize()
            self._copied[i] = None
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(
                -(-nbytes // 65536) * 65536, dtype=torch.uint8,
                pin_memory=self._pin)
        return buf

    def to_device(self, frame):
        """(dense int16 [1, 6*nmb, 64], MVs int16 [1, mbh, mbw, 4, 2],
        flags uint8 [1, mbh, mbw]) of `frame`, on the device."""
        mbh, mbw = frame.mb_h, frame.mb_w
        nmb = mbh * mbw
        a, b = 6 * nmb * 64 * 2, 6 * nmb * 64 * 2 + nmb * 16
        c = b + nmb
        buf = self._next(c)
        host = buf.numpy()
        dense = host[:a].view(np.int16).reshape(6 * nmb, 64)
        dense[:4 * nmb] = frame.coeffs_y.reshape(4 * nmb, 64)
        dense[4 * nmb:5 * nmb] = frame.coeffs_cb.reshape(nmb, 64)
        dense[5 * nmb:] = frame.coeffs_cr.reshape(nmb, 64)
        host[a:b].view(np.int16)[:] = frame.mvs.reshape(-1)
        host[b:c] = frame.inter.reshape(-1)
        with trace_stage("transfer"):
            dev = buf[:c].to(self.device, non_blocking=True, copy=True)
            if self._pin:
                self._copied[self._i] = kernels.record_event(self.device)
        return (dev[:a].view(torch.int16).view(1, 6 * nmb, 64),
                dev[a:b].view(torch.int16).view(1, mbh, mbw, 4, 2),
                dev[b:c].view(1, mbh, mbw))


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

    def __init__(self, n: int, device):
        self.n, self.device = n, kernels.resolve_device(device)
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
            self._copied = kernels.record_event(self.device)
        return dev[:n4].view(torch.int32), dev[n4:].view(torch.bool)
