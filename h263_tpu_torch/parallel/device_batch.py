"""Batched decoding with the device entropy front-end, PyTorch.

Port of `h263_tpu/parallel/device_batch.py::DeviceFrontendDecoder`, single-
frame step, ragged payload only.  Per step:

    native header prep (host) -> one host-to-device copy of the ragged
    payload + int32 meta [6, S] -> entropy automaton (CUDA kernel) ->
    IDCT + motion compensation + add-clamp (one CUDA kernel) -> planes

The reference planes stay on the device.  Errored lanes emit the identity
frame, so their previous picture persists (the reference's whole-picture
transaction).  Per-stream status stays on the device until `fetch_status`.

Host staging: the payload and meta go through one pinned ping-pong pair,
sized for every stream at the frame cap (grown if a step needs more), and
only the step's used words are copied, with `non_blocking=True`.  Each
buffer carries a CUDA event recorded after its copy; before a buffer is
written again, its event is synchronised, so the host never overwrites
bytes a copy may still read.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..decoder.reconstruct import present_rgba_batched, reconstruct_from_dense
from ..native import DevicePrepBatch
from ..ops.deblock import QUANT_TO_STRENGTH
from ..parser.automaton_cuda import parse_assemble_cuda
from ..testing.encoder import MBSpec, encode_sorenson_picture
from ..types import DecoderOption, H263Error, PictureTypeCode


class DeviceFrontendDecoder:
    """Decode S same-resolution Sorenson streams, one frame per stream per
    `decode_step`, on `device` ("cuda", the default, or "cpu"; no fallback
    between them).
    """

    def __init__(self, n_streams: int, width: int, height: int,
                 decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 *, device="cuda", max_frame_bytes: Optional[int] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        if not decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM:
            raise ValueError("the native header prep parses Sorenson "
                             "headers only")
        self.n = n_streams
        self.w, self.h = width, height
        self.cw, self.ch = (width + 1) // 2, (height + 1) // 2
        self.mb_w, self.mb_h = -(-width // 16), -(-height // 16)
        cap = (((max_frame_bytes or 8192) + 3) // 4) * 4
        self.max_frame_bytes = cap
        self._prep = DevicePrepBatch(n_streams, width, height)

        def planes(h, w):
            return torch.zeros((n_streams, h, w), dtype=torch.uint8,
                               device=self.device)

        self.ref_y = planes(self.h, self.w)
        self.ref_cb = planes(self.ch, self.cw)
        self.ref_cr = planes(self.ch, self.cw)
        self.last_status: Optional[torch.Tensor] = None
        self._skip: Optional[bytes] = None
        # Last-good presentation params per stream (quantizer -> deblock
        # strength, advisory deblocker flag).
        self._last_quant = np.full(n_streams, 8, dtype=np.int32)
        self._last_deblock = np.zeros(n_streams, dtype=np.bool_)
        # Ping-pong staging pair: flat payload bytes (one spare zero word,
        # so the payload is never empty), meta, the event of the last copy.
        self._pin = self.device.type == "cuda"
        self._stage = [torch.zeros(n_streams * cap + 4, dtype=torch.uint8,
                                   pin_memory=self._pin) for _ in range(2)]
        self._meta = [torch.zeros((6, n_streams), dtype=torch.int32,
                                  pin_memory=self._pin) for _ in range(2)]
        self._copied = [None, None]
        self._pp = 0

    # -- host-side helpers ---------------------------------------------------

    def _skip_frame_bytes(self) -> bytes:
        """An all-uncoded P-frame: decodes to the identity frame."""
        if self._skip is None:
            self._skip = encode_sorenson_picture(
                self.w, self.h, PictureTypeCode.P_FRAME,
                [MBSpec(kind="uncoded")] * (self.mb_w * self.mb_h),
                temporal_reference=0)
        return self._skip

    def _next_stage(self, nbytes: int):
        """The next buffer of the ping-pong pair as its first `nbytes`
        bytes ([nbytes // 4, 4]) and its meta, once the copy that last read
        it has finished."""
        self._pp ^= 1
        i = self._pp
        if self._copied[i] is not None:
            self._copied[i].synchronize()
            self._copied[i] = None
        if self._stage[i].numel() < nbytes:
            self._stage[i] = torch.zeros(nbytes, dtype=torch.uint8,
                                         pin_memory=self._pin)
        return self._stage[i][:nbytes].view(-1, 4), self._meta[i]

    # -- the step ------------------------------------------------------------

    def decode_step(self, buffers: Sequence[Optional[bytes]], mask=None):
        """Decode one frame per stream; returns (y, cb, cr) uint8 planes on
        the device.  `None` (or a False `mask` slot) decodes the skip frame
        with the header commit suppressed.  A frame over the transfer cap or
        with a rejected header decodes as the identity frame, and the first
        such error is raised after the step has been dispatched."""
        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")
        if mask is not None:
            buffers = [b if mask[i] else None for i, b in enumerate(buffers)]
        cap = self.max_frame_bytes
        bufs = [self._skip_frame_bytes() if b is None
                else (b"" if len(b) > cap else b) for b in buffers]
        stage, meta = self._next_stage(
            sum(((len(b) + 3) // 4) * 4 for b in bufs) + 4)

        failed = self._prep.prepare_ragged(bufs, stage.numpy(), meta.numpy())
        hdr = self._prep.hdr
        okm = self._prep.rc == 0
        commit = okm & np.array([b is not None for b in buffers], dtype=bool)
        np.copyto(self._last_quant, hdr[:, 6], where=commit)
        np.copyto(self._last_deblock, hdr[:, 5] != 0, where=commit)
        first_err: Optional[Exception] = None
        if failed:
            i = int(np.argmin(okm))
            first_err = H263Error(
                f"stream {i}: header rejected by device front-end prep "
                f"(rc {int(self._prep.rc[i])})")

        dev_stage = stage.to(self.device, non_blocking=True, copy=True)
        dev_meta = meta.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._copied[self._pp] = ev

        dense, mvs, inter, status = parse_assemble_cuda(
            dev_stage, dev_meta, mbh=self.mb_h, mbw=self.mb_w,
            width=self.w, height=self.h)
        y, cb, cr = reconstruct_from_dense(dense, mvs, inter, self.ref_y,
                                           self.ref_cb, self.ref_cr)
        self.ref_y, self.ref_cb, self.ref_cr = y, cb, cr
        self.last_status = status
        if first_err is not None:
            raise first_err
        return y, cb, cr

    # -- state ---------------------------------------------------------------

    def load_state(self, y, cb, cr, last_quant=None, last_deblock=None):
        """Replace the reference planes (uint8 numpy [S, H, W] and two
        [S, ch, cw]) and, when given, the per-stream presentation state
        (last quantizer int [S], last deblock flag bool [S]) — e.g. to
        continue a GOP that another decoder started."""
        shapes = ((self.n, self.h, self.w), (self.n, self.ch, self.cw),
                  (self.n, self.ch, self.cw))
        for a, s in zip((y, cb, cr), shapes):
            if np.shape(a) != s:
                raise ValueError(f"plane shape {np.shape(a)} != {s}")
        self.ref_y, self.ref_cb, self.ref_cr = (
            torch.tensor(np.asarray(a, dtype=np.uint8), device=self.device)
            for a in (y, cb, cr))
        if last_quant is not None:
            self._last_quant[:] = np.asarray(last_quant, dtype=np.int32)
        if last_deblock is not None:
            self._last_deblock[:] = np.asarray(last_deblock, dtype=np.bool_)

    def reset_slot_state(self, slot: int, running=None) -> None:
        """Reset one lane to a fresh stream: planes zeroed, presentation
        params and status cleared (the pool's slot-recycle contract).
        `running` is the JAX package's carried-options seed, which Sorenson
        headers never use; it is accepted for the same call shape."""
        # Out of place: the planes and status a step returned stay as
        # they were.
        idx = torch.tensor([slot], device=self.device)
        self.ref_y = self.ref_y.index_fill(0, idx, 0)
        self.ref_cb = self.ref_cb.index_fill(0, idx, 0)
        self.ref_cr = self.ref_cr.index_fill(0, idx, 0)
        self._last_quant[slot] = 8
        self._last_deblock[slot] = False
        if self.last_status is not None:
            self.last_status = self.last_status.index_fill(0, idx, 0)

    def fetch_status(self) -> np.ndarray:
        """The last step's per-stream status (int32; 0 = ok).  Waits for
        the step to finish."""
        return self.last_status.cpu().numpy()

    def present_rgba(self, deblock: Optional[bool] = None):
        """RGBA uint8 [S, H, W, 4] of the current planes: per-stream deblock
        (the stream's advisory flag, or `deblock` for all) + BT.601."""
        strength = QUANT_TO_STRENGTH[self._last_quant & 31].astype(np.int32)
        flags = (self._last_deblock if deblock is None
                 else np.full(self.n, deblock, dtype=np.bool_))
        return present_rgba_batched(
            self.ref_y, self.ref_cb, self.ref_cr,
            torch.as_tensor(strength).to(self.device),
            torch.as_tensor(flags).to(self.device))
