"""Wrapper of the fused CUDA reconstruction kernel (`csrc/reconstruct.cu`).

It replaces the Pallas TPU kernel `h263_tpu/ops/idct_pallas.py::_kernel`
together with the XLA tail the JAX package left around it
(`h263_tpu/decoder/reconstruct.py::reconstruct_from_dense`: residual planes,
`gather_plane_jnp`, `chroma_mv_jnp`, add and clamp).  The kernel is bound by
bytes: it reads the coefficients and the reference planes once and writes
the new planes once; the residual and the prediction stay on the chip.  A
CPU tensor goes to the plain version (`ops/reconstruct.py`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .idct_cuda import _BASIS
from .reconstruct import reconstruct_from_dense_plain

# Kernel launches since the last reset (plain-version calls do not count).
launches = 0


def _overlap(a, b) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def reconstruct_from_dense_cuda(dense, mvs, inter, ref_y, ref_cb, ref_cr,
                                out=None, out_hw=None):
    """dense int16 [S, 6*nmb, 64] (luma block grid row-major, then Cb, then
    Cr), mvs int16 [S, mbh, mbw, 4, 2], inter bool or uint8 [S, mbh, mbw],
    ref_y uint8 [S, rh, rw], ref_cb / ref_cr uint8 [S, (rh+1)//2,
    (rw+1)//2] -> three uint8 planes [S, h, w], [S, ch, cw] twice, where
    `out_hw` = (h, w) gives the output's luma dims (None: the references',
    as the batched decoders have it; other dims: a picture after a size
    change, predicted from the previous picture at its own dims, as the JAX
    single decoder's `get_reconstruct_fn(h, w)` does).  The planes are
    fresh ones, or `out` = (y, cb, cr), contiguous tensors of those shapes
    that overlap no reference (a window writes frame t into its slices of
    [T, S, ...] batches)."""
    global launches
    if inter.dim() != 3:
        raise ValueError(f"inter must be [S, mbh, mbw], got "
                         f"{tuple(inter.shape)}")
    s, mbh, mbw = inter.shape
    if ref_y.dim() != 3:
        raise ValueError(f"ref_y must be [S, h, w], got {tuple(ref_y.shape)}")
    rh, rw = ref_y.shape[1:]
    h, w = (rh, rw) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
    if h <= 0 or w <= 0:
        raise ValueError(f"out_hw must be positive, got {out_hw}")
    ref_chroma = (s, (rh + 1) // 2, (rw + 1) // 2)
    want = {
        "dense": (dense, torch.int16, (s, 6 * mbh * mbw, 64)),
        "mvs": (mvs, torch.int16, (s, mbh, mbw, 4, 2)),
        "ref_y": (ref_y, torch.uint8, (s, rh, rw)),
        "ref_cb": (ref_cb, torch.uint8, ref_chroma),
        "ref_cr": (ref_cr, torch.uint8, ref_chroma),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if inter.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"inter: expected bool or uint8, got {inter.dtype}")
    if h > 16 * mbh or w > 16 * mbw:
        raise ValueError(f"picture {w}x{h} exceeds the {mbw}x{mbh} "
                         f"macroblock grid")
    tensors = (dense, mvs, inter, ref_y, ref_cb, ref_cr)
    dev = dense.device
    if any(t.device != dev for t in tensors):
        raise ValueError("all tensors must lie on one device")
    refs = (ref_y, ref_cb, ref_cr)
    shapes = ((s, h, w), (s, (h + 1) // 2, (w + 1) // 2),
              (s, (h + 1) // 2, (w + 1) // 2))
    if out is not None:
        out = tuple(out)
        for name, o, shape in zip(("y", "cb", "cr"), out, shapes):
            if (o.dtype != torch.uint8 or tuple(o.shape) != shape
                    or o.device != dev or not o.is_contiguous()):
                raise ValueError(f"out {name}: expected contiguous uint8 "
                                 f"{shape} on {dev}")
            if any(_overlap(o, x) for x in refs):
                raise ValueError(f"out {name} overlaps a reference plane")
    if dev.type == "cpu":
        return reconstruct_from_dense_plain(*tensors, out=out, out_hw=(h, w))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")
    if dense.data_ptr() % 16 or mvs.data_ptr() % 16:
        raise ValueError("dense and mvs must be 16-byte aligned")
    if out is None:
        out = tuple(torch.empty(shape, dtype=torch.uint8, device=dev)
                    for shape in shapes)
    basis = kernels.device_table("idct_basis", _BASIS, dev)
    kernels.launch(
        "h263_reconstruct", dev, dense.data_ptr(), mvs.data_ptr(),
        inter.data_ptr(), ref_y.data_ptr(), ref_cb.data_ptr(),
        ref_cr.data_ptr(), *(o.data_ptr() for o in out), s, mbh, mbw, h, w,
        rh, rw, basis.data_ptr())
    launches += 1
    return out
