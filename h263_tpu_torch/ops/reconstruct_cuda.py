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


def reconstruct_from_dense_cuda(dense, mvs, inter, ref_y, ref_cb, ref_cr):
    """dense int16 [S, 6*nmb, 64] (luma block grid row-major, then Cb, then
    Cr), mvs int16 [S, mbh, mbw, 4, 2], inter bool or uint8 [S, mbh, mbw],
    ref_y uint8 [S, h, w], ref_cb / ref_cr uint8 [S, ch, cw] -> three fresh
    uint8 planes of the references' shapes."""
    global launches
    if inter.dim() != 3:
        raise ValueError(f"inter must be [S, mbh, mbw], got "
                         f"{tuple(inter.shape)}")
    s, mbh, mbw = inter.shape
    if ref_y.dim() != 3:
        raise ValueError(f"ref_y must be [S, h, w], got {tuple(ref_y.shape)}")
    h, w = ref_y.shape[1:]
    chroma = (s, (h + 1) // 2, (w + 1) // 2)
    want = {
        "dense": (dense, torch.int16, (s, 6 * mbh * mbw, 64)),
        "mvs": (mvs, torch.int16, (s, mbh, mbw, 4, 2)),
        "ref_y": (ref_y, torch.uint8, (s, h, w)),
        "ref_cb": (ref_cb, torch.uint8, chroma),
        "ref_cr": (ref_cr, torch.uint8, chroma),
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
    if dev.type == "cpu":
        return reconstruct_from_dense_plain(*tensors)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")
    if dense.data_ptr() % 16 or mvs.data_ptr() % 16:
        raise ValueError("dense and mvs must be 16-byte aligned")
    out = tuple(torch.empty_like(r) for r in (ref_y, ref_cb, ref_cr))
    basis = kernels.device_table("idct_basis", _BASIS, dev)
    rc = kernels.lib().h263_reconstruct(
        dense.data_ptr(), mvs.data_ptr(), inter.data_ptr(), ref_y.data_ptr(),
        ref_cb.data_ptr(), ref_cr.data_ptr(), *(o.data_ptr() for o in out),
        s, mbh, mbw, h, w, basis.data_ptr(), kernels.stream_handle(dev))
    kernels.check(rc, "h263_reconstruct")
    launches += 1
    return out
