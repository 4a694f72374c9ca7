"""Frame reconstruction from residuals, plain PyTorch, batched over streams.

Port of `h263_tpu/decoder/reconstruct.py::reconstruct_from_residuals_single`
and of the Pallas branch of `reconstruct_from_dense` around it:

    planes = clamp(halfpel_gather(ref, mv) + clipped_idct(coeffs), 0, 255)

This is the plain version of the fused CUDA kernel (`ops/reconstruct_cuda.py`):
the tests and CPU tensors use it; on a card the main path does not.
"""

from __future__ import annotations

import torch

from .idct import idct_residual_fused
from .mocomp import chroma_mv, gather_plane


def _blocks_to_plane(res, h, w):
    """[..., nby, nbx, 8, 8] -> [..., nby*8, nbx*8] cropped to [h, w]."""
    nby, nbx = res.shape[-4], res.shape[-3]
    lead = res.shape[:-4]
    plane = res.transpose(-3, -2).reshape(*lead, nby * 8, nbx * 8)
    return plane[..., :h, :w]


def _expand_luma_mvs(mvs):
    """[..., mbh, mbw, 4, 2] -> per-8x8-block [..., 2*mbh, 2*mbw, 2]
    (block k: 0 top-left, 1 top-right, 2 bottom-left, 3 bottom-right)."""
    lead = mvs.shape[:-4]
    mbh, mbw = mvs.shape[-4], mvs.shape[-3]
    g = mvs.reshape(*lead, mbh, mbw, 2, 2, 2).movedim(-3, -4)
    return g.reshape(*lead, mbh * 2, mbw * 2, 2)


def _expand_luma_mask(inter):
    lead = inter.shape[:-2]
    mbh, mbw = inter.shape[-2], inter.shape[-1]
    m = inter[..., :, None, :, None].expand(*lead, mbh, 2, mbw, 2)
    return m.reshape(*lead, mbh * 2, mbw * 2)


def reconstruct_from_residuals(res_y, res_cb, res_cr, mvs, inter,
                               ref_y, ref_cb, ref_cr):
    """Batched `reconstruct_from_residuals_single`: residuals int32
    [S, nby, nbx, 8, 8] per plane, mvs [S, mbh, mbw, 4, 2], inter bool
    [S, mbh, mbw], reference planes uint8 [S, ...] -> uint8 (y, cb, cr).
    One plane at a time, so that the int32 sample planes of only one
    plane are alive at once."""
    h, w = ref_y.shape[-2], ref_y.shape[-1]
    ch, cw = (h + 1) // 2, (w + 1) // 2
    inter = inter.to(torch.bool)

    def clamp(pred, res, ph, pw):
        return (pred + _blocks_to_plane(res, ph, pw)).clamp(0, 255).to(
            torch.uint8)

    y = clamp(gather_plane(ref_y, _expand_luma_mvs(mvs),
                           _expand_luma_mask(inter), (h, w)), res_y, h, w)
    cmv = chroma_mv(mvs)
    cb = clamp(gather_plane(ref_cb, cmv, inter, (ch, cw)), res_cb, ch, cw)
    cr = clamp(gather_plane(ref_cr, cmv, inter, (ch, cw)), res_cr, ch, cw)
    return y, cb, cr


def reconstruct_from_dense_plain(dense, mvs, inter, ref_y, ref_cb, ref_cr,
                                 idct=idct_residual_fused):
    """Dense int16 [S, 6*nmb, 64] coefficients (luma block grid row-major,
    then Cb, then Cr; row-major within a block) + MVs + INTER flags +
    reference planes -> uint8 (y, cb, cr) planes.  `idct` maps the dense
    tensor to int32 residuals of the same shape."""
    s, mbh, mbw = inter.shape
    nmb = mbh * mbw
    res = idct(dense)
    ry = res[:, :4 * nmb].reshape(s, 2 * mbh, 2 * mbw, 8, 8)
    rcb = res[:, 4 * nmb:5 * nmb].reshape(s, mbh, mbw, 8, 8)
    rcr = res[:, 5 * nmb:].reshape(s, mbh, mbw, 8, 8)
    return reconstruct_from_residuals(ry, rcb, rcr, mvs, inter,
                                      ref_y, ref_cb, ref_cr)
