"""Annex-J deblocking filter, plain PyTorch.

Port of `h263_tpu/ops/deblock.py::deblock_jnp`.  The reference mixes two
integer divisions: its SIMD zone divides by arithmetic shift (floor), its
scalar remainder by Rust `/` (truncation toward zero), so

  * horizontal edges: columns [0, 8*(w//8)) floor, the rest trunc;
  * vertical edges:   rows    [0, 8*(h//8)) floor, the rest trunc.

A and D write back with a wrapping u8 cast; B and C clamp to [0, 255].

`deblock_batched` is the plain version of the CUDA kernel
(`ops/deblock_cuda.py`): per-stream strengths and an apply mask.
"""

from __future__ import annotations

import numpy as np
import torch

# Table J.2/H.263 (deblock.rs:5-8; `h263_tpu/ops/deblock.py`); index by
# QUANT, [0] unused.
QUANT_TO_STRENGTH = np.array(
    [0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 7, 7, 8, 8, 8, 9, 9, 9,
     10, 10, 10, 11, 11, 11, 12, 12, 12], dtype=np.int32)


def _div_trunc(x, d):
    return torch.div(x, d, rounding_mode="trunc")


def _process(a, b, c, d, strength, floor_mode):
    """One ABCD quartet update on int32 tensors; returns new (a, b, c, d)."""
    num = a - 4 * b + 4 * c - d
    diff = a - d
    if floor_mode:
        dd = num >> 3
        d2_in = diff >> 2
    else:
        dd = _div_trunc(num, 8)
        d2_in = _div_trunc(diff, 4)
    ax = dd.abs()
    d1 = torch.sign(dd) * torch.clamp(ax - torch.clamp(2 * (ax - strength),
                                                      min=0), min=0)
    lim = (d1 >> 1).abs() if floor_mode else _div_trunc(d1, 2).abs()
    d2 = torch.maximum(torch.minimum(d2_in, lim), -lim)
    na = (a - d2) & 0xFF
    nb = torch.clamp(b + d1, 0, 255)
    nc = torch.clamp(c - d1, 0, 255)
    nd = (d + d2) & 0xFF
    return na, nb, nc, nd


def deblock(plane, strength):
    """Deblock uint8 planes [..., H, W]; `strength` is an int or an int32
    tensor broadcastable to [..., 1, 1] (per stream)."""
    h, w = plane.shape[-2], plane.shape[-1]
    dev = plane.device
    out = plane.to(torch.int32)
    if isinstance(strength, torch.Tensor):
        strength = strength.to(torch.int32)
    simd_w = (w // 8) * 8

    edge_rows = list(range(8, h - 1, 8))
    if edge_rows:
        ey = torch.tensor(edge_rows, device=dev)
        quart = [out[..., ey + o, :] for o in (-2, -1, 0, 1)]
        new = _process(*quart, strength, True)
        if simd_w < w:
            tr = _process(*quart, strength, False)
            col = torch.arange(w, device=dev) < simd_w
            new = [torch.where(col, f, t) for f, t in zip(new, tr)]
        for o, v in zip((-2, -1, 0, 1), new):
            out[..., ey + o, :] = v

    if w >= 10:
        simd_h = (h // 8) * 8
        n_chunks = (w - 2) // 8
        if n_chunks:
            ca = torch.tensor([2 + 8 * k + 4 for k in range(n_chunks)],
                              device=dev)
            quart = [out[..., :, ca + o] for o in range(4)]
            new = _process(*quart, strength, True)
            if simd_h < h:
                tr = _process(*quart, strength, False)
                row = (torch.arange(h, device=dev) < simd_h)[:, None]
                new = [torch.where(row, f, t) for f, t in zip(new, tr)]
            for o, v in zip(range(4), new):
                out[..., :, ca + o] = v

    return out.to(torch.uint8)


def deblock_batched(planes, strength, apply):
    """uint8 planes [S, H, W], int32 strength [S], bool apply [S] -> uint8
    [S, H, W]: stream s deblocked with strength[s] where apply[s] and
    strength[s] > 0, else copied."""
    s3 = strength.to(torch.int32)[:, None, None]
    use = apply.to(torch.bool)[:, None, None] & (s3 > 0)
    return torch.where(use, deblock(planes, s3), planes)
