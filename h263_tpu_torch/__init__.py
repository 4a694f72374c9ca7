"""h263_tpu_torch — the PyTorch / CUDA port of h263_tpu's device path.

The JAX package `h263_tpu` stays the reference.  This package imports
neither it nor `jax`: it keeps its own copies of the host layer it needs
(bitstream types, VLC tables, the native header prep, the test encoder, the
FLV demuxer).  What ran on the device runs here as hand-written CUDA
kernels for Hopper (`csrc/`): the entropy automaton, the fused
reconstruction (sparse-class IDCT + motion compensation + add-clamp), the
IDCT on its own, the Annex-J deblock and the BT.601 RGBA conversion.

Entry points, on the card unless the caller names `device="cpu"`:
`StreamPool()`, the serving pool of Sorenson streams of mixed resolutions
(`add_stream`, `remove_stream`, `decode_step({id: frame})`,
`present_rgba()`), and `DeviceFrontendDecoder(n_streams, width, height)`,
one lockstep bucket of it.
"""

from .parallel.device_batch import DeviceFrontendDecoder
from .parallel.pool import StreamPool

__all__ = ["DeviceFrontendDecoder", "StreamPool"]
