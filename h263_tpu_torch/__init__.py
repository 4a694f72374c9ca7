"""h263_tpu_torch — the PyTorch / CUDA port of h263_tpu's device path.

The JAX package `h263_tpu` stays the reference.  This package imports
neither it nor `jax`: it keeps its own copies of the host layer it needs
(bitstream types, VLC tables, the bit reader and host parsers, the native
entropy decoder and header prep, the test encoder, the FLV demuxer).  What
ran on the device runs here as hand-written CUDA kernels for Hopper
(`csrc/`): the entropy automaton, the fused reconstruction (sparse-class
IDCT + motion compensation + add-clamp), the fused presentation (Annex-J
deblock of the three planes + BT.601 RGBA), the unpack of the host
front-end's fused transport, and the IDCT, the deblock and the RGBA
conversion each on its own.

Entry points, on the card unless the caller names `device="cpu"`, for
Sorenson Spark streams or standard H.263 streams (`DecoderOption.NONE`):
`H263Decoder()`, the single-stream decoder (`decode_next_picture`, the
counterpart of the reference's `H263State::decode_next_picture`, and
`last_picture_rgba`), standard H.263 unless it is given
`DecoderOption.SORENSON_SPARK_BITSTREAM`, as the JAX package's;
`StreamPool()`, the serving pool of streams of mixed resolutions
(`add_stream`, `remove_stream`, `decode_step({id: frame})`,
`present_rgba()`, and `switch_frontend("device")` for a Sorenson host
pool), with the device entropy front-end by default or the host one
(`frontend="host"`); `DeviceFrontendDecoder(n_streams, width, height)`,
one lockstep bucket of the device front-end; and
`BatchedStreamDecoder(n_streams, width, height)`, one bucket of the host
front-end (the native entropy decoder on the host's cores, the delta24
transport unpacked on the card by `csrc/d24.cu`); the last three are
Sorenson by default; the last two also decode sharded over several
devices (`mesh=make_stream_mesh(...)`, `parallel/sharding.py`).  Around
them: `io.stream` (incremental stream input), `utils.checkpoint`
(suspend and resume every decoding surface, in the JAX package's v2
format), `python -m h263_tpu_torch` (decode, info, selftest) and the
examples (`python -m h263_tpu_torch.examples.<name>`).
"""

from .types import (
    BPictureQuantizer,
    DecoderOption,
    H263Error,
    MotionVector,
    Picture,
    PictureOption,
    PictureTypeCode,
    ReferencePictureSelectionMode,
    SliceSubmode,
    SourceFormat,
    SourceFormatKind,
)
from .bitio import BitReader
from .decoder import DecodedPicture, H263Decoder
from .parallel.batch import BatchedStreamDecoder
from .parallel.device_batch import DeviceFrontendDecoder
from .parallel.pool import StreamPool
from .parallel.sharding import (
    StreamMesh,
    StreamShards,
    make_stream_mesh,
    shard_device_frontend_fn,
    shard_present_fn,
    shard_reconstruct_fn,
)

__version__ = "0.1.0"

__all__ = [
    "BPictureQuantizer",
    "BatchedStreamDecoder",
    "BitReader",
    "DecodedPicture",
    "DecoderOption",
    "DeviceFrontendDecoder",
    "H263Decoder",
    "H263Error",
    "MotionVector",
    "Picture",
    "PictureOption",
    "PictureTypeCode",
    "ReferencePictureSelectionMode",
    "SliceSubmode",
    "SourceFormat",
    "SourceFormatKind",
    "StreamMesh",
    "StreamPool",
    "StreamShards",
    "__version__",
    "make_stream_mesh",
    "shard_device_frontend_fn",
    "shard_present_fn",
    "shard_reconstruct_fn",
]
