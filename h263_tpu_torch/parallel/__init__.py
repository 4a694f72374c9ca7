"""Multi-stream parallel decode: the port's scaling axis.

S concurrent streams decode as one batch over a [stream, ...] axis, and
`sharding` splits that axis over a mesh of devices with nothing crossing
between shards (`mesh=` on `BatchedStreamDecoder` and
`DeviceFrontendDecoder`).
"""

from .batch import BatchedStreamDecoder
from .device_batch import DeviceFrontendDecoder
from .pool import PoolStepResult, StreamPool
from .sharding import (
    StreamMesh,
    StreamShards,
    make_stream_mesh,
    shard_device_frontend_fn,
    shard_present_fn,
    shard_reconstruct_fn,
)

__all__ = ["BatchedStreamDecoder", "DeviceFrontendDecoder", "PoolStepResult",
           "StreamPool", "make_stream_mesh", "shard_device_frontend_fn",
           "shard_present_fn", "shard_reconstruct_fn", "StreamMesh",
           "StreamShards"]
