"""Stream sharding over several devices, PyTorch.

Port of `h263_tpu/parallel/sharding.py`.  Streams are independent, so the
only sharded axis is `stream`: a mesh is a list of devices, each shard a
contiguous equal range of the streams on its device, and nothing crosses
between shards.  Where the JAX package compiled one SPMD program per chip
with `NamedSharding`, each function here returns a callable that runs the
port's program once per shard, in mesh order, on the shard's device and
that device's current stream, with no host synchronisation between shards.

`StreamShards` stands in for a stream-sharded `jax.Array`: a tuple of the
per-shard tensors.  A mesh may repeat a device: `["cpu"] * 8` is the CPU
counterpart of the JAX tests' 8 virtual CPU devices, and `["cuda:0"] * 2`
runs two shards on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import kernels
from ..decoder import reconstruct as rec
from ..parser import automaton_cuda


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """A 1-D mesh of indexed devices over the axis "stream"."""

    devices: tuple
    axis_names: tuple = ("stream",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> int:
        """How many distinct devices the mesh spans."""
        return len(set(self.devices))

    def shard_ranges(self, n_streams: int) -> list:
        """[(lo, hi)] of each shard's contiguous streams; the stream count
        must divide over the mesh (the JAX sharding's rule)."""
        if n_streams % self.size:
            raise ValueError(f"{n_streams} streams do not divide over a mesh "
                             f"of {self.size} devices")
        k = n_streams // self.size
        return [(i * k, (i + 1) * k) for i in range(self.size)]


def make_stream_mesh(devices=None) -> StreamMesh:
    """A 1-D mesh over every visible CUDA device, or over `devices` (names
    or torch.devices, repeats allowed).  Without CUDA, `None` raises: a CPU
    mesh is only built when its devices are named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_stream_mesh(): CUDA is not available; "
                               "name the devices for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(kernels.resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh's devices are all CUDA or all CPU, not "
                         f"{[str(d) for d in devices]}")
    return StreamMesh(devices)


class StreamShards(tuple):
    """The port's stream-sharded array: a tuple of per-shard tensors, shard
    k on its own device, split along `axis` (0 for [S, ...]; a window's
    [T, S, ...] outputs are split along 1)."""

    def __new__(cls, shards, axis: int = 0):
        self = super().__new__(cls, shards)
        self.axis = axis
        return self

    @property
    def shape(self) -> tuple:
        s = list(self[0].shape)
        s[self.axis] = sum(t.shape[self.axis] for t in self)
        return tuple(s)

    @property
    def dtype(self):
        return self[0].dtype

    @property
    def devices(self) -> tuple:
        return tuple(t.device for t in self)

    @property
    def device_set(self) -> set:
        return set(self.devices)

    def gather(self, device="cpu") -> torch.Tensor:
        """The shards concatenated on one device."""
        return torch.cat([t.to(device) for t in self], dim=self.axis)

    def __array__(self, dtype=None, copy=None):
        a = self.gather("cpu").numpy()
        return a if dtype is None else a.astype(dtype)


def scatter(mesh: StreamMesh, x, axis: int = 0) -> StreamShards:
    """`x` split over the mesh along `axis`: a host array or a tensor is cut
    into the shard ranges and each range copied to its device, as jit's
    `in_shardings` places an input; StreamShards are checked and kept."""
    if isinstance(x, StreamShards):
        if x.devices != mesh.devices:
            raise ValueError(f"shards on {x.devices}, mesh {mesh.devices}")
        return x
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return StreamShards(
        [t.narrow(axis, lo, hi - lo).to(dev).contiguous()
         for dev, (lo, hi) in zip(mesh.devices,
                                  mesh.shard_ranges(t.shape[axis]))], axis)


def place(x, device=None, mesh=None):
    """Host array `x`, copied, on `device`, or scattered over `mesh`."""
    t = torch.tensor(np.asarray(x))
    return t.to(device) if mesh is None else scatter(mesh, t)


def _per_shard(mesh, name, n_out, **kw):
    """The function `name` of `decoder/reconstruct.py` (looked up at each
    call, so a stand-in installed there sees every shard's call) applied
    to each shard's inputs in mesh order, with `kw`; the outputs
    re-assembled as StreamShards (a tuple of them when n_out > 1)."""

    def run(*args):
        fn = getattr(rec, name)
        ins = [scatter(mesh, a) for a in args]
        outs = [fn(*(a[k] for a in ins), **kw) for k in range(mesh.size)]
        if n_out == 1:
            return StreamShards(outs)
        return tuple(StreamShards([o[j] for o in outs]) for j in range(n_out))

    return run


def shard_reconstruct_fn(mesh: StreamMesh, h: int, w: int, packed=False,
                         mv_full=False):
    """A stream-sharded batched reconstruction program returning (y, cb,
    cr) as StreamShards.  packed=False takes the dense program
    (`reconstruct_from_dense`: dense int16 [S, 6*nmb, 64], MVs, INTER flags,
    the three reference planes), "d24" the delta24 entries beside int16
    MVs and byte flags (`reconstruct_frame_packed_d24`), "d24f" the fused
    single-leaf rows (`reconstruct_frame_packed_d24_fused`, `mv_full`
    selecting the slim or full MV rows) beside the references.  Inputs are
    host arrays or tensors (scattered) or StreamShards on the mesh."""
    if packed == "d24f":
        return _per_shard(mesh, "reconstruct_frame_packed_d24_fused", 3,
                          mv_full=mv_full, mbh=-(-h // 16), mbw=-(-w // 16))
    if packed == "d24":
        return _per_shard(mesh, "reconstruct_frame_packed_d24", 3)
    if packed is False or packed is None:
        return _per_shard(mesh, "reconstruct_from_dense", 3)
    raise ValueError(
        f"packed must be False, 'd24' or 'd24f' (the port has no u32 or "
        f"split transport); got {packed!r}")


def shard_device_frontend_fn(mesh: StreamMesh, h: int, w: int):
    """A stream-sharded device-front-end step: per shard, its staged
    ragged payload (uint8 [Nw, 4]) and meta (int32 [6, S/n], or [T, 6, S/n]
    for a window of T frames) -> the entropy automaton -> the
    reconstruction against the shard's reference planes.  `payloads` and
    `metas` hold one tensor per shard, on the shard's device (a ragged
    payload has no stream axis to scatter); the references are StreamShards
    or host arrays.  Returns (y, cb, cr, status) as StreamShards, split
    along the stream axis (axis 1 of a window's [T, S, ...] outputs)."""
    mbh, mbw = -(-h // 16), -(-w // 16)

    def run(payloads: Sequence, metas: Sequence, ref_y, ref_cb, ref_cr):
        if len(payloads) != mesh.size or len(metas) != mesh.size:
            raise ValueError(f"expected {mesh.size} payloads and metas")
        refs = [scatter(mesh, r) for r in (ref_y, ref_cb, ref_cr)]
        outs = []
        for k, dev in enumerate(mesh.devices):
            if payloads[k].device != dev or metas[k].device != dev:
                raise ValueError(f"shard {k}'s payload and meta must lie on "
                                 f"{dev}")
            outs.append(automaton_cuda.whole_step(
                payloads[k], metas[k], *(r[k] for r in refs), mbh=mbh,
                mbw=mbw, width=w, height=h))
        axis = 1 if metas[0].dim() == 3 else 0
        return tuple(StreamShards([o[j] for o in outs], axis)
                     for j in range(4))

    return run


def shard_present_fn(mesh: StreamMesh):
    """A stream-sharded presentation program (deblock + BT.601): y [S, H,
    W], cb/cr [S, ch, cw], strength int32 [S], apply bool [S] -> RGBA uint8
    [S, H, W, 4] as StreamShards, each shard through the fused present
    kernel on its own device."""
    return _per_shard(mesh, "present_rgba_batched", 1)
