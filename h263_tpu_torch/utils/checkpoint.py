"""Decoder state checkpoint / resume: the port of
`h263_tpu/utils/checkpoint.py`, format v2.

The complete inter-frame state of a stream is small and explicit
(state.rs:16-38 semantics): up to two reference pictures, the running
options, and the last/reference temporal references.  These helpers
serialize it so a decode can be suspended, migrated across hosts or cards,
and resumed bit-exactly.

Format (v2): a zip archive written by ``np.savez`` whose member ``meta``
holds a JSON document and whose remaining members are the raw uint8 planes.
Every header field is spelled out as JSON primitives — no Python object
graphs.  The schema is the JAX package's, so its blobs load here:

* a JAX blob of any of the four kinds (decoder, device front-end, batched,
  pool, with either front-end) loads into the port's counterpart and
  decoding continues as the JAX decoder continues;
* a port blob of kind ``decoder`` carries every key the JAX loader reads,
  so `h263_tpu.utils.checkpoint.load_decoder_state` resumes it; the port's
  other kinds round-trip within the port.

The loaders drop, by name, the JAX-only constructor knobs that the port
does not have (`JAX_ONLY_KNOBS`: the tape, the parse harness, Pallas, the
payload layout, the coefficient transport) and the per-stream last buffers
that fed `resolve_overflows` (the port's automaton has no tape to
overflow); any other unknown keyword still raises.  v1 blobs are pickles
of the JAX package's own classes, and unpickling them would import it: the
loaders refuse them.

Saving copies the reference planes to host memory (a mesh decoder's
shards gathered), a sync point.  Loading puts them on `device` ("cuda" by
default, or "cpu"), or scatters them over `mesh=` for the two batched
decoders: a blob does not record whether its decoder was sharded, so it
resumes sharded or not, over any mesh whose size divides its streams.

Covered surfaces: the single-stream `H263Decoder`, `BatchedStreamDecoder`,
`DeviceFrontendDecoder`, and `StreamPool` (whole-pool membership +
per-bucket decoder states).
"""

from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np
import torch

from ..parallel.sharding import StreamShards, place

FORMAT_VERSION = 2
_ZIP_MAGIC = b"PK\x03\x04"

#: Constructor knobs of the JAX decoders that exist only for XLA, Mosaic or
#: the automaton's tape; a JAX blob (or caller) naming them loads without
#: them.
JAX_ONLY_KNOBS = frozenset(("tape_len", "harness", "unroll", "pallas",
                            "payload", "coef_transport"))


# ---------------------------------------------------------------------------
# Picture header <-> JSON-primitive dict
# ---------------------------------------------------------------------------


def _format_to_dict(fmt) -> Optional[dict]:
    if fmt is None:
        return None
    d = {"kind": fmt.kind.value}
    if fmt.custom is not None:
        c = fmt.custom
        d["custom"] = {
            "par": c.pixel_aspect_ratio.value,
            "width": c.width,
            "height": c.height,
            "par_width": c.par_width,
            "par_height": c.par_height,
        }
    return d


def _format_from_dict(d):
    from ..types import (CustomPictureFormat, PixelAspectRatio, SourceFormat,
                         SourceFormatKind)

    if d is None:
        return None
    custom = None
    if d.get("custom") is not None:
        c = d["custom"]
        custom = CustomPictureFormat(
            PixelAspectRatio(c["par"]), c["width"], c["height"],
            c["par_width"], c["par_height"])
    return SourceFormat(SourceFormatKind(d["kind"]), custom)


def picture_to_dict(pic) -> Optional[dict]:
    """Explicit JSON-primitive schema for a parsed picture header."""
    if pic is None:
        return None
    sl = pic.scalability_layer
    return {
        "version": pic.version,
        "temporal_reference": pic.temporal_reference,
        "format": _format_to_dict(pic.format),
        "options": int(pic.options),
        "has_plusptype": pic.has_plusptype,
        "has_opptype": pic.has_opptype,
        "picture_type": pic.picture_type.value,
        "motion_vector_range": (None if pic.motion_vector_range is None
                                else pic.motion_vector_range.value),
        "slice_submode": (None if pic.slice_submode is None
                          else int(pic.slice_submode)),
        "scalability_layer": (None if sl is None
                              else [sl.enhancement, sl.reference]),
        "reference_picture_selection_mode": (
            None if pic.reference_picture_selection_mode is None
            else int(pic.reference_picture_selection_mode)),
        "prediction_reference": pic.prediction_reference,
        "quantizer": pic.quantizer,
        "multiplex_bitstream": pic.multiplex_bitstream,
        "pb_reference": pic.pb_reference,
        "pb_quantizer": (None if pic.pb_quantizer is None
                         else int(pic.pb_quantizer)),
        "extra": pic.extra.hex(),
    }


def picture_from_dict(d):
    if d is None:
        return None
    from ..types import (BPictureQuantizer, MotionVectorRange, Picture,
                         PictureOption, PictureTypeCode,
                         ReferencePictureSelectionMode, ScalabilityLayer,
                         SliceSubmode)

    sl = d["scalability_layer"]
    return Picture(
        version=d["version"],
        temporal_reference=d["temporal_reference"],
        format=_format_from_dict(d["format"]),
        options=PictureOption(d["options"]),
        has_plusptype=d["has_plusptype"],
        has_opptype=d["has_opptype"],
        picture_type=PictureTypeCode(d["picture_type"]),
        motion_vector_range=(None if d["motion_vector_range"] is None
                             else MotionVectorRange(d["motion_vector_range"])),
        slice_submode=(None if d["slice_submode"] is None
                       else SliceSubmode(d["slice_submode"])),
        scalability_layer=(None if sl is None
                           else ScalabilityLayer(sl[0], sl[1])),
        reference_picture_selection_mode=(
            None if d["reference_picture_selection_mode"] is None
            else ReferencePictureSelectionMode(
                d["reference_picture_selection_mode"])),
        prediction_reference=d["prediction_reference"],
        backchannel_message=None,
        reference_picture_resampling=None,
        quantizer=d["quantizer"],
        multiplex_bitstream=d["multiplex_bitstream"],
        pb_reference=d["pb_reference"],
        pb_quantizer=(None if d["pb_quantizer"] is None
                      else BPictureQuantizer(d["pb_quantizer"])),
        extra=bytes.fromhex(d["extra"]),
    )


def _pack(meta: dict, arrays: dict) -> bytes:
    buf = io.BytesIO()
    meta_arr = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(buf, meta=meta_arr, **arrays)
    return buf.getvalue()


def _unpack(blob: bytes, kind: str):
    """(meta, members) of a v2 blob of `kind`; raises ValueError on a v1
    pickle, another version or another kind."""
    blob = bytes(blob)
    if not blob.startswith(_ZIP_MAGIC):
        raise ValueError(
            "not a v2 checkpoint: v1 blobs are pickles of the JAX package's "
            "classes and do not load into h263_tpu_torch (load them with "
            "h263_tpu and save them again, which writes v2)")
    z = np.load(io.BytesIO(blob), allow_pickle=False)
    meta = json.loads(bytes(z["meta"]).decode("utf-8"))
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta.get('format_version')} "
                         f"!= {FORMAT_VERSION}")
    if meta.get("kind") != kind:
        raise ValueError(f"checkpoint kind {meta.get('kind')!r} != {kind!r}")
    return meta, z


def _host(t) -> np.ndarray:
    """A device tensor, or a mesh decoder's StreamShards gathered, as a
    host copy."""
    if isinstance(t, StreamShards):
        return t.gather("cpu").numpy()
    return t.to("cpu", copy=True).numpy()


def _on(device, a) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)




def _without_jax_knobs(kwargs: dict) -> dict:
    return {k: v for k, v in kwargs.items() if k not in JAX_ONLY_KNOBS}


# ---------------------------------------------------------------------------
# Single-stream decoder state
# ---------------------------------------------------------------------------


def save_decoder_state(decoder) -> bytes:
    """Snapshot an H263Decoder's complete inter-frame state (format v2)."""
    arrays = {}
    pictures = []
    for idx, (tr, pic) in enumerate(sorted(decoder.reference_states.items())):
        pictures.append({
            "tr": tr,
            "header": picture_to_dict(pic.picture_header),
            "format": _format_to_dict(pic.format),
            "planes": f"pic{idx}",
        })
        arrays[f"pic{idx}_y"] = _host(pic.luma)
        arrays[f"pic{idx}_cb"] = _host(pic.chroma_b)
        arrays[f"pic{idx}_cr"] = _host(pic.chroma_r)
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "decoder",
        "decoder_options": int(decoder.decoder_options),
        # Read by the JAX package's loader when no backend is named: its
        # host oracle resumes anywhere.  The port's loader ignores it.
        "backend": "numpy",
        "last_picture": decoder.last_picture,
        "reference_picture": decoder.reference_picture,
        "running_options": int(decoder.running_options),
        "pictures": pictures,
    }
    return _pack(meta, arrays)


def load_decoder_state(blob: bytes, device="cuda"):
    """Reconstruct an H263Decoder on `device` from a v2 blob written by
    `save_decoder_state` of either package."""
    from ..decoder.picture import DecodedPicture
    from ..decoder.state import H263Decoder
    from ..types import DecoderOption, PictureOption

    meta, z = _unpack(blob, "decoder")
    dec = H263Decoder(DecoderOption(meta["decoder_options"]), device=device)
    dec.last_picture = meta["last_picture"]
    dec.reference_picture = meta["reference_picture"]
    dec.running_options = PictureOption(meta["running_options"])
    for p in meta["pictures"]:
        key = p["planes"]
        dec.reference_states[p["tr"]] = DecodedPicture(
            picture_from_dict(p["header"]), _format_from_dict(p["format"]),
            *(_on(dec.device, z[f"{key}_{c}"]) for c in ("y", "cb", "cr")))
    return dec


# ---------------------------------------------------------------------------
# Batched decoder state (host front-end)
# ---------------------------------------------------------------------------


def save_batched_state(dec) -> bytes:
    """Snapshot a BatchedStreamDecoder's per-stream state + reference planes
    (format v2)."""
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "batched",
        "n": dec.n,
        "w": dec.w,
        "h": dec.h,
        "decoder_options": int(dec.decoder_options),
        "pack_cap": dec.pack_cap,
        "mv_full": bool(dec._mv_full),
        "states": [
            {"running_options": int(s.running_options),
             "last_header": picture_to_dict(s.last_header),
             "has_reference": s.has_reference}
            for s in dec.states
        ],
    }
    arrays = {
        "ref_y": _host(dec.ref_y),
        "ref_cb": _host(dec.ref_cb),
        "ref_cr": _host(dec.ref_cr),
        # Standard-H.263 format-inheritance sticky (batch.py _std_prev_fmt).
        "std_prev_fmt": np.asarray(dec._std_prev_fmt),
    }
    return _pack(meta, arrays)


def load_batched_state(blob: bytes, **kwargs):
    """Reconstruct a BatchedStreamDecoder from a v2 blob of either package.
    `kwargs` go to its constructor (`pack_cap`, `device` or `mesh`, whose
    shards the planes are scattered over) over the saved ones; the
    JAX-only knobs (`coef_transport`, `pallas`, ...) are dropped."""
    from ..parallel.batch import BatchedStreamDecoder
    from ..types import DecoderOption, PictureOption

    meta, z = _unpack(blob, "batched")
    kwargs = _without_jax_knobs(kwargs)
    kwargs.setdefault("pack_cap", meta["pack_cap"])
    dec = BatchedStreamDecoder(meta["n"], meta["w"], meta["h"],
                               DecoderOption(meta["decoder_options"]),
                               **kwargs)
    dec.load_state(z["ref_y"], z["ref_cb"], z["ref_cr"])
    # Optional members: absent in blobs written before these fields were
    # checkpointed; the defaults (fresh-decoder values) then apply.
    dec._mv_full = bool(meta.get("mv_full", False))
    if "std_prev_fmt" in z.files:
        dec._std_prev_fmt[:] = z["std_prev_fmt"]
    for s, sd in zip(dec.states, meta["states"]):
        s.running_options = PictureOption(sd["running_options"])
        s.last_header = picture_from_dict(sd["last_header"])
        s.has_reference = sd["has_reference"]
    return dec


# ---------------------------------------------------------------------------
# Device-front-end decoder state
# ---------------------------------------------------------------------------


def save_device_frontend_state(dec) -> bytes:
    """Snapshot a DeviceFrontendDecoder (format v2): reference planes,
    per-stream header state, presentation params and the last status."""
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "device_frontend",
        "n": dec.n,
        "w": dec.w,
        "h": dec.h,
        "decoder_options": int(dec.decoder_options),
        "max_frame_bytes": dec.max_frame_bytes,
        "pictures": [picture_to_dict(p) for p in dec._pictures],
        "running": [int(r) for r in dec._running],
        "has_status": dec.last_status is not None,
    }
    arrays = {
        "ref_y": _host(dec.ref_y),
        "ref_cb": _host(dec.ref_cb),
        "ref_cr": _host(dec.ref_cr),
        "last_quant": np.asarray(dec._last_quant),
        "last_deblock": np.asarray(dec._last_deblock),
    }
    if dec.last_status is not None:
        arrays["status"] = _host(dec.last_status)
    return _pack(meta, arrays)


def load_device_frontend_state(blob: bytes, **kwargs):
    """Reconstruct a DeviceFrontendDecoder from a v2 blob of either
    package.  `kwargs` go to its constructor (`max_frame_bytes`, `device`
    or `mesh`, whose shards the planes and status are scattered over) over
    the saved ones; the JAX-only knobs (`tape_len`, `harness`,
    `unroll`, `pallas`, `payload`) are dropped, and so are a JAX blob's
    last buffers (the input of `resolve_overflows`)."""
    from ..parallel.device_batch import DeviceFrontendDecoder
    from ..types import DecoderOption, PictureOption

    meta, z = _unpack(blob, "device_frontend")
    ctor = {"max_frame_bytes": meta["max_frame_bytes"]}
    ctor.update(_without_jax_knobs(kwargs))
    dec = DeviceFrontendDecoder(meta["n"], meta["w"], meta["h"],
                                DecoderOption(meta["decoder_options"]),
                                **ctor)
    dec.load_state(z["ref_y"], z["ref_cb"], z["ref_cr"], z["last_quant"],
                   z["last_deblock"])
    if meta["has_status"]:
        dec.last_status = place(z["status"], dec.device, dec.mesh)
    dec._pictures = [picture_from_dict(p) for p in meta["pictures"]]
    dec._running = [PictureOption(r)
                    for r in meta.get("running", [0] * meta["n"])]
    return dec


# ---------------------------------------------------------------------------
# Serving-pool state
# ---------------------------------------------------------------------------

# Stream ids serialize as [tag, value] pairs so int and str ids round-trip
# distinguishably through JSON.
_SID_TAGS = {str: "s", int: "i"}


def _sid_to_json(sid):
    tag = _SID_TAGS.get(type(sid))
    if tag is None:
        raise TypeError(
            f"stream id {sid!r} is not checkpointable (str or int only)")
    return [tag, sid]


def _sid_from_json(pair):
    tag, value = pair
    return str(value) if tag == "s" else int(value)


def save_pool_state(pool) -> bytes:
    """Snapshot a StreamPool: membership, per-bucket decoder states, free
    slots, and pending (never-decoded) registrations (format v2).  Stream
    ids must be str or int."""
    save_bucket = (save_device_frontend_state
                   if pool.frontend == "device" else save_batched_state)
    buckets = []
    arrays = {}
    for idx, ((w, h), bucket) in enumerate(sorted(pool._buckets.items())):
        member = f"bucket{idx}"
        buckets.append({
            "w": w,
            "h": h,
            "member": member,
            "slots": [[_sid_to_json(sid), slot]
                      for sid, slot in bucket.slots.items()],
            "free": list(bucket.free),
        })
        arrays[member] = np.frombuffer(save_bucket(bucket.dec),
                                       dtype=np.uint8).copy()
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "pool",
        "decoder_options": int(pool.decoder_options),
        "frontend": pool.frontend,
        # The pool's own constructor knobs for its buckets, as the JAX
        # pool's decoder kwargs.
        "decoder_kwargs": ({} if pool.max_frame_bytes is None
                           else {"max_frame_bytes": pool.max_frame_bytes}),
        "max_dims": list(pool.max_dims),
        "dims": [[_sid_to_json(sid), w, h]
                 for sid, (w, h) in pool._dims.items()],
        "pending": [[w, h, [_sid_to_json(sid) for sid in sids]]
                    for (w, h), sids in pool._pending.items()],
        "pending_running": [[_sid_to_json(sid), int(r)]
                            for sid, r in pool._pending_running.items()],
        "buckets": buckets,
    }
    return _pack(meta, arrays)


def load_pool_state(blob: bytes, **overrides):
    """Reconstruct a StreamPool from a v2 blob of either package.  Keyword
    arguments (`device`, `max_frame_bytes`) override the saved decoder
    kwargs; the JAX-only knobs among either are dropped, and any other
    unknown keyword raises (TypeError, from the pool's constructor)."""
    from ..parallel.pool import StreamPool, _Bucket
    from ..types import DecoderOption, PictureOption

    meta, z = _unpack(blob, "pool")
    kwargs = _without_jax_knobs(meta["decoder_kwargs"])
    overrides = _without_jax_knobs(overrides)
    kwargs.update(overrides)
    pool = StreamPool(DecoderOption(meta["decoder_options"]),
                      frontend=meta["frontend"],
                      max_dims=tuple(meta.get("max_dims", (2048, 2048))),
                      **kwargs)
    pool._dims = {_sid_from_json(sid): (w, h)
                  for sid, w, h in meta["dims"]}
    pool._pending = {(w, h): [_sid_from_json(sid) for sid in sids]
                     for w, h, sids in meta["pending"]}
    pool._pending_running = {_sid_from_json(sid): PictureOption(r)
                             for sid, r in meta.get("pending_running", [])}
    # The per-bucket loaders take their constructor knobs from their own
    # sub-blob meta; the pool-level `max_frame_bytes` must not clobber a
    # device bucket's, but an explicit caller override wins over both.
    sub_kwargs = {"device": pool.device}
    if meta["frontend"] == "device":
        load_bucket = load_device_frontend_state
        if "max_frame_bytes" in overrides:
            sub_kwargs["max_frame_bytes"] = overrides["max_frame_bytes"]
    else:
        load_bucket = load_batched_state
    for b in meta["buckets"]:
        dec = load_bucket(bytes(z[b["member"]]), **sub_kwargs)
        bucket = _Bucket(dec)
        bucket.slots = {_sid_from_json(sid): slot for sid, slot in b["slots"]}
        bucket.free = list(b["free"])
        pool._buckets[(b["w"], b["h"])] = bucket
    return pool
