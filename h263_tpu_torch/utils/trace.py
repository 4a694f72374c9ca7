"""Stage timers, event counters and a device profile: the port of
`h263_tpu/utils/trace.py`.

* Stage timers aggregate host wall-time per pipeline stage (`host_parse`,
  `transfer`, `reconstruct_dispatch`, `reclaim_wait`, as the JAX package
  names them at the same places), enabled with `H263_TPU_TRACE=1` or
  `trace_enabled()`.  They read the host clock and never synchronise the
  card: a stage that enqueues device work records the time to enqueue it,
  so tracing does not change what it times.  `get_metrics()` has the JAX
  module's dict shape, so the two packages' readings sit side by side.
* Event counters (joins, leaves, rebuckets, host fetches of the pool) are
  always on; `incr` is called once per event, never per pixel.
* `torch_profile(logdir)` wraps a region in `torch.profiler` (host and
  device activity, TensorBoard format), the counterpart of `xla_profile`.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

_lock = threading.Lock()
# name -> [count, total_seconds, min_seconds, max_seconds]
_stats: dict = collections.defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
_counters: collections.Counter = collections.Counter()
_enabled = bool(os.environ.get("H263_TPU_TRACE"))


def trace_enabled(on: bool = True) -> None:
    """Switch the stage timers on or off for the process."""
    global _enabled
    _enabled = on


def _record(name: str, dt: float) -> None:
    with _lock:
        s = _stats[name]
        s[0] += 1
        s[1] += dt
        if dt < s[2]:
            s[2] = dt
        if dt > s[3]:
            s[3] = dt


@contextlib.contextmanager
def trace_stage(name: str):
    """Time a pipeline stage on the host clock; no-op unless enabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


class StageTimer:
    """Explicit start/stop variant for stages that are not one scope."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def start(self):
        if _enabled:
            self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            _record(self.name, time.perf_counter() - self._t0)
            self._t0 = None


def incr(name: str, n: int = 1) -> None:
    """Bump an event counter (always on)."""
    with _lock:
        _counters[name] += n


def get_metrics() -> dict:
    """Stage-timer snapshot: {stage: {count, total_s, mean_ms, min_ms,
    max_ms}}."""
    with _lock:
        return {
            name: {
                "count": c,
                "total_s": round(t, 6),
                "mean_ms": round(1e3 * t / c, 4) if c else 0.0,
                "min_ms": round(1e3 * lo, 4) if c else 0.0,
                "max_ms": round(1e3 * hi, 4) if c else 0.0,
            }
            for name, (c, t, lo, hi) in _stats.items()
        }


def get_counters() -> dict:
    """Event-counter snapshot: {name: count}."""
    with _lock:
        return dict(_counters)


def reset_metrics() -> None:
    """Clear the stage timers and the event counters."""
    with _lock:
        _stats.clear()
        _counters.clear()


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Capture a `torch.profiler` trace of a region (host activity, and the
    card's where CUDA is available) into `logdir`, TensorBoard format."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
