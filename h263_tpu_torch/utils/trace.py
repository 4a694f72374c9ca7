"""Event counters (the counter half of `h263_tpu/utils/trace.py`).

The pool counts its joins, leaves, rebuckets and per-stream host fetches
here.  Counters are process-wide and always on; `incr` is called once per
event, never per pixel.
"""

from __future__ import annotations

import collections
import threading

_lock = threading.Lock()
_counters: collections.Counter = collections.Counter()


def incr(name: str, n: int = 1) -> None:
    """Bump an event counter."""
    with _lock:
        _counters[name] += n


def get_counters() -> dict:
    """Event-counter snapshot: {name: count}."""
    with _lock:
        return dict(_counters)
