"""Utilities: stage timers and counters (`trace.py`) and checkpoints of
every decoding surface (`checkpoint.py`); the names of
`h263_tpu/utils/__init__.py`."""

from .trace import (StageTimer, get_counters, get_metrics, incr,
                    reset_metrics, trace_stage)

__all__ = ["StageTimer", "get_counters", "get_metrics", "incr",
           "reset_metrics", "trace_stage"]
