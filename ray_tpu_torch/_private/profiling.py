"""Profile events; port of ray_tpu/_private/profiling.py's buffer.

A process records spans (tracing.py) and plain profile events into one
bounded local buffer. The reference's flush to the GCS profile table, its
timeline export and its compile probes are not ported yet; `drain` reads
the buffer in the process.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from ray_tpu_torch._private import stats as _stats

# events evicted by the deque bound are lost, and counted here
M_EVENTS_DROPPED = _stats.Count(
    "profiling.events_dropped_total",
    "profile/trace events dropped by the local buffer bound")


class ProfileBuffer:
    def __init__(self, component_type: str, maxlen: int = 20_000):
        self.component_type = component_type
        self.component_id = os.getpid()
        self._events: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, event_type: str, start: float, end: float,
               extra: dict | None = None):
        with self._lock:
            if len(self._events) == self._events.maxlen:
                M_EVENTS_DROPPED.inc()
            self._events.append({
                "event_type": event_type,
                "start_time": start,
                "end_time": end,
                "extra_data": extra or {},
            })

    def drain(self) -> list[dict]:
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    def __len__(self):
        with self._lock:
            return len(self._events)

    def profile(self, event_type: str, extra: dict | None = None):
        return _Span(self, event_type, extra)


class _Span:
    def __init__(self, buf: ProfileBuffer, event_type: str, extra):
        self._buf = buf
        self._event_type = event_type
        self._extra = extra

    def __enter__(self):
        self._start = time.time()
        return self

    def __exit__(self, *exc):
        self._buf.record(self._event_type, self._start, time.time(),
                         self._extra)
        return False
