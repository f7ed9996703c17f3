"""Structured cluster events (the RAY_EVENT analog; reference:
src/ray/util/event.h:36 RAY_EVENT macro, EventManager :84,
LogEventReporter :51 — structured severity/label events written to an
event log dir and surfaced to operators).

The GCS and the raylet call `init_events(source_type, source_id,
log_dir)` once; `report_event()` then appends a JSON line to
<log_dir>/events/event_<source_type>.log."""

from __future__ import annotations

import json
import os
import threading
import time

INFO, WARNING, ERROR, FATAL = "INFO", "WARNING", "ERROR", "FATAL"

_lock = threading.Lock()
_state = {"source_type": "unknown", "source_id": "", "path": None}


def init_events(source_type: str, source_id: str,
                log_dir: str | None = None):
    with _lock:
        _state["source_type"] = source_type
        _state["source_id"] = source_id
        if log_dir:
            event_dir = os.path.join(log_dir, "events")
            os.makedirs(event_dir, exist_ok=True)
            _state["path"] = os.path.join(
                event_dir, f"event_{source_type}.log")


def report_event(severity: str, label: str, message: str, **fields):
    """reference: RAY_EVENT(severity, label) << message."""
    event = {
        "timestamp": time.time(),
        "severity": severity,
        "label": label,
        "message": message,
        "source_type": _state["source_type"],
        "source_id": _state["source_id"],
        "source_pid": os.getpid(),
        **({"custom_fields": fields} if fields else {}),
    }
    path = _state["path"]
    if path:
        try:
            with _lock, open(path, "a") as f:
                f.write(json.dumps(event) + "\n")
        except OSError:
            pass
    return event

