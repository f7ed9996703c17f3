"""Per-process logging setup: each service logs to its own file in the
session dir (reference behavior: per-process files in the session dir,
src/ray/util/logging.h RAY_LOG + python log_monitor tailing)."""

from __future__ import annotations

import logging
import os
import sys


class _ForwardingStream:
    """Wraps a worker's stdout/stderr: lines still reach the local log
    file AND are published to the driver through GCS pubsub — the analog
    of the reference's log_monitor.py:48 tail-and-republish (without the
    extra tailing process: the worker pushes directly)."""

    def __init__(self, original, publish, stream_name: str):
        self._original = original
        self._publish = publish
        self._stream = stream_name
        self._buf = ""

    def write(self, data):
        n = self._original.write(data)
        self._buf += data
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.strip():
                try:
                    self._publish(line, self._stream)
                except Exception:
                    pass
        return n

    def flush(self):
        self._original.flush()

    def __getattr__(self, name):
        return getattr(self._original, name)


def install_stdout_forwarder(core_worker):
    """Route this worker's print()/stderr output to the driver(s)."""
    sys.stdout = _ForwardingStream(sys.stdout, core_worker.publish_log,
                                   "stdout")
    sys.stderr = _ForwardingStream(sys.stderr, core_worker.publish_log,
                                   "stderr")


def setup_process_logging(name: str, log_file: str | None = None,
                          level=logging.INFO):
    fmt = logging.Formatter(
        f"[%(asctime)s %(levelname).1s {name} pid={os.getpid()}] "
        "%(name)s: %(message)s"
    )
    root = logging.getLogger()
    root.setLevel(level)
    if log_file:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        handler: logging.Handler = logging.FileHandler(log_file)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(fmt)
    root.addHandler(handler)
    return root
