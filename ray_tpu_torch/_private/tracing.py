"""Trace contexts and spans; port of ray_tpu/_private/tracing.py.

A compact trace context `(trace_id, span_id, parent_span_id)` is minted
at an entry point (Serve's HTTP ingress and router) and threaded through
the seams it crosses (router -> replica -> engine). Spans record into the
process's bounded ProfileBuffer (profiling.py), and a histogram observation
may carry the trace id as its exemplar (stats.py).

Head sampling: 1% of trace roots. Propagated contexts are always
honored: the sampling decision is made once, at the trace root. The
reference's flush of the buffer to the GCS, its trace table, its query
API and its cluster-wide sampling knob are not ported yet.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading

_SAMPLE_RATE = 0.01
_rng = random.Random()
_lock = threading.Lock()
_buffer = None  # ProfileBuffer this process records spans into

# Ambient context: set around task execution / request handling so any
# nested entry point (a task submitted from inside a traced task, a
# collective op inside a traced replica call) joins the same tree.
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_trace_ctx", default=None)


class TraceContext:
    """One node of a trace tree. Only sampled contexts exist — an
    unsampled entry point yields None everywhere, so the unsampled hot
    path carries no per-call state at all."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: bytes, span_id: bytes,
                 parent_id: bytes | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def __repr__(self):
        return (f"TraceContext({self.trace_id.hex()}, {self.span_id.hex()},"
                f" parent={self.parent_id.hex() if self.parent_id else None})")


def _get_buffer():
    global _buffer
    if _buffer is None:
        with _lock:
            if _buffer is None:
                from ray_tpu_torch._private import failpoints as _fp
                from ray_tpu_torch._private.profiling import ProfileBuffer

                _buffer = ProfileBuffer(_fp.get_role() or "process")
    return _buffer


def new_context() -> TraceContext:
    """Fresh root context (unconditional — callers wanting head sampling
    use maybe_trace)."""
    return TraceContext(os.urandom(8), os.urandom(8))


def child(ctx: TraceContext) -> TraceContext:
    return TraceContext(ctx.trace_id, os.urandom(8), ctx.span_id)


def maybe_trace() -> TraceContext | None:
    """Entry-point mint: continue the ambient trace when one is active
    (nested submit, traced request handler), else head-sample a fresh
    root at the current rate. Returns None when not sampled."""
    cur = _CTX.get()
    if cur is not None:
        return child(cur)
    if _rng.random() >= _SAMPLE_RATE:
        return None
    return new_context()


# --- ambient context -------------------------------------------------------

def current() -> TraceContext | None:
    return _CTX.get()


def current_id() -> str | None:
    """Hex trace id of the ambient context (the histogram-exemplar
    form), or None when the current call is unsampled."""
    ctx = _CTX.get()
    return ctx.trace_id.hex() if ctx is not None else None


def exemplar_of(ctx: TraceContext | None) -> str | None:
    """Hex trace id of `ctx` for Histogram.observe(exemplar=...)."""
    return ctx.trace_id.hex() if ctx is not None else None


def push(ctx: TraceContext | None):
    """Set the ambient context (even to None — execution scopes shadow
    any caller-thread leftovers); returns the reset token."""
    return _CTX.set(ctx)


def pop(token) -> None:
    try:
        _CTX.reset(token)
    except ValueError:
        pass  # token from another context (executor-pool reuse)


@contextlib.contextmanager
def use(ctx: TraceContext | None):
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        pop(token)


# --- span recording --------------------------------------------------------

def record_span(name: str, start: float, end: float,
                ctx: TraceContext | None, extra: dict | None = None) -> None:
    """Record one span into the bound ProfileBuffer. With ctx=None this
    degrades to a plain profile event (no trace linkage) — used by the
    unconditional task-execution event."""
    fields = dict(extra) if extra else {}
    if ctx is not None:
        fields["tid"] = ctx.trace_id.hex()
        fields["sid"] = ctx.span_id.hex()
        if ctx.parent_id:
            fields["psid"] = ctx.parent_id.hex()
    _get_buffer().record(name, start, end, fields)
