"""Streamed responses end-to-end: the token plane between a decode
engine and its callers; port of ray_tpu/serve/streaming.py.

Engine side, a `TokenChannel` per live sequence: the decode thread
pushes each step's token and finishes the channel with an optional
typed error. Consumer side, the channel supports BOTH a threaded
blocking read (in-process callers, tests) and an asyncio long-poll
(`wait_async` — the gang leader's async `stream_next` actor method
parks here without holding the actor's event loop), waking waiters
through their own loop via `call_soon_threadsafe` so a token burst is
one wakeup, not one per waiter poll tick.

Above the actor boundary the tokens travel router -> proxy as chunk
dicts (`stream_next` long-poll replies) and leave the proxy as
Server-Sent Events — `sse_event`/`iter_sse_lines` define the wire
framing both the proxy and the test/bench clients speak, so
time-to-first-token is measured on the same bytes clients see.

Chaos seam: `serve.stream_emit` fires on every channel push (leader
emit path).
"""

from __future__ import annotations

import json
import threading
import time

from ray_tpu_torch._private import failpoints as _fp


class TokenChannel:
    """Single-producer token stream with cursor-based reads (a reader
    that reconnects re-reads from its cursor; the channel keeps the
    whole sequence — generations are short-lived and bounded by
    max_tokens, so no ring eviction)."""

    __slots__ = ("seq_id", "tokens", "done", "error", "created_at",
                 "first_token_at", "finished_at", "consumed", "_cond",
                 "_waiters")

    def __init__(self, seq_id: str):
        self.seq_id = seq_id
        self.tokens: list[int] = []
        self.done = False
        self.error = None
        self.created_at = time.time()
        self.first_token_at = None
        self.finished_at = None
        self.consumed = 0  # highest cursor a reader acked (backlog gauge)
        self._cond = threading.Condition()
        # (loop, asyncio.Event) pairs parked in wait_async
        self._waiters: list = []

    # -- producer (decode thread) ---------------------------------------

    def push(self, token: int) -> None:
        if _fp.ARMED:
            _fp.fire_strict("serve.stream_emit")
        with self._cond:
            if self.done:
                return
            if self.first_token_at is None:
                self.first_token_at = time.time()
            self.tokens.append(int(token))
            self._wake_locked()

    def finish(self, error=None) -> None:
        """Close the channel (idempotent; the first error wins — an
        abort racing a gang-death must not downgrade the typed error a
        reader already saw)."""
        with self._cond:
            if self.done:
                return
            self.done = True
            self.error = error
            self.finished_at = time.time()
            self._wake_locked()

    def _wake_locked(self):
        self._cond.notify_all()
        waiters, self._waiters = self._waiters, []
        for loop, event in waiters:
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass  # reader's loop closed: nobody is waiting

    # -- consumers -------------------------------------------------------

    def chunk(self, cursor: int) -> dict:
        """Everything past `cursor` + terminal state, msgpack/pickle
        safe (the `stream_next` reply payload)."""
        with self._cond:
            if cursor > self.consumed:
                self.consumed = min(cursor, len(self.tokens))
            return {"tokens": list(self.tokens[cursor:]),
                    "cursor": len(self.tokens),
                    "done": self.done,
                    "error": self.error}

    def wait(self, cursor: int, timeout: float) -> dict:
        """Blocking read: park until there is anything past `cursor` or
        the channel finished; empty non-done chunk on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while len(self.tokens) <= cursor and not self.done:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        return self.chunk(cursor)

    async def wait_async(self, cursor: int, timeout: float) -> dict:
        """Asyncio read: same contract as wait(), parked on the caller's
        event loop (the leader's stream_next actor method — other actor
        coroutines keep interleaving while this one is parked)."""
        import asyncio

        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                if len(self.tokens) > cursor or self.done:
                    return self.chunk(cursor)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self.chunk(cursor)
                event = asyncio.Event()
                self._waiters.append((asyncio.get_running_loop(), event))
            try:
                await asyncio.wait_for(event.wait(), remaining)
            except asyncio.TimeoutError:
                return self.chunk(cursor)


# ---------------------------------------------------------------------------
# SSE wire framing (proxy writer + test/bench readers speak this)
# ---------------------------------------------------------------------------

SSE_CONTENT_TYPE = "text/event-stream"


def meta_chunk(seq_id: str, **meta) -> dict:
    """The stream's FIRST chunk: no tokens, just admission metadata
    (session_cached, prefix_hashes, ...) the client contract needs
    before any token arrives — shaped like a token chunk so SSE framing
    and cursor handling are uniform."""
    return {"meta": {"seq": seq_id, **meta},
            "tokens": [], "cursor": 0, "done": False}


def sse_event(data: dict, event: str | None = None) -> bytes:
    """One Server-Sent Event frame: optional `event:` line + one
    JSON-encoded `data:` line + blank-line terminator."""
    head = f"event: {event}\n" if event else ""
    return (head + f"data: {json.dumps(data)}\n\n").encode()


def iter_sse_lines(line_iter):
    """Parse an SSE byte-line stream into (event, data_dict) pairs —
    the client half of sse_event, shared by tests and the bench so TTFT
    is measured on real frames."""
    event = None
    for raw in line_iter:
        line = raw.decode() if isinstance(raw, (bytes, bytearray)) else raw
        line = line.rstrip("\r\n")
        if not line:
            event = None
            continue
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            yield event, json.loads(line[5:].strip())
