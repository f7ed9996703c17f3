"""Lightweight asyncio RPC: length-prefixed msgpack frames over UDS/TCP.

Plays the role of the reference's gRPC layer (reference: src/ray/rpc/
grpc_server.h, grpc_client.h, client_call.h) for the control plane. Design
differences are deliberate: a single multiplexed duplex connection per
client with integer-correlated requests, msgpack payloads (bytes pass
through zero-copy on the read side), and first-class server->client pushes
(used for pubsub and task dispatch) instead of gRPC streaming.

Wire format: 4-byte big-endian frame length, then
    msgpack([msgtype, msgid, method, data])
msgtype: 0=request 1=reply-ok 2=reply-err 3=oneway 4=push.
`data` is any msgpack value; application payloads that need pickling are
passed as bytes.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import pickle
import socket
import struct
import threading
import traceback
from typing import Any, Awaitable, Callable

import msgpack

logger = logging.getLogger(__name__)

REQUEST, REPLY_OK, REPLY_ERR, ONEWAY, PUSH = 0, 1, 2, 3, 4

_HDR = struct.Struct(">I")
_MAX_FRAME = 1 << 31

# Churn instrumentation (tier-1 guarded: tests assert the per-task hop
# count stays bounded so per-call wakeups can't silently regrow).
# A "wakeup" is one self-pipe write onto an event loop — a real syscall.
from ray_tpu_torch._private import stats as _stats

M_LOOP_WAKEUPS = _stats.Count(
    "rpc.loop_wakeups_total",
    "cross-thread event-loop wakeups (self-pipe writes)")
M_FRAMES_SENT = _stats.Count(
    "rpc.frames_sent_total", "rpc frames queued for send")
M_SOCKET_FLUSHES = _stats.Count(
    "rpc.socket_flushes_total", "transport writes (coalesced frame bursts)")


def _set_nodelay(writer: asyncio.StreamWriter) -> None:
    """Disable Nagle on every TCP peer connection. asyncio sets this for
    transports it creates, but the guarantee is per-implementation — the
    40ms delayed-ACK/Nagle interplay showed up as multi-ms stalls in the
    1:1 actor-call microbenchmark, so the runtime verifies it explicitly
    on both the dialing and the accepting side."""
    sock = writer.get_extra_info("socket")
    if sock is None or sock.family not in (socket.AF_INET, socket.AF_INET6):
        return
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:  # pragma: no cover - transport already closed
        pass


class RpcError(Exception):
    pass


class RemoteError(RpcError):
    """Handler on the other side raised; carries its pickled exception."""

    def __init__(self, exc: BaseException, tb: str):
        self.exc = exc
        self.tb = tb
        super().__init__(f"{exc!r}\nRemote traceback:\n{tb}")


class ConnectionLost(RpcError):
    pass


class ConnectionGaveUp(ConnectionLost):
    """A ReconnectingConnection exhausted its redial budget: the peer is
    being treated as permanently gone. Every queued/future caller gets
    this typed error (not a bare timeout), carrying who gave up on what."""

    def __init__(self, name: str, address: str, cause: str = ""):
        self.conn_name = name
        self.address = address
        self.cause = cause
        super().__init__(
            f"{name}: gave up redialing {address}"
            + (f" ({cause})" if cause else ""))

    def __reduce__(self):
        # travels inside rpc error replies: a handler that hit a
        # given-up connection must not become an unpicklable payload
        # that tears down the receiving side's whole connection
        return (ConnectionGaveUp,
                (self.conn_name, self.address, self.cause))


def _pack(msg) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    return _HDR.pack(len(body)) + body


async def _read_frame(reader: asyncio.StreamReader):
    hdr = await reader.readexactly(_HDR.size)
    (length,) = _HDR.unpack(hdr)
    if length > _MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    return msgpack.unpackb(body, raw=False)


def deferred(fn):
    """Mark an rpc handler as deferred-reply: it is invoked as
    fn(conn, data, msgid) synchronously on the read loop and owes the
    caller a later `conn.reply_deferred(msgid, method, reply)` — from any
    thread. This lets a handler hand work to another thread WITHOUT an
    asyncio future + task + coroutine resume per request (the worker's
    task-execution path: read loop → dispatcher thread → coalesced reply
    enqueue, two hops total)."""
    fn._rpc_deferred = True
    return fn


class Connection:
    """One duplex connection; usable as both caller and callee side."""

    def __init__(self, reader, writer, handlers, on_disconnect=None, name=""):
        self._loop = asyncio.get_running_loop()
        self._reader = reader
        self._writer = writer
        self._handlers = handlers
        self._on_disconnect = on_disconnect
        self.name = name
        self._msgid = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._push_handler: Callable[[str, Any], Awaitable[None]] | None = None
        self._send_lock = asyncio.Lock()
        self._undrained = 0
        # outbound frame coalescing: frames queue here and one call_soon
        # callback writes them in a single transport write per loop tick
        # (a submit burst of 100 small calls = a handful of socket sends
        # instead of 100 — sock.send was 15% of the n:n microbenchmark)
        self._outbuf: list[bytes] = []
        self._flush_scheduled = False
        self._closed = False
        self._reader_task = asyncio.create_task(self._read_loop())
        # Opaque per-connection state slot for servers (e.g. worker identity).
        self.context: dict[str, Any] = {}

    def set_push_handler(self, fn):
        self._push_handler = fn

    async def _read_loop(self):
        try:
            while True:
                msg = await _read_frame(self._reader)
                msgtype = msg[0]
                if msgtype == REQUEST:
                    if not self._dispatch_fast(msg[1], msg[2], msg[3]):
                        asyncio.create_task(
                            self._dispatch(msg[1], msg[2], msg[3]))
                elif msgtype in (REPLY_OK, REPLY_ERR):
                    fut = self._pending.pop(msg[1], None)
                    if fut is not None and not fut.done():
                        if msgtype == REPLY_OK:
                            fut.set_result(msg[3])
                        else:
                            exc, tb = pickle.loads(msg[3][0]), msg[3][1]
                            fut.set_exception(RemoteError(exc, tb))
                elif msgtype == ONEWAY:
                    if not self._dispatch_fast(None, msg[2], msg[3]):
                        asyncio.create_task(
                            self._dispatch(None, msg[2], msg[3]))
                elif msgtype == PUSH:
                    if self._push_handler is not None:
                        asyncio.create_task(self._push_handler(msg[2], msg[3]))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except Exception:
            logger.exception("rpc read loop error (%s)", self.name)
        finally:
            await self._shutdown()

    async def _shutdown(self):
        if self._closed:
            return
        self._flush()  # don't strand queued frames (e.g. a last reply)
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost(f"connection {self.name} lost"))
        self._pending.clear()
        try:
            self._writer.close()
        except Exception:
            pass
        if self._on_disconnect is not None:
            try:
                await self._on_disconnect(self)
            except Exception:
                logger.exception("on_disconnect callback failed")

    async def _dispatch(self, msgid, method, data):
        handler = self._handlers.get(method)
        try:
            if handler is None:
                raise RpcError(f"no handler for method {method!r}")
            result = handler(self, data)
            if asyncio.iscoroutine(result):
                result = await result
            if msgid is not None:
                await self._send([REPLY_OK, msgid, method, result])
        except Exception as e:
            if msgid is not None:
                payload = [pickle.dumps(e), traceback.format_exc()]
                try:
                    await self._send([REPLY_ERR, msgid, method, payload])
                except Exception:
                    pass
            else:
                logger.exception("oneway handler %s failed", method)

    def _dispatch_fast(self, msgid, method, data) -> bool:
        """Run a request inline on the read loop when the handler is
        synchronous, skipping the per-request task spawn; async handlers
        get their (already-created) coroutine handed to one awaiting task.
        A small sync handler's whole request→reply turnaround becomes
        plain function calls plus one coalesced flush — this path carries
        task replies and control acks, the per-call churn the task
        microbenchmark pays for. Returns False to fall back to the
        task-per-request slow path (unknown method → its error reply)."""
        handler = self._handlers.get(method)
        if handler is None:
            return False
        try:
            if getattr(handler, "_rpc_deferred", False):
                handler(self, data, msgid)
                return True
            result = handler(self, data)
        except Exception as e:
            if msgid is not None:
                payload = [pickle.dumps(e), traceback.format_exc()]
                self._queue_reply([REPLY_ERR, msgid, method, payload])
            else:
                logger.exception("oneway handler %s failed", method)
            return True
        if asyncio.iscoroutine(result):
            asyncio.create_task(self._dispatch_await(msgid, method, result))
            return True
        if msgid is not None:
            try:
                self._queue_reply([REPLY_OK, msgid, method, result])
            except Exception as e:
                # unpackable result — surface as a remote error, like the
                # slow path would
                payload = [pickle.dumps(RpcError(
                    f"unserializable reply from {method!r}: {e}")),
                    traceback.format_exc()]
                self._queue_reply([REPLY_ERR, msgid, method, payload])
        return True

    async def _dispatch_await(self, msgid, method, coro):
        """Finish a coroutine handler started by the fast dispatch."""
        try:
            result = await coro
            if msgid is not None:
                await self._send([REPLY_OK, msgid, method, result])
        except Exception as e:
            if msgid is not None:
                payload = [pickle.dumps(e), traceback.format_exc()]
                try:
                    await self._send([REPLY_ERR, msgid, method, payload])
                except Exception:
                    pass
            else:
                logger.exception("oneway handler %s failed", method)

    def _queue_reply(self, msg):
        """Queue an outbound frame from loop context without awaiting;
        falls back to an async send under backpressure, or for
        large frames (those need a real drain)."""
        try:
            if not self._send_nowait(msg):
                asyncio.create_task(self._send_checked(msg))
        except ConnectionLost:
            pass  # reader shutdown path already notified the peer futures

    async def _send_checked(self, msg):
        try:
            await self._send(msg)
        except Exception:
            logger.debug("queued reply dropped on %s (connection dying)",
                         self.name)

    def reply_deferred(self, msgid, method, result=None, error=None,
                       tb: str = ""):
        """Complete a `deferred` handler — callable from ANY thread;
        delivery rides the connection loop's coalesced call queue, so a
        burst of completions from a worker thread costs one loop wakeup."""
        if msgid is None:
            return
        if error is not None:
            msg = [REPLY_ERR, msgid, method,
                   [pickle.dumps(error), tb]]
        else:
            msg = [REPLY_OK, msgid, method, result]
        try:
            loop_call_queue(self._loop).call(self._reply_deferred_on_loop,
                                             msg)
        except RuntimeError:
            pass  # loop closed: caller's future got ConnectionLost

    def _reply_deferred_on_loop(self, msg):
        try:
            self._queue_reply(msg)
        except ConnectionLost:
            pass
        except Exception as e:
            try:
                payload = [pickle.dumps(RpcError(
                    f"unserializable reply from {msg[2]!r}: {e}")),
                    traceback.format_exc()]
                self._queue_reply([REPLY_ERR, msg[1], msg[2], payload])
            except Exception:
                pass

    def _send_nowait(self, msg) -> bool:
        """Synchronous enqueue of one small frame onto the coalesced
        flush. Returns False when the caller must take the async path:
        a concurrent sender holds the drain lock (backpressure in
        progress), or the frame/budget needs a writer drain."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed")
        if self._send_lock.locked():
            return False
        data = _pack(msg)
        if len(data) > 65536 or self._undrained + len(data) > (1 << 20):
            return False
        self._enqueue(data)
        return True

    async def _send(self, msg):
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed")
        data = _pack(msg)
        async with self._send_lock:
            try:
                self._enqueue(data)
                # drain() per frame costs a syscall-sized stall on every
                # small control message (it was the top cost in the
                # actor-call microbenchmark). Small frames skip it, but
                # only up to an un-drained budget — an unbounded skip
                # would let a one-way flood (e.g. worker log lines) grow
                # the transport buffer without backpressure.
                if len(data) > 65536 or self._undrained > (1 << 20):
                    self._flush()
                    await self._writer.drain()
                    self._undrained = 0
            except (ConnectionError, OSError, RuntimeError) as e:
                # RuntimeError: asyncio raises it for writes on a
                # transport closed under us (chaos kill, peer reset)
                # normalize transport failures mid-send: retry layers
                # (ReconnectingConnection) only understand ConnectionLost
                raise ConnectionLost(
                    f"connection {self.name} lost mid-send: {e}") from e

    def _enqueue(self, data: bytes) -> None:
        """Queue one packed frame for the coalesced per-tick flush."""
        self._outbuf.append(data)
        M_FRAMES_SENT.inc()
        self._undrained += len(data)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush)

    def _flush(self):
        """Write every queued frame in one transport call. Runs on the
        event loop (call_soon AFTER the burst of _send callbacks that
        queued frames, preserving FIFO order with the immediate
        large-frame path, which calls this synchronously first)."""
        self._flush_scheduled = False
        if not self._outbuf or self._closed:
            self._outbuf.clear()
            return
        buf = (self._outbuf[0] if len(self._outbuf) == 1
               else b"".join(self._outbuf))
        self._outbuf.clear()
        M_SOCKET_FLUSHES.inc()
        try:
            self._writer.write(buf)
        except (ConnectionError, OSError, RuntimeError):
            # the reader loop notices the dead transport and runs the
            # full shutdown path; callers see ConnectionLost there
            logger.debug("flush failed on %s (connection dying)",
                         self.name)

    async def call(self, method: str, data: Any = None, timeout: float | None = None):
        msgid = next(self._msgid)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msgid] = fut
        try:
            await self._send([REQUEST, msgid, method, data])
        except BaseException:
            # abandon our own future cleanly — _shutdown may already have
            # set ConnectionLost on it, which would otherwise be logged
            # as "exception was never retrieved"
            fut = self._pending.pop(msgid, fut)
            if not fut.done():
                fut.cancel()
            else:
                fut.exception()  # mark retrieved
            raise
        if timeout:
            return await asyncio.wait_for(fut, timeout)
        return await fut

    async def notify(self, method: str, data: Any = None):
        await self._send([ONEWAY, None, method, data])

    async def push(self, channel: str, data: Any = None):
        await self._send([PUSH, None, channel, data])

    @property
    def closed(self) -> bool:
        return self._closed

    async def close(self):
        self._reader_task.cancel()
        await self._shutdown()


class Server:
    """RPC server bound to a UDS path and/or TCP port."""

    def __init__(self, handlers: dict[str, Callable], on_disconnect=None,
                 on_connect=None, name="server"):
        self.handlers = handlers
        self.on_disconnect = on_disconnect
        self.on_connect = on_connect
        self.name = name
        self._servers: list[asyncio.AbstractServer] = []
        self.connections: set[Connection] = set()
        self.tcp_port: int | None = None

    async def _accept(self, reader, writer):
        _set_nodelay(writer)
        conn = Connection(reader, writer, self.handlers,
                          on_disconnect=self._handle_disconnect, name=self.name)
        self.connections.add(conn)
        if self.on_connect is not None:
            try:
                res = self.on_connect(conn)
                if asyncio.iscoroutine(res):
                    await res
            except Exception:
                logger.exception("on_connect failed")

    async def _handle_disconnect(self, conn):
        self.connections.discard(conn)
        if self.on_disconnect is not None:
            res = self.on_disconnect(conn)
            if asyncio.iscoroutine(res):
                await res

    async def start_unix(self, path: str):
        srv = await asyncio.start_unix_server(self._accept, path=path)
        self._servers.append(srv)

    async def start_tcp(self, host: str = "127.0.0.1", port: int = 0,
                        uds_dir: str | None = None):
        srv = await asyncio.start_server(self._accept, host=host, port=port)
        self.tcp_port = srv.sockets[0].getsockname()[1]
        self._servers.append(srv)
        if uds_dir is not None:
            # Same-node fast path: a sibling UDS listener whose path is
            # derived from the TCP port, so any local peer can rewrite
            # "ip:port" -> "unix:<dir>/<port>.sock" (uds_address) without
            # any wire-format or directory change. Loopback TCP costs
            # ~0.25ms more per RTT than UDS on the gVisor-style kernels
            # this runs on — that is ~20% of a small-task round trip.
            try:
                os.makedirs(uds_dir, exist_ok=True)
                path = uds_address(uds_dir, self.tcp_port)[len("unix:"):]
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                await self.start_unix(path)
            except OSError as e:  # pragma: no cover - fs quirks
                logger.warning("no UDS listener beside tcp port %d: %s",
                               self.tcp_port, e)
        return self.tcp_port

    async def close(self):
        for srv in self._servers:
            srv.close()
        for conn in list(self.connections):
            await conn.close()


async def dial_once(address: str, handlers: dict | None = None,
                    on_disconnect=None, name="client") -> Connection:
    """One dial attempt, no retry: 'unix:/path' or 'host:port'. Raises
    the raw OS-level error; retry policy belongs to the caller."""
    if address.startswith("unix:"):
        reader, writer = await asyncio.open_unix_connection(address[5:])
    else:
        host, port = address.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        _set_nodelay(writer)
    return Connection(reader, writer, handlers or {},
                      on_disconnect=on_disconnect, name=name)


async def connect(address: str, handlers: dict | None = None,
                  on_disconnect=None, name="client",
                  timeout: float = 10.0) -> Connection:
    """address: 'unix:/path' or 'host:port'."""
    deadline = asyncio.get_running_loop().time() + timeout
    last_err: Exception | None = None
    while asyncio.get_running_loop().time() < deadline:
        try:
            return await dial_once(address, handlers,
                                   on_disconnect=on_disconnect, name=name)
        except (ConnectionError, FileNotFoundError, OSError) as e:
            last_err = e
            await asyncio.sleep(0.05)
    raise ConnectionLost(f"could not connect to {address}: {last_err}")


class ReconnectingConnection:
    """Client connection that survives server restarts (the GCS fault-
    tolerance plane; reference: src/ray/gcs/gcs_client/service_based_gcs_client.h
    reconnection + python/ray/tests/test_gcs_fault_tolerance.py behavior).

    `call()` transparently retries across a connection loss: it redials the
    same address until `retry_timeout` elapses, runs `on_reconnect(conn)`
    on the fresh connection so the caller can re-establish session state
    (re-register, re-subscribe) BEFORE queued calls resume, and then
    replays the call. Handlers/push-handler are re-attached automatically.
    Calls whose reply was lost mid-flight are retried, so server handlers
    reached through this wrapper must be idempotent.

    Redials are paced with exponential backoff plus jitter (capped at
    `redial_cap_s`, ~2s): after a head-node crash every raylet, worker and
    driver redials at once, and a fixed cadence would hammer the
    recovering server in lockstep. When the budget is exhausted the
    wrapper gives up PERMANENTLY: `on_give_up` runs once, and every
    queued and future caller gets the typed `ConnectionGaveUp` (never a
    bare timeout), so callers can distinguish "peer is gone" from "my
    call was slow".
    """

    def __init__(self, address: str, handlers: dict | None = None,
                 name: str = "client", on_reconnect=None,
                 retry_timeout: float = 30.0, on_give_up=None,
                 dial_timeout: float = 10.0, redial_cap_s: float = 2.0):
        self.address = address
        self.name = name
        self._handlers = handlers or {}
        self._on_reconnect = on_reconnect
        self._on_give_up = on_give_up
        self._retry_timeout = retry_timeout
        self._dial_timeout = dial_timeout
        self._redial_cap = redial_cap_s
        self._conn: Connection | None = None
        self._push_handler = None
        self._dial_lock: asyncio.Lock | None = None
        self._ever_connected = False
        self._gave_up = False
        self.context: dict[str, Any] = {}

    async def ensure_connected(self) -> Connection:
        if self._conn is not None and not self._conn.closed:
            return self._conn
        if self._gave_up:
            raise ConnectionGaveUp(self.name, self.address)
        if self._dial_lock is None:
            self._dial_lock = asyncio.Lock()
        async with self._dial_lock:
            if self._conn is not None and not self._conn.closed:
                return self._conn
            if self._gave_up:
                raise ConnectionGaveUp(self.name, self.address)
            timeout = (self._retry_timeout if self._ever_connected
                       else self._dial_timeout)
            try:
                conn = await self._redial(timeout)
            except ConnectionLost:
                if self._ever_connected:
                    self._gave_up = True
                    if self._on_give_up is not None:
                        try:
                            res = self._on_give_up()
                            if asyncio.iscoroutine(res):
                                await res
                        except Exception:
                            logger.exception("%s on_give_up failed", self.name)
                    raise ConnectionGaveUp(self.name, self.address)
                raise
            if self._push_handler is not None:
                conn.set_push_handler(self._push_handler)
            conn.context.update(self.context)
            reconnecting = self._ever_connected
            self._ever_connected = True
            self._conn = conn
            if reconnecting and self._on_reconnect is not None:
                logger.info("%s: reconnected to %s", self.name, self.address)
                try:
                    await self._on_reconnect(conn)
                except Exception:
                    logger.exception("%s on_reconnect failed", self.name)
            return conn

    async def _redial(self, timeout: float) -> Connection:
        """Dial until success or `timeout`, with exponential backoff +
        jitter capped at redial_cap_s. Raises ConnectionLost when the
        budget runs out."""
        import random as _random

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        attempt = 0
        last_err: Exception | None = None
        while True:
            try:
                return await dial_once(self.address, self._handlers,
                                       on_disconnect=self._lost,
                                       name=self.name)
            except (ConnectionError, FileNotFoundError, OSError) as e:
                last_err = e
                attempt += 1
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise ConnectionLost(
                        f"could not connect to {self.address} after "
                        f"{attempt} attempts: {last_err}") from last_err
                backoff = min(self._redial_cap,
                              0.05 * (2 ** min(attempt - 1, 12)))
                backoff *= 0.5 + _random.random()  # jitter: 50-150%
                # never forfeit budget: clamp the sleep so a peer that
                # comes back just inside the window still gets one
                # final dial instead of a premature give-up
                await asyncio.sleep(min(backoff, remaining))

    async def _lost(self, conn):
        # Proactive background redial so pubsub pushes resume without
        # waiting for the next outbound call.
        if self._gave_up:
            return
        async def _redial():
            try:
                await self.ensure_connected()
            except Exception:
                pass
        try:
            asyncio.get_running_loop().create_task(_redial())
        except RuntimeError:
            pass

    def set_push_handler(self, fn):
        self._push_handler = fn
        if self._conn is not None:
            self._conn.set_push_handler(fn)

    async def call(self, method: str, data: Any = None,
                   timeout: float | None = None):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self._retry_timeout
        while True:
            conn = await self.ensure_connected()
            try:
                return await conn.call(method, data, timeout)
            except ConnectionGaveUp:
                raise  # permanent: never retry-spin on a given-up peer
            except ConnectionLost:
                if loop.time() >= deadline:
                    raise
                await asyncio.sleep(0.1)

    async def notify(self, method: str, data: Any = None):
        conn = await self.ensure_connected()
        await conn.notify(method, data)

    async def push(self, channel: str, data: Any = None):
        conn = await self.ensure_connected()
        await conn.push(channel, data)

    @property
    def closed(self) -> bool:
        # A lost underlying connection is redialable, not closed; only a
        # permanent give-up (ConnectionGaveUp to all callers) closes it.
        return self._gave_up

    async def close(self):
        self._gave_up = True
        if self._conn is not None:
            await self._conn.close()


class ThreadsafeCallQueue:
    """Coalesced cross-thread dispatch onto one event loop.

    Every `loop.call_soon_threadsafe` writes a byte to the loop's self-pipe
    — a real syscall per call, and the single largest per-request cost on
    the serve HTTP path (one wakeup per dispatched query + one per result).
    This queue batches them: callers append under a plain lock and only the
    FIRST append per burst schedules a drain, so N wakeups from any number
    of threads collapse into one self-pipe write per loop tick (the same
    trick the Connection send path uses for outbound frames)."""

    def __init__(self, loop):
        self._loop = loop
        self._lock = threading.Lock()
        self._pending: list = []
        self._scheduled = False

    def call(self, fn, *args) -> None:
        """Run fn(*args) on the loop soon; never blocks. Raises
        RuntimeError if the loop is closed (same as call_soon_threadsafe).
        """
        if self._loop.is_closed():
            # checked BEFORE the _scheduled shortcut: a drain scheduled
            # just before the loop stopped never runs, and the shortcut
            # would otherwise swallow every later call silently
            raise RuntimeError("Event loop is closed")
        with self._lock:
            self._pending.append((fn, args))
            if self._scheduled:
                return
            self._scheduled = True
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        try:
            if running is self._loop:
                self._loop.call_soon(self._drain)  # already on-loop: no pipe
            else:
                M_LOOP_WAKEUPS.inc()
                self._loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            # loop closed: nothing will ever drain. Reset so every later
            # call() retries the schedule and raises too (otherwise they
            # would see _scheduled=True and silently report success).
            # Concurrent winners of the append race lose their items —
            # same as a callback accepted just before close — but any
            # coroutine arguments (submit_nowait) get close()d so they
            # don't leak un-awaited.
            with self._lock:
                self._scheduled = False
                dropped, self._pending = self._pending, []
            for _fn, args in dropped:
                for a in args:
                    if asyncio.iscoroutine(a):
                        a.close()
            raise

    def _drain(self):
        while True:
            with self._lock:
                batch = self._pending
                if not batch:
                    self._scheduled = False
                    return
                self._pending = []
            for fn, args in batch:
                try:
                    fn(*args)
                except Exception:
                    logger.exception("threadsafe call failed")


_loop_queues_lock = threading.Lock()


def loop_call_queue(loop) -> ThreadsafeCallQueue:
    """The shared ThreadsafeCallQueue for `loop` (created on first use).
    Stored as an attribute ON the loop so the queue dies with the loop —
    short-lived loops (tests, proxy restarts) can't pile up in any
    module-global registry."""
    queue = getattr(loop, "_ray_tpu_torch_call_queue", None)
    if queue is None:
        with _loop_queues_lock:
            queue = getattr(loop, "_ray_tpu_torch_call_queue", None)
            if queue is None:
                queue = ThreadsafeCallQueue(loop)
                loop._ray_tpu_torch_call_queue = queue
    return queue


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread.

    The synchronous driver/worker API (get/put/remote) fronts all its async
    IO through one of these — the analog of the reference core worker's
    io_service threads (reference: core_worker.cc io_service_).
    """

    def __init__(self, name="ray_tpu_torch-io"):
        self.loop = asyncio.new_event_loop()
        # via the registry, so resolve_async/_watch_batch waiters reaching
        # this loop through loop_call_queue() coalesce into the SAME queue
        self._calls = loop_call_queue(self.loop)
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout=None):
        M_LOOP_WAKEUPS.inc()
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def submit(self, coro):
        M_LOOP_WAKEUPS.inc()
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def submit_nowait(self, coro):
        """Fire-and-forget coroutine scheduling through the coalesced
        queue — for hot paths that never look at the result (submit()
        builds a concurrent.Future + an uncoalesced wakeup per call)."""
        try:
            self._calls.call(self._spawn, coro)
        except RuntimeError:
            coro.close()  # loop closed: don't leak an unawaited coroutine
            raise

    @staticmethod
    def _spawn(coro):
        asyncio.ensure_future(coro)

    def stop(self):
        def _cancel_all():
            for task in asyncio.all_tasks(self.loop):
                task.cancel()
            self.loop.call_soon(self.loop.stop)

        try:
            self.loop.call_soon_threadsafe(_cancel_all)
        except RuntimeError:
            return
        self._thread.join(timeout=5)


def uds_address(uds_dir: str, port: int) -> str:
    return f"unix:{os.path.join(uds_dir, f'{port}.sock')}"


def prefer_uds(address: str, uds_dir: str | None, local_ips=("127.0.0.1",)):
    """Rewrite a same-node 'ip:port' address to its sibling UDS path when
    that socket exists; remote addresses and missing sockets pass
    through untouched."""
    if uds_dir is None or address.startswith("unix:"):
        return address
    host, _, port = address.rpartition(":")
    if host not in local_ips:
        return address
    candidate = uds_address(uds_dir, int(port))
    if os.path.exists(candidate[len("unix:"):]):
        return candidate
    return address
