"""HTTP proxy actor; port of ray_tpu/serve/http_proxy.py (reference:
python/ray/serve/http_proxy.py:165 HTTPProxyActor — uvicorn/starlette
there, aiohttp here, imported only when the proxy starts). Routes
`route -> endpoint` pushed from the controller via long-poll
(reference: serve/long_poll.py:26): the request path touches no
controller RPC — it reads a locally-cached route table that a single
background thread keeps fresh."""

from __future__ import annotations

import json
import threading
import time

from ray_tpu_torch._private import stats as _stats
from ray_tpu_torch._private import tracing
from ray_tpu_torch.serve import payload as _payload

M_HTTP_E2E_S = _stats.Histogram(
    "serve.http_e2e_s", _stats.LATENCY_BOUNDARIES_S,
    "HTTP request arrival -> response sent (proxy side)")


def _error_response(e: BaseException):
    """Map typed internal errors to honest status codes (the production
    contract: overload and infrastructure loss are RETRYABLE 503s with a
    hint, user exceptions are 500s — a blanket 500 made clients retry
    bugs and give up on sheds). Returns (status, headers, body_dict)."""
    from ray_tpu_torch import exceptions as exc

    if isinstance(e, exc.ServeOverloadedError):
        return 503, {"Retry-After": f"{max(e.retry_after_s, 0.1):.010g}"}, {
            "error": str(e), "type": "ServeOverloadedError",
            "retry_after_s": e.retry_after_s}
    if isinstance(e, exc.ReplicaGroupDied):
        # gang restart in progress: retryable once the controller
        # respawns the group
        return 503, {"Retry-After": "1"}, {
            "error": str(e), "type": "ReplicaGroupDied"}
    if isinstance(e, exc.ObjectLostError):
        # a zero-copy payload's producer died with the only copy
        return 503, {"Retry-After": "1"}, {
            "error": str(e), "type": "ObjectLostError"}
    if isinstance(e, exc.SequenceAborted):
        # the stream was aborted (client gone, KV exhausted mid-decode,
        # engine shutdown): nginx-style 499 — not retryable as-is, not
        # a server bug
        return 499, {}, {"error": str(e), "type": "SequenceAborted"}
    if isinstance(e, exc.TaskError):
        return 500, {}, {"error": str(e), "type": "TaskError",
                         "cause": e.cause_cls_name}
    return 500, {}, {"error": str(e), "type": type(e).__name__}


class HTTPProxy:
    """Actor: runs an aiohttp server on a thread; one Router per endpoint."""

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 0,
                 reuse_port: bool = False):
        self._controller = controller
        self._routers: dict[str, object] = {}
        self._routes: dict[str, dict] = {}
        self._thresholds: dict[str, int] = {}
        self._streaming: dict[str, bool] = {}
        self._state_lock = threading.Lock()
        self._version = -1
        self._host = host
        self._port = port
        # SO_REUSEPORT lets N proxy actor PROCESSES share one listen
        # port; the kernel spreads accepted connections across them, so
        # qps scales past one event loop's ceiling (the reference scales
        # the same way with one uvicorn proxy per node)
        self._reuse_port = reuse_port
        self._actual_port = None
        self._error: BaseException | None = None
        self._ready = threading.Event()
        self._synced = threading.Event()
        self._closed = False
        self._poller = threading.Thread(target=self._poll_loop, daemon=True)
        self._poller.start()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        self._ready.wait(timeout=10)
        if self._error is not None:
            # Surface bind failures (port in use, bad host) as an actor
            # init error instead of a silent None port 10s later — the
            # caller (_start_proxies) kills partially-started proxies on
            # this (no orphaned HTTPProxy actors on bind failure).
            raise RuntimeError(
                f"HTTP proxy failed to serve on {host}:{port}: "
                f"{self._error}") from self._error
        self._synced.wait(timeout=10)

    def _poll_loop(self):
        """Long-poll the controller: one parked RPC instead of a
        get_version per HTTP request."""
        import ray_tpu_torch

        while not self._closed:
            try:
                snap = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._version, 10.0),
                    timeout=40)
            except Exception:
                time.sleep(0.5)
                continue
            if snap is None:
                self._synced.set()  # controller alive, nothing changed
                continue
            # per-endpoint zero-copy cutover, read from the primary
            # backend's config (same snapshot the routes came from)
            thresholds = {}
            streaming = {}
            for name, ep_state in (snap.get("endpoints") or {}).items():
                cfg = (ep_state.get("backends", {})
                       .get(ep_state.get("backend"), {})
                       .get("config") or {})
                thresholds[name] = int(
                    cfg.get("large_payload_threshold") or 0)
                streaming[name] = bool(cfg.get("streaming"))
            with self._state_lock:
                self._routes = dict(snap["routes"])
                self._thresholds = thresholds
                self._streaming = streaming
                self._version = snap["version"]
            self._synced.set()

    def _router_for(self, endpoint: str):
        # Executor threads race here; the lock keeps it to one Router
        # (each owns flusher/completion threads) per endpoint.
        with self._state_lock:
            if endpoint not in self._routers:
                from ray_tpu_torch.serve.router import Router

                self._routers[endpoint] = Router(self._controller, endpoint)
            return self._routers[endpoint]

    def _serve(self):
        import asyncio

        from aiohttp import web

        async def stream_handler(request, endpoint, router, data):
            """Streaming-backend request: SSE when the client asked for
            it (Accept: text/event-stream or {"stream": true}), else
            aggregate the decoded tokens into one JSON reply — both ride
            the engine's continuous batch; only the framing differs.
            TTFT decoupling is the SSE path: the first `data:` frame
            flushes one decode step after admission."""
            from ray_tpu_torch.serve.streaming import (SSE_CONTENT_TYPE,
                                                       sse_event)

            wants_sse = (SSE_CONTENT_TYPE
                         in request.headers.get("Accept", "")
                         or (isinstance(data, dict)
                             and data.get("stream")))
            gen = router.stream_async(data, timeout=60.0)
            if not wants_sse:
                toks: list[int] = []
                try:
                    async for chunk in gen:
                        toks.extend(chunk["tokens"])
                except Exception as e:
                    status, headers, doc = _error_response(e)
                    return web.json_response(doc, status=status,
                                             headers=headers)
                return web.json_response({"result": toks})
            resp = web.StreamResponse(
                status=200,
                headers={"Cache-Control": "no-cache",
                         "X-Accel-Buffering": "no"})
            resp.content_type = SSE_CONTENT_TYPE
            await resp.prepare(request)
            total = 0
            try:
                async for chunk in gen:
                    if "meta" in chunk:
                        # stream preamble: seq id + session-cache
                        # hit/miss (delta-prompt clients resend full
                        # history on a miss)
                        await resp.write(sse_event(chunk["meta"],
                                                   event="meta"))
                        continue
                    total = chunk["cursor"]
                    # one frame per engine chunk, flushed immediately:
                    # a disconnected client surfaces here as a write
                    # error/cancel -> gen closes -> sequence aborts and
                    # its KV pages free (the router's abandon path)
                    await resp.write(sse_event(
                        {"tokens": chunk["tokens"], "cursor": total}))
                await resp.write(sse_event(
                    {"done": True, "tokens_total": total}, event="done"))
            except (asyncio.CancelledError, ConnectionResetError,
                    ConnectionError):
                raise
            except Exception as e:
                status, _, doc = _error_response(e)
                try:
                    await resp.write(sse_event(
                        {**doc, "status": status}, event="error"))
                except (ConnectionError, RuntimeError):
                    pass
            finally:
                try:
                    await gen.aclose()  # no-op if exhausted; otherwise
                except BaseException:   # triggers the abort path
                    pass
                try:
                    await resp.write_eof()
                except (ConnectionError, RuntimeError):
                    pass
            return resp

        async def handler(request: "web.Request"):
            # Fully async request path: route lookup is a plain dict get,
            # the router resolves the RESULT directly (call_async) so a
            # request costs zero per-query cross-thread wakeups — the
            # batch's results arrive on this loop in one coalesced tick
            # (reference: serve's uvicorn proxy is equally async
            # end-to-end).
            route = self._routes.get(request.path)
            if route is None:
                return web.json_response(
                    {"error": f"no route {request.path}"}, status=404)
            if request.method.upper() not in route["methods"]:
                return web.json_response(
                    {"error": f"method {request.method} not allowed"},
                    status=405)
            body = (await request.read()) if request.body_exists else None
            endpoint = route["endpoint"]
            ctype = request.headers.get("Content-Type", "")
            if body is not None and ctype.startswith(
                    "application/octet-stream"):
                # binary body (tensor payloads): pass raw bytes through;
                # at/over the endpoint's threshold they ride the object
                # store as a LargePayload ref instead of being pickled
                # through the router. The store put is a
                # blocking copy — off the event loop (like the response
                # unwrap below), or one 512MB body stalls every
                # concurrent small request on this proxy.
                threshold = self._thresholds.get(endpoint) or 0
                if threshold and len(body) >= threshold:
                    data = await asyncio.get_running_loop() \
                        .run_in_executor(None, _payload.wrap, body,
                                         threshold)
                else:
                    data = body
            else:
                try:
                    data = json.loads(body) if body else None
                except json.JSONDecodeError:
                    return web.json_response({"error": "invalid JSON"},
                                             status=400)
            # lock-free hot path: dict reads are GIL-atomic; the locked
            # creator runs only on the first request per endpoint
            router = self._routers.get(endpoint)
            if router is None:
                router = self._router_for(endpoint)
            # Serve trace entry point: head-sample a root context and
            # make it ambient for the dispatch — the router carries it
            # to the replica so one HTTP request becomes one tree
            # (proxy -> router queue -> lease -> replica exec).
            ctx = tracing.maybe_trace()
            token = tracing.push(ctx) if ctx is not None else None
            t0 = time.time()
            try:
                if self._streaming.get(endpoint):
                    return await stream_handler(request, endpoint,
                                                router, data)
                result = await router.call_async(data, timeout=60.0)
                if isinstance(result, _payload.LargePayload):
                    # zero-copy response: resolve the stored ref off the
                    # event loop and answer binary
                    result = await asyncio.get_running_loop() \
                        .run_in_executor(None, _payload.unwrap, result)
                if isinstance(result, (bytes, bytearray, memoryview)):
                    return web.Response(
                        body=bytes(result),
                        content_type="application/octet-stream")
                return web.json_response({"result": result})
            except Exception as e:
                status, headers, payload_doc = _error_response(e)
                return web.json_response(payload_doc, status=status,
                                         headers=headers)
            finally:
                end = time.time()
                M_HTTP_E2E_S.observe(end - t0,
                                     exemplar=tracing.exemplar_of(ctx))
                if token is not None:
                    tracing.pop(token)
                    tracing.record_span("http.request", t0, end, ctx,
                                        {"name": request.path})

        async def run():
            # client_max_size: large tensor bodies are a first-class
            # workload (they ride the store past the threshold); aiohttp's
            # 1MB default would 413 them at the door
            app = web.Application(client_max_size=1 << 30)
            app.router.add_route("*", "/{tail:.*}", handler)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, self._host, self._port,
                               reuse_port=self._reuse_port or None)
            await site.start()
            self._actual_port = site._server.sockets[0].getsockname()[1]
            self._ready.set()
            while True:
                await asyncio.sleep(3600)

        try:
            asyncio.run(run())
        except BaseException as e:
            already_up = self._ready.is_set()
            self._error = e
            self._ready.set()
            if already_up:
                # post-startup crash (EMFILE, serve-loop bug): __init__
                # returned long ago and nothing reads _error — log loudly
                # instead of leaving a dark proxy with a live-looking port
                import logging

                logging.getLogger("ray_tpu_torch").exception(
                    "HTTP proxy server crashed after startup")
            # pre-ready failures (bind errors) are raised by __init__

    def port(self) -> int:
        return self._actual_port

    def ping(self):
        return "pong"

