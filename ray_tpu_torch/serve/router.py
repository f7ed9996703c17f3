"""Router — batches queries and balances them over replicas; port of
ray_tpu/serve/router.py (reference: python/ray/serve/router.py:178 Router
/ :48 ReplicaSet; micro-batching from backend_worker.py:33 BatchQueue
lives here so one actor RPC carries a full batch).

Each endpoint gets a flusher thread: queries queue up to max_batch_size or
batch_wait_timeout, then fly to the least-loaded replica with a free slot
(max_concurrent_queries in-flight batches per replica). Batch completion —
releasing the replica slot, and resolving result-mode queries — rides
memstore ready-callbacks fired by the task-reply path: there is no polling
thread, and a whole batch's results reach a waiting event loop in one
coalesced wakeup (rpc.loop_call_queue)."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ray_tpu_torch._private import stats as _stats
from ray_tpu_torch._private import tracing
from ray_tpu_torch.serve.kv_cache import prefix_block_hashes
from ray_tpu_torch.serve.metrics import (M_ADMITTED_TOTAL, M_ROUTER_QUEUED,
                                         M_ROUTER_SESSIONS_PRUNED,
                                         M_SHED_TOTAL)

M_ROUTER_QUEUE_S = _stats.Histogram(
    "serve.router_queue_s", _stats.LATENCY_BOUNDARIES_S,
    "query enqueue -> batch dispatch to a replica (the autoscaler's "
    "queue-delay feed, observed for every query)")

def _parse_session(data):
    """(prompt, max_tokens, session, stream?) — the engine's request
    schema; the router only needs the session key for affinity."""
    from ray_tpu_torch.serve.engine import parse_stream_request

    return parse_stream_request(data)


class _PendingQuery:
    __slots__ = ("data", "event", "ref", "error", "abandoned", "loop",
                 "future", "want_result", "trace", "t_enqueue")

    def __init__(self, data):
        self.data = data
        self.event = threading.Event()
        self.ref = None
        self.error = None
        self.abandoned = False
        self.loop = None    # set by assign_async/call_async: asyncio bridge
        self.future = None
        self.want_result = False  # call_async: resolve with the VALUE
        # the caller's ambient trace context (the HTTP proxy mints one
        # per sampled request): carried to the flusher thread so the
        # dispatched batch task joins the request's trace tree
        self.trace = tracing.current()
        self.t_enqueue = time.time()

    def _notify(self):
        """Dispatch outcome is ready: wake the sync waiter and, for async
        callers, resolve their future on its own event loop (the flusher
        thread can't touch asyncio state directly). Result-mode queries
        only land here on dispatch ERRORS — their success path resolves at
        completion with the value, with zero per-query dispatch wakeups."""
        self.event.set()
        if self.future is not None:
            from ray_tpu_torch._private import rpc

            def _done(q=self):
                # abandoned = caller timed out and stopped awaiting; an
                # exception set now would only surface as "Future
                # exception was never retrieved" GC spam
                if not q.future.done() and not q.abandoned:
                    if q.error is not None:
                        q.future.set_exception(q.error)
                    else:
                        q.future.set_result(q.ref)
            try:
                rpc.loop_call_queue(self.loop).call(_done)
            except RuntimeError:
                # caller's event loop already closed (proxy shutdown
                # race): nobody is waiting; the sync event is set
                pass


class Router:
    def __init__(self, controller, endpoint: str,
                 refresh_interval: float = 0.25):
        self._controller = controller
        self._endpoint = endpoint
        self._refresh_interval = refresh_interval
        self._lock = threading.Lock()
        self._queue: list[_PendingQuery] = []
        self._inflight: dict[bytes, int] = {}   # actor_id -> live batches
        # streaming tier: sticky session -> replica actor key, plus live
        # open-stream accounting (streams hold an _inflight slot for
        # their whole life, not one batch). Both tables are LRU-bounded
        # OrderedDicts: insertion order is eviction order, hits refresh
        # via move_to_end, caps come from the backend config
        # (router_session_cap / router_prefix_cap).
        self._sessions: OrderedDict[str, bytes] = OrderedDict()
        # prefix-hash -> replica actor key, fed by the engine's
        # stream_open meta: new sessions route to the replica already
        # holding their longest page-aligned prefix
        self._prefixes: OrderedDict[str, bytes] = OrderedDict()
        self._streams_open = 0
        self._affinity_hits = 0
        self._affinity_misses = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._sessions_pruned = 0
        self._state = None
        self._state_time = 0.0
        self._shed_total = 0
        self._admitted_total = 0
        self._closed = False
        self._wake = threading.Event()
        self._refresh()
        self._flusher = threading.Thread(target=self._flush_loop, daemon=True)
        self._flusher.start()
        self._poller = threading.Thread(target=self._poll_loop, daemon=True)
        self._poller.start()

    def debug_state(self) -> dict:
        """Msgpack-safe live snapshot: queued queries with ages (+trace
        ids), per-replica in-flight batches."""
        now = time.time()
        with self._lock:
            queue = list(self._queue)
            inflight = {aid.hex()[:16]: n
                        for aid, n in self._inflight.items() if n}
        maxq, _ = self._admission()
        return {
            "endpoint": self._endpoint,
            "queued": len(queue),
            "max_queued": maxq or 0,
            "shed_total": self._shed_total,
            "admitted_total": self._admitted_total,
            "streams_open": self._streams_open,
            "sessions": len(self._sessions),
            "affinity_hits": self._affinity_hits,
            "affinity_misses": self._affinity_misses,
            "prefix_index": len(self._prefixes),
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "sessions_pruned": self._sessions_pruned,
            "oldest_age_s": (round(max(now - q.t_enqueue
                                       for q in queue), 3)
                             if queue else 0.0),
            "inflight_batches": inflight,
            "queries": [{
                "endpoint": self._endpoint,
                "age_s": round(now - q.t_enqueue, 3),
                "trace_id": (q.trace.trace_id.hex()
                             if q.trace is not None else ""),
            } for q in queue[:25]],
        }

    # -- state sync ------------------------------------------------------

    def _refresh(self):
        import ray_tpu_torch

        self._state = ray_tpu_torch.get(
            self._controller.get_routing_state.remote(self._endpoint),
            timeout=30)
        self._state_time = time.monotonic()

    def _poll_loop(self):
        """Long-poll push of routing state (reference: long_poll.py:26) +
        queue-depth reporting for the controller's autoscaler (reference:
        autoscaling_policy.py:137). The dispatch path never talks to the
        controller."""
        import ray_tpu_torch

        while not self._closed:
            try:
                with self._lock:
                    qlen = len(self._queue)
                ray_tpu_torch.get(self._controller.report_queue_len.remote(
                    self._endpoint, qlen), timeout=30)
                snap = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._state["version"] if self._state else -1, 2.0),
                    timeout=30)
            except Exception:
                time.sleep(0.5)
                continue
            if snap is None:
                continue
            st = snap["endpoints"].get(self._endpoint)
            if st is not None:
                self._state = st
                self._wake.set()

    # -- admission control (load shedding / backpressure) ----------------

    def _admission(self) -> tuple[int | None, float]:
        """(max_queued_requests, retry_after_s) for this endpoint, read
        from the primary backend's config in the current routing state
        (None = unbounded)."""
        state = self._state
        if not state:
            return None, 1.0
        cfg = (state.get("backends", {})
               .get(state.get("backend"), {})
               .get("config"))
        if not cfg:
            return None, 1.0
        return (cfg.get("max_queued_requests"),
                float(cfg.get("overload_retry_after_s") or 1.0))

    def _admit(self, q: _PendingQuery) -> None:
        """Append under the bounded queue or raise the typed shed error.
        All bookkeeping the shed/cancel paths must keep honest lives
        here and in _abandon/_take_batch: the live-queue gauge moves
        with every append/remove, and a shed never touches any ref or
        memstore state (nothing was created for it)."""
        from ray_tpu_torch import exceptions as exc

        maxq, retry_after = self._admission()
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    f"router for {self._endpoint!r} is closed")
            depth = len(self._queue)
            if maxq is not None and depth >= maxq:
                self._shed_total += 1
                shed = exc.ServeOverloadedError(
                    self._endpoint, depth, maxq, retry_after)
            else:
                self._queue.append(q)
                self._admitted_total += 1
                shed = None
        if shed is not None:
            M_SHED_TOTAL.inc()
            raise shed
        M_ADMITTED_TOTAL.inc()
        M_ROUTER_QUEUED.add(1)
        self._wake.set()

    # -- client surface --------------------------------------------------

    def assign(self, data, timeout: float = 30.0):
        """Enqueue one query; block until its batch is dispatched; return
        the caller's ObjectRef slice of the batched call."""
        q = _PendingQuery(data)
        self._admit(q)
        if not q.event.wait(timeout):
            # Nobody will consume the result — withdraw the query so it
            # doesn't burn a replica slot after we've given up on it.
            self._abandon(q)
            raise TimeoutError(
                f"no replica accepted the query within {timeout}s")
        if q.error is not None:
            raise q.error
        return q.ref

    async def assign_async(self, data, timeout: float = 30.0):
        """assign() for asyncio callers (the HTTP proxy): enqueue and
        await dispatch WITHOUT parking a thread per request — the proxy's
        request concurrency is then bounded by the event loop, not an
        executor pool."""
        import asyncio

        q = _PendingQuery(data)
        q.loop = asyncio.get_running_loop()
        q.future = q.loop.create_future()
        self._admit(q)
        try:
            return await asyncio.wait_for(asyncio.shield(q.future),
                                          timeout)
        except asyncio.TimeoutError:
            self._abandon(q)
            raise TimeoutError(
                f"no replica accepted the query within {timeout}s")
        except asyncio.CancelledError:
            self._abandon(q)  # caller task cancelled (client disconnect)
            raise

    async def call_async(self, data, timeout: float = 30.0):
        """One round trip for asyncio callers (the HTTP proxy): enqueue and
        await the RESULT VALUE directly. Versus assign_async + `await ref`
        this removes both per-request cross-thread wakeups: dispatch does
        not notify the caller at all, and the reply's deserialized values
        are delivered for the whole batch in one coalesced loop tick."""
        import asyncio

        q = _PendingQuery(data)
        q.loop = asyncio.get_running_loop()
        q.future = q.loop.create_future()
        q.want_result = True
        self._admit(q)
        try:
            return await asyncio.wait_for(asyncio.shield(q.future), timeout)
        except asyncio.TimeoutError:
            self._abandon(q)
            raise TimeoutError(
                f"request timed out after {timeout}s") from None
        except asyncio.CancelledError:
            # caller task cancelled (HTTP client disconnected mid-request):
            # same cleanup as a timeout, or the dead client's query still
            # dispatches and its orphaned future collects exception spam
            self._abandon(q)
            raise

    # -- streaming (continuous-batching backends) ------------------------

    def _pick_stream_replica(self, state: dict, backend: str,
                             session: str | None,
                             prefix_hashes: list[str] = (),
                             cfg: dict | None = None):
        """KV-aware pick, in order: (1) sticky session -> the replica
        holding that session's KV pages; (2) prefix index -> the
        replica holding the LONGEST page-aligned prefix of this prompt
        (hashes checked longest-first, so a deep match beats a shallow
        one); (3) least-loaded fallback. Sessions whose replica
        vanished (gang restart, downscale) re-stick wherever they
        land."""
        st = state["backends"].get(backend)
        if st is None or not st["replicas"]:
            return None
        cfg = cfg or {}
        session_cap = int(cfg.get("router_session_cap") or 4096)
        live = {h._actor_id.binary(): h for h in st["replicas"]}
        with self._lock:
            if session:
                want = self._sessions.get(session)
                if want is not None and want in live:
                    self._affinity_hits += 1
                    self._sessions.move_to_end(session)
                    return live[want]
            for h in reversed(prefix_hashes):
                want = self._prefixes.get(h)
                if want is not None and want in live:
                    self._prefix_hits += 1
                    self._prefixes.move_to_end(h)
                    if session:
                        self._affinity_misses += 1
                        self._stick(session, want, session_cap)
                    return live[want]
            if prefix_hashes:
                self._prefix_misses += 1
            best, best_load = None, None
            for key, handle in live.items():
                load = self._inflight.get(key, 0)
                if best_load is None or load < best_load:
                    best, best_load = handle, load
            if session and best is not None:
                self._affinity_misses += 1
                self._stick(session, best._actor_id.binary(),
                            session_cap)
        return best

    def _stick(self, session: str, key: bytes, cap: int):
        """Record session -> replica under self._lock, LRU-bounded."""
        self._sessions.pop(session, None)
        self._sessions[session] = key
        while len(self._sessions) > cap:
            self._sessions.popitem(last=False)
            self._sessions_pruned += 1
            M_ROUTER_SESSIONS_PRUNED.inc()

    def _note_stream_meta(self, key: bytes, reply: dict,
                          cfg: dict | None = None):
        """Digest a stream_open reply's routing feedback: index the
        prefix hashes this replica now holds (LRU-bounded), and prune
        sticky entries for sessions the engine LRU-evicted — without
        this the router pins a session to a replica whose cache is
        long gone."""
        cfg = cfg or {}
        prefix_cap = int(cfg.get("router_prefix_cap") or 8192)
        hashes = reply.get("prefix_hashes") or []
        evicted = reply.get("evicted_sessions") or []
        with self._lock:
            for h in hashes:
                self._prefixes.pop(h, None)
                self._prefixes[h] = key
            while len(self._prefixes) > prefix_cap:
                self._prefixes.popitem(last=False)
            for sess in evicted:
                # only unpin if still pointing at the evicting replica
                # (the session may have re-stuck elsewhere already)
                if self._sessions.get(sess) == key:
                    self._sessions.pop(sess, None)
                    self._sessions_pruned += 1
                    M_ROUTER_SESSIONS_PRUNED.inc()

    async def stream_async(self, data, timeout: float = 60.0):
        """Async generator of token chunks from a streaming backend:
        open a sequence on the affine replica, long-poll its channel,
        yield each chunk as it lands. `timeout` bounds time WITHOUT
        progress (admission included), not total generation.

        Accounting (the long-lived-request fix): the stream holds the
        queued gauge only until the sequence is admitted, then one
        in-flight slot on its replica until it ends — and the ABANDON
        path (caller cancelled / disconnected mid-stream) aborts the
        remote sequence so its KV pages free, then returns both gauges,
        exactly like a one-shot query's withdraw."""
        import asyncio

        from ray_tpu_torch import exceptions as exc

        state = self._state
        backend = self._pick_backend(state) if state else None
        if backend is None or backend not in state.get("backends", {}):
            raise RuntimeError(
                f"no backend serving endpoint {self._endpoint!r}")
        cfg = state["backends"][backend]["config"]
        if not cfg.get("streaming"):
            raise RuntimeError(
                f"backend {backend!r} is not a streaming backend "
                f"(deploy with BackendConfig(streaming=True))")
        poll_s = float(cfg.get("stream_poll_s") or 2.0)
        prompt, _, session, _ = _parse_session(data)
        # same chained page hashes the engine computes: a router-side
        # hash matches a replica-side one iff the token pages match
        phashes = []
        if prompt and cfg.get("prefix_sharing", True):
            phashes = prefix_block_hashes(
                prompt, int(cfg.get("kv_page_size") or 16))
        deadline = time.monotonic() + timeout
        replica = None
        while replica is None:
            replica = self._pick_stream_replica(state, backend, session,
                                                phashes, cfg)
            if replica is None:
                # gang restarting / replicas scaling: wait for cutover
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no replica for {backend!r} within {timeout}s")
                await asyncio.sleep(0.05)
                state = self._state
        key = replica._actor_id.binary()
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
        M_ROUTER_QUEUED.add(1)
        queued = True
        opened = False
        seq_id = None
        finished = False
        try:
            try:
                reply = await replica.stream_open.remote(data)
            except BaseException as e:
                if isinstance(e, exc.ServeOverloadedError):
                    with self._lock:
                        self._shed_total += 1
                    M_SHED_TOTAL.inc()
                    raise
                raise self._map_group_error(e, cfg) from None
            seq_id = reply["seq"]
            self._note_stream_meta(key, reply, cfg)
            M_ROUTER_QUEUED.add(-1)
            queued = False
            opened = True
            M_ADMITTED_TOTAL.inc()  # admitted = the engine accepted it
            with self._lock:
                self._admitted_total += 1
                self._streams_open += 1
            # meta chunk first: session-cache hit/miss is part of the
            # stream contract (a delta-prompt client must resend full
            # history on a miss — see stream_open)
            from ray_tpu_torch.serve.streaming import meta_chunk
            yield meta_chunk(
                seq_id,
                session_cached=reply.get("session_cached", False),
                prefix_hashes=reply.get("prefix_hashes") or [])
            cursor = 0
            deadline = time.monotonic() + timeout
            while True:
                try:
                    chunk = await replica.stream_next.remote(
                        seq_id, cursor, poll_s)
                except BaseException as e:
                    raise self._map_group_error(e, cfg) from None
                if chunk["tokens"]:
                    cursor = chunk["cursor"]
                    deadline = time.monotonic() + timeout  # progress
                    yield chunk
                if chunk["done"]:
                    finished = True
                    err = chunk.get("error")
                    if err is not None:
                        if isinstance(err, exc.ServeOverloadedError):
                            # engine-side shed (KV pool / prefill): the
                            # 503 must move the shed counters even
                            # though stream_open itself succeeded
                            with self._lock:
                                self._shed_total += 1
                            M_SHED_TOTAL.inc()
                        raise self._map_group_error(err, cfg)
                    return
                if time.monotonic() > deadline:
                    finished = True  # we abort it: not abandoned
                    await self._abort_stream(replica, seq_id,
                                             "stream idle timeout")
                    raise TimeoutError(
                        f"stream {seq_id} made no progress within "
                        f"{timeout}s")
        finally:
            if queued:
                M_ROUTER_QUEUED.add(-1)
            with self._lock:
                self._inflight[key] -= 1
                if opened:
                    self._streams_open -= 1
            if opened and not finished:
                # abandon path: caller cancelled / client disconnected
                # mid-stream — abort the sequence so the engine frees
                # its KV pages (fire-and-forget on the caller's loop;
                # we cannot await inside GeneratorExit)
                try:
                    asyncio.get_running_loop().create_task(
                        self._abort_stream(replica, seq_id,
                                           "client disconnect"))
                except RuntimeError:
                    pass  # caller's loop is gone; the engine's stream
                    # reaper and gang teardown bound the leak
            self._wake.set()

    @staticmethod
    async def _abort_stream(replica, seq_id: str, reason: str):
        try:
            await replica.stream_abort.remote(seq_id, reason)
        except Exception:
            pass  # replica already dead: pages died with it

    def _abandon(self, q: _PendingQuery):
        """Caller gave up (timeout / client disconnect). While still
        queued the query is withdrawn outright — queue gauge reclaimed,
        no refs were ever created for it. Once dispatched, the abandoned
        flag makes the completion path drop the result and free the
        router-owned ref instead of parking it on a dead future."""
        with self._lock:
            q.abandoned = True
            dequeued = q in self._queue
            if dequeued:
                self._queue.remove(q)
        if dequeued:
            M_ROUTER_QUEUED.add(-1)

    def close(self):
        with self._lock:
            self._closed = True
            stranded = list(self._queue)
            self._queue.clear()
        if stranded:
            # a closed router must not strand queued callers until their
            # timeout: error them now and give the gauge back
            M_ROUTER_QUEUED.add(-len(stranded))
            err = RuntimeError(
                f"router for {self._endpoint!r} closed while the query "
                f"was queued")
            for q in stranded:
                q.error = err
                q._notify()
        self._wake.set()

    # -- flusher ---------------------------------------------------------

    @staticmethod
    def _pick_backend(state: dict) -> str | None:
        """Weighted-random backend per batch (reference: serve v1
        set_traffic — router splits by endpoint traffic policy)."""
        import random

        traffic = state.get("traffic")
        if not traffic:
            return state.get("backend")
        names = list(traffic)
        if len(names) == 1:
            return names[0]
        return random.choices(names, weights=[traffic[n] for n in names])[0]

    def _pick_replica(self, state: dict, backend: str):
        st = state["backends"].get(backend)
        if st is None:
            return None
        cap = st["config"]["max_concurrent_queries"]
        with self._lock:
            best, best_load = None, None
            for handle in st["replicas"]:
                load = self._inflight.get(handle._actor_id.binary(), 0)
                if load < cap and (best_load is None or load < best_load):
                    best, best_load = handle, load
        return best

    def _flush_loop(self):
        import logging

        while not self._closed:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            try:
                self._flush_once()
            except Exception:
                # the flusher must outlive any single bad dispatch —
                # a dead flusher turns every future assign() into a
                # timeout
                logging.getLogger("ray_tpu_torch.serve").exception(
                    "router flush iteration failed")
                time.sleep(0.05)

    def _flush_once(self):
        import random

        while not self._closed:
            # one consistent snapshot per iteration: the poller
            # thread swaps self._state on traffic cutover, and mixing
            # two snapshots' backend maps would KeyError the flusher
            state = self._state
            with self._lock:
                if not self._queue:
                    break
            backend = self._pick_backend(state)
            if backend is None or backend not in state["backends"]:
                time.sleep(0.01)
                continue
            cfg = state["backends"][backend]["config"]
            # fill a batch (or give stragglers batch_wait_timeout) —
            # event-driven: enqueues set _wake, so a full batch dispatches
            # the moment it fills instead of on the next 1ms poll tick
            # (each sleep(0.001) is a timer syscall that cost multiple ms
            # under load on the 1-core box)
            if cfg["max_batch_size"]:
                deadline = time.monotonic() + cfg["batch_wait_timeout"]
                while (not self._closed
                       and len(self._queue) < cfg["max_batch_size"]):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(remaining)
                    self._wake.clear()
            replica = self._pick_replica(state, backend)
            if replica is None:
                # chosen backend saturated — try any other traffic
                # backend with capacity before waiting
                for other in state.get("traffic", {}):
                    if other != backend:
                        replica = self._pick_replica(state, other)
                        if replica is not None:
                            backend = other
                            cfg = state["backends"][other]["config"]
                            break
            if replica is None:
                time.sleep(0.002)
                continue
            # batch sized by the backend that will actually serve it
            max_bs = cfg["max_batch_size"] or 1
            with self._lock:
                taken = min(max_bs, len(self._queue))
                batch = [q for q in self._queue[:max_bs]
                         if not q.abandoned]
                del self._queue[:max_bs]
            if taken:
                M_ROUTER_QUEUED.add(-taken)
            if not batch:
                continue
            self._dispatch(replica, batch, cfg=cfg)
            # shadow traffic: mirror the batch, results dropped
            # (reference: serve/api.py shadow_traffic)
            for sb, prop in (state.get("shadow") or {}).items():
                if random.random() < prop:
                    sreplica = self._pick_replica(state, sb)
                    if sreplica is not None:
                        self._dispatch(sreplica, batch, shadow=True,
                                       cfg=state["backends"][sb]["config"])

    def _map_group_error(self, e, cfg):
        """Sharded backends: a dead group LEADER surfaces to callers as
        the typed ReplicaGroupDied (member deaths are typed by the
        leader itself; leader death is an actor error only the router
        can attribute to the gang)."""
        from ray_tpu_torch import exceptions as exc

        if (cfg and cfg.get("num_shards", 1) > 1
                and isinstance(e, (exc.ActorDiedError,
                                   exc.ActorUnavailableError))):
            return exc.ReplicaGroupDied(
                self._endpoint, "",
                f"group leader died: {type(e).__name__}: {e}")
        return e

    def _dispatch(self, replica, batch: list[_PendingQuery],
                  shadow: bool = False, cfg: dict | None = None):
        key = replica._actor_id.binary()
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
        batch_ctx = None
        if not shadow:
            # queue-wait hop closes here: histogram for every query,
            # spans for the traced ones. The first traced query's
            # context becomes ambient for the batch's .remote() below,
            # so the replica-side exec span joins its request tree.
            now = time.time()
            for q in batch:
                M_ROUTER_QUEUE_S.observe(
                    now - q.t_enqueue,
                    exemplar=tracing.exemplar_of(q.trace))
                if q.trace is not None:
                    tracing.record_span(
                        "serve.router_queue", q.t_enqueue, now,
                        tracing.child(q.trace))
                    if batch_ctx is None:
                        batch_ctx = q.trace
        refs: list = []
        try:
            with tracing.use(batch_ctx):
                out = replica.handle_batch.options(
                    num_returns=len(batch)).remote([q.data for q in batch])
            refs = [out] if len(batch) == 1 else list(out)
            if not shadow:
                for q, ref in zip(batch, refs):
                    if q.want_result:
                        continue  # resolved at completion with the value
                    q.ref = ref
                    q._notify()
        except Exception as e:
            if not shadow:
                e = self._map_group_error(e, cfg)
                for q in batch:
                    q.error = e
                    q._notify()
        if refs:
            # shadow batches still occupy a replica slot until done
            # (backpressure); their results are reclaimed the moment
            # each lands (_watch_batch owns and frees those refs)
            self._watch_batch(key, refs, () if shadow else batch,
                              cfg=cfg)
        else:
            with self._lock:
                self._inflight[key] -= 1

    def _watch_batch(self, key: bytes, refs: list, batch,
                     cfg: dict | None = None):
        """Arm one memstore ready-callback per return: the last one to
        fire frees the replica slot, and result-mode queries get their
        deserialized value pushed straight to their event loop. The
        callbacks run inline on the task-reply (io-loop) thread, so a
        whole batch completes in one pass with no polling anywhere.

        Ref reclamation: refs only the ROUTER will ever read — shadow
        results, and result-mode (call_async) returns whose callers get
        the VALUE — are held in `owned` and dropped deterministically as
        each completes, so their memstore entries and owned-table rows
        free on the spot instead of whenever GC finds the callback
        closures ("results go nowhere" must not strand entries). Refs
        handed to assign() callers are theirs to hold; the router keeps
        no copy past the callback."""
        from ray_tpu_torch._private import global_state, rpc, serialization
        from ray_tpu_torch._private.memstore import IN_PLASMA

        cw = global_state.get_core_worker()
        state = {"left": len(refs)}
        waiters = {ref.id(): q for q, ref in zip(batch, refs)
                   if q.want_result}
        if batch:
            owned = {ref.id(): ref for q, ref in zip(batch, refs)
                     if q.want_result}
        else:  # shadow: every result is nobody's — all router-owned
            owned = {ref.id(): ref for ref in refs}

        def finish_one(oid):
            owned.pop(oid, None)  # deterministic free (see docstring)
            with self._lock:
                state["left"] -= 1
                done = state["left"] == 0
                if done:
                    self._inflight[key] -= 1
            if done:
                self._wake.set()

        def deliver(q, result, is_exc):
            def _set():
                fut = q.future
                # abandoned = caller timed out; setting an exception on
                # the orphaned future would log "exception was never
                # retrieved" at GC for every such request
                if fut is None or fut.done() or q.abandoned:
                    return
                if is_exc:
                    fut.set_exception(result)
                else:
                    fut.set_result(result)
            try:
                rpc.loop_call_queue(q.loop).call(_set)
            except RuntimeError:
                pass  # caller's loop closed; result goes nowhere

        def make_cb(ref):
            oid = ref.id()
            q = waiters.get(oid)

            def resolve_blocking():
                import ray_tpu_torch

                try:
                    deliver(q, ray_tpu_torch.get(ref), False)
                except BaseException as e:
                    deliver(q, self._map_group_error(e, cfg), True)
                finally:
                    finish_one(oid)

            def on_ready():
                if q is None:
                    finish_one(oid)
                    return
                found, value, is_exc = cw.memstore.get_if_ready(oid)
                if not found or value is IN_PLASMA:
                    # raced a reset(), or a store-resident result: the
                    # read may block — keep it off this thread
                    threading.Thread(target=resolve_blocking,
                                     daemon=True).start()
                    return
                try:
                    result = serialization.deserialize(value)
                except BaseException as e:
                    result, is_exc = e, True
                if is_exc:
                    result = self._map_group_error(result, cfg)
                deliver(q, result, is_exc)
                finish_one(oid)

            return on_ready

        for ref in refs:
            cw.memstore.add_ready_callback(ref.id(), make_cb(ref))


class ServeHandle:
    """Caller-facing handle (reference: python/ray/serve/handle.py):
    handle.remote(data) -> ObjectRef; ray_tpu_torch.get(ref) -> result."""

    def __init__(self, controller, endpoint: str):
        self._router = Router(controller, endpoint)
        self.endpoint = endpoint

    def remote(self, data=None):
        return self._router.assign(data)

    def stream(self, data=None, timeout: float = 60.0):
        """Sync token generator over a streaming backend: bridges the
        router's async stream onto a private loop thread so plain
        callers iterate tokens as they decode. Abandoning the generator
        mid-stream cancels the async side, which aborts the remote
        sequence (KV pages free) — same contract as an HTTP client
        disconnecting."""
        import asyncio
        import queue as _queue

        out: _queue.Queue = _queue.Queue()
        holder: dict = {}

        def run():
            async def go():
                holder["task"] = asyncio.current_task()
                try:
                    async for chunk in self._router.stream_async(
                            data, timeout=timeout):
                        out.put(("tokens", chunk["tokens"]))
                except asyncio.CancelledError:
                    out.put(("done", None))
                    raise
                except BaseException as e:
                    out.put(("error", e))
                    return
                out.put(("done", None))

            try:
                asyncio.run(go())
            except BaseException:
                pass
            holder["loop_done"] = True

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        try:
            while True:
                kind, val = out.get()
                if kind == "tokens":
                    yield from val
                elif kind == "error":
                    raise val
                else:
                    return
        finally:
            task = holder.get("task")
            if task is not None and not holder.get("loop_done"):
                try:
                    task.get_loop().call_soon_threadsafe(task.cancel)
                except RuntimeError:
                    pass

    def __repr__(self):
        return f"ServeHandle({self.endpoint!r})"
