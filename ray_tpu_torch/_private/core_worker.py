"""CoreWorker — the in-process runtime in every driver and worker.

Capability parity with the reference core worker (reference:
src/ray/core_worker/core_worker.h:321 and core_worker.cc — Put :903,
Get :1024, Wait :1157, SubmitTask :1390, CreateActor :1435,
SubmitActorTask :1595, CancelTask :1644, KillActor :1684, ExecuteTask
:1863), the direct task submitter with lease reuse + pipelining
(direct_task_transport.h:52), the direct actor submitter with per-caller
sequence numbers and RESTARTING queues (direct_actor_transport.h:62), and a
simplified distributed reference counter (reference_count.h:59: local refs +
borrows + in-flight submission pins; lineage kept while references exist).

Threading model: synchronous public API on the caller's thread; all network
IO on one asyncio event-loop thread (the analog of the reference's
io_service threads); task execution (worker mode) on a dedicated dispatcher
thread, with async actor methods running on their own loop.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import contextvars
import itertools
import logging
import os
import queue as queue_mod
import sys
import threading
import time
import traceback
from typing import Any

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import common, global_state, rpc, serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.memstore import IN_PLASMA, MemoryStore
from ray_tpu_torch._private.object_store import make_store
from ray_tpu_torch.object_ref import ObjectRef

logger = logging.getLogger("ray_tpu_torch.core_worker")

DRIVER = "driver"
WORKER = "worker"

# Churn instrumentation for the task fast path. Together with
# rpc.loop_wakeups_total these feed the tier-1 hop-count guard
# (tests/test_task_pipelining.py): per completed task, wakeups + executor
# hops must stay below a fixed bound so per-call churn can't silently
# regrow.
from ray_tpu_torch._private import stats as _stats

M_TASKS_SUBMITTED = _stats.Count(
    "core.tasks_submitted_total", "tasks submitted by this process")
M_TASKS_COMPLETED = _stats.Count(
    "core.tasks_completed_total", "task replies handled by this process")
M_TASKS_EXECUTED = _stats.Count(
    "core.tasks_executed_total", "tasks executed by this process")
M_EXEC_HOPS = _stats.Count(
    "core.exec_hops_total", "dispatcher/executor thread handoffs")
M_LEASE_REQUESTS = _stats.Count(
    "core.lease_requests_total", "worker-lease request RPCs issued")

# Per-hop latency histograms of the task path (TrainWorker.read_metric
# reads them in a worker).
M_QUEUE_WAIT_S = _stats.Histogram(
    "core.task_queue_wait_s", _stats.LATENCY_BOUNDARIES_S,
    "submit -> pushed to a leased worker")
M_LEASE_WAIT_S = _stats.Histogram(
    "core.task_lease_wait_s", _stats.LATENCY_BOUNDARIES_S,
    "worker-lease request round trip")
M_EXEC_S = _stats.Histogram(
    "core.task_exec_s", _stats.LATENCY_BOUNDARIES_S,
    "task execution (worker side)")
M_REPLY_OVERHEAD_S = _stats.Histogram(
    "core.task_reply_overhead_s", _stats.LATENCY_BOUNDARIES_S,
    "push round trip minus worker-held time (wire + loop overhead)")
M_E2E_S = _stats.Histogram(
    "core.task_e2e_s", _stats.LATENCY_BOUNDARIES_S,
    "submit -> reply handled (owner side)")


# Task id of the async-actor coroutine currently running on the actor's
# event loop (asyncio snapshots the context per scheduled coroutine).
_ASYNC_TASK_ID: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_async_task_id", default=None)


class _Lease:
    __slots__ = ("lease_id", "worker_id", "address", "conn", "inflight",
                 "last_used", "task_conn", "burst_channel")

    def __init__(self, lease_id, worker_id, address, conn, task_conn=None):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.address = address
        self.conn = conn
        self.inflight = 0
        self.last_used = time.monotonic()
        # Direct task channel (blocking UDS served by the worker's
        # executor thread itself); None when the worker has none.
        self.task_conn = task_conn
        self.burst_channel = True

    @property
    def push_conn(self):
        """Latency/throughput hybrid, chosen ONCE per burst (when
        inflight rises from 0, see _drain_pending): shallow bursts ride
        the direct channel (no asyncio hops worker-side), deep bursts
        ride the rpc conn, whose replies overlap execution on the
        worker's io loop instead of sendall()ing from the executor.
        Sticky per burst so every in-flight push for this lease shares
        ONE FIFO connection — mixing conns would let later tasks reach
        the worker's queue first (order matters to queued-task
        cancellation and to wait()-style first-come expectations)."""
        conn = self.task_conn
        if conn is not None and not conn.closed and self.burst_channel:
            return conn
        return self.conn


class _ActorClient:
    """Owner-side state for one actor (per-handle ordering + restart queue)."""

    def __init__(self, actor_id: bytes):
        self.actor_id = actor_id
        self.address = ""
        self.state = "PENDING_CREATION"
        self.conn: rpc.Connection | None = None
        self.seq = 0
        # Reorder-lane epoch: bumped on a connection loss to a
        # still-ALIVE actor. The worker cannot tell whether the seq
        # numbers lost with the connection were consumed, so the lane is
        # poisoned — callers and the worker restart matching (epoch,
        # seq=0) lanes instead of wedging every later call behind a seq
        # hole nothing will ever fill.
        self.epoch = 0
        self.queued: list[tuple[dict, list[ObjectID]]] = []
        self.subscribed = False
        self.death_cause = ""
        self.flush_scheduled = False
        self.poll_scheduled = False
        self.inflight = 0
        self.burst_channel = True
        # same-node direct task channel of the hosting worker
        self.task_channel = ""
        self.task_conn: rpc.Connection | None = None
        # the constructor's object args, pinned while the actor lives: a
        # creation queued for resources, and every restart, reads them
        self.creation_pins: list[ObjectID] = []


class _OwnedRef:
    __slots__ = ("local", "borrows", "pins", "plasma", "lineage_task")

    def __init__(self):
        self.local = 0
        self.borrows = 0
        self.pins = 0
        self.plasma = False
        self.lineage_task = None

    def total(self):
        return self.local + self.borrows + self.pins


class CoreWorker:
    def __init__(self, *, mode: str, raylet_address: str, gcs_address: str,
                 session_dir: str, store_root: str, config: Config,
                 job_id: JobID | None = None, worker_id: WorkerID | None = None):
        self.mode = mode
        self.config = config
        self.session_dir = session_dir
        self.worker_id = worker_id or WorkerID.from_random()
        self.job_id = job_id or JobID.from_int(0)
        self.node_id: NodeID | None = None

        self.memstore = MemoryStore()
        self.store = make_store(store_root, config)
        self._io = rpc.EventLoopThread()
        self._lock = threading.RLock()

        # reference counting
        self.owned: dict[ObjectID, _OwnedRef] = {}
        self.borrowed: dict[ObjectID, dict] = {}  # oid -> {count, owner}

        # task management
        self._task_counter = 0
        # next() of a count is atomic: puts from several threads (a
        # driver that makes actors concurrently) never share an id
        self._put_counter = itertools.count(1)
        self.current_task_id = TaskID.for_driver(self.job_id)
        self._task_ctx = threading.local()
        self.submitted: dict[bytes, dict] = {}  # task_id -> record
        self.leases: dict[tuple, list[_Lease]] = {}
        self._lease_requests: dict[tuple, int] = {}
        self._pending_by_key: dict[tuple, list] = {}
        # lease pre-warm bookkeeping (all io-loop-confined): when a key's
        # queue became non-empty (hard-escalation clock) and until when
        # soft prewarm is suppressed after a miss
        self._pending_since: dict[tuple, float] = {}
        self._soft_backoff: dict[tuple, float] = {}
        self._lease_reaper_running = False

        # actors
        self.actor_clients: dict[bytes, _ActorClient] = {}
        # placement-group waiters (io-loop-confined): pg_id -> futures
        self._pg_waiters: dict[bytes, list] = {}

        # function registry
        self._fn_cache: dict[bytes, Any] = {}
        self._exported: set[bytes] = set()

        # execution (worker mode)
        self._exec_queue: queue_mod.Queue = queue_mod.Queue()
        self._cancelled_tasks: set[bytes] = set()
        self.task_channel_address = ""
        self._actor_instance = None
        self._actor_id: ActorID | None = None
        self._actor_reorder: dict[bytes, dict] = {}  # caller -> {next, heap}
        self._async_loop: rpc.EventLoopThread | None = None
        self._exec_pool = None  # ThreadPoolExecutor when max_concurrency>1
        self._shutdown = False
        self._exiting = False

        # connections
        self.raylet: rpc.Connection | None = None
        self.gcs: rpc.Connection | None = None
        self._peer_conns: dict[str, rpc.Connection] = {}
        # io-loop-confined per-address dial locks: without them a burst
        # of concurrent _peer() callers (arg fetches + borrow syncs of
        # one arriving task) each dial, and the losers' connections are
        # silently dropped from the cache while still carrying in-flight
        # calls — the orphaned conn+task cycles then get GC'd mid-await
        # and the calls neither complete NOR error (observed as a
        # permanent arg-fetch hang under the chaos sweep, seed 102)
        self._peer_dial_locks: dict[str, asyncio.Lock] = {}
        self.server = rpc.Server(self._handlers(), name=f"cw-{mode}")
        self.address = ""

        if mode == WORKER:
            self._start_task_channel()
        self._connect(raylet_address, gcs_address)
        serialization.set_context(None, None)
        global_state.set_core_worker(self)

    # ------------------------------------------------------------------
    # bootstrap
    # ------------------------------------------------------------------

    def _handlers(self):
        return {
            "push_task": self.h_push_task,
            "create_actor": self.h_create_actor,
            "push_actor_task": self.h_push_actor_task,
            "get_object": self.h_get_object,
            "recover_object": self.h_recover_object,
            "add_borrow": self.h_add_borrow,
            "remove_borrow": self.h_remove_borrow,
            "exit": self.h_exit,
            "cancel_task": self.h_cancel_task,
            "ping": lambda conn, d: "pong",
        }

    def _uds_dir(self) -> str:
        return os.path.join(self.session_dir, "sock")

    def _maybe_uds(self, address: str) -> str:
        """Same-node peers dial the sibling UDS listener (rpc.prefer_uds):
        loopback TCP costs ~0.25ms more per round trip on this class of
        kernel — a fifth of a small-task RTT."""
        return rpc.prefer_uds(
            address, self._uds_dir(),
            local_ips=("127.0.0.1", self.config.node_ip_address))

    def _connect(self, raylet_address: str, gcs_address: str):
        async def setup():
            port = await self.server.start_tcp(host=self.config.bind_host,
                                               uds_dir=self._uds_dir())
            self.address = f"{self.config.node_ip_address}:{port}"
            # GCS connection survives GCS restarts: on redial, re-subscribe
            # every actor channel and resync state missed while down
            # (reference: service_based_gcs_client.h reconnection).
            async def _gcs_reconnected(conn):
                if self.mode == DRIVER:
                    await conn.call("subscribe",
                                    {"channel": "worker_logs"})
                for client in list(self.actor_clients.values()):
                    if not client.subscribed:
                        continue
                    await conn.call("subscribe", {
                        "channel": f"actor:{client.actor_id.hex()}"})
                    info = await conn.call("get_actor",
                                           {"actor_id": client.actor_id})
                    if info:
                        self._apply_actor_update(info)
                        await self._flush_actor_queue(client)

            self.gcs = rpc.ReconnectingConnection(
                self._maybe_uds(gcs_address),
                name="cw->gcs", on_reconnect=_gcs_reconnected,
                retry_timeout=self.config.gcs_reconnect_timeout_s,
                # a worker is spawned into a RUNNING cluster: a dead GCS
                # at bootstrap means the cluster is gone — die fast
                # (the raylet respawns workers if it's actually alive)
                # instead of lingering 10s as an un-registered orphan
                dial_timeout=(3.0 if self.mode == WORKER else 10.0))
            self.gcs.set_push_handler(self._on_gcs_push)
            await self.gcs.ensure_connected()
            # Duplex: the raylet sends actor-creation/kill requests back
            # over this same connection. A worker cannot function without
            # its raylet — it dies with it (reference: worker exits when
            # the raylet socket closes).
            async def _raylet_lost(conn):
                if self.mode == WORKER and not self._shutdown:
                    logger.warning("raylet connection lost; worker exiting")
                    os._exit(1)

            # Workers are spawned BY a raylet that is already listening:
            # a refused dial here means the raylet died — fail fast
            # (die) instead of retrying 10s as a bootstrap zombie that
            # outlives its whole node (drivers keep the longer budget:
            # they may race a node that is still coming up).
            self.raylet = await rpc.connect(self._maybe_uds(raylet_address),
                                            handlers=self._handlers(),
                                            on_disconnect=_raylet_lost,
                                            name="cw->raylet",
                                            timeout=(2.0
                                                     if self.mode == WORKER
                                                     else 10.0))
            reply = await self.raylet.call("register_client", {
                "kind": self.mode,
                "worker_id": self.worker_id.binary(),
                "address": self.address,
                "pid": os.getpid(),
                # the GPU ids the raylet pinned this process to at spawn
                "gpus": [int(i) for i in os.environ.get(
                    "RAY_TPU_TORCH_WORKER_GPUS", "").split(",") if i],
                "task_channel": self.task_channel_address,
            })
            self.node_id = NodeID(reply["node_id"])
            if self.mode == DRIVER:
                job = await self.gcs.call(
                    "register_job",
                    {"driver_addr": self.address,
                     "token": self.worker_id.hex()})
                self.job_id = JobID(job["job_id"])
                # Worker print()/stderr lines stream to this console
                # (reference: log_monitor.py:48).
                await self.gcs.call("subscribe",
                                    {"channel": "worker_logs"})
                self.current_task_id = TaskID.for_driver(self.job_id)

        self._io.run(setup(), timeout=30)

    # ------------------------------------------------------------------
    # reference counting
    # ------------------------------------------------------------------

    def register_ref(self, ref: ObjectRef):
        with self._lock:
            rec = self.owned.get(ref.id())
            if rec is not None:
                rec.local += 1
            else:
                b = self.borrowed.get(ref.id())
                if b is not None:
                    b["count"] += 1
                # refs neither owned nor borrowed (e.g. freshly created by
                # submit) are registered explicitly by their creators.

    def _register_owned(self, object_id: ObjectID, plasma=False) -> _OwnedRef:
        with self._lock:
            rec = self.owned.get(object_id)
            if rec is None:
                rec = self.owned[object_id] = _OwnedRef()
            rec.plasma = rec.plasma or plasma
            return rec

    def release_ref(self, object_id: ObjectID):
        if self._shutdown:
            return
        with self._lock:
            rec = self.owned.get(object_id)
            if rec is not None:
                rec.local -= 1
                if rec.total() <= 0:
                    self._delete_owned(object_id, rec)
                return
            b = self.borrowed.get(object_id)
            if b is not None:
                b["count"] -= 1
                if b["count"] <= 0:
                    self.borrowed.pop(object_id, None)
                    self.memstore.delete(object_id)
                    owner = b["owner"]
                    if owner and owner != self.address:
                        self._io.submit(self._notify_owner(
                            owner, "remove_borrow",
                            {"object_id": object_id.binary()}))

    async def _notify_owner(self, owner_addr, method, data):
        try:
            conn = await self._peer(owner_addr)
            await conn.notify(method, data)
        except Exception:
            pass

    def _delete_owned(self, object_id: ObjectID, rec: _OwnedRef):
        self.owned.pop(object_id, None)
        self.memstore.delete(object_id)
        if rec.plasma:
            self._io.submit(self._free_plasma([object_id.binary()]))

    async def _free_plasma(self, oids):
        try:
            await self.raylet.call("free_objects", {"object_ids": oids})
        except Exception:
            pass

    def serialize_ref(self, ref: ObjectRef) -> dict:
        """Called from ObjectRef.__reduce__. Pins the object until the
        receiving side registers its borrow (released on task reply or
        explicitly)."""
        object_id = ref.id()
        with self._lock:
            rec = self.owned.get(object_id)
            if rec is not None:
                rec.pins += 1
                owner = self.address
                plasma = rec.plasma
            else:
                b = self.borrowed.get(object_id)
                owner = b["owner"] if b else ref.owner_address
                plasma = ref.is_plasma()
                if b is not None and owner:
                    self._io.submit(self._notify_owner(
                        owner, "add_borrow",
                        {"object_id": object_id.binary(), "transit": True}))
        ctx = getattr(self._task_ctx, "serialized_refs", None)
        if ctx is not None:
            ctx.append(object_id)
        return {"id": object_id.binary(), "owner": owner, "plasma": plasma}

    def deserialize_ref(self, desc: dict) -> ObjectRef:
        object_id = ObjectID(desc["id"])
        owner = desc.get("owner", "")
        with self._lock:
            if object_id in self.owned:
                ref = ObjectRef(object_id, self.address,
                                self.owned[object_id].plasma)
                return ref
            b = self.borrowed.get(object_id)
            if b is None:
                self.borrowed[object_id] = {"count": 0, "owner": owner}
                if owner and owner != self.address:
                    self._io.submit(self._borrow_sync(owner, object_id))
        return ObjectRef(object_id, owner, desc.get("plasma", False))

    async def _borrow_sync(self, owner, object_id):
        try:
            conn = await self._peer(owner)
            await conn.call("add_borrow", {"object_id": object_id.binary()})
        except Exception:
            pass

    # handlers (owner side)
    async def h_add_borrow(self, conn, d):
        object_id = ObjectID(d["object_id"])
        with self._lock:
            rec = self.owned.get(object_id)
            if rec is not None:
                rec.borrows += 1
        return True

    async def h_remove_borrow(self, conn, d):
        object_id = ObjectID(d["object_id"])
        with self._lock:
            rec = self.owned.get(object_id)
            if rec is not None:
                rec.borrows -= 1
                if rec.total() <= 0:
                    self._delete_owned(object_id, rec)
        return True

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        object_id = ObjectID.for_put(self._current_task_id(),
                                     next(self._put_counter))
        header, buffers = serialization.serialize(value)
        size = serialization.total_size(header, buffers)
        rec = self._register_owned(object_id)
        if size <= self.config.max_direct_call_object_size:
            payload = b"".join([header, *[bytes(b) for b in buffers]])
            self.memstore.put(object_id, payload)
        else:
            rec.plasma = True
            try:
                self.store.put_serialized(object_id, header, buffers)
            except MemoryError:
                # store full: the raylet spills asynchronously after
                # seals — force a synchronous spill pass and retry once
                # (reference: plasma create retries after SpillObjects)
                self._io.run(self.raylet.call(
                    "spill_now", {"need_bytes": size}))
                self.store.put_serialized(object_id, header, buffers)
            self._io.run(self.raylet.call("notify_object_sealed", {
                "object_id": object_id.binary(), "size": size}))
            self.memstore.put(object_id, IN_PLASMA)
        return ObjectRef(object_id, self.address, rec.plasma)

    def get(self, refs: list[ObjectRef], timeout: float | None = None):
        deadline = time.monotonic() + timeout if timeout is not None else None
        results: list[Any] = [None] * len(refs)
        for i, ref in enumerate(refs):
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            results[i] = self._get_one(ref, remaining)
        return results

    def _get_one(self, ref: ObjectRef, timeout: float | None):
        object_id = ref.id()
        found, value, is_exc = self.memstore.get_if_ready(object_id)
        if not found:
            self._ensure_fetch(ref)
            ready = self.memstore.wait([object_id], 1, timeout)
            if object_id not in ready:
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {object_id.hex()[:12]}")
            found, value, is_exc = self.memstore.get_if_ready(object_id)
        if value is IN_PLASMA:
            return self._read_plasma(object_id, timeout,
                                     owner=ref.owner_address)
        result = serialization.deserialize(value)
        if is_exc:
            raise result
        return result

    def _read_plasma(self, object_id: ObjectID, timeout: float | None,
                     owner: str = ""):
        """Resolve a plasma-resident object, or — when the node no longer
        holds it — reconstruct it from lineage (reference:
        object_recovery_manager.h:87-103: pin existing copy → else
        re-submit the creating task)."""
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        while True:
            buf = self.store.get(object_id)
            if buf is not None:
                break
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise exc.GetTimeoutError(
                        f"timed out waiting for {object_id.hex()[:12]}")
            # Bounded probe so loss is *detected* instead of blocking
            # forever.
            probe = 2.0 if remaining is None else max(0.05, min(2.0, remaining))
            ok = self._io.run(self.raylet.call(
                "wait_object_local",
                {"object_id": object_id.binary(), "timeout": probe}))
            if ok:
                continue
            if not self._recover_object(object_id, owner):
                raise exc.ObjectLostError(object_id.hex())
            # Reconstruction resubmitted the creating task; wait for the
            # fresh value (memstore flips back to ready on task reply for
            # the owner; borrowers just keep probing).
            if object_id in self.owned:
                self.memstore.wait([object_id], 1,
                                   remaining if remaining is not None else 30.0)
        try:
            value = serialization.deserialize(buf.view)
        finally:
            # Note: zero-copy numpy views keep the mmap alive via memoryview.
            buf.close()
        if isinstance(value, exc.RayTpuError):
            raise value
        return value

    # ---- object reconstruction (reference: object_recovery_manager.h) ----

    def _recover_object(self, object_id: ObjectID, owner: str = "") -> bool:
        """Every copy of a plasma object is gone: re-execute the task that
        created it (owner-side, bounded by the task's max_retries), or ask
        the owner to if we're a borrower. Returns True if recovery is in
        flight."""
        with self._lock:
            rec = self.owned.get(object_id)
        if rec is not None:
            return self._try_reconstruct(object_id)
        if owner and owner != self.address:
            try:
                return bool(self._io.run(self._ask_owner_recover(
                    object_id, owner)))
            except Exception as e:
                logger.warning("owner %s unreachable for recovery of %s: %s",
                               owner, object_id.hex()[:12], e)
                return False
        return False

    async def _ask_owner_recover(self, object_id: ObjectID, owner: str):
        conn = await self._peer(owner)
        return await conn.call("recover_object",
                               {"object_id": object_id.binary()})

    async def h_recover_object(self, conn, d):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self._try_reconstruct, ObjectID(d["object_id"]))

    def _try_reconstruct(self, object_id: ObjectID) -> bool:
        """Re-submit the lineage task for a lost object. Idempotent while a
        reconstruction is already in flight; the whole check-then-insert is
        under the lock (a get()ing user thread and a borrower's RPC both
        race into here)."""
        with self._lock:
            rec = self.owned.get(object_id)
            lineage = rec.lineage_task if rec is not None else None
            if lineage is None:
                return False
            spec = lineage["spec"]
            task_id = spec["task_id"]
            if task_id in self.submitted:
                return True  # already reconstructing
            if lineage["retries"] <= 0:
                return False
            lineage["retries"] -= 1
            self.submitted[task_id] = {
                "spec": spec, "pinned": [],
                "retries": lineage["retries"], "cancelled": False,
            }
        logger.warning("object %s lost; reconstructing via task %s "
                       "(%d lineage retries left)", object_id.hex()[:12],
                       spec["name"], lineage["retries"])
        for i in range(spec["num_returns"]):
            rid = ObjectID.for_return(TaskID(task_id), i)
            self.memstore.reset(rid)
        self._io.submit(self._submit_async(spec))
        return True

    def _ensure_fetch(self, ref: ObjectRef):
        """Make sure something will eventually fill the memstore entry."""
        object_id = ref.id()
        with self._lock:
            if object_id in self.owned:
                return  # reply path will fill it
            b = self.borrowed.get(object_id)
            owner = (b or {}).get("owner") or ref.owner_address
        if not owner or owner == self.address:
            return
        self.memstore.open(object_id)
        self._io.submit(self._fetch_from_owner(object_id, owner))

    async def _fetch_from_owner(self, object_id: ObjectID, owner: str):
        try:
            conn = await self._peer(owner)
            reply = await conn.call("get_object",
                                    {"object_id": object_id.binary()})
            if reply["kind"] == "plasma":
                self.memstore.put(object_id, IN_PLASMA)
            else:
                self.memstore.put(object_id, reply["data"],
                                  is_exception=reply.get("err", False))
        except Exception as e:
            header, bufs = serialization.serialize(
                exc.ObjectLostError(object_id.hex()))
            payload = b"".join([header, *[bytes(b) for b in bufs]])
            logger.debug("fetch from owner %s failed: %s", owner, e)
            self.memstore.put(object_id, payload, is_exception=True)
            # A dead owner must not leak the `open`ed slot: if nothing on
            # this process tracks the ref (so no release will ever delete
            # the entry), drop it once current waiters have observed the
            # error — the grace covers sync memstore.wait()ers woken by
            # the put above; future gets re-open + re-fetch + re-fail.
            with self._lock:
                tracked = (object_id in self.owned
                           or object_id in self.borrowed)
            if not tracked:
                asyncio.get_running_loop().call_later(
                    1.0, self.memstore.delete, object_id)

    async def h_get_object(self, conn, d):
        """Owner service: long-poll for a small object's value
        (reference: core_worker.proto GetObjectStatus).

        One ready-callback registration per waiter. The previous
        implementation parked an executor THREAD per waiter, re-polling
        `memstore.wait` in 5s slices — N borrowers of a slow object cost
        N blocked threads plus a wake-per-slice churn loop. Now a result
        arriving wakes exactly one coalesced loop callback, and an owner
        dropping the entry (every ref released) fires the same callback
        so the waiter sees loss instead of hanging."""
        object_id = ObjectID(d["object_id"])
        found, value, is_exc = self.memstore.get_if_ready(object_id)
        if not found:
            with self._lock:
                known = object_id in self.owned
            if not known:
                raise exc.ObjectLostError(object_id.hex())
            loop = asyncio.get_running_loop()
            caller = rpc.loop_call_queue(loop)
            fut = loop.create_future()

            def on_ready():
                try:
                    caller.call(lambda: fut.done() or fut.set_result(None))
                except RuntimeError:
                    pass  # loop closed: the waiter is gone

            # create=False: the owner may have released the object between
            # the check and the registration — re-creating the entry would
            # leave a pending slot nothing will ever fill.
            if not self.memstore.add_ready_callback(object_id, on_ready,
                                                    create=False):
                raise exc.ObjectLostError(object_id.hex())
            try:
                await fut
            finally:
                # waiter cancelled (loop teardown, client gone) before
                # the object resolved: don't leave the callback — and
                # the future it closes over — parked in the entry
                if not fut.done():
                    self.memstore.remove_ready_callback(object_id,
                                                        on_ready)
            found, value, is_exc = self.memstore.get_if_ready(object_id)
            if not found:
                # entry deleted under the waiter: object was released
                raise exc.ObjectLostError(object_id.hex())
        if value is IN_PLASMA:
            return {"kind": "plasma"}
        return {"kind": "bytes", "data": value, "err": is_exc}

    def wait(self, refs: list[ObjectRef], num_returns=1,
             timeout: float | None = None, fetch_local=True):
        for ref in refs:
            self._ensure_fetch(ref)
        ids = [r.id() for r in refs]
        ready_ids = self.memstore.wait(ids, num_returns, timeout)
        ready, not_ready = [], []
        for ref in refs:
            if ref.id() in ready_ids and len(ready) < max(num_returns,
                                                          len(ready_ids)):
                ready.append(ref)
            else:
                not_ready.append(ref)
        # cap ready at num_returns preserving order
        if len(ready) > num_returns:
            overflow = ready[num_returns:]
            ready = ready[:num_returns]
            not_ready = overflow + not_ready
        return ready, not_ready

    # internal kv (reference: python/ray/experimental/internal_kv.py —
    # GCS-backed KV used by libraries for rendezvous/config)
    def kv_put(self, key: str, value: bytes, overwrite=True) -> bool:
        return self._io.run(self.gcs.call("kv_put", {
            "key": key, "value": value, "overwrite": overwrite}))

    def kv_get(self, key: str) -> bytes | None:
        return self._io.run(self.gcs.call("kv_get", {"key": key}))

    def kv_del(self, key: str) -> bool:
        return self._io.run(self.gcs.call("kv_del", {"key": key}))

    # ------------------------------------------------------------------
    # function registry (reference: python/ray/function_manager.py)
    # ------------------------------------------------------------------

    def export_function(self, pickled: bytes, kind="fn") -> bytes:
        fn_id = common.function_id(pickled)
        if fn_id not in self._exported:
            key = f"{kind}:{self.job_id.hex()}:{fn_id.hex()}"
            self._io.run(self.gcs.call("kv_put", {
                "key": key, "value": pickled, "overwrite": False}))
            self._exported.add(fn_id)
        return fn_id

    def fetch_function(self, fn_id: bytes, job_id: bytes, kind="fn"):
        if fn_id in self._fn_cache:
            return self._fn_cache[fn_id]
        key = f"{kind}:{JobID(job_id).hex()}:{fn_id.hex()}"
        deadline = time.monotonic() + 30
        while True:
            data = self._io.run(self.gcs.call("kv_get", {"key": key}))
            if data is not None:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"function {fn_id.hex()} never exported")
            time.sleep(0.05)
        fn = cloudpickle.loads(data)
        self._fn_cache[fn_id] = fn
        return fn

    # ------------------------------------------------------------------
    # task submission (reference: direct_task_transport.cc)
    # ------------------------------------------------------------------

    def _current_task_id(self) -> TaskID:
        # Async-actor coroutines carry their task id in a contextvar (they
        # all share the loop thread); sync tasks use the thread-local.
        return (_ASYNC_TASK_ID.get()
                or getattr(self._task_ctx, "task_id", None)
                or self.current_task_id)

    def _serialize_args(self, args, kwargs) -> tuple[list[dict], list[ObjectID]]:
        """Returns (arg descriptors, pinned object ids)."""
        if not args and not kwargs:
            return [], []
        self._task_ctx.serialized_refs = []
        descs = []
        try:
            for value in args:
                descs.append(self._serialize_one_arg(value))
            if kwargs:
                descs.append({"kind": "kwargs",
                              "data": serialization.dumps(kwargs)})
            pinned = list(self._task_ctx.serialized_refs)
        finally:
            self._task_ctx.serialized_refs = None
        return descs, pinned

    def _serialize_one_arg(self, value) -> dict:
        if isinstance(value, ObjectRef):
            desc = self.serialize_ref(value)
            return {"kind": "ref", **desc}
        data = serialization.dumps(value)
        if len(data) > self.config.max_direct_call_object_size:
            # Large pass-by-value arg: promote to a put (owner = caller).
            ref = self.put(value)
            desc = self.serialize_ref(ref)
            # keep the ref alive until pinning is recorded
            return {"kind": "ref", **desc}
        return {"kind": "inline", "data": data}

    def _make_return_refs(self, task_id: TaskID, num_returns: int):
        """Register + open a task's return set with two lock hops total
        (the per-return _register_owned/register_ref/open triple cost three
        lock round-trips EACH — pure bookkeeping churn on the serve request
        path where every query is a return slot)."""
        return_ids = [ObjectID.for_return(task_id, i)
                      for i in range(num_returns)]
        with self._lock:
            for return_id in return_ids:
                rec = self.owned.get(return_id)
                if rec is None:
                    rec = self.owned[return_id] = _OwnedRef()
                rec.local += 1
        self.memstore.open_many(return_ids)
        refs = []
        for return_id in return_ids:
            ref = ObjectRef(return_id, self.address, False, _register=False)
            ref._registered = True  # owned count bumped above
            refs.append(ref)
        return refs

    def _release_creation_pins(self, client: _ActorClient):
        pinned, client.creation_pins = client.creation_pins, []
        self._release_pins(pinned)

    def _release_pins(self, pinned: list[ObjectID]):
        with self._lock:
            for object_id in pinned:
                rec = self.owned.get(object_id)
                if rec is not None:
                    rec.pins -= 1
                    if rec.total() <= 0:
                        self._delete_owned(object_id, rec)
                    continue
                b = self.borrowed.get(object_id)
                if b is not None and b["owner"]:
                    self._io.submit(self._notify_owner(
                        b["owner"], "remove_borrow",
                        {"object_id": object_id.binary()}))

    def make_task_template(self, *, fn_id: bytes, name: str, num_returns=1,
                           resources=None, max_retries=None,
                           ) -> dict:
        """Pre-build the static prefix of a task spec (descriptor, owner
        address, quantized resources) so `fn.remote()` pays one dict copy
        per call instead of re-quantizing and re-assembling the whole spec
        (reference analog: the cached TaskSpecBuilder prefix in
        direct_task_transport). Cached per RemoteFunction."""
        return common.make_task_spec(
            task_id=b"",
            job_id=self.job_id.binary(),
            name=name,
            fn_id=fn_id,
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            args=None,
            num_returns=num_returns,
            resources=resources or {"CPU": 1},
            max_retries=(self.config.task_max_retries
                         if max_retries is None else max_retries),
        )

    def submit_task(self, *, fn_id: bytes = b"", name: str = "", args=(),
                    kwargs=None, num_returns=1, resources=None,
                    max_retries=None, template: dict | None = None,
                    placement_group: bytes | None = None,
                    bundle_index: int = -1) -> list[ObjectRef]:
        task_id = TaskID.for_task(self.job_id)
        descs, pinned = self._serialize_args(args, kwargs)
        if template is not None:
            spec = dict(template)
            spec["task_id"] = task_id.binary()
            spec["args"] = descs
            num_returns = spec["num_returns"]
        else:
            spec = common.make_task_spec(
                task_id=task_id.binary(),
                job_id=self.job_id.binary(),
                name=name,
                fn_id=fn_id,
                owner_addr=self.address,
                owner_worker_id=self.worker_id.binary(),
                args=descs,
                num_returns=num_returns,
                resources=resources or {"CPU": 1},
                max_retries=(self.config.task_max_retries
                             if max_retries is None else max_retries),
                placement_group_id=placement_group,
                bundle_index=bundle_index,
            )
        refs = self._make_return_refs(task_id, num_returns)
        self.submitted[task_id.binary()] = {
            "spec": spec, "pinned": pinned,
            "retries": spec["max_retries"], "cancelled": False,
            "t0": time.time(),
        }
        M_TASKS_SUBMITTED.inc()
        self._io.submit_nowait(self._submit_async(spec))
        return refs

    async def _submit_async(self, spec):
        key = common.scheduling_key(spec)
        rec = self.submitted.get(spec["task_id"])
        if rec is None or rec["cancelled"]:
            self._fail_task(spec, exc.TaskCancelledError(
                spec["task_id"].hex()), release=True)
            return
        pending = self._pending_by_key.setdefault(key, [])
        if not pending:
            self._pending_since[key] = time.monotonic()
        pending.append(spec)
        await self._drain_pending(key)

    def _find_lease(self, key) -> _Lease | None:
        """Least-loaded live lease with pipeline capacity — tasks fan
        across every live lease instead of filling lease 0 to the cap
        before lease 1 sees any work."""
        best = None
        for lease in self.leases.get(key, []):
            if (not lease.conn.closed
                    and lease.inflight < self.config.max_tasks_in_flight_per_worker
                    and (best is None or lease.inflight < best.inflight)):
                best = lease
        return best

    def _live_leases(self, key) -> list[_Lease]:
        return [lease for lease in self.leases.get(key, [])
                if not lease.conn.closed]

    def _maybe_request_leases(self, key):
        """Request leases ahead of demand, up to a soft target of
        ceil(outstanding work / max_tasks_in_flight_per_worker) leases
        (one lease at a time, each granted only after the previous
        grant's drain, would serialize burst ramp-up behind worker-spawn
        latency). One batched request
        RPC is outstanding per key at a time; while ≥1 lease is already
        working the request is SOFT (the raylet grants only from idle
        workers, never spawning), escalating to a hard request when the
        queue has waited past lease_escalation_s — so a burst of tiny
        tasks can't spawn-storm the node while long tasks still scale
        out (reference: direct_task_transport.h pipelined lease
        requests)."""
        if self._lease_requests.get(key, 0) > 0:
            return
        pending = self._pending_by_key.get(key)
        if not pending:
            return
        live = self._live_leases(key)
        cap = max(1, self.config.max_tasks_in_flight_per_worker)
        inflight = sum(lease.inflight for lease in live)
        target = -(-(len(pending) + inflight) // cap)  # ceil
        count = min(target - len(live), self.config.max_lease_batch)
        if count <= 0:
            return
        now = time.monotonic()
        soft = bool(live) and (now - self._pending_since.get(key, now)
                               < self.config.lease_escalation_s)
        if soft and now < self._soft_backoff.get(key, 0.0):
            return
        self._lease_requests[key] = 1
        asyncio.ensure_future(
            self._request_leases(key, pending[0], count, soft))

    async def _request_leases(self, key, spec, count: int, soft: bool):
        M_LEASE_REQUESTS.inc()
        lease_t0 = time.time()
        try:
            reply = await self.raylet.call("request_worker_lease",
                                           {"spec": spec, "count": count,
                                            "soft": soft})
            grants = reply["grants"]
            for grant in grants:
                conn = await self._peer(grant["worker_address"])
                lease = _Lease(grant["lease_id"], grant["worker_id"],
                               grant["worker_address"], conn,
                               task_conn=await self._task_channel_conn(
                                   grant.get("task_channel")))
                self.leases.setdefault(key, []).append(lease)
            if grants:
                M_LEASE_WAIT_S.observe(time.time() - lease_t0)
            if not grants:
                # soft miss: the idle pool is dry; stop re-asking for a
                # beat so the raylet isn't hammered with no-op requests.
                # The retry timer matters for liveness, not just pacing:
                # if every in-flight task is blocked (e.g. nested
                # ray.get on a producer still queued behind them), no
                # push ever completes, so no drain would re-evaluate the
                # request — and the escalation clock (lease_escalation_s
                # → hard, may-spawn request) must keep being consulted.
                self._soft_backoff[key] = time.monotonic() + 0.2
                asyncio.get_running_loop().call_later(
                    0.25, self._maybe_request_leases, key)
        except Exception as e:
            if self._live_leases(key):
                # queued work is still draining on live leases: a failed
                # PRE-WARM must not fail tasks that never needed it
                self._soft_backoff[key] = time.monotonic() + 0.5
                asyncio.get_running_loop().call_later(
                    0.6, self._maybe_request_leases, key)
            else:
                pending = self._pending_by_key.pop(key, [])
                for p in pending:
                    self._fail_task(p, exc.WorkerCrashedError(
                        f"lease request failed: {e}"), release=True)
                return
        finally:
            self._lease_requests[key] = 0
            self._ensure_lease_reaper()
        await self._drain_pending(key)

    async def _drain_pending(self, key, inline_ok=True):
        pending = self._pending_by_key.get(key, [])
        while pending:
            lease = self._find_lease(key)
            if lease is None:
                break
            spec = pending.pop(0)
            # Reserve the in-flight slot synchronously so concurrent drains
            # see correct pipelining capacity, then push without blocking
            # the drain loop (lease pipelining, reference:
            # direct_task_transport.h max_tasks_in_flight_per_worker).
            lease.inflight += 1
            if lease.inflight == 1:
                # burst boundary: pick this burst's connection by the
                # queue depth behind the task being pushed
                lease.burst_channel = len(pending) < 2
            lease.last_used = time.monotonic()
            if inline_ok and not pending:
                # SOLE task of this drain (the sync-call pattern): run the
                # push in THIS coroutine instead of spawning a Task for
                # it. Only when nothing else was popped in this drain —
                # an ensure_future'd sibling starts on the NEXT loop
                # tick, so sending inline here would invert frame order
                # within the burst. A push's own tail drain passes
                # inline_ok=False, so the await chain push→drain→push
                # can never grow beyond one level.
                await self._push_to_lease(lease, spec, key)
                pending = self._pending_by_key.get(key, [])
                continue
            inline_ok = False  # later pops must queue behind this one
            asyncio.ensure_future(self._push_to_lease(lease, spec, key))
        if not pending:
            self._pending_since.pop(key, None)
        self._maybe_request_leases(key)

    async def _task_channel_conn(self, address) -> rpc.Connection | None:
        """Dial a lease's direct task channel when its socket file
        exists."""
        if not address or not address.startswith("unix:"):
            return None
        if not os.path.exists(address[len("unix:"):]):
            return None
        conn = self._peer_conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        lock = self._peer_dial_locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._peer_conns.get(address)
            if conn is None or conn.closed:
                try:
                    conn = await rpc.connect(address,
                                             name="cw->task-channel")
                except Exception as e:
                    logger.debug("task channel dial failed (%s); rpc path",
                                 e)
                    return None
                self._cache_peer(address, conn)
        return conn

    def _note_pushed(self, rec, spec):
        """Queue-wait hop closes when the push leaves the owner."""
        now = time.time()
        t0 = rec.get("t0")
        if t0 is not None and "t_push" not in rec:
            M_QUEUE_WAIT_S.observe(now - t0)
        rec["t_push"] = now

    async def _push_to_lease(self, lease: _Lease, spec, key):
        rec = self.submitted.get(spec["task_id"])
        if rec is None or rec["cancelled"]:
            lease.inflight -= 1
            self._fail_task(spec, exc.TaskCancelledError(""), release=True)
            return
        rec["lease"] = lease
        self._note_pushed(rec, spec)
        try:
            reply = await lease.push_conn.call("push_task", {"spec": spec})
            self._handle_task_reply(spec, reply)
        except (rpc.ConnectionLost, rpc.RemoteError) as e:
            # FailpointError: an armed `rpc.send=raise` fires in OUR send
            # path — the push never left; route it through the same
            # retry/fail machinery (letting it escape would leak the
            # inflight slot and hang the caller)
            lease.inflight -= 1
            await self._handle_push_failure(spec, key, lease, e)
            return
        lease.inflight -= 1
        lease.last_used = time.monotonic()
        await self._drain_pending(key, inline_ok=False)

    def _ensure_lease_reaper(self):
        if self._lease_reaper_running or self._shutdown:
            return
        self._lease_reaper_running = True
        asyncio.ensure_future(self._lease_reaper())

    async def _lease_reaper(self):
        """ONE periodic sweep returns idle leases after a grace period —
        replacing the per-push asyncio.sleep(0.25) grace coroutine (at
        240 tasks/s that was ~60 live loop timers at any instant, each a
        wakeup). Also how pre-warmed leases that arrived after the queue
        drained get handed back, so prewarm can't strand workers. Exits
        when no leases remain; restarted on the next grant."""
        grace = self.config.lease_idle_grace_s
        try:
            while not self._shutdown:
                await asyncio.sleep(grace)
                now = time.monotonic()
                for key, leases in list(self.leases.items()):
                    busy = bool(self._pending_by_key.get(key))
                    for lease in list(leases):
                        if lease.inflight > 0 or busy:
                            continue
                        if (not lease.conn.closed
                                and now - lease.last_used < grace):
                            continue
                        if lease not in leases:
                            # removed by a concurrent push-failure
                            # handler while we awaited a return_worker
                            continue
                        leases.remove(lease)
                        try:
                            await self.raylet.call(
                                "return_worker",
                                {"lease_id": lease.lease_id,
                                 "worker_exiting": lease.conn.closed})
                        except Exception:
                            pass
                    if not leases:
                        self.leases.pop(key, None)
                if not self.leases:
                    return
        finally:
            self._lease_reaper_running = False

    async def _handle_push_failure(self, spec, key, lease, error):
        if lease in self.leases.get(key, []):
            self.leases[key].remove(lease)
            try:
                await self.raylet.call(
                    "return_worker", {"lease_id": lease.lease_id,
                                      "worker_exiting": True})
            except Exception:
                pass
        rec = self.submitted.get(spec["task_id"])
        if isinstance(error, rpc.RemoteError):
            # The worker raised outside user code (system error) — retry.
            pass
        if rec is not None and rec["retries"] > 0 and not rec["cancelled"]:
            rec["retries"] -= 1
            logger.info("retrying task %s (%d retries left)",
                        spec["name"], rec["retries"])
            await self._submit_async(spec)
        else:
            self._fail_task(spec, exc.WorkerCrashedError(
                f"task {spec['name']} failed: worker died ({error})"),
                release=True)

    def _handle_task_reply(self, spec, reply):
        task_id = spec["task_id"]
        rec = self.submitted.pop(task_id, None)
        M_TASKS_COMPLETED.inc()
        if rec is not None:
            now = time.time()
            t0 = rec.get("t0")
            if t0 is not None:
                M_E2E_S.observe(now - t0)
            t_push = rec.get("t_push")
            held_s = (reply.get("held_s", reply.get("exec_s"))
                      if isinstance(reply, dict) else None)
            if t_push is not None and held_s is not None:
                # durations only — clock-skew-free wire+loop overhead.
                # held_s (not exec_s): worker-side queueing behind other
                # in-flight pushes must not read as reply overhead.
                M_REPLY_OVERHEAD_S.observe(max(0.0, now - t_push - held_s))
        if rec is not None and rec["pinned"]:
            self._release_pins(rec["pinned"])
        # Lineage shared by all plasma returns of this task: enough to
        # re-execute it if every copy is later lost (reference:
        # object_recovery_manager.h:87-103; lineage retained while the
        # refs live, task_manager.h lineage pinning). Built lazily: the
        # common all-inline reply never needs it.
        lineage = None
        inline_puts = []
        for i, ret in enumerate(reply["returns"]):
            return_id = ObjectID.for_return(TaskID(task_id), i)
            if ret["kind"] == "inline":
                inline_puts.append((return_id, ret["data"],
                                    ret.get("err", False)))
            else:  # plasma
                if lineage is None:
                    lineage = {"spec": spec,
                               "retries": rec["retries"] if rec else 0}
                with self._lock:
                    owned = self.owned.get(return_id)
                    if owned is not None:
                        owned.plasma = True
                        # A stray duplicate reply (rec already popped) must
                        # not clobber live lineage with retries=0.
                        if rec is not None or owned.lineage_task is None:
                            owned.lineage_task = lineage
                self.memstore.put(return_id, IN_PLASMA)
        if inline_puts:
            # one lock/notify for the whole return set (a serve batch is
            # num_returns inline values landing together)
            self.memstore.put_many(inline_puts)

    def _fail_task(self, spec, error: Exception, release=False):
        task_id = spec["task_id"]
        rec = self.submitted.pop(task_id, None)
        if rec is not None and release:
            self._release_pins(rec["pinned"])
        payload = serialization.dumps(error)
        for i in range(spec["num_returns"]):
            return_id = ObjectID.for_return(TaskID(task_id), i)
            self.memstore.put(return_id, payload, is_exception=True)

    def cancel_task(self, ref: ObjectRef, force=False, recursive=True):
        task_id = ref.task_id().binary()
        rec = self.submitted.get(task_id)
        if rec is None:
            return
        rec["cancelled"] = True
        lease = rec.get("lease")

        async def _do_cancel():
            if lease is not None and not lease.conn.closed:
                try:
                    await lease.conn.call("cancel_task", {
                        "task_id": task_id, "force": force})
                except Exception:
                    pass

        self._io.submit(_do_cancel())

    # ------------------------------------------------------------------
    # actors — owner side (reference: direct_actor_transport.h:62)
    # ------------------------------------------------------------------

    def create_actor(self, *, cls_id: bytes, name: str, args, kwargs,
                     num_returns=0, resources=None, max_restarts=0,
                     max_concurrency=1, actor_name="",
                     namespace="", placement_group: bytes | None = None,
                     bundle_index: int = -1) -> bytes:
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_task(self.job_id)
        descs, pinned = self._serialize_args(args, kwargs)
        spec = common.make_task_spec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            name=name,
            fn_id=cls_id,
            task_type=common.ACTOR_CREATION_TASK,
            actor_id=actor_id.binary(),
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            args=descs,
            num_returns=0,
            resources=resources or {"CPU": 1},
            actor_creation={
                "max_restarts": max_restarts,
                "max_concurrency": max_concurrency,
                "name": actor_name,
                "namespace": namespace,
            },
            placement_group_id=placement_group,
            bundle_index=bundle_index,
        )
        client = _ActorClient(actor_id.binary())
        client.creation_pins = pinned
        self.actor_clients[actor_id.binary()] = client

        async def _register():
            try:
                info = await self.gcs.call("register_actor", {"spec": spec})
                await self._subscribe_actor(actor_id.binary())
                self._apply_actor_update(info)
                # flush calls queued while registration was in flight:
                # the ALIVE state just arrived via this REPLY — if the
                # pubsub publish was lost (GCS crash/drop between table
                # apply and publish), no push will ever flush them
                await self._flush_actor_queue(client)
            except Exception as e:
                client.state = "DEAD"
                client.death_cause = f"registration failed: {e}"
                self._release_creation_pins(client)
                await self._flush_actor_queue(client)

        self._io.submit(_register())
        return actor_id.binary()

    async def _subscribe_actor(self, actor_id: bytes):
        client = self.actor_clients.get(actor_id)
        if client is None or client.subscribed:
            return
        client.subscribed = True
        await self.gcs.call("subscribe", {"channel": f"actor:{actor_id.hex()}"})

    def publish_log(self, line: str, stream: str):
        """Worker-side: forward one output line to subscribed drivers
        (reference: log_monitor.py:48 republishing, worker stdout/stderr
        streaming to the driver console). Tagged with the job that ran the
        producing task so each driver prints only its own workers."""
        if self.gcs is None or self._shutdown:
            return
        self._io.submit(self.gcs.notify("publish", {
            "channel": "worker_logs",
            "data": {"pid": os.getpid(),
                     "worker_id": self.worker_id.binary(),
                     "job_id": getattr(self, "_exec_job_id", None),
                     "stream": stream, "line": line},
        }))

    async def _on_gcs_push(self, channel: str, data):
        if channel.startswith("pg:"):
            # placement-group transition (CREATED / INFEASIBLE / REMOVED):
            # wake every parked wait_placement_group with the record
            for fut in self._pg_waiters.get(data.get("pg_id"), []):
                if not fut.done():
                    fut.set_result(data)
        elif channel.startswith("actor:"):
            self._apply_actor_update(data)
            client = self.actor_clients.get(data["actor_id"])
            if client is not None:
                await self._flush_actor_queue(client)
        elif channel == "worker_logs" and self.mode == DRIVER:
            # Print worker output on the driver console (stderr: driver
            # stdout often carries machine-readable output). Lines from
            # other drivers' jobs are dropped.
            job = data.get("job_id")
            if job is not None and job != self.job_id.binary():
                return
            print(f"(pid={data['pid']}, {data['stream']}) {data['line']}",
                  file=sys.__stderr__)

    def _apply_actor_update(self, info):
        client = self.actor_clients.get(info["actor_id"])
        if client is None:
            client = _ActorClient(info["actor_id"])
            self.actor_clients[info["actor_id"]] = client
        client.state = info["state"]
        client.death_cause = info.get("death_cause", "")
        if info["state"] == "DEAD":
            self._release_creation_pins(client)
        if info["state"] == "ALIVE":
            client.task_channel = info.get("task_channel", "") or ""
            if client.address != info["address"]:
                client.address = info["address"]
                client.conn = None
                client.task_conn = None
                client.seq = 0  # fresh incarnation expects seq 0
        else:
            client.address = info.get("address", "") or ""
            client.conn = None
            client.task_conn = None

    def make_actor_task_template(self, actor_id: bytes, *, fn_id: bytes,
                                 name: str, method_name: str,
                                 num_returns=1) -> dict:
        """Static spec prefix for one actor method — cached per
        (handle, method) so each call pays a dict copy, not a full spec
        assembly (same trick as make_task_template)."""
        return common.make_task_spec(
            task_id=b"",
            job_id=self.job_id.binary(),
            name=name,
            fn_id=fn_id,
            task_type=common.ACTOR_TASK,
            actor_id=actor_id,
            method_name=method_name,
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            args=None,
            num_returns=num_returns,
        )

    def submit_actor_task(self, actor_id: bytes, *, fn_id: bytes = b"",
                          name: str = "", method_name: str = "",
                          args=(), kwargs=None, num_returns=1,
                          template: dict | None = None) -> list[ObjectRef]:
        task_id = TaskID.for_task(self.job_id)
        descs, pinned = self._serialize_args(args, kwargs)
        client = self.actor_clients.get(actor_id)
        if client is None:
            client = _ActorClient(actor_id)
            self.actor_clients[actor_id] = client
        if template is not None:
            spec = dict(template)
            spec["task_id"] = task_id.binary()
            spec["args"] = descs
            num_returns = spec["num_returns"]
        else:
            spec = common.make_task_spec(
                task_id=task_id.binary(),
                job_id=self.job_id.binary(),
                name=name,
                fn_id=fn_id,
                task_type=common.ACTOR_TASK,
                actor_id=actor_id,
                method_name=method_name,
                owner_addr=self.address,
                owner_worker_id=self.worker_id.binary(),
                args=descs,
                num_returns=num_returns,
            )
        refs = self._make_return_refs(task_id, num_returns)
        self.submitted[task_id.binary()] = {
            "spec": spec, "pinned": pinned, "retries": 0,
            "cancelled": False, "t0": time.time()}

        # seq_no is assigned at push time (not here) so a restarted actor —
        # whose reorder buffer starts from 0 again — sees a contiguous
        # sequence (reference: direct_actor_transport resend/reset
        # semantics). The append happens on the CALLER thread (GIL-atomic)
        # and a single flush coroutine is scheduled per burst: N rapid
        # submits cost one io-loop wakeup, not N (the wakeup write was the
        # top cost in the actor-call microbenchmark).
        client.queued.append((spec, pinned))
        if not client.flush_scheduled:
            client.flush_scheduled = True
            self._io.submit_nowait(self._submit_flush(client))
        return refs

    async def _submit_flush(self, client: _ActorClient):
        client.flush_scheduled = False  # appends after this get this flush
        await self._ensure_actor_ready(client)
        await self._flush_actor_queue(client)

    async def _ensure_actor_ready(self, client: _ActorClient):
        if client.state == "ALIVE" and client.address:
            return
        if not client.subscribed:
            await self._subscribe_actor(client.actor_id)
            info = await self.gcs.call("get_actor",
                                       {"actor_id": client.actor_id})
            if info is not None:
                self._apply_actor_update(info)

    async def _flush_actor_queue(self, client: _ActorClient):
        if client.state == "DEAD":
            for spec, pinned in client.queued:
                self._fail_task(spec, exc.ActorDiedError(
                    client.actor_id.hex(), client.death_cause), release=True)
            client.queued.clear()
            return
        if client.state != "ALIVE" or not client.address:
            # Pubsub is the fast path, but a LOST publish (GCS dying
            # between table apply and publish, a dropped subscriber conn)
            # must not wedge the queued calls forever — poll as backstop.
            self._schedule_actor_poll(client)
            return  # wait for pubsub update (or the poll)
        if client.conn is None or client.conn.closed:
            try:
                # NOT fresh: a live cached peer conn is shareable (actor
                # ordering comes from the seq/epoch reorder lanes, not
                # the conn), and a fresh dial would close() the cached
                # conn under whoever else is using it (_cache_peer)
                client.conn = await self._peer(client.address)
            except Exception:
                # undialable while believed-ALIVE (worker died, DEAD
                # publish possibly lost): the poll re-queries the GCS
                # and re-drives this flush — without it nothing would
                self._schedule_actor_poll(client)
                return
            client.task_conn = None
        if client.task_conn is None and client.task_channel:
            client.task_conn = await self._task_channel_conn(
                client.task_channel)
        # swap-drain: pop(0) per task is O(n²) on a deep queue, and the
        # queue can only grow behind this loop from the caller thread
        # (GIL-atomic append) — those appends get the next flush
        queued, client.queued = client.queued, []
        if queued and client.inflight == 0:
            # burst boundary (same rule as _Lease.push_conn): pick ONE
            # conn for the whole burst — actor calls are seq-ordered by
            # the reorder buffer either way, but a single FIFO conn keeps
            # arrival order matching seq order (no buffer stalls)
            client.burst_channel = len(queued) < 2
        for spec, pinned in queued:
            spec["seq_no"] = client.seq
            spec["caller_epoch"] = client.epoch
            client.seq += 1
            asyncio.ensure_future(self._push_actor_task(client, spec))

    def _schedule_actor_poll(self, client: _ActorClient):
        """Bounded (1/s, one in flight per actor) get_actor poll while
        calls are queued on an unresolved actor state: recovers from a
        lost ALIVE/DEAD publish instead of hanging the callers. Re-armed
        by _flush_actor_queue until the state resolves or the queue
        drains."""
        if client.poll_scheduled or not client.queued or self._shutdown:
            return
        client.poll_scheduled = True

        async def _poll():
            await asyncio.sleep(1.0)
            client.poll_scheduled = False
            if self._shutdown or not client.queued:
                return
            # ALWAYS re-query: a believed-ALIVE state can be stale (the
            # worker died and the DEAD publish was lost) — re-flushing
            # against a stale address alone would dial-fail forever
            try:
                info = await self.gcs.call("get_actor",
                                           {"actor_id": client.actor_id})
            except rpc.ConnectionGaveUp as e:
                # the control plane is PERMANENTLY gone: a 1/s poll
                # forever would hang the queued calls — fail them typed
                for spec, _pinned in client.queued:
                    self._fail_task(spec, exc.ActorDiedError(
                        ActorID(client.actor_id).hex(),
                        f"control plane unreachable: {e}"), release=True)
                client.queued.clear()
                return
            except Exception:
                info = None
            if info is not None:
                self._apply_actor_update(info)
            await self._flush_actor_queue(client)

        asyncio.ensure_future(_poll())

    async def _push_actor_task(self, client: _ActorClient, spec):
        # same hybrid as _Lease.push_conn: channel for shallow bursts,
        # rpc conn for deep ones (reply IO overlaps execution there);
        # sticky per burst so arrival order matches seq order
        conn = client.task_conn
        client.inflight += 1
        if conn is None or conn.closed or not client.burst_channel:
            conn = client.conn
        rec = self.submitted.get(spec["task_id"])
        if rec is not None:
            self._note_pushed(rec, spec)
        try:
            if conn is None or conn.closed:
                # a sibling push's failure handler nulled the conns (the
                # epoch bump) before this scheduled push first ran: take
                # the same typed failure path, never an AttributeError
                # that would leak the inflight slot and hang the caller
                raise rpc.ConnectionLost(
                    "actor connection lost before push")
            reply = await conn.call("push_actor_task", {"spec": spec})
            client.inflight -= 1
            self._handle_task_reply(spec, reply)
        except (rpc.ConnectionLost, rpc.RemoteError) as e:
            client.inflight -= 1
            if isinstance(e, rpc.RemoteError) and isinstance(
                    e.exc, exc.TaskCancelledError):
                self._fail_task(spec, e.exc, release=True)
                return
            if (isinstance(e, rpc.ConnectionLost)
                    and spec.get("caller_epoch", 0) == client.epoch):
                # First failure of this epoch: the connection died with
                # seq numbers possibly undelivered, so the worker's
                # reorder lane may hold a hole forever. Open a fresh
                # (epoch, seq=0) lane — one bump per loss event (sibling
                # in-flight failures carry the old epoch and skip this)
                # — and drop the conns so the flush redials.
                client.epoch += 1
                client.seq = 0
                client.conn = None
                client.task_conn = None
            # Connection lost mid-flight: the task may or may not have run —
            # fail it (reference default: max_task_retries=0; in-flight
            # tasks get RayActorError on actor death). Tasks still queued
            # owner-side are preserved for the next incarnation.
            try:
                info = await self.gcs.call("get_actor",
                                           {"actor_id": client.actor_id})
                if info is not None:
                    self._apply_actor_update(info)
            except Exception:
                # GCS itself unreachable (shutdown teardown) — nothing to
                # learn; fall through and fail the task locally.
                pass
            self._fail_task(spec, exc.ActorDiedError(
                client.actor_id.hex(),
                client.death_cause or f"task in flight when actor died ({e})"),
                release=True)
            await self._flush_actor_queue(client)

    def kill_actor(self, actor_id: bytes, no_restart=True):
        self._io.run(self.gcs.call("kill_actor", {
            "actor_id": actor_id, "no_restart": no_restart}))

    def get_named_actor(self, name: str, namespace: str = ""):
        return self._io.run(self.gcs.call("get_named_actor", {
            "name": name, "namespace": namespace or "default"}))

    def get_actor_info(self, actor_id: bytes):
        return self._io.run(self.gcs.call("get_actor", {"actor_id": actor_id}))

    # ------------------------------------------------------------------
    # placement groups (reference: core_worker.cc:1524 CreatePlacementGroup)
    # ------------------------------------------------------------------

    def create_placement_group(self, pg_id: bytes, bundles, strategy,
                               name=""):
        # quantized at the boundary, as task-spec resources
        return self._io.run(self.gcs.call("create_placement_group", {
            "pg_id": pg_id,
            "bundles": [{"resources": common.ResourceSet(dict(b)).raw()}
                        for b in bundles],
            "strategy": strategy,
            "name": name,
        }))

    def remove_placement_group(self, pg_id: bytes):
        return self._io.run(self.gcs.call("remove_placement_group",
                                          {"pg_id": pg_id}))

    def get_placement_group(self, pg_id: bytes):
        return self._io.run(self.gcs.call("get_placement_group",
                                          {"pg_id": pg_id}))

    def wait_placement_group(self, pg_id: bytes,
                             timeout: float | None = None):
        """Park until the placement group is CREATED or INFEASIBLE, woken
        by the GCS's `pg:<hex>` publish (its payload is the whole record),
        with a slow re-poll (0.1 s doubling to 1 s) behind it. Returns the
        record, None if `timeout` elapsed first; ValueError if the group
        was removed."""
        async def _wait():
            channel = f"pg:{pg_id.hex()}"
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()
            self._pg_waiters.setdefault(pg_id, []).append(fut)
            await self.gcs.call("subscribe", {"channel": channel})
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            poll = 0.1
            try:
                # the subscription may have raced the transition: read
                # once up front
                info = await self.gcs.call("get_placement_group",
                                           {"pg_id": pg_id})
                while True:
                    if info is None or info.get("state") == "REMOVED":
                        raise ValueError(
                            f"placement group {pg_id.hex()} was removed")
                    if info.get("state") in ("CREATED", "INFEASIBLE"):
                        return info
                    remaining = poll
                    if deadline is not None:
                        remaining = min(remaining,
                                        deadline - time.monotonic())
                        if remaining <= 0:
                            return None
                    try:
                        info = await asyncio.wait_for(asyncio.shield(fut),
                                                      remaining)
                    except asyncio.TimeoutError:
                        poll = min(poll * 2, 1.0)
                        info = await self.gcs.call("get_placement_group",
                                                   {"pg_id": pg_id})
                        continue
                    # consumed: re-arm with a fresh future
                    waiters = self._pg_waiters.get(pg_id, [])
                    if fut in waiters:
                        waiters.remove(fut)
                    fut = loop.create_future()
                    self._pg_waiters.setdefault(pg_id, []).append(fut)
            finally:
                waiters = self._pg_waiters.get(pg_id)
                if waiters is not None:
                    if fut in waiters:
                        waiters.remove(fut)
                    if not waiters:
                        self._pg_waiters.pop(pg_id, None)
                        try:
                            await self.gcs.call("unsubscribe",
                                                {"channel": channel})
                        except Exception:
                            pass

        return self._io.run(_wait())

    def get_named_placement_group(self, name: str):
        return self._io.run(self.gcs.call("get_named_placement_group",
                                          {"name": name}))

    def list_placement_groups(self):
        return self._io.run(self.gcs.call("list_placement_groups", {}))

    # ------------------------------------------------------------------
    # execution side (worker mode; reference: core_worker.cc ExecuteTask +
    # _raylet.pyx:347 execute_task)
    # ------------------------------------------------------------------

    def h_push_task(self, conn, d, msgid):
        """Deferred-reply push: no asyncio future/task per pushed task —
        the dispatcher thread completes the RPC straight through the
        connection loop's coalesced call queue (rpc.deferred)."""
        self._dispatch_exec(
            d["spec"],
            lambda reply: conn.reply_deferred(msgid, "push_task", reply))

    h_push_task._rpc_deferred = True

    async def h_create_actor(self, conn, d):
        return await self._enqueue_exec(d["spec"])

    def _actor_push_common(self, spec, complete):
        """Per-caller seq reorder, then hand to the single execution lane
        (the dispatcher queue — actor tasks must serialize regardless of
        which connection delivered them). Safe from the io loop AND from
        a task-channel thread: reorder state is per-caller and each
        caller pushes over exactly one path."""
        spec.setdefault("_arrived", time.time())
        caller = spec["owner_worker_id"]
        epoch = spec.get("caller_epoch", 0)
        state = self._actor_reorder.get(caller)
        if state is None or state.get("epoch", 0) < epoch:
            # new caller, or the caller reopened its lane after a
            # connection loss (its old seq numbers may have died with
            # the conn — waiting for them would wedge the lane forever)
            if state is not None:
                # entries buffered behind the lost seq still owe their
                # (possibly live rpc-conn) callers a reply — error them
                # rather than dropping the completions on the floor
                for old_spec, old_complete in state["buffer"].values():
                    try:
                        old_complete(self._pack_error(
                            old_spec, exc.ActorUnavailableError(
                                "superseded by a newer connection epoch")))
                    except Exception:
                        pass
            state = self._actor_reorder[caller] = {
                "next": 0, "buffer": {}, "epoch": epoch}
        elif state.get("epoch", 0) > epoch:
            # straggler from a pre-loss epoch (the owner already failed
            # it as ActorDied): don't poison the fresh lane with it
            complete(self._pack_error(spec, exc.ActorUnavailableError(
                "stale actor push from a superseded connection epoch")))
            return
        state["buffer"][spec["seq_no"]] = (spec, complete)
        while state["next"] in state["buffer"]:
            next_spec, next_complete = state["buffer"].pop(state["next"])
            state["next"] += 1
            self._dispatch_exec(next_spec, next_complete)

    def h_push_actor_task(self, conn, d, msgid):
        self._actor_push_common(
            d["spec"],
            lambda reply, m=msgid, c=conn: c.reply_deferred(
                m, "push_actor_task", reply))

    h_push_actor_task._rpc_deferred = True

    async def _enqueue_exec(self, spec):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._dispatch_exec(spec, self._fut_completer(fut, loop))
        return await fut

    def _fut_completer(self, fut, loop):
        def complete(reply):
            self._deliver_reply(reply, fut, loop)

        return complete

    def _dispatch_exec(self, spec, complete):
        # Worker-side arrival stamp (_exec_scope pops it): held_s in the
        # reply spans arrival -> reply built, so the owner's reply-
        # overhead histogram excludes dispatcher/arg-wait queueing even
        # with many pushes in flight on one lease.
        spec.setdefault("_arrived", time.time())
        if spec["type"] == common.NORMAL_TASK:
            # Resolve ref args BEFORE entering the execution lane
            # (reference: dependencies are made local before dispatch).
            # Blocking the single dispatcher inside _resolve_args used to
            # rely on producers always arriving before consumers — true
            # on one FIFO connection, NOT true now that pushes ride two
            # conns (rpc + direct channel): a consumer that started first
            # would deadlock against its producer queued behind it.
            self._dispatch_when_args_ready(spec, complete)
            return
        # actor tasks keep strict seq order even when args are pending
        M_EXEC_HOPS.inc()
        self._exec_queue.put((spec, complete))

    def _dispatch_when_args_ready(self, spec, complete):
        waiting = []
        for desc in spec["args"]:
            if desc.get("kind") != "ref":
                continue
            object_id = ObjectID(desc["id"])
            found, _, _ = self.memstore.get_if_ready(object_id)
            if not found:
                waiting.append((object_id, desc))
        if not waiting:
            M_EXEC_HOPS.inc()
            self._exec_queue.put((spec, complete))
            return
        state = {"remaining": len(waiting)}
        state_lock = threading.Lock()
        # deserialize_ref registers the borrow and _ensure_fetch starts
        # the owner fetch; the refs are kept alive by the callback
        # closures until every arg is ready (release then rides GC —
        # _resolve_args re-registers its own refs during execution)
        refs = [self.deserialize_ref(desc) for _, desc in waiting]

        def on_ready(refs=refs):
            with state_lock:
                state["remaining"] -= 1
                if state["remaining"]:
                    return
            M_EXEC_HOPS.inc()
            self._exec_queue.put((spec, complete))

        for (object_id, _desc), ref in zip(waiting, refs):
            self._ensure_fetch(ref)
            self.memstore.add_ready_callback(object_id, on_ready)

    # ---- direct task channel (same-node fast path) -------------------

    def _start_task_channel(self):
        """Blocking UDS endpoint for plain-task pushes where the serving
        thread IS the executor. The worker-side round trip becomes
        kernel-wake → execute → sendall: zero asyncio machinery, zero
        thread handoffs (the rpc-loop path pays a dispatcher futex hop
        plus a coalesced loop wakeup per reply). Speaks the normal frame
        protocol, so the owner dials it with a stock rpc.Connection; it
        carries ONLY push_task/ping — actor tasks (reorder + concurrency
        routing) and every control message stay on the rpc connection."""
        import socket as socket_mod

        uds_dir = self._uds_dir()
        os.makedirs(uds_dir, exist_ok=True)
        path = os.path.join(uds_dir, f"task-{self.worker_id.hex()[:16]}.sock")
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        listener = socket_mod.socket(socket_mod.AF_UNIX,
                                     socket_mod.SOCK_STREAM)
        try:
            listener.bind(path)
        except OSError as e:
            logger.warning("task channel disabled (%s)", e)
            return
        listener.listen(8)
        self.task_channel_address = "unix:" + path
        threading.Thread(target=self._task_channel_accept, args=(listener,),
                         name="task-channel", daemon=True).start()

    def _task_channel_accept(self, listener):
        while not self._shutdown:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_task_channel, args=(sock,),
                             name="task-channel-serve", daemon=True).start()

    def _serve_task_channel(self, sock):
        import pickle
        import struct as struct_mod

        import msgpack

        from ray_tpu_torch._private import rpc as rpc_mod

        send_lock = threading.Lock()

        def recv_exact(n):
            buf = bytearray()
            while len(buf) < n:
                chunk = sock.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("task channel closed")
                buf.extend(chunk)
            return bytes(buf)

        def send_msg(msg):
            data = rpc_mod._pack(msg)
            try:
                with send_lock:
                    sock.sendall(data)
            except OSError:
                # A reply that cannot be delivered must not strand the
                # owner on a half-dead channel: shutdown() THEN close —
                # plain close() with the serve thread concurrently
                # blocked in recv() on the same fd defers the real close
                # (no FIN reaches the owner, observed on gVisor), which
                # left in-flight pushes hanging on a reply that will
                # never come. shutdown() sends the FIN immediately, so
                # the owner gets ConnectionLost and fails over.
                import socket as socket_mod

                try:
                    sock.shutdown(socket_mod.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                raise

        try:
            while not self._shutdown:
                (length,) = struct_mod.unpack(">I", recv_exact(4))
                msg = msgpack.unpackb(recv_exact(length), raw=False)
                _msgtype, msgid, method, data = msg
                if method == "ping":
                    send_msg([rpc_mod.REPLY_OK, msgid, method, "pong"])
                    continue
                if method == "push_actor_task":
                    # actor tasks reorder, then ride the single execution
                    # lane; only the reply skips the asyncio machinery
                    def complete(reply, m=msgid):
                        try:
                            send_msg([rpc_mod.REPLY_OK, m,
                                      "push_actor_task", reply])
                        except OSError:
                            pass

                    self._actor_push_common(data["spec"], complete)
                    continue
                if method != "push_task":
                    err = rpc_mod.RpcError(
                        f"task channel carries push_task/push_actor_task "
                        f"only, not {method!r}")
                    send_msg([rpc_mod.REPLY_ERR, msgid, method,
                              [pickle.dumps(err), ""]])
                    continue
                spec = data["spec"]
                if spec["task_id"] in self._cancelled_tasks:
                    self._cancelled_tasks.discard(spec["task_id"])
                    reply = self._pack_error(spec, exc.TaskCancelledError(
                        spec["task_id"].hex()))
                    if msgid is not None:
                        send_msg([rpc_mod.REPLY_OK, msgid, "push_task",
                                  reply])
                    continue

                # Hand to the dispatcher queue rather than executing on
                # this thread: pushed-but-not-started tasks stay visible
                # to h_cancel_task's queue scan, and execution keeps its
                # single lane. Only the reply bypasses asyncio (direct
                # sendall from the completing thread).
                def complete_task(reply, m=msgid):
                    if m is None:
                        return
                    try:
                        send_msg([rpc_mod.REPLY_OK, m, "push_task", reply])
                    except OSError:
                        pass

                self._dispatch_exec(spec, complete_task)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def run_task_execution_loop(self):
        """Main loop of worker processes (reference:
        CoreWorkerProcess::RunTaskExecutionLoop, core_worker.h:193).

        The dispatcher thread pops tasks in arrival order (so actor tasks
        *start* in order) but does not necessarily run them itself:
        coroutine methods are scheduled onto the actor's asyncio loop and
        interleave (reference: asyncio actors, _raylet.pyx:377-424), and
        when the actor declared max_concurrency>1, sync methods run on a
        thread pool (reference: fiber.h:30-45)."""
        while not self._shutdown:
            try:
                item = self._exec_queue.get(timeout=0.1)
            except queue_mod.Empty:
                continue
            spec, complete = item
            if spec["task_id"] in self._cancelled_tasks:
                self._cancelled_tasks.discard(spec["task_id"])
                complete(self._pack_error(spec, exc.TaskCancelledError(
                    spec["task_id"].hex())))
                continue
            try:
                if not self._dispatch_concurrent(spec, complete):
                    complete(self._execute_task(spec))
            except BaseException as e:
                # The dispatcher is the worker's single execution lane; it
                # must never die with a reply still owed (a deferred-reply
                # push whose completing thread vanished would hang its
                # caller FOREVER — no timeout fires on a live connection).
                # Error the request first, then fail-stop on fatal errors
                # so the owner's next recourse is ConnectionLost -> retry,
                # never a half-alive worker that accepts-and-drops tasks.
                try:
                    complete(self._pack_error(spec, exc.TaskError(
                        type(e).__name__, repr(e),
                        traceback.format_exc())))
                except Exception:
                    pass
                if not isinstance(e, Exception):
                    # SystemExit/KeyboardInterrupt from task code
                    logger.error("dispatcher hit fatal %r; worker "
                                 "fail-stops", e)
                    os._exit(1)

    def _deliver_reply(self, reply, fut, loop):
        """Resolve a push handler's future from the dispatcher thread.
        Delivery rides the loop's coalesced call queue: a burst of task
        completions costs one self-pipe wakeup, not one syscall per reply
        (call_soon_threadsafe writes the pipe every call)."""
        if loop.is_closed():
            return

        def _set(f=fut, r=reply):
            f.done() or f.set_result(r)

        try:
            rpc.loop_call_queue(loop).call(_set)
        except RuntimeError:
            pass  # loop closed under us: nobody is waiting for the reply

    def _dispatch_concurrent(self, spec, complete) -> bool:
        """Route an actor task to the async loop or the thread pool.
        Returns False if the task should run inline on the dispatcher."""
        if spec["type"] != common.ACTOR_TASK or self._actor_instance is None:
            return False
        import inspect

        method = getattr(self._actor_instance, spec["method_name"], None)
        if inspect.iscoroutinefunction(method):
            if self._async_loop is None:
                self._async_loop = rpc.EventLoopThread(name="actor-async")
            # Resolve args on the dispatcher thread: _resolve_args may block
            # on remote refs, and blocking the actor's event loop would
            # freeze every interleaved coroutine (and deadlock if the ref
            # is produced by this very actor).
            try:
                args, kwargs = self._resolve_args(spec["args"])
            except BaseException as e:
                complete(self._pack_error(spec, exc.TaskError(
                    type(e).__name__, repr(e), traceback.format_exc())))
                return True
            cfut = self._async_loop.submit(
                self._execute_coro_task(spec, method, args, kwargs))

            def _done(cf, spec=spec, complete=complete):
                try:
                    reply = cf.result()
                except BaseException as e:
                    # Cancelled loop / SystemExit from the method: still
                    # resolve the caller's future instead of hanging it.
                    reply = self._pack_error(spec, exc.TaskError(
                        type(e).__name__, repr(e), ""))
                complete(reply)

            cfut.add_done_callback(_done)
            return True
        if self._exec_pool is not None:
            self._exec_pool.submit(
                lambda: complete(self._execute_task(spec)))
            return True
        return False

    async def _execute_coro_task(self, spec, method, args, kwargs):
        """Async-actor path: await the coroutine method on the actor's
        event loop so concurrent calls interleave at await points.

        The current task id lives in a contextvar (not the thread-local
        _task_ctx): every interleaved coroutine shares the loop thread, and
        asyncio gives each scheduled coroutine its own context copy, so
        puts/nested submits inside the method attribute to the right task.
        """
        token = _ASYNC_TASK_ID.set(TaskID(spec["task_id"]))
        try:
            with self._exec_scope(spec) as scope:
                try:
                    result = await method(*args, **kwargs)
                    reply = self._pack_returns(spec, result)
                except BaseException as e:
                    if isinstance(e, (SystemExit, KeyboardInterrupt)):
                        raise
                    if (isinstance(e, exc.RayTpuError)
                            and not isinstance(e, exc.GetTimeoutError)):
                        # typed runtime errors cross the task boundary
                        # untranslated (same contract as the sync path)
                        reply = self._pack_error(spec, e)
                    else:
                        error = exc.TaskError(type(e).__name__, repr(e),
                                              traceback.format_exc())
                        reply = self._pack_error(spec, error)
        finally:
            _ASYNC_TASK_ID.reset(token)
            self._cancelled_tasks.discard(spec["task_id"])
        reply["exec_s"] = scope["exec_s"]
        reply["held_s"] = scope["held_s"]
        return reply

    @contextlib.contextmanager
    def _exec_scope(self, spec):
        """Timing shared by the sync and async execution paths. Fills
        scope["exec_s"] (user code only) and scope["held_s"] (worker
        arrival -> reply built, one clock — what the owner subtracts
        from the push round trip so dispatcher queueing under pipelined
        pushes never counts as reply-wire overhead)."""
        arrived = spec.pop("_arrived", None)
        start = time.time()
        scope = {}
        try:
            yield scope
        finally:
            end = time.time()
            M_EXEC_S.observe(end - start)
            scope["exec_s"] = end - start
            scope["held_s"] = end - (arrived if arrived is not None
                                     else start)

    def _execute_task(self, spec) -> dict:
        with self._exec_scope(spec) as scope:
            reply = self._execute_task_inner(spec)
        if isinstance(reply, dict):
            # lets the owner derive the reply-hop overhead from the push
            # round trip without comparing cross-process clocks
            reply["exec_s"] = scope["exec_s"]
            reply["held_s"] = scope["held_s"]
        # a cancel that raced this execution leaves a marker nothing else
        # will ever consume — drop it so the set stays bounded
        self._cancelled_tasks.discard(spec["task_id"])
        M_TASKS_EXECUTED.inc()
        return reply

    def _execute_task_inner(self, spec) -> dict:
        task_id = TaskID(spec["task_id"])
        self._task_ctx.task_id = task_id
        # Sticky (not reset in finally): output from background threads the
        # task spawned is still attributed to the last job this worker ran.
        self._exec_job_id = spec.get("job_id")
        self._cancel_flag = False
        try:
            args, kwargs = self._resolve_args(spec["args"])
            if spec["type"] == common.ACTOR_CREATION_TASK:
                cls = self.fetch_function(spec["fn_id"], spec["job_id"],
                                          kind="cls")
                self._actor_instance = cls(*args, **kwargs)
                self._actor_id = ActorID(spec["actor_id"])
                creation = spec.get("actor_creation") or {}
                if creation.get("max_concurrency", 1) > 1:
                    self._exec_pool = concurrent.futures.ThreadPoolExecutor(
                        max_workers=creation["max_concurrency"])
                return {"returns": []}
            elif spec["type"] == common.ACTOR_TASK:
                method = getattr(self._actor_instance, spec["method_name"])
                result = self._run_callable(method, args, kwargs)
            else:
                fn = self.fetch_function(spec["fn_id"], spec["job_id"])
                result = self._run_callable(fn, args, kwargs)
            return self._pack_returns(spec, result)
        except exc.TaskCancelledError:
            raise
        except BaseException as e:
            if isinstance(e, (SystemExit, KeyboardInterrupt)):
                raise
            if (isinstance(e, exc.RayTpuError)
                    and not isinstance(e, exc.GetTimeoutError)):
                # Typed runtime errors (ObjectLostError surfaced by an
                # arg fetch, ReplicaGroupDied raised by a serve group
                # leader, ...) propagate AS THEMSELVES — wrapping them in
                # TaskError would strip the type the caller's retry/
                # degradation logic dispatches on (reference: RayError
                # subclasses cross the task boundary untranslated).
                # GetTimeoutError stays wrapped: a remote task's internal
                # get timeout must not masquerade as the CALLER's own
                # get() timing out (the chaos harness reads that as a
                # hang).
                return self._pack_error(spec, e)
            error = exc.TaskError(type(e).__name__, repr(e),
                                  traceback.format_exc())
            return self._pack_error(spec, error)
        finally:
            self._task_ctx.task_id = None

    def _run_callable(self, fn, args, kwargs):
        import inspect

        if inspect.iscoroutinefunction(fn):
            if self._async_loop is None:
                self._async_loop = rpc.EventLoopThread(name="actor-async")
            return self._async_loop.run(fn(*args, **kwargs))
        return fn(*args, **kwargs)

    def _resolve_args(self, descs):
        args = []
        kwargs = {}
        for desc in descs:
            if desc["kind"] == "inline":
                args.append(serialization.loads(desc["data"]))
            elif desc["kind"] == "kwargs":
                kwargs = serialization.loads(desc["data"])
            else:  # ref
                ref = self.deserialize_ref(desc)
                args.append(self._get_one(ref, timeout=None))
        return args, kwargs

    def _pack_returns(self, spec, result) -> dict:
        num_returns = spec["num_returns"]
        if num_returns == 0:
            return {"returns": []}
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(values)} values")
        returns = []
        for i, value in enumerate(values):
            return_id = ObjectID.for_return(TaskID(spec["task_id"]), i)
            header, buffers = serialization.serialize(value)
            size = serialization.total_size(header, buffers)
            if size <= self.config.max_direct_call_object_size:
                payload = b"".join([header, *[bytes(b) for b in buffers]])
                returns.append({"kind": "inline", "data": payload,
                                "err": False})
            else:
                self.store.put_serialized(return_id, header, buffers)
                self._io.run(self.raylet.call("notify_object_sealed", {
                    "object_id": return_id.binary(), "size": size}))
                returns.append({"kind": "plasma", "size": size})
        return {"returns": returns}

    def _pack_error(self, spec, error) -> dict:
        payload = serialization.dumps(error)
        return {"returns": [
            {"kind": "inline", "data": payload, "err": True}
            for _ in range(max(spec["num_returns"], 1))
        ], "error_repr": str(error)}

    async def h_exit(self, conn, d):
        self._exiting = True
        self._shutdown = True

        def _die():
            time.sleep(0.1)
            os._exit(0)

        threading.Thread(target=_die, daemon=True).start()
        return True

    async def h_cancel_task(self, conn, d):
        # Best-effort: only tasks still queued (not yet executing) can be
        # cancelled without force; force interrupts the dispatcher thread.
        # Tasks queued in the direct task channel's socket buffer are
        # caught by this marker when their frame is read. Bounded: a
        # marker for an already-finished task is never consumed, so cap
        # the set (dropping an arbitrary stale marker only downgrades a
        # best-effort cancel to a no-op).
        if len(self._cancelled_tasks) >= 4096:
            self._cancelled_tasks.pop()
        self._cancelled_tasks.add(d["task_id"])
        cancelled = []
        drained = []
        while True:
            try:
                item = self._exec_queue.get_nowait()
            except queue_mod.Empty:
                break
            spec, complete = item
            if spec["task_id"] == d["task_id"]:
                err = exc.TaskCancelledError(spec["task_id"].hex())
                complete(self._pack_error(spec, err))
                cancelled.append(spec["task_id"])
                self._cancelled_tasks.discard(spec["task_id"])
            else:
                drained.append(item)
        for item in drained:
            self._exec_queue.put(item)
        return bool(cancelled)

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------

    async def _peer(self, address: str) -> rpc.Connection:
        conn = self._peer_conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        lock = self._peer_dial_locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._peer_conns.get(address)
            if conn is not None and not conn.closed:
                return conn
            conn = await rpc.connect(self._maybe_uds(address),
                                     handlers=self._handlers(),
                                     name=f"cw->{address}")
            self._cache_peer(address, conn)
        return conn

    def _cache_peer(self, address: str, conn: rpc.Connection) -> None:
        """Install a freshly dialed peer conn, CLOSING any live one it
        replaces: a silently dropped connection strands its in-flight
        calls in a GC-able island (they never resume), while close()
        errors them with ConnectionLost so every waiter takes a typed
        failure path."""
        old = self._peer_conns.get(address)
        self._peer_conns[address] = conn
        if old is not None and old is not conn and not old.closed:
            asyncio.ensure_future(old.close())

    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        """Future resolving to the object, WITHOUT a parked thread per
        call: a memstore ready-callback resolves small results inline
        (reference analog: memory_store GetAsync), and only IN_PLASMA
        values — which may restore or reconstruct — hop to a small shared
        pool. A thread-per-call here capped serve HTTP at ~1k qps."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        object_id = ref.id()

        def deliver(result=None, exception=None):
            # the caller may have cancelled (e.g. aiohttp killing a
            # handler task on client disconnect) — never raise back into
            # the putter's callback loop
            if fut.cancelled():
                return
            try:
                if exception is not None:
                    fut.set_exception(exception)
                else:
                    fut.set_result(result)
            except concurrent.futures.InvalidStateError:
                pass

        def resolve_blocking():
            try:
                deliver(self._get_one(ref, None))
            except BaseException as e:
                deliver(exception=e)

        def on_ready():
            found, value, is_exc = self.memstore.get_if_ready(object_id)
            if not found or value is IN_PLASMA:
                # raced a reset(), or plasma-resident: the restore
                # can block for seconds — a dedicated thread (the old
                # per-call design) avoids head-of-line blocking behind
                # other slow resolutions
                threading.Thread(target=resolve_blocking,
                                 daemon=True).start()
                return
            try:
                result = serialization.deserialize(value)
            except BaseException as e:
                deliver(exception=e)
                return
            if is_exc:
                deliver(exception=result)
            else:
                deliver(result)

        self._ensure_fetch(ref)
        self.memstore.add_ready_callback(object_id, on_ready)
        return fut

    def resolve_async(self, ref: ObjectRef) -> asyncio.Future:
        """Asyncio-native get: an asyncio.Future on the CALLING loop that
        resolves to the value. Unlike `as_future` + `wrap_future` (a
        concurrent.Future plus one call_soon_threadsafe per ref), delivery
        rides the loop's coalesced call queue — a task reply carrying N
        awaited results costs one loop wakeup, not N. This is what
        `await ref` uses under an event loop (the serve proxy hot path)."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        caller = rpc.loop_call_queue(loop)
        object_id = ref.id()

        def deliver(result, is_exc):
            def _set():
                if fut.cancelled():
                    return
                if is_exc:
                    fut.set_exception(result)
                else:
                    fut.set_result(result)
            try:
                caller.call(_set)
            except RuntimeError:
                pass  # caller's loop closed: nobody is waiting

        def resolve_blocking():
            try:
                deliver(self._get_one(ref, None), False)
            except BaseException as e:
                deliver(e, True)

        def on_ready():
            found, value, is_exc = self.memstore.get_if_ready(object_id)
            if not found or value is IN_PLASMA:
                # raced a reset(), or plasma-resident: the restore can
                # block for seconds — resolve on a thread, off this loop
                threading.Thread(target=resolve_blocking,
                                 daemon=True).start()
                return
            try:
                result = serialization.deserialize(value)
            except BaseException as e:
                deliver(e, True)
                return
            deliver(result, is_exc)

        self._ensure_fetch(ref)
        self.memstore.add_ready_callback(object_id, on_ready)
        return fut

    def cluster_info(self) -> dict:
        return self._io.run(self.raylet.call("cluster_info", {}))

    def notify_actor_exiting(self):
        try:
            self._io.run(self.raylet.call("actor_exiting", {}))
        except Exception:
            pass

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True

        async def _close():
            for key, leases in list(self.leases.items()):
                for lease in leases:
                    try:
                        await self.raylet.call(
                            "return_worker",
                            {"lease_id": lease.lease_id})
                    except Exception:
                        pass
            await self.server.close()
            for conn in list(self._peer_conns.values()):
                await conn.close()
            if self.raylet is not None:
                await self.raylet.close()
            if self.gcs is not None:
                await self.gcs.close()

        try:
            self._io.run(_close(), timeout=5)
        except Exception:
            pass
        self._io.stop()
        global_state.set_core_worker(None)
