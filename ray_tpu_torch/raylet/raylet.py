"""Raylet — the per-node manager process.

The port runs one node: this raylet grants worker leases from its own
resources (reference: src/ray/raylet/node_manager.h:133,
HandleRequestWorkerLease node_manager.cc:1318) and queues what does not fit
now, manages the pool of Python worker processes (worker_pool.h:92), tracks
the node's objects and spills them to disk (local_object_manager.h:38), and
executes the GCS's actor-creation and placement-group bundle requests
(the bundle two-phase commit, placement_group_resource_manager.h:51, and
leases granted from a committed bundle). Spillback to other nodes and
object transfer between nodes are not ported.

Task *data* never flows through the raylet: owners push tasks directly to
leased workers over their own connections (the direct-call architecture of
the reference's CoreWorkerDirectTaskSubmitter).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import subprocess
import sys
import time

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.common import InsufficientResources, ResourceSet
from ray_tpu_torch._private.config import Config, get_config, set_config
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private.object_store import make_store

logger = logging.getLogger("ray_tpu_torch.raylet")


class WorkerHandle:
    def __init__(self, worker_id: bytes, address: str, pid: int, conn):
        self.worker_id = worker_id
        self.address = address
        self.pid = pid
        self.conn = conn
        self.actor_id: bytes | None = None
        self.lease_id: bytes | None = None
        self.lease_resources: ResourceSet | None = None
        # the GPU ids its process was pinned to at spawn (CUDA_VISIBLE_
        # DEVICES); () for a CPU worker
        self.gpus: tuple[int, ...] = ()
        self.task_channel: str = ""  # same-node direct task UDS ("" = none)


class Raylet:
    def __init__(self, *, node_id: NodeID, session_dir: str, gcs_address: str,
                 resources: dict[str, float], store_root: str,
                 is_head: bool, labels: dict[str, str], config: Config):
        self.node_id = node_id
        self.session_dir = session_dir
        self.gcs_address = gcs_address
        self.config = config
        self.is_head = is_head
        self.labels = labels
        self.total = ResourceSet(resources)
        # free share of each GPU, by GPU id: a lease asking for g GPUs is
        # granted whole free ids (g >= 1) or a share of one id (g < 1),
        # and its worker runs with CUDA_VISIBLE_DEVICES = them
        self.gpu_free = {i: 1.0 for i in range(int(self.total.get("GPU")))}
        self.available = self.total.copy()
        # placement-group bundles: (pg_id, index) -> {"resources",
        # "available", "gpu_free" (the bundle's share of each card it
        # fixed at prepare time, unleased), "state": PREPARED|COMMITTED}
        self.bundles: dict[tuple[bytes, int], dict] = {}
        self.store = make_store(store_root, config)
        self.store_root = store_root

        # worker pool — CPU workers, and GPU workers pooled by the GPU ids
        # they were pinned to at spawn. A process keeps its CUDA_VISIBLE_
        # DEVICES for life, so a lease granted GPU 1 is never served by a
        # worker pinned to GPU 0.
        self.workers: dict[bytes, WorkerHandle] = {}  # registered, by worker_id
        self.idle: list[WorkerHandle] = []
        self.idle_gpu: dict[tuple[int, ...], list[WorkerHandle]] = {}
        self.starting = 0
        self.starting_gpu: dict[tuple[int, ...], int] = {}
        self._worker_waiters: list[tuple[asyncio.Future, tuple]] = []
        # Spawned-but-unregistered worker processes, so a worker that dies
        # during startup (plugin import error, chip already claimed, OOM)
        # is reaped and its `starting` slot released instead of wedging
        # _pop_worker forever.
        self._starting_procs: list = []  # [(Popen, gpu ids)]
        self._warned_infeasible: set[tuple] = set()
        self.num_cpus = int(resources.get("CPU", os.cpu_count() or 1))

        # scheduling
        self._lease_seq = 0
        self.pending_leases: list[tuple[dict, asyncio.Future]] = []

        # object manager
        self.local_objects: dict[bytes, dict] = {}  # oid -> {size, spilled}
        self.object_waiters: dict[bytes, list[asyncio.Future]] = {}
        self.store_used = 0
        self.spill_dir = os.path.join(session_dir, "spill")

        # cluster view (from GCS pubsub)
        self.cluster_nodes: dict[bytes, dict] = {}

        self.gcs: rpc.Connection | None = None
        self.server = rpc.Server(self._handlers(),
                                 on_disconnect=self._on_disconnect,
                                 name="raylet")
        self.address = ""  # tcp address, set in run()
        self._shutting_down = False

    def _handlers(self):
        return {
            # worker/driver-facing
            "register_client": self.h_register_client,
            "request_worker_lease": self.h_request_worker_lease,
            "return_worker": self.h_return_worker,
            "notify_object_sealed": self.h_notify_object_sealed,
            "wait_object_local": self.h_wait_object_local,
            "free_objects": self.h_free_objects,
            "spill_now": self.h_spill_now,
            "cluster_info": self.h_cluster_info,
            "actor_exiting": self.h_actor_exiting,
            # gcs-facing
            "create_actor": self.h_create_actor,
            "kill_actor_worker": self.h_kill_actor_worker,
            "prepare_bundle": self.h_prepare_bundle,
            "commit_bundle": self.h_commit_bundle,
            "cancel_bundle": self.h_cancel_bundle,
            "return_bundle": self.h_return_bundle,
            "ping": lambda conn, d: "pong",
        }

    # ------------------------------------------------------------------
    # worker pool (reference: src/ray/raylet/worker_pool.h)
    # ------------------------------------------------------------------

    def _start_worker_process(self, gpus: tuple[int, ...] = ()):
        if gpus:
            self.starting_gpu[gpus] = self.starting_gpu.get(gpus, 0) + 1
        else:
            self.starting += 1
        log_file = os.path.join(
            self.session_dir, "logs",
            f"worker-{self.node_id.hex()[:8]}-"
            f"{self.starting + sum(self.starting_gpu.values())}"
            f"-{time.time():.0f}.log")
        env = dict(os.environ)
        env.update(self.config.child_env())
        # A GPU worker sees exactly the cards of its lease, and echoes
        # their ids back at registration; a CPU worker sees no card at
        # all, so it never creates a CUDA context on one. The ids count
        # the cards this raylet sees: through its own CUDA_VISIBLE_DEVICES
        # when that is set.
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        names = visible.split(",") if visible else None
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            names[i] if names else str(i) for i in gpus)
        env["RAY_TPU_TORCH_WORKER_GPUS"] = ",".join(str(i) for i in gpus)
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.worker.main",
            "--raylet-address", self.address,
            "--gcs-address", self.gcs_address,
            "--node-id", self.node_id.hex(),
            "--session-dir", self.session_dir,
            "--store-root", self.store_root,
            "--log-file", log_file,
        ]
        # stderr lands in the worker's log file so crashes (uncaught
        # tracebacks, aborts) are diagnosable post-mortem.
        errf = open(log_file + ".err", "ab") if log_file else subprocess.DEVNULL
        proc = subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.DEVNULL, stderr=errf,
            start_new_session=True)
        if errf is not subprocess.DEVNULL:
            errf.close()
        self._starting_procs.append((proc, gpus))
        logger.info("started worker process pid=%d gpus=%s", proc.pid,
                    list(gpus))
        return proc

    def _reap_starting_workers(self):
        """Release `starting` slots held by worker processes that exited
        before registering, and re-wake waiters so they respawn."""
        alive, died = [], []
        for proc, gpus in self._starting_procs:
            (alive if proc.poll() is None else died).append((proc, gpus))
        self._starting_procs = alive
        for proc, gpus in died:
            logger.warning("worker pid=%d (gpus %s) exited (rc=%s) before "
                           "registering", proc.pid, list(gpus),
                           proc.returncode)
            self._started(gpus)
        if died:
            # Wake every waiter; each re-runs its loop and respawns now
            # that the stuck `starting` slot is free.
            for fut, _gpus in self._worker_waiters:
                if not fut.done():
                    fut.set_result(None)
            self._worker_waiters = []

    def _started(self, gpus: tuple[int, ...]):
        """A spawned worker left the `starting` count (registered or
        died)."""
        if gpus:
            self.starting_gpu[gpus] = max(0, self.starting_gpu.get(gpus, 0)
                                          - 1)
        else:
            self.starting = max(0, self.starting - 1)

    def _pool(self, gpus: tuple[int, ...]) -> list:
        return self.idle_gpu.setdefault(gpus, []) if gpus else self.idle

    async def _pop_worker(self, ignore_cap: bool = False,
                          gpus: tuple[int, ...] = ()) -> WorkerHandle:
        while True:
            pool = self._pool(gpus)
            if pool:
                return pool.pop()
            if gpus:
                # GPU workers are pinned to their ids — no cap games.
                if not self.starting_gpu.get(gpus):
                    self._start_worker_process(gpus)
            else:
                max_workers = (self.config.max_workers_per_node
                               or max(self.num_cpus, 4))
                active = len(self.workers) + self.starting
                if ignore_cap or active < max_workers or self.starting == 0:
                    self._start_worker_process()
            fut = asyncio.get_running_loop().create_future()
            self._worker_waiters.append((fut, gpus))
            await fut

    def _push_worker(self, worker: WorkerHandle):
        worker.lease_id = None
        worker.lease_resources = None
        if worker.conn.closed:
            return
        self._pool(worker.gpus).append(worker)
        self._wake_worker_waiters()

    def _wake_worker_waiters(self):
        remaining = []
        for fut, gpus in self._worker_waiters:
            if self._pool(gpus) and not fut.done():
                fut.set_result(None)
            elif not fut.done():
                remaining.append((fut, gpus))
        self._worker_waiters = remaining

    async def h_register_client(self, conn, d):
        kind = d["kind"]
        if kind == "worker":
            worker = WorkerHandle(d["worker_id"], d["address"], d["pid"], conn)
            worker.gpus = tuple(d.get("gpus") or ())
            worker.task_channel = d.get("task_channel") or ""
            self._starting_procs = [(p, g) for p, g in self._starting_procs
                                    if p.pid != d["pid"]]
            self.workers[d["worker_id"]] = worker
            conn.context["worker"] = worker
            self._started(worker.gpus)
            self._pool(worker.gpus).append(worker)
            self._wake_worker_waiters()
        else:  # driver
            # truthy dict (callers only truth-test it)
            conn.context["driver"] = {"pid": d.get("pid"),
                                      "address": d.get("address", "")}
        return {"node_id": self.node_id.binary(), "address": self.address}

    async def _on_disconnect(self, conn):
        if self._shutting_down:
            return
        # Lease-holder death: leases granted to this connection (a
        # driver, or a worker that owned subtasks) are returned now —
        # resources released, still-alive workers back in the idle pool —
        # instead of stranding them until node teardown.
        held = conn.context.pop("lease_ids", None)
        if held:
            reclaimed = 0
            for w in list(self.workers.values()):
                if w.lease_id in held:
                    self._release(w.lease_resources)
                    self._push_worker(w)
                    reclaimed += 1
            if reclaimed:
                logger.warning(
                    "lease holder disconnected; reclaimed %d leased "
                    "worker(s)", reclaimed)
                await self._dispatch_pending()
        worker: WorkerHandle | None = conn.context.get("worker")
        if worker is None:
            return
        self.workers.pop(worker.worker_id, None)
        pool = self._pool(worker.gpus)
        if worker in pool:
            pool.remove(worker)
        # release lease resources
        if worker.lease_resources is not None:
            self._release(worker.lease_resources)
            await self._dispatch_pending()
        intended = bool(conn.context.get("intended_exit"))
        if not intended:
            # structured WORKER_DIED event (RAY_EVENT analog)
            from ray_tpu_torch._private import events

            events.report_event(
                events.ERROR, "WORKER_DIED",
                f"worker {worker.worker_id.hex()[:8]} "
                f"(pid {worker.pid}) died unexpectedly",
                worker_id=worker.worker_id.hex(), pid=worker.pid)
        if worker.actor_id is not None and self.gcs is not None:
            try:
                await self.gcs.call("report_worker_failure", {
                    "worker_id": worker.worker_id,
                    "actor_ids": [worker.actor_id],
                    "intended": intended,
                })
            except Exception:
                pass

    # ------------------------------------------------------------------
    # scheduling (reference: cluster_task_manager.cc)
    # ------------------------------------------------------------------

    @staticmethod
    def _bundle_key(spec) -> tuple[bytes, int] | None:
        if spec.get("pg_id") is None:
            return None
        return (spec["pg_id"], spec.get("bundle_index", -1))

    def _find_bundle(self, key):
        if key[1] != -1:
            b = self.bundles.get(key)
            return (key, b) if b and b["state"] == "COMMITTED" else None
        # wildcard bundle index: any committed bundle of the group here
        for k, b in self.bundles.items():
            if k[0] == key[0] and b["state"] == "COMMITTED":
                return k, b
        return None

    def _try_acquire(self, spec) -> ResourceSet | None:
        """The lease's resources, taken from the node's pool or, for a
        spec in a placement group, from its committed bundle (a GPU
        bundle's lease gets the bundle's cards); None if they do not fit
        now."""
        need = ResourceSet.from_raw(spec["resources"])
        key = self._bundle_key(spec)
        if key is None:
            pool, gpu_free = self.available, self.gpu_free
        else:
            found = self._find_bundle(key)
            if found is None:
                return None
            need.bundle, bundle = found
            pool, gpu_free = bundle["available"], bundle["gpu_free"]
        if not need.is_subset_of(pool):
            return None
        need.gpu_ids = _take_gpus(gpu_free, need.get("GPU"))
        if need.gpu_ids is None:
            return None
        pool.subtract(need)
        return need

    def _release(self, res: ResourceSet):
        """Gives a lease's resources back to where they came from: its
        bundle, or the node's pool (also for a bundle removed while the
        lease was out)."""
        bundle = self.bundles.get(res.bundle) if res.bundle else None
        if bundle is None:
            pool, gpu_free = self.available, self.gpu_free
        else:
            pool, gpu_free = bundle["available"], bundle["gpu_free"]
        if res.gpu_ids:
            share = res.get("GPU") / len(res.gpu_ids)
            for i in res.gpu_ids:
                gpu_free[i] += share
            res.gpu_ids = ()
        pool.add(res)
        res.bundle = None

    def _feasible_ever(self, spec) -> bool:
        if self._bundle_key(spec) is not None:
            return True  # bundles are explicit placements: wait for them
        return ResourceSet.from_raw(spec["resources"]).is_subset_of(
            self.total)

    def _warn_infeasible(self, spec):
        shape = tuple(sorted(spec.get("resources", {}).items()))
        if shape not in self._warned_infeasible:
            self._warned_infeasible.add(shape)
            logger.warning(
                "task %s demands resources %s that this node can never "
                "satisfy; it stays queued "
                "(reference warns identically: cluster_task_manager.cc)",
                spec.get("name", "?"), dict(spec.get("resources", {})))

    def _pop_idle_now(self, gpus: tuple[int, ...]):
        """Pop an idle worker if one exists RIGHT NOW — no wait, no spawn
        (the grant path for soft/prewarm lease requests and for the tail
        of a batched grant)."""
        pool = self._pool(gpus)
        return pool.pop() if pool else None

    async def h_request_worker_lease(self, conn, d):
        """Grant up to `count` worker leases in ONE round trip from
        capacity that is idle now; only a hard request with zero idle
        workers waits (and possibly spawns) for a single worker, or
        queues until resources free. A `soft` request never spawns and
        never queues — a dry idle pool returns an empty grant list
        immediately, so owner-side lease pre-warm for bursts of tiny
        tasks cannot spawn-storm the node."""
        spec = d["spec"]
        count = max(1, int(d.get("count", 1)))
        soft = bool(d.get("soft"))
        grants: list[dict] = []
        while len(grants) < count:
            res = self._try_acquire(spec)
            if res is None:
                break
            worker = self._pop_idle_now(res.gpu_ids)
            if worker is None:
                if soft or grants:
                    # soft never spawns; a batch never blocks its
                    # already-granted leases behind worker startup
                    self._release(res)
                    break
                try:
                    worker = await self._pop_worker(gpus=res.gpu_ids)
                except Exception:
                    self._release(res)
                    raise
            grants.append(self._lease_reply(worker, res))
        if grants:
            if conn.closed:
                # The holder died while we awaited worker spawn: its
                # disconnect callback already ran, so reclaim these
                # grants now — nobody can receive the reply or ever
                # return the leases.
                ids = {g["lease_id"] for g in grants}
                for w in list(self.workers.values()):
                    if w.lease_id in ids:
                        self._release(w.lease_resources)
                        self._push_worker(w)
                await self._dispatch_pending()
            else:
                self._track_holder(conn, grants)
            return {"grants": grants}
        if soft:
            return {"grants": []}
        if not self._feasible_ever(spec):
            self._warn_infeasible(spec)
        fut = asyncio.get_running_loop().create_future()
        self.pending_leases.append((spec, fut))
        result = await fut
        if conn.closed:
            # The holder died while its request sat in the queue: its
            # disconnect callback already ran (empty lease set), so
            # reclaim this grant NOW — the reply can't be delivered and
            # nobody would ever return the lease.
            for w in list(self.workers.values()):
                if w.lease_id == result["lease_id"]:
                    self._release(w.lease_resources)
                    self._push_worker(w)
                    break
            await self._dispatch_pending()
        else:
            self._track_holder(conn, [result])
        return {"grants": [result]}

    @staticmethod
    def _track_holder(conn, grants):
        """Remember which connection holds each lease, so a lease holder
        that crashes (driver killed, owner worker dies mid-pipeline)
        returns its leases instead of stranding workers+resources until
        node death (_on_disconnect reclaims)."""
        held = conn.context.setdefault("lease_ids", set())
        for g in grants:
            held.add(g["lease_id"])

    async def _grant_lease(self, res):
        try:
            worker = await self._pop_worker(gpus=res.gpu_ids)
        except Exception:
            self._release(res)
            raise
        return self._lease_reply(worker, res)

    def _lease_reply(self, worker, res) -> dict:
        self._lease_seq += 1
        lease_id = self._lease_seq.to_bytes(8, "big")
        worker.lease_id = lease_id
        worker.lease_resources = res
        return {
            "lease_id": lease_id,
            "worker_id": worker.worker_id,
            "worker_address": worker.address,
            "task_channel": worker.task_channel,
        }

    async def h_return_worker(self, conn, d):
        held = conn.context.get("lease_ids")
        if held is not None:
            held.discard(d["lease_id"])
        worker = None
        for w in self.workers.values():
            if w.lease_id == d["lease_id"]:
                worker = w
                break
        if worker is None:
            return False
        self._release(worker.lease_resources)
        if d.get("worker_exiting") or worker.conn.closed:
            self.workers.pop(worker.worker_id, None)
        else:
            self._push_worker(worker)
        await self._dispatch_pending()
        return True

    async def _dispatch_pending(self):
        remaining = []
        for spec, fut in self.pending_leases:
            if fut.done():
                continue
            res = self._try_acquire(spec)
            if res is None:
                remaining.append((spec, fut))
                continue
            try:
                fut.set_result(await self._grant_lease(res))
            except Exception as e:  # pragma: no cover
                if not fut.done():
                    fut.set_exception(e)
        self.pending_leases = remaining

    # ------------------------------------------------------------------
    # actors (GCS-driven)
    # ------------------------------------------------------------------

    async def h_create_actor(self, conn, d):
        spec = d["spec"]
        res = self._try_acquire(spec)
        if res is None:
            # GCS checked the resource snapshot, but we may have raced.
            raise InsufficientResources("insufficient resources for actor")
        try:
            worker = await asyncio.wait_for(
                self._pop_worker(ignore_cap=True, gpus=res.gpu_ids),
                self.config.worker_register_timeout_s)
        except Exception:
            self._release(res)
            raise
        worker.actor_id = spec["actor_id"]
        worker.lease_resources = res
        try:
            reply = await worker.conn.call("create_actor", {"spec": spec})
            # The worker packs constructor exceptions as an error result
            # instead of raising over RPC — surface them so the GCS records
            # a real death cause (reference: creation failures publish the
            # actor as DEAD with the error, gcs_actor_manager.h:125-127).
            if any(r.get("err") for r in (reply or {}).get("returns", [])):
                raise RuntimeError(
                    f"actor constructor failed: "
                    f"{(reply or {}).get('error_repr', 'unknown error')}")
        except Exception:
            worker.actor_id = None
            self._release(res)
            worker.lease_resources = None
            if not worker.conn.closed:
                self._push_worker(worker)
            raise
        return {"worker_address": worker.address,
                "worker_id": worker.worker_id,
                "task_channel": worker.task_channel}

    async def h_kill_actor_worker(self, conn, d):
        worker = self.workers.get(d["worker_id"])
        if worker is None:
            return False
        worker.conn.context["intended_exit"] = True
        try:
            await worker.conn.notify("exit", {"reason": "killed"})
        except Exception:
            pass

        async def _force_kill():
            await asyncio.sleep(2.0)
            try:
                os.kill(worker.pid, 9)
            except ProcessLookupError:
                pass

        asyncio.create_task(_force_kill())
        return True

    async def h_actor_exiting(self, conn, d):
        """Actor worker announces a clean exit (exit_actor())."""
        conn.context["intended_exit"] = True
        return True

    # ------------------------------------------------------------------
    # placement group bundles (two-phase; reference:
    # placement_group_resource_manager.h:51)
    # ------------------------------------------------------------------

    async def h_prepare_bundle(self, conn, d):
        """Reserves a bundle's resources from the node's pool; a GPU
        bundle fixes its cards now, and every lease in it gets them."""
        need = ResourceSet.from_raw(d["resources"])
        if not need.is_subset_of(self.available):
            return False
        gpus = _take_gpus(self.gpu_free, need.get("GPU"))
        if gpus is None:
            return False
        self.available.subtract(need)
        share = need.get("GPU") / len(gpus) if gpus else 0.0
        self.bundles[(d["pg_id"], d["bundle_index"])] = {
            "resources": need, "available": need.copy(),
            "gpu_free": {i: share for i in gpus}, "state": "PREPARED"}
        return True

    async def h_commit_bundle(self, conn, d):
        bundle = self.bundles.get((d["pg_id"], d["bundle_index"]))
        if bundle is None:
            return False
        bundle["state"] = "COMMITTED"
        await self._dispatch_pending()
        return True

    async def h_cancel_bundle(self, conn, d):
        """Removes a bundle: its unleased part goes back to the node's
        pool now, each leased part as its lease ends (_release). Workers
        still leasing from the group are killed, as the reference kills
        the tasks of a removed group."""
        bundle = self.bundles.pop((d["pg_id"], d["bundle_index"]), None)
        if bundle is None:
            return True
        self.available.add(bundle["available"])
        for i, free in bundle["gpu_free"].items():
            self.gpu_free[i] += free
        for w in list(self.workers.values()):
            if (w.lease_resources is not None
                    and w.lease_resources.bundle is not None
                    and w.lease_resources.bundle[0] == d["pg_id"]):
                await self.h_kill_actor_worker(conn,
                                               {"worker_id": w.worker_id})
        await self._dispatch_pending()
        return True

    async def h_return_bundle(self, conn, d):
        return await self.h_cancel_bundle(conn, d)

    # ------------------------------------------------------------------
    # objects of this node (reference: local_object_manager.h)
    # ------------------------------------------------------------------

    async def h_notify_object_sealed(self, conn, d):
        oid = d["object_id"]
        size = d["size"]
        self.local_objects[oid] = {"size": size, "spilled": None}
        self.store_used += size
        await self._wake_object_waiters(oid)

        # The spill check rides a background task: the putting worker
        # does not wait for it.
        async def _spill():
            try:
                await self._maybe_spill()
            except Exception:
                # Spill failures (disk full, perms) must be visible, not
                # an unretrieved-task exception; the next seal retries.
                logger.exception("object spill failed")

        asyncio.create_task(_spill())
        return True

    async def _wake_object_waiters(self, oid: bytes):
        for fut in self.object_waiters.pop(oid, []):
            if not fut.done():
                fut.set_result(True)

    async def h_wait_object_local(self, conn, d):
        """Returns True once the object is sealed here (restored first if
        it was spilled), False when `timeout` passes before that. On one
        node there is no other copy to pull: an object that stays absent
        was freed or lost, and the caller turns to lineage recovery."""
        oid = d["object_id"]
        timeout = d.get("timeout") or None
        rec = self.local_objects.get(oid)
        if rec is not None:
            if rec["spilled"]:
                await self._restore_spilled(oid)
            return True
        fut = asyncio.get_running_loop().create_future()
        self.object_waiters.setdefault(oid, []).append(fut)
        if timeout:
            try:
                return await asyncio.wait_for(asyncio.shield(fut), timeout)
            except asyncio.TimeoutError:
                return False
        return await fut

    async def h_spill_now(self, conn, d):
        """Synchronous spill on behalf of a worker whose store create
        failed: move residents to disk until `need_bytes` fits (plus the
        normal threshold), oldest first."""
        need = int(d.get("need_bytes", 0))
        limit = max(0, int(self.config.object_store_memory
                           * self.config.object_spilling_threshold) - need)
        for oid, rec in list(self.local_objects.items()):
            if self.store_used <= limit:
                break
            if not rec["spilled"]:
                await self._spill_one(oid, rec)
        return True

    async def h_free_objects(self, conn, d):
        for oid in d["object_ids"]:
            await self._free_one(oid)
        return True

    async def _free_one(self, oid: bytes):
        rec = self.local_objects.pop(oid, None)
        if rec is None:
            return
        freed = 0
        if rec["spilled"]:
            try:
                os.unlink(rec["spilled"])
            except FileNotFoundError:
                pass
        else:
            freed = self.store.delete(ObjectID(oid))
        self.store_used = max(0, self.store_used - freed)

    async def _maybe_spill(self):
        """Spill objects to disk above the usage threshold
        (reference: local_object_manager.h SpillObjects). Safe on BOTH
        backends: the files store copies before unlink, and the native
        arena's delete zombifies under outstanding reader pins (store.cc
        rts_delete) — the block is only reused after the last zero-copy
        view releases, so spilling can never corrupt a live reader.
        Zombie blocks do keep arena bytes busy until released, which is
        why the threshold leaves headroom below physical capacity."""
        limit = int(self.config.object_store_memory
                    * self.config.object_spilling_threshold)
        if self.store_used <= limit:
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        for oid, rec in list(self.local_objects.items()):
            if self.store_used <= limit:
                break
            # reference semantics: owner-pinned primaries may move to
            # disk under pressure, the spill file keeps the bytes
            # (local_object_manager.h SpillObjects)
            if not rec["spilled"]:
                await self._spill_one(oid, rec)

    async def _spill_one(self, oid: bytes, rec: dict):
        object_id = ObjectID(oid)
        buf = self.store.get(object_id)
        if buf is None:
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, object_id.hex())
        with open(path, "wb") as f:
            f.write(buf.view)
        buf.close()
        self.store.delete(object_id)
        rec["spilled"] = path
        self.store_used -= rec["size"]
        logger.info("spilled %s (%d bytes)", object_id.hex()[:12],
                    rec["size"])

    async def _restore_spilled(self, oid: bytes):
        rec = self.local_objects.get(oid)
        if rec is None or not rec["spilled"]:
            return
        object_id = ObjectID(oid)
        with open(rec["spilled"], "rb") as f:
            data = f.read()
        try:
            self.store.put_bytes(object_id, data)
        except MemoryError:
            # the store is the reason this object was spilled — push
            # other residents out until this one fits, then retry once
            # (bounded: spilling everything would thrash alternating
            # restores into O(n²) disk churn)
            target = max(
                0, int(self.config.object_store_memory
                       * self.config.object_spilling_threshold)
                - rec["size"])
            for other, orec in list(self.local_objects.items()):
                if self.store_used <= target:
                    break
                if other != oid and not orec["spilled"]:
                    await self._spill_one(other, orec)
            self.store.put_bytes(object_id, data)
        os.unlink(rec["spilled"])
        rec["spilled"] = None
        self.store_used += rec["size"]

    # ------------------------------------------------------------------
    # cluster info
    # ------------------------------------------------------------------

    async def h_cluster_info(self, conn, d):
        # worker_pids: a worker leaves it in the step that returns its
        # lease (_on_disconnect), so callers can wait for both
        return {"nodes": list(self.cluster_nodes.values()),
                "available": self.available.raw(),
                "worker_pids": [w.pid for w in self.workers.values()]}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def _handle_gcs_push(self, channel, data):
        if channel == "nodes":
            node = data["node"]
            if data["event"] in ("added", "updated"):
                self.cluster_nodes[node["node_id"]] = node
            else:
                self.cluster_nodes.pop(node["node_id"], None)
                await self._dispatch_pending()

    async def _reap_loop(self):
        while True:
            await asyncio.sleep(1.0)
            try:
                self._reap_starting_workers()
            except Exception:
                logger.exception("starting-worker reap failed")

    def _fail_stop(self, reason: str):
        """Fail-stop this node: kill every worker and exit. A raylet the
        GCS has given up on must NOT linger as a split-brain zombie that
        still grants leases and runs tasks nobody can reach — the rest of
        the cluster already declared this node dead and rescheduled its
        actors (reference: raylets exit when disconnected from the GCS)."""
        logger.error("raylet fail-stop: %s — killing %d worker(s) and "
                     "exiting", reason, len(self.workers))
        self._shutting_down = True
        for w in list(self.workers.values()):
            try:
                os.kill(w.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for proc, _flavor in self._starting_procs:
            try:
                proc.kill()
            except OSError:
                pass
        os._exit(1)

    async def heartbeat_loop(self):
        interval = self.config.heartbeat_interval_s
        window = max(self.config.gcs_reconnect_timeout_s, 2 * interval)
        last_ok = time.monotonic()
        while True:
            await asyncio.sleep(interval)
            try:
                beat = {
                    "node_id": self.node_id.binary(),
                    "available": self.available.raw(),
                }
                # Bounded per-beat: a HUNG (not dead) GCS must not park
                # this call forever — that would stop the failure clock
                # and leave exactly the zombie this loop exists to kill.
                await self.gcs.call("heartbeat", beat,
                                    timeout=max(2.0, 4 * interval))
                last_ok = time.monotonic()
            except Exception:
                logger.warning("heartbeat to GCS failed")
                if time.monotonic() - last_ok > window:
                    # Continuous failure past the reconnect window: the
                    # GCS has long since declared us dead (heartbeat
                    # timeout is far shorter) — fail-stop, don't zombie.
                    self._fail_stop(
                        f"heartbeats failing for >{window:.0f}s "
                        f"(GCS reconnect window)")

    async def run(self, port: int = 0, ready_file: str | None = None):
        actual = await self.server.start_tcp(
            host=self.config.bind_host, port=port,
            uds_dir=os.path.join(self.session_dir, "sock"))
        self.address = f"{self.config.node_ip_address}:{actual}"

        async def _gcs_session(conn):
            """(Re-)establish GCS session state: subscribe, refresh the
            cluster view, re-register this node. Runs on first connect and
            again after every GCS restart (reference: raylet re-registers
            via service_based_gcs_client reconnection)."""
            await conn.call("subscribe", {"channel": "nodes"})
            nodes = await conn.call("get_all_nodes", {})
            self.cluster_nodes = {n["node_id"]: n for n in nodes}
            await conn.call("register_node", {
                "node_id": self.node_id.binary(),
                "address": self.address,
                "resources": self.total.raw(),
                "available": self.available.raw(),
                "hostname": os.uname().nodename,
                "is_head": self.is_head,
                "labels": self.labels,
            })

        def _gcs_gone():
            self._fail_stop("GCS unreachable past reconnect timeout")

        # Duplex: the GCS drives actor creation back over this
        # connection.
        uds_dir = os.path.join(self.session_dir, "sock")
        self.gcs = rpc.ReconnectingConnection(
            rpc.prefer_uds(self.gcs_address, uds_dir,
                           local_ips=("127.0.0.1",
                                      self.config.node_ip_address)),
            handlers=self._handlers(), name="raylet->gcs",
            on_reconnect=_gcs_session,
            retry_timeout=self.config.gcs_reconnect_timeout_s,
            on_give_up=_gcs_gone)
        self.gcs.set_push_handler(self._handle_gcs_push)
        await _gcs_session(await self.gcs.ensure_connected())
        asyncio.create_task(self.heartbeat_loop())
        asyncio.create_task(self._reap_loop())
        prestart = self.config.num_initial_workers
        if prestart < 0:
            prestart = min(int(self.num_cpus), 8)
        for _ in range(prestart):
            self._start_worker_process()
        logger.info("raylet up at %s (node %s)", self.address,
                    self.node_id.hex()[:8])
        if ready_file:
            tmp = ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(self.address)
            os.rename(tmp, ready_file)
        while True:
            await asyncio.sleep(3600)


def _take_gpus(free: dict[int, float], amount: float
               ) -> tuple[int, ...] | None:
    """Picks the GPU ids of a lease that asks for `amount` GPUs from the
    free shares `free` (the node's, or a bundle's) and marks them taken:
    whole free cards for amount >= 1, else the most used card that still
    has the share free. None when the free shares are too fragmented."""
    if amount <= 0:
        return ()
    if amount >= 1:
        whole = [i for i, f in free.items() if f >= 1 - 1e-9]
        if len(whole) < amount:
            return None
        ids = tuple(whole[:int(amount)])
    else:
        fits = [i for i, f in free.items() if f >= amount - 1e-9]
        if not fits:
            return None
        ids = (min(fits, key=lambda i: free[i]),)
    share = amount / len(ids)
    for i in ids:
        free[i] -= share
    return ids


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--store-root", required=True)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=0)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--is-head", action="store_true")
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--log-file", default=None)
    args = parser.parse_args()

    import json

    from ray_tpu_torch._private.log_utils import setup_process_logging

    setup_process_logging("raylet", args.log_file)
    from ray_tpu_torch._private.events import init_events

    init_events("RAYLET", args.node_id or "",
                os.path.dirname(args.log_file) if args.log_file else None)
    set_config(Config.load())
    resources = dict(json.loads(args.resources))
    resources.setdefault("CPU", args.num_cpus
                         if args.num_cpus is not None else (os.cpu_count() or 1))
    if args.num_gpus:
        resources.setdefault("GPU", args.num_gpus)
    node_id = (NodeID.from_hex(args.node_id) if args.node_id
               else NodeID.from_random())
    raylet = Raylet(
        node_id=node_id,
        session_dir=args.session_dir,
        gcs_address=args.gcs_address,
        resources=resources,
        store_root=args.store_root,
        is_head=args.is_head,
        labels=json.loads(args.labels),
        config=get_config(),
    )
    asyncio.run(raylet.run(args.port, args.ready_file))


if __name__ == "__main__":
    main()
