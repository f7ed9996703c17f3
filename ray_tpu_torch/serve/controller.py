"""ServeController actor; port of ray_tpu/serve/controller.py (reference:
python/ray/serve/controller.py:34 + backend_state.py reconciliation): owns the desired state — backends,
endpoints, replica sets — and reconciles actual replica actors toward it.

Routers/proxies stay in sync via LONG-POLL (reference: serve/long_poll.py:26
LongPollHost): `listen_for_change(version)` is an async actor method that
parks until the config version advances and then returns one full snapshot
— zero controller RPCs on the request path. Queue-depth autoscaling
(reference: autoscaling_policy.py:137) piggybacks on the same traffic:
routers report queue lengths with each poll cycle and the controller
resizes replica sets toward target_queued per replica. A replica (or a
gang member) leases `num_gpus_per_shard` of a card where the backend
sets it (serve/config.py)."""

from __future__ import annotations

import math
import time

import ray_tpu_torch
from ray_tpu_torch.serve.config import BackendConfig
from ray_tpu_torch.serve.metrics import M_GROUP_RESTARTS_TOTAL
from ray_tpu_torch.serve.replica import Replica
from ray_tpu_torch.serve.replica_group import (kill_replica_group,
                                               spawn_replica_group)


class ServeController:
    # Autoscaling clock: router reports drive reactive scaling, the tick
    # drives idle convergence (a deployment with NO router traffic — or
    # no router at all, handle-only — must still drift to min_replicas).
    AUTOSCALE_TICK_S = 0.5
    # A queue report older than this reads as 0: a router that died (or
    # an endpoint whose traffic stopped reaching any router) must not
    # pin replicas up with its last non-zero report forever.
    QUEUE_REPORT_TTL_S = 10.0
    # KV-pressure poll cadence for streaming autoscaled backends (the
    # engine_state gets run OUTSIDE the autoscale lock on the tick
    # thread; a stale sample past 3x this is ignored).
    KV_POLL_TTL_S = 2.0

    def __init__(self):
        import threading

        # name -> {"config": dict, "pickled": bytes, "init_args": tuple,
        #          "replicas": [handle]}
        self.backends: dict[str, dict] = {}
        # name -> {"backend": str, "route": str|None, "methods": [str]}
        self.endpoints: dict[str, dict] = {}
        self.version = 0
        # endpoint -> (latest reported router queue length, monotonic ts)
        self._queue_lens: dict[str, tuple[float, float]] = {}
        self._gang_restarts = 0
        # backend -> {"in_use", "pages_total", "replicas", "ts", "ring"}
        # sampled KV-page pressure for KV-aware autoscaling
        self._kv_stats: dict[str, dict] = {}
        self._last_downscale_ok: dict[str, float] = {}
        self._last_autoscale = 0.0
        # serializes tick-thread autoscaling against report-triggered
        # autoscaling on the actor's dispatcher thread
        self._autoscale_lock = threading.Lock()
        self._stopped = False
        # drained gang leaders awaiting their reap timer: (leader, pg)
        self._draining: list = []
        # Long-poll parking: listeners wait on this event (on the actor's
        # async loop); sync mutators fire it thread-safely via the loop.
        self._change_event = None
        self._loop = None
        threading.Thread(target=self._autoscale_loop,
                         name="serve-autoscale", daemon=True).start()

    def _autoscale_loop(self):
        """The control-loop clock (reference: controller.py run_control_loop):
        without it, _maybe_autoscale only ran when router traffic reports
        arrived, so an idle deployment never scaled down to min_replicas
        and a handle-only deployment never autoscaled at all. The same
        tick drives replica-GROUP health: a gang with any DEAD member is
        torn down and respawned whole (gang restart)."""
        import logging

        logger = logging.getLogger("ray_tpu_torch.serve.controller")
        while not self._stopped:
            time.sleep(self.AUTOSCALE_TICK_S)
            try:
                # poll BEFORE taking the autoscale lock: a slow replica
                # get must not freeze resizes / gang restarts
                self._refresh_kv_stats()
            except Exception:
                logger.exception("kv-pressure poll failed")
            try:
                self._maybe_autoscale()
            except Exception:
                logger.exception("autoscale tick failed")
            try:
                self._check_gangs()
            except Exception:
                logger.exception("gang health tick failed")

    def stop(self):
        """Stop the autoscale tick thread and tear down every replica
        and gang (called by Client.shutdown before the actor is killed;
        also the teardown for in-process controllers in tests). The
        reference leaves the replicas to die with their owner; the
        port's runtime has no owner fate-sharing, so the controller
        kills what it spawned."""
        self._stopped = True
        with self._autoscale_lock:
            recs = list(self.backends.values())
            self.backends.clear()
            draining, self._draining = self._draining, []
        for leader, pg in draining:
            kill_replica_group({"members": [leader], "pg": pg})
        for rec in recs:
            for gang in rec.get("gangs") or []:
                kill_replica_group(gang)
            if not rec.get("gangs"):
                for handle in rec["replicas"]:
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:
                        pass
        return True

    def _notify_change(self):
        """Wake parked listen_for_change calls; safe from any thread."""
        loop = self._loop
        if loop is None:
            return

        def _fire():
            import asyncio

            ev = self._change_event
            self._change_event = asyncio.Event()
            if ev is not None:
                ev.set()

        try:
            loop.call_soon_threadsafe(_fire)
        except RuntimeError:
            pass

    # -- backends --------------------------------------------------------

    def create_backend(self, name: str, pickled_callable: bytes,
                       init_args: tuple, config: dict):
        if name in self.backends:
            raise ValueError(f"backend {name!r} already exists")
        cfg = BackendConfig.from_dict(config)
        # _autoscale_lock: the tick thread walks backends/replicas;
        # structural mutations must not interleave with its _reconcile
        with self._autoscale_lock:
            self.backends[name] = {
                "config": cfg.to_dict(),
                "pickled": pickled_callable,
                "init_args": init_args,
                "replicas": [],
            }
            try:
                self._reconcile(name)
            except BaseException:
                # failed bootstrap (e.g. a gang whose callable has no
                # shard protocol, or an unplaceable reservation) must
                # not leave a half-registered backend behind — NOR the
                # gangs/replicas reconcile already spawned before the
                # failing one (they'd be untracked and leak forever)
                rec = self.backends.pop(name, None)
                if rec is not None:
                    for gang in rec.get("gangs") or []:
                        kill_replica_group(gang)
                    for handle in rec.get("replicas") or []:
                        try:
                            ray_tpu_torch.kill(handle)
                        except Exception:
                            pass
                raise
        self.version += 1
        self._notify_change()
        return True

    def delete_backend(self, name: str):
        used_by = [ep for ep, rec in self.endpoints.items()
                   if name in rec["traffic"] or name in rec["shadow"]]
        if used_by:
            # Reference semantics: a backend can't vanish under a live
            # endpoint — routers would keep dispatching to dead replicas.
            raise ValueError(
                f"backend {name!r} is used by endpoint(s) {used_by}; "
                f"delete them first")
        with self._autoscale_lock:
            # under the lock: a tick-thread _reconcile appending a fresh
            # replica to a just-popped rec would orphan that actor
            rec = self.backends.pop(name, None)
            if rec is None:
                return False
            if rec.get("gangs"):
                for gang in rec["gangs"]:
                    kill_replica_group(gang)
            else:
                for handle in rec["replicas"]:
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:
                        pass
        self.version += 1
        self._notify_change()
        return True

    def update_backend_config(self, name: str, config: dict):
        with self._autoscale_lock:
            rec = self._backend(name)
            old_shards = rec["config"].get("num_shards", 1)
            merged = {**rec["config"], **config}
            merged_cfg = BackendConfig.from_dict(merged).to_dict()
            if merged_cfg.get("num_shards", 1) != old_shards:
                raise ValueError(
                    f"num_shards of a live backend cannot change "
                    f"({old_shards} -> {merged_cfg.get('num_shards')}); "
                    f"deploy a new backend and shift traffic instead")
            if bool(merged_cfg.get("streaming")) != bool(
                    rec["config"].get("streaming")):
                raise ValueError(
                    "streaming of a live backend cannot change (live "
                    "replicas' decode engines are not reconfigurable); "
                    "deploy a new backend and shift traffic instead")
            rec["config"] = merged_cfg
            self._reconcile(name)
            # gangs: reconfigure reaches every member, not just leaders
            replicas = ([m for g in rec["gangs"] for m in g["members"]]
                        if rec.get("gangs") else list(rec["replicas"]))
        if rec["config"].get("user_config") is not None:
            # reconfigure outside the lock: a 60s replica get must not
            # stall the autoscale tick
            refs = [r.reconfigure.remote(rec["config"]["user_config"])
                    for r in replicas]
            ray_tpu_torch.get(refs, timeout=60)
        self.version += 1
        self._notify_change()
        return True

    def get_backend_config(self, name: str) -> dict:
        return dict(self._backend(name)["config"])

    def list_backends(self) -> list[str]:
        return list(self.backends)

    def _backend(self, name: str) -> dict:
        if name not in self.backends:
            raise ValueError(f"no backend {name!r}")
        return self.backends[name]

    def _reconcile(self, name: str):
        rec = self._backend(name)
        want = rec["config"]["num_replicas"]
        replicas = rec["replicas"]
        if rec["config"].get("num_shards", 1) > 1:
            # Sharded backend: each "replica" is a GANG; rec["gangs"][i]
            # is the gang whose leader is rec["replicas"][i].
            gangs = rec.setdefault("gangs", [])
            while len(gangs) < want:
                gang = spawn_replica_group(
                    name, rec["pickled"], rec["init_args"], rec["config"])
                gangs.append(gang)
                replicas.append(gang["leader"])
            while len(gangs) > want:
                gang = gangs.pop()
                replicas.pop()
                kill_replica_group(gang)
            return
        replica_cls = ray_tpu_torch.remote(Replica)
        gpus = float(rec["config"].get("num_gpus_per_shard") or 0.0)
        if gpus:
            replica_cls = replica_cls.options(num_gpus=gpus)
        while len(replicas) < want:
            replicas.append(replica_cls.remote(
                rec["pickled"], rec["init_args"],
                rec["config"].get("user_config"),
                rec["config"].get("large_payload_threshold") or 0,
                {**rec["config"], "_backend_name": name}))
        while len(replicas) > want:
            handle = replicas.pop()
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass

    # -- replica-group (gang) health -------------------------------------

    def _check_gangs(self):
        """One health pass: any gang member DEAD in the GCS actor table
        => gang-restart the whole group (kill survivors, fresh pg-backed
        gang + collective group, swap the leader handle, bump version so
        routers cut over). In-flight requests against the old gang get
        typed ReplicaGroupDied (leader alive: starved allreduce; leader
        dead: ActorDiedError mapped by the router).

        Locking: ONLY the gang-table reads/mutations hold
        _autoscale_lock. The liveness RPCs and the (possibly tens of
        seconds) respawn run outside it — a stuck placement must not
        freeze create/delete/update_backend, the autoscaler, or the
        routers' 30s controller gets (same rule as the reconfigure path
        above)."""
        from ray_tpu_torch._private import global_state

        cw = global_state.get_core_worker()
        if cw is None:
            return
        # Elastic membership: a member sitting on a DRAINING node is as
        # restart-worthy as a dead one — the node is leaving while the
        # old gang still answers. One cluster-view read per pass, not
        # per gang.
        try:
            draining = {n["node_id"]
                        for n in cw.cluster_info()["nodes"]
                        if n.get("state") not in (None, "ALIVE")}
        except Exception:
            draining = set()
        now = time.monotonic()
        with self._autoscale_lock:
            candidates = [
                (name, rec, gang)
                for name, rec in list(self.backends.items())
                for gang in (rec.get("gangs") or [])
                if not gang.get("restarting")
                and gang.get("restart_backoff_until", 0.0) <= now]
        for name, rec, gang in candidates:
            if not self._gang_is_dead(cw, gang, draining):
                continue
            with self._autoscale_lock:
                gangs = rec.get("gangs") or []
                if (self.backends.get(name) is not rec
                        or gang not in gangs or gang.get("restarting")):
                    continue  # deleted/resized under us
                gang["restarting"] = True
                i = gangs.index(gang)
            self._restart_gang(name, rec, i, gang)

    @staticmethod
    def _gang_is_dead(cw, gang: dict, draining_nodes: set = frozenset()) -> bool:
        for member in gang["members"]:
            try:
                info = cw.get_actor_info(member._actor_id.binary())
            except Exception:
                return False  # GCS unreachable: don't thrash
            if info is None or info.get("state") == "DEAD":
                return True
            if info.get("node_id") in draining_nodes:
                # planned departure: restart proactively, inside the
                # drain window, instead of waiting for the member to die
                return True
        return False

    def _restart_gang(self, name: str, rec: dict, i: int, gang: dict):
        """Drain-then-kill gang restart (called WITHOUT the autoscale
        lock; `gang["restarting"]` was claimed under it). Followers die
        NOW (no caller ever dispatches to them); the LEADER is left
        alive long enough for its in-flight collective forwards to
        starve into typed ReplicaGroupDied within the group timeout —
        killing it immediately would downgrade every in-flight caller's
        error to a bare ActorDiedError. A timer reaps the drained leader
        (and the old gang's reservation) after the timeout + grace; the
        fresh gang takes over the routing slot once it spawns. A failed
        respawn (cluster temporarily short on resources) leaves the
        slot's dead gang in place — callers keep getting typed errors —
        and retries with backoff WITHOUT re-draining or re-counting."""
        import logging
        import threading

        import ray_tpu_torch as _rt
        from ray_tpu_torch.util.placement_group import remove_placement_group

        logger = logging.getLogger("ray_tpu_torch.serve.controller")
        if not gang.get("drain_started"):
            # one-shot side effects, however many respawn retries follow
            gang["drain_started"] = True
            logger.warning(
                "backend %r gang %s lost a member; gang-restarting",
                name, gang["gang_id"])
            for member in gang["members"][1:]:
                try:
                    _rt.kill(member)
                except Exception:
                    pass
            leader, pg = gang["leader"], gang["pg"]
            grace = float(rec["config"].get("shard_group_timeout_s")
                          or 10.0) + 2.0

            drained = (leader, pg)
            with self._autoscale_lock:
                self._draining.append(drained)

            def _reap():
                with self._autoscale_lock:
                    if drained not in self._draining:
                        return  # stop() reaped it already
                    self._draining.remove(drained)
                try:
                    _rt.kill(leader)
                except Exception:
                    pass
                try:
                    remove_placement_group(pg)
                except Exception:
                    pass

            timer = threading.Timer(grace, _reap)
            timer.daemon = True
            timer.start()
        try:
            fresh = spawn_replica_group(name, rec["pickled"],
                                        rec["init_args"], rec["config"])
        except BaseException:
            logger.exception(
                "backend %r gang %s respawn failed; retrying with "
                "backoff", name, gang["gang_id"])
            gang["restart_backoff_until"] = time.monotonic() + 5.0
            gang["restarting"] = False
            return
        with self._autoscale_lock:
            gangs = rec.get("gangs") or []
            if (self.backends.get(name) is not rec
                    or i >= len(gangs) or gangs[i] is not gang):
                # backend deleted or resized mid-respawn: the slot is
                # gone — don't leak the fresh gang into nowhere
                kill_replica_group(fresh)
                return
            gangs[i] = fresh
            rec["replicas"][i] = fresh["leader"]
            self._gang_restarts += 1
        M_GROUP_RESTARTS_TOTAL.inc()
        self.version += 1
        self._notify_change()

    def get_gang_members(self, name: str) -> list:
        """Member handles of every gang of a sharded backend (ordered
        rank 0..N-1 per gang) — the test/chaos surface for arming
        member-local failpoints and picking victims."""
        rec = self._backend(name)
        return [list(g["members"]) for g in rec.get("gangs") or []]

    # -- endpoints -------------------------------------------------------

    def create_endpoint(self, name: str, backend: str,
                        route: str | None = None,
                        methods: list[str] | None = None):
        self._backend(backend)
        self.endpoints[name] = {
            "backend": backend,  # primary (back-compat/introspection)
            "traffic": {backend: 1.0},
            "shadow": {},
            "route": route,
            "methods": [m.upper() for m in (methods or ["GET"])],
        }
        self.version += 1
        self._notify_change()
        return True

    def set_traffic(self, endpoint: str, traffic: dict):
        """Weighted split across backends (reference: serve/api.py
        set_traffic — the canary/rollout primitive). Weights normalize;
        every named backend must exist."""
        ep = self._endpoint(endpoint)
        if not traffic:
            raise ValueError("traffic dict must not be empty")
        total = 0.0
        for backend, weight in traffic.items():
            self._backend(backend)
            w = float(weight)
            if w < 0:
                raise ValueError(f"negative weight for {backend!r}")
            total += w
        if total <= 0:
            raise ValueError("traffic weights sum to zero")
        live = [b for b, w in traffic.items() if float(w) > 0]
        self._check_streaming_uniform(live + list(ep["shadow"]))
        ep["traffic"] = {b: float(w) / total for b, w in traffic.items()
                        if float(w) > 0}
        ep["backend"] = max(ep["traffic"], key=ep["traffic"].get)
        self.version += 1
        self._notify_change()
        return True

    def shadow_traffic(self, endpoint: str, backend: str,
                       proportion: float):
        """Mirror a fraction of requests to `backend`, results dropped
        (reference: serve/api.py shadow_traffic). proportion=0 stops."""
        ep = self._endpoint(endpoint)
        proportion = float(proportion)
        if not 0.0 <= proportion <= 1.0:
            raise ValueError("proportion must be in [0, 1]")
        if proportion == 0.0:
            ep["shadow"].pop(backend, None)
        else:
            self._backend(backend)
            self._check_streaming_uniform(list(ep["traffic"]) + [backend])
            ep["shadow"][backend] = proportion
        self.version += 1
        self._notify_change()
        return True

    def _check_streaming_uniform(self, backends: list):
        """An endpoint's backends must agree on `streaming`: the proxy
        picks its dispatch style (SSE/stream vs request/response) per
        ENDPOINT while the router picks a backend per REQUEST by
        weight, so a mixed split would hard-500 whichever arm loses
        the primary flag. Canary between two streaming backends (or
        two request-level ones) instead."""
        flags = {b: bool(self._backend(b)["config"].get("streaming"))
                 for b in backends}
        if len(set(flags.values())) > 1:
            raise ValueError(
                f"cannot split/shadow an endpoint across streaming AND "
                f"request-level backends: {flags}; deploy the "
                f"replacement with the same serving mode")

    def _endpoint(self, name: str) -> dict:
        if name not in self.endpoints:
            raise ValueError(f"no endpoint {name!r}")
        return self.endpoints[name]

    def delete_endpoint(self, name: str):
        out = self.endpoints.pop(name, None) is not None
        self.version += 1
        self._notify_change()
        return out

    def list_endpoints(self) -> dict:
        return {k: {kk: vv for kk, vv in v.items()}
                for k, v in self.endpoints.items()}

    # -- router/proxy state sync ----------------------------------------

    def get_version(self) -> int:
        return self.version

    def get_routing_state(self, endpoint: str) -> dict:
        """Everything a router needs to drive one endpoint: the traffic
        split plus per-backend config/replicas."""
        ep = self._endpoint(endpoint)
        involved = set(ep["traffic"]) | set(ep["shadow"])
        return {
            "version": self.version,
            "backend": ep["backend"],
            "traffic": dict(ep["traffic"]),
            "shadow": dict(ep["shadow"]),
            "backends": {
                b: {"config": dict(self._backend(b)["config"]),
                    "replicas": list(self._backend(b)["replicas"])}
                for b in involved
            },
        }

    # -- long poll (reference: serve/long_poll.py:26) --------------------

    def _snapshot(self) -> dict:
        return {
            "version": self.version,
            "routes": {
                ep["route"]: {"endpoint": name, "methods": ep["methods"]}
                for name, ep in self.endpoints.items() if ep.get("route")
            },
            "endpoints": {name: self.get_routing_state(name)
                          for name in self.endpoints},
        }

    async def listen_for_change(self, cur_version: int,
                                timeout_s: float = 10.0):
        """Park until the config version advances past cur_version, then
        return a full snapshot; None on timeout (client just re-polls).
        Async actor method: concurrent listeners interleave on the actor's
        event loop while sync mutators keep running on the dispatcher and
        wake them via _notify_change — true parking, no poll loop."""
        import asyncio

        if self._loop is None:
            self._loop = asyncio.get_running_loop()
            self._change_event = asyncio.Event()
        deadline = time.monotonic() + timeout_s
        while self.version == cur_version:
            ev = self._change_event
            if self.version != cur_version:  # re-check after grabbing ev
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                return None
        return self._snapshot()

    # -- autoscaling (reference: autoscaling_policy.py:137) --------------

    def report_queue_len(self, endpoint: str, queued: int):
        """Routers report their queue depth each poll cycle; reports
        drive reactive scaling, the periodic tick (_autoscale_loop)
        drives idle convergence."""
        self._queue_lens[endpoint] = (float(queued), time.monotonic())
        self._maybe_autoscale()
        return True

    def _maybe_autoscale(self):
        with self._autoscale_lock:
            self._maybe_autoscale_locked()

    def _maybe_autoscale_locked(self):
        now = time.monotonic()
        if now - self._last_autoscale < 0.5:
            return
        self._last_autoscale = now
        for name, rec in list(self.backends.items()):
            auto = rec["config"].get("autoscaling")
            if not auto:
                continue
            queued = sum(
                q * (self.endpoints[ep]["traffic"].get(name, 0.0)
                     + self.endpoints[ep]["shadow"].get(name, 0.0))
                for ep, (q, ts) in self._queue_lens.items()
                if ep in self.endpoints
                and now - ts < self.QUEUE_REPORT_TTL_S)
            cur = len(rec["replicas"])
            target = auto.get("target_queued", 2.0) or 2.0
            # two pressure signals, take the max: queue depth (reactive,
            # router-reported) and predicted KV-page occupancy
            # (streaming backends: prefill load materializes as pages
            # long before queues back up)
            want = max(1, math.ceil(queued / target))
            kv_want = self._kv_desired(name, auto)
            desired = max(auto.get("min_replicas", 1),
                          min(auto.get("max_replicas", 4),
                              max(want, kv_want)))
            if desired > cur:
                self._resize(name, desired)
                self._last_downscale_ok[name] = (
                    now + auto.get("downscale_delay_s", 5.0))
            elif desired < cur:
                # Hold-down: only shrink after the backlog has stayed low
                # past the delay window (reference smooths the same way).
                if now >= self._last_downscale_ok.get(name, 0.0):
                    self._resize(name, desired)

    def _refresh_kv_stats(self):
        """Sample KV-page pressure from streaming autoscaled backends
        (engine_state gets, OUTSIDE the autoscale lock). Keeps a short
        per-backend ring of (ts, pages_in_use) — the same series the
        metrics history graphs as `serve.kv_pages_in_use`, sampled here
        per backend."""
        now = time.monotonic()
        for name, rec in list(self.backends.items()):
            cfg = rec["config"]
            if not (cfg.get("streaming") and cfg.get("autoscaling")):
                continue
            st = self._kv_stats.get(name)
            if st is not None and now - st["ts"] < self.KV_POLL_TTL_S:
                continue
            replicas = list(rec["replicas"])
            if not replicas:
                continue
            try:
                states = ray_tpu_torch.get(
                    [r.engine_state.remote() for r in replicas],
                    timeout=5)
            except Exception:
                continue
            in_use = total = 0
            for es in states:
                kv = (es or {}).get("kv") or {}
                in_use += int(kv.get("pages_in_use") or 0)
                total += int(kv.get("pages_total") or 0)
            now = time.monotonic()
            ring = list(st["ring"]) if st is not None else []
            ring.append((now, float(in_use)))
            ring = [s for s in ring if now - s[0] < 60.0][-32:]
            self._kv_stats[name] = {
                "in_use": in_use, "pages_total": total,
                "replicas": len(replicas), "ts": now, "ring": ring}

    def _kv_desired(self, name: str, auto: dict) -> int:
        """Replicas needed so PREDICTED KV occupancy stays under
        kv_target_util per pool: linear extrapolation of the sampled
        pages_in_use series kv_horizon_s ahead. 0 = no opinion (stale
        sample, KV scaling disabled, or not a streaming backend)."""
        util = float(auto.get("kv_target_util", 0.8) or 0.0)
        if util <= 0:
            return 0
        st = self._kv_stats.get(name)
        now = time.monotonic()
        if (st is None or not st["pages_total"]
                or now - st["ts"] > 3 * self.KV_POLL_TTL_S):
            return 0
        predicted = float(st["in_use"])
        horizon = float(auto.get("kv_horizon_s", 10.0) or 0.0)
        ring = st["ring"]
        if horizon > 0 and len(ring) >= 2:
            (t0, v0), (t1, v1) = ring[0], ring[-1]
            if t1 > t0:
                predicted = max(0.0, v1 + (v1 - v0) / (t1 - t0) * horizon)
        per_replica = st["pages_total"] / max(1, st["replicas"])
        return math.ceil(predicted / max(1.0, per_replica * util))

    def _resize(self, name: str, n: int):
        rec = self._backend(name)
        before = list(rec["replicas"])
        rec["config"]["num_replicas"] = n
        self._reconcile(name)
        fresh = [r for r in rec["replicas"] if r not in before]
        cfg = rec["config"]
        if (fresh and before and cfg.get("streaming")
                and cfg.get("num_shards", 1) == 1
                and int(cfg.get("kv_warm_pages") or 0) > 0):
            # warm the newcomers' prefix caches from a sibling through
            # the object store — advisory, off the control path
            import threading

            threading.Thread(
                target=self._warm_replicas, daemon=True,
                name=f"serve-kv-warm-{name}",
                args=(name, before, fresh,
                      int(cfg.get("kv_warm_pages") or 0))).start()
        self.version += 1
        self._notify_change()

    def _warm_replicas(self, name: str, donors: list, fresh: list,
                       max_pages: int):
        """Scale-up cache warming: one donor exports its hottest prefix
        pages to the object store, each new replica imports them (the
        controller only relays the ~100-byte ref marker). Gangs never warm — members must replay
        the leader's op stream, so imports are refused replica-side."""
        import logging

        logger = logging.getLogger("ray_tpu_torch.serve.controller")
        try:
            payload = None
            for donor in donors:
                try:
                    payload = ray_tpu_torch.get(
                        donor.export_prefix_pages.remote(max_pages),
                        timeout=15)
                except Exception:
                    continue
                if payload and payload.get("pages"):
                    break
                payload = None
            if payload is None:
                return
            for r in fresh:
                try:
                    # nested ref: rehydrates on the importer WITHOUT
                    # resolution — import_prefix_pages pulls it there
                    ray_tpu_torch.get(r.import_prefix_pages.remote(
                        {"ref": payload["ref"]}), timeout=30)
                except Exception:
                    logger.debug("kv warm import failed for %s", name,
                                 exc_info=True)
        except Exception:
            logger.debug("kv warm pass failed for %s", name,
                         exc_info=True)
