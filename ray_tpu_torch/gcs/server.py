"""GCS — global control store server (the control plane).

Ported from the reference's gcs_server process (reference:
src/ray/gcs/gcs_server/gcs_server.h:57): node membership + heartbeat
failure detection (GcsHeartbeatManager, gcs_heartbeat_manager.h:32), actor
lifecycle + restart (GcsActorManager, gcs_actor_manager.h:157), actor
scheduling (GcsActorScheduler, gcs_actor_scheduler.h:83), job registry,
KV store + pubsub (GcsPubSub over Redis in the reference — here an
in-process table + push channels over our RPC layer; no Redis process),
and placement groups (GcsPlacementGroupManager,
gcs_placement_group_manager.h:130: bundle placement, the two-phase
reservation on the raylets). The object directory is not ported: the
port runs one node.

State lives in this process's memory only: the reference's write-through
table storage and GCS restart (gcs_table_storage.h:294) are not ported.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import random
import time

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import stats as _stats
from ray_tpu_torch._private.common import InsufficientResources, ResourceSet
from ray_tpu_torch._private.config import Config, get_config, set_config

logger = logging.getLogger("ray_tpu_torch.gcs")

M_TOPO_FALLBACKS = _stats.Count(
    "gcs.placement_topology_fallbacks_total",
    "ICI_RING placements that fell back to PACK (the port registers no "
    "topology coords, so every placed ICI_RING group counts)")

# Actor states (reference: src/ray/protobuf/gcs.proto ActorTableData.ActorState)
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class GcsServer:
    def __init__(self, config: Config):
        self.config = config
        self.kv: dict[str, bytes] = {}
        self.subscriptions: dict[str, set[rpc.Connection]] = {}
        # node_id(bytes) -> node info dict
        self.nodes: dict[bytes, dict] = {}
        self.node_conns: dict[bytes, rpc.Connection] = {}
        self.last_heartbeat: dict[bytes, float] = {}
        self.available: dict[bytes, ResourceSet] = {}
        # actor_id -> record
        self.actors: dict[bytes, dict] = {}
        self.named_actors: dict[tuple[str, str], bytes] = {}
        self.jobs: dict[bytes, dict] = {}
        self.next_job = 1
        self.server = rpc.Server(self._handlers(), on_disconnect=self._on_disconnect,
                                 name="gcs")
        self._pending_actor_queue: list[bytes] = []
        self._pending_logged: set[bytes] = set()
        # pg_id -> record
        self.placement_groups: dict[bytes, dict] = {}

    def _handlers(self):
        return {
            "kv_put": self.h_kv_put,
            "kv_get": self.h_kv_get,
            "kv_del": self.h_kv_del,
            "subscribe": self.h_subscribe,
            "unsubscribe": self.h_unsubscribe,
            "publish": self.h_publish,
            "register_node": self.h_register_node,
            "heartbeat": self.h_heartbeat,
            "get_all_nodes": self.h_get_all_nodes,
            "register_job": self.h_register_job,
            "register_actor": self.h_register_actor,
            "get_actor": self.h_get_actor,
            "get_named_actor": self.h_get_named_actor,
            "kill_actor": self.h_kill_actor,
            "report_worker_failure": self.h_report_worker_failure,
            "create_placement_group": self.h_create_placement_group,
            "remove_placement_group": self.h_remove_placement_group,
            "get_placement_group": self.h_get_placement_group,
            "get_named_placement_group": self.h_get_named_placement_group,
            "list_placement_groups": self.h_list_placement_groups,
            "get_metric": lambda conn, d: _stats.snapshot().get(d["name"]),
            "ping": lambda conn, data: "pong",
        }

    # ---- kv ----
    async def h_kv_put(self, conn, d):
        key = d["key"]
        if not d.get("overwrite", True) and key in self.kv:
            return False
        self.kv[key] = d["value"]
        return True

    async def h_kv_get(self, conn, d):
        return self.kv.get(d["key"])

    async def h_kv_del(self, conn, d):
        return self.kv.pop(d["key"], None) is not None

    # ---- pubsub ----
    async def h_subscribe(self, conn, d):
        self.subscriptions.setdefault(d["channel"], set()).add(conn)
        return True

    async def h_unsubscribe(self, conn, d):
        self.subscriptions.get(d["channel"], set()).discard(conn)
        return True

    async def h_publish(self, conn, d):
        await self.publish(d["channel"], d["data"])
        return True

    async def publish(self, channel: str, data):
        for conn in list(self.subscriptions.get(channel, ())):
            if conn.closed:
                self.subscriptions[channel].discard(conn)
                continue
            try:
                await conn.push(channel, data)
            except Exception:
                self.subscriptions[channel].discard(conn)

    # ---- nodes ----
    async def h_register_node(self, conn, d):
        node_id = d["node_id"]
        info = {
            "node_id": node_id,
            "address": d["address"],  # raylet rpc address
            "resources": d["resources"],  # raw quantized dict
            "hostname": d.get("hostname", ""),
            "is_head": d.get("is_head", False),
            "labels": d.get("labels", {}),
            "state": "ALIVE",
            "start_time": time.time(),
        }
        rejoining = node_id in self.nodes  # redial after a GCS restart
        self.nodes[node_id] = info
        self.available[node_id] = ResourceSet.from_raw(
            d.get("available", d["resources"]))
        self.last_heartbeat[node_id] = time.monotonic()
        conn.context["node_id"] = node_id
        self.node_conns[node_id] = conn
        if not rejoining:
            await self.publish("nodes",
                               {"event": "added", "node": _node_public(info)})
        logger.info("node %s: %s @ %s",
                    "re-registered" if rejoining else "registered",
                    node_id.hex()[:8], d["address"])
        if not rejoining:
            from ray_tpu_torch._private.events import INFO

            self._event(INFO, "NODE_ADDED",
                        f"node {node_id.hex()[:8]} joined @ {d['address']}",
                        node_id=node_id.hex())
        await self._try_schedule_pending_actors()
        await self._retry_pending_pgs()
        return True

    async def h_heartbeat(self, conn, d):
        node_id = d["node_id"]
        self.last_heartbeat[node_id] = time.monotonic()
        if "available" in d and node_id in self.nodes:
            self.available[node_id] = ResourceSet.from_raw(d["available"])
            if any(r["state"] == "PENDING"
                   for r in self.placement_groups.values()):
                await self._retry_pending_pgs()
            # resources freed elsewhere may unblock queued actors —
            # without this, a pending actor waits for a node REGISTRATION
            # that may never come (the deadlock: all slots busy at
            # creation time, freed later)
            if self._pending_actor_queue:
                await self._try_schedule_pending_actors()
        return True

    async def h_get_all_nodes(self, conn, d):
        return [_node_public(info) for info in self.nodes.values()]

    async def _remove_node(self, node_id: bytes, reason: str):
        info = self.nodes.pop(node_id, None)
        self.available.pop(node_id, None)
        self.last_heartbeat.pop(node_id, None)
        self.node_conns.pop(node_id, None)
        if info is None:
            return
        from ray_tpu_torch._private.events import ERROR

        self._event(ERROR, "NODE_REMOVED",
                    f"node {node_id.hex()[:8]} removed: {reason}",
                    node_id=node_id.hex(), reason=reason)
        info["state"] = "DEAD"
        await self.publish("nodes", {"event": "removed",
                                     "node": _node_public(info),
                                     "reason": reason})
        # Fail or restart actors that lived on this node.
        for actor_id, rec in list(self.actors.items()):
            if rec.get("node_id") == node_id and rec["state"] in (ALIVE, PENDING_CREATION):
                await self._on_actor_interrupted(actor_id, f"node died ({reason})")

    async def heartbeat_checker(self):
        cfg = self.config
        timeout = cfg.heartbeat_interval_s * cfg.num_heartbeats_timeout
        while True:
            await asyncio.sleep(cfg.heartbeat_interval_s)
            now = time.monotonic()
            for node_id, last in list(self.last_heartbeat.items()):
                if now - last > timeout:
                    logger.warning("node %s missed heartbeats; declaring dead",
                                   node_id.hex()[:8])
                    await self._remove_node(node_id, reason="heartbeat timeout")

    # ---- jobs ----
    async def h_register_job(self, conn, d):
        # Idempotent by driver-supplied token: a replayed call (reply lost
        # across a GCS restart) returns the already-allocated job instead
        # of minting a ghost.
        token = d.get("token") or ""
        if token:
            for rec in self.jobs.values():
                if rec.get("token") == token:
                    return {"job_id": rec["job_id"]}
        job_id = self.next_job.to_bytes(4, "big")
        self.next_job += 1
        self.jobs[job_id] = {"job_id": job_id, "driver_addr": d.get("driver_addr", ""),
                             "start_time": time.time(), "state": "RUNNING",
                             "token": token}
        return {"job_id": job_id}

    # ---- actors ----
    async def h_register_actor(self, conn, d):
        """Register + schedule an actor creation.

        Protocol parity (reference: gcs_actor_manager.h:125-127): caller
        registers the actor; GCS owns scheduling + lifetime from then on.
        Returns once the actor is scheduled (ALIVE) or queued.
        """
        spec = d["spec"]
        actor_id = spec["actor_id"]
        # Idempotent: a client retrying across a GCS restart (or a lost
        # reply) must not double-register.
        existing_rec = self.actors.get(actor_id)
        if existing_rec is not None:
            return self._actor_public(existing_rec)
        name = spec["actor_creation"].get("name") or ""
        namespace = spec["actor_creation"].get("namespace") or "default"
        if name:
            key = (namespace, name)
            if key in self.named_actors:
                existing = self.named_actors[key]
                if self.actors.get(existing, {}).get("state") != DEAD:
                    raise ValueError(f"actor name {name!r} already taken")
            self.named_actors[key] = actor_id
        rec = {
            "actor_id": actor_id,
            "spec": spec,
            "state": PENDING_CREATION,
            "address": "",
            "task_channel": "",
            "node_id": None,
            "worker_id": None,
            "name": name,
            "namespace": namespace,
            "num_restarts": 0,
            "max_restarts": spec["actor_creation"].get("max_restarts", 0),
            "death_cause": "",
        }
        self.actors[actor_id] = rec
        await self._schedule_actor(actor_id)
        return self._actor_public(rec)

    async def _schedule_actor(self, actor_id: bytes):
        rec = self.actors[actor_id]
        spec = rec["spec"]
        need = ResourceSet.from_raw(spec["resources"])
        # Random-among-feasible policy (reference:
        # gcs_actor_schedule_strategy.h:42 GcsRandomActorScheduleStrategy),
        # honoring the placement-group bundle's node when there is one
        # (its resources are held by the bundle, not the node's pool).
        candidates = []
        if spec.get("pg_id") is not None:
            pg = self.placement_groups.get(spec["pg_id"])
            if pg and pg["state"] == "CREATED":
                idx = spec.get("bundle_index", -1)
                candidates = list({b["node_id"] for b in pg["bundles"]
                                   if idx in (-1, b["bundle_index"])
                                   and b["node_id"] in self.nodes})
        if not candidates:
            candidates = [
                node_id for node_id, avail in self.available.items()
                if need.is_subset_of(avail)
            ]
        # Only ALIVE nodes with a live raylet connection are placeable.
        # A node whose raylet hasn't (re)dialed yet
        # is NOT dead (its actors are alive) — skip it and let the
        # heartbeat checker decide its fate, never _remove_node from
        # here.
        candidates = [
            n for n in candidates
            if (c := self.node_conns.get(n)) is not None and not c.closed
            and self.nodes.get(n, {}).get("state") == "ALIVE"
        ]
        if not candidates:
            if actor_id not in self._pending_actor_queue:
                self._pending_actor_queue.append(actor_id)
            # one-shot logging: the heartbeat-driven retry re-enters here
            # every interval for a stuck actor
            if actor_id not in self._pending_logged:
                self._pending_logged.add(actor_id)
                logger.info("actor %s pending: no feasible node",
                            actor_id.hex()[:8])
                # infeasible-anywhere warning (reference:
                # cluster_task_manager.cc logs infeasible tasks)
                totals = [ResourceSet.from_raw(n["resources"])
                          for n in self.nodes.values()]
                if not any(need.is_subset_of(t) for t in totals):
                    logger.warning(
                        "actor %s requires %s, which exceeds every "
                        "node's TOTAL capacity — it will never schedule "
                        "on the current cluster", actor_id.hex()[:8],
                        need.to_dict())
            return
        self._pending_logged.discard(actor_id)
        node_id = random.choice(candidates)
        conn = self.node_conns[node_id]
        rec["node_id"] = node_id
        try:
            reply = await conn.call("create_actor", {"spec": spec})
        except Exception as e:
            if isinstance(getattr(e, "exc", None), InsufficientResources):
                # The GCS's availability view was stale (lease grants race
                # the heartbeat): that is a scheduling miss, not an actor
                # failure — requeue, and correct the view so the next
                # pass waits for the node's next heartbeat (which carries
                # the true value).
                self.available[node_id] = ResourceSet()
                if actor_id not in self._pending_actor_queue:
                    self._pending_actor_queue.append(actor_id)
                logger.info("actor %s bounced off %s (stale availability);"
                            " requeued", actor_id.hex()[:8],
                            node_id.hex()[:8])
                return
            logger.warning("actor creation on %s failed: %s", node_id.hex()[:8], e)
            await self._on_actor_interrupted(actor_id, f"creation failed: {e}")
            return
        rec["state"] = ALIVE
        rec["address"] = reply["worker_address"]
        # direct task channel of the hosting worker ("" when
        # unavailable: owners then use the rpc address)
        rec["task_channel"] = reply.get("task_channel") or ""
        rec["worker_id"] = reply["worker_id"]
        await self._publish_actor(rec)

    async def _on_actor_interrupted(self, actor_id: bytes, reason: str):
        rec = self.actors.get(actor_id)
        if rec is None or rec["state"] == DEAD:
            return
        restarts_left = (rec["max_restarts"] == -1
                         or rec["num_restarts"] < rec["max_restarts"])
        if restarts_left:
            rec["num_restarts"] += 1
            rec["state"] = RESTARTING
            rec["address"] = ""
            await self._publish_actor(rec)
            await self._schedule_actor(actor_id)
        else:
            rec["state"] = DEAD
            rec["death_cause"] = reason
            rec["address"] = ""
            await self._publish_actor(rec)

    async def _publish_actor(self, rec):
        # Every externally-visible actor transition goes through here, so
        # it is also the event point.
        if rec["state"] in (DEAD, RESTARTING):
            from ray_tpu_torch._private.events import ERROR, WARNING

            self._event(
                ERROR if rec["state"] == DEAD else WARNING,
                "ACTOR_DEAD" if rec["state"] == DEAD else "ACTOR_RESTART",
                f"actor {rec['actor_id'].hex()[:8]} "
                f"({rec['spec']['name']}) -> {rec['state']}: "
                f"{rec.get('death_cause') or 'restarting'}",
                actor_id=rec["actor_id"].hex(),
                class_name=rec["spec"]["name"])
        await self.publish(f"actor:{rec['actor_id'].hex()}", self._actor_public(rec))

    def _actor_public(self, rec):
        return {
            "actor_id": rec["actor_id"],
            "state": rec["state"],
            "address": rec["address"],
            "node_id": rec["node_id"],
            "name": rec["name"],
            "namespace": rec["namespace"],
            "num_restarts": rec["num_restarts"],
            "max_restarts": rec["max_restarts"],
            "death_cause": rec["death_cause"],
            "task_channel": (rec.get("task_channel", "")
                             if rec["state"] == ALIVE else ""),
            "class_name": rec["spec"]["name"],
        }

    async def h_get_actor(self, conn, d):
        rec = self.actors.get(d["actor_id"])
        return self._actor_public(rec) if rec else None

    async def h_get_named_actor(self, conn, d):
        key = (d.get("namespace") or "default", d["name"])
        actor_id = self.named_actors.get(key)
        if actor_id is None:
            return None
        return self._actor_public(self.actors[actor_id])

    async def h_kill_actor(self, conn, d):
        actor_id = d["actor_id"]
        rec = self.actors.get(actor_id)
        if rec is None:
            return False
        no_restart = d.get("no_restart", True)
        if no_restart:
            rec["max_restarts"] = rec["num_restarts"]
        node_conn = self.node_conns.get(rec.get("node_id"))
        if node_conn is not None and rec["state"] == ALIVE:
            try:
                await node_conn.call("kill_actor_worker",
                                     {"worker_id": rec["worker_id"],
                                      "actor_id": actor_id})
            except Exception:
                pass
        if no_restart:
            rec["state"] = DEAD
            rec["death_cause"] = "killed via kill()"
            rec["address"] = ""
            await self._publish_actor(rec)
        return True

    async def h_report_worker_failure(self, conn, d):
        """Raylet reports a dead worker, listing actors it hosted."""
        for actor_id in d.get("actor_ids", []):
            rec = self.actors.get(actor_id)
            if rec is not None and rec["state"] in (ALIVE, RESTARTING):
                if d.get("intended", False):
                    rec["state"] = DEAD
                    rec["death_cause"] = "actor exited"
                    rec["address"] = ""
                    await self._publish_actor(rec)
                else:
                    await self._on_actor_interrupted(actor_id, "worker died")
        return True

    async def _try_schedule_pending_actors(self):
        queue, self._pending_actor_queue = self._pending_actor_queue, []
        for actor_id in queue:
            if self.actors.get(actor_id, {}).get("state") != DEAD:
                await self._schedule_actor(actor_id)

    # ---- placement groups ----
    async def h_create_placement_group(self, conn, d):
        """Two-phase bundle reservation across raylets (reference:
        gcs_placement_group_scheduler.h:49; strategies :133-160). A group
        that does not fit now stays PENDING and is retried as resources
        free and nodes join; STRICT_SPREAD wanting more nodes than the
        cluster has goes INFEASIBLE (typed at the client's ready())."""
        pg_id = d["pg_id"]
        # idempotent: a replayed call must not reset a CREATED group
        if pg_id not in self.placement_groups:
            self.placement_groups[pg_id] = {
                "pg_id": pg_id, "bundles": [dict(b) for b in d["bundles"]],
                "strategy": d.get("strategy", "PACK"), "state": "PENDING",
                "name": d.get("name", ""),
            }
        return {"state": await self._try_create_pg(pg_id)}

    async def _retry_pending_pgs(self):
        for pg_id, rec in list(self.placement_groups.items()):
            # INFEASIBLE retries too: a joining node can make a too-wide
            # STRICT_SPREAD placeable again
            if rec["state"] in ("PENDING", "INFEASIBLE"):
                await self._try_create_pg(pg_id)

    async def _try_create_pg(self, pg_id) -> str:
        rec = self.placement_groups.get(pg_id)
        if rec is None:
            return "REMOVED"
        if rec["state"] == "CREATED":
            return "CREATED"
        # in-flight guard: while one two-phase attempt awaits the raylets,
        # a concurrent retry (heartbeat, node join) must not prepare the
        # bundles a second time
        if rec.get("creating"):
            return "PENDING"
        rec["creating"] = True
        try:
            return await self._do_create_pg(pg_id, rec)
        finally:
            rec["creating"] = False

    async def _do_create_pg(self, pg_id, rec) -> str:
        bundles = rec["bundles"]
        strategy = rec["strategy"]
        placement = self._place_bundles(bundles, strategy)
        if placement is None:
            alive = sum(1 for n in self.node_conns.values()
                        if n is not None and not n.closed)
            if strategy == "STRICT_SPREAD" and len(bundles) > alive:
                detail = (f"{len(bundles)} STRICT_SPREAD bundles "
                          f"need distinct nodes; fleet has {alive}")
                if (rec["state"] == "INFEASIBLE"
                        and rec.get("detail") == detail):
                    return "INFEASIBLE"
                rec["state"] = "INFEASIBLE"
                rec["detail"] = detail
                await self.publish(f"pg:{pg_id.hex()}", _pg_public(rec))
                return "INFEASIBLE"
            if rec["state"] == "INFEASIBLE":
                # structurally placeable again but not yet reserved
                rec["state"] = "PENDING"
                rec.pop("detail", None)
                await self.publish(f"pg:{pg_id.hex()}", _pg_public(rec))
            return "PENDING"
        # prepare
        prepared = []
        for idx, node_id in placement.items():
            conn_n = self.node_conns.get(node_id)
            try:
                if not await conn_n.call("prepare_bundle", {
                        "pg_id": pg_id, "bundle_index": idx,
                        "resources": bundles[idx]["resources"]}):
                    break
                prepared.append((idx, node_id))
            except Exception:
                break
        if len(prepared) < len(placement):
            for idx, node_id in prepared:
                await self._bundle_call(node_id, "cancel_bundle", pg_id, idx)
            return "PENDING"
        # commit
        committed = []
        for idx, node_id in placement.items():
            conn_n = self.node_conns.get(node_id)
            try:
                if conn_n is None or conn_n.closed:
                    raise ConnectionError("node connection lost")
                await conn_n.call("commit_bundle",
                                  {"pg_id": pg_id, "bundle_index": idx})
                committed.append(idx)
            except Exception:
                # a node died between prepare and commit: unwind every
                # bundle and stay PENDING for the next retry
                for jdx, jnode in placement.items():
                    await self._bundle_call(
                        jnode, "return_bundle" if jdx in committed
                        else "cancel_bundle", pg_id, jdx)
                return "PENDING"
        if self.placement_groups.get(pg_id) is not rec:
            # removed while the two phases were in flight
            for idx, node_id in placement.items():
                await self._bundle_call(node_id, "return_bundle", pg_id, idx)
            return "REMOVED"
        rec["state"] = "CREATED"
        rec.pop("detail", None)
        rec["bundles"] = [
            {"bundle_index": i, "resources": bundles[i]["resources"],
             "node_id": placement[i]}
            for i in range(len(bundles))]
        # wake PlacementGroup.ready() waiters with the whole record
        await self.publish(f"pg:{pg_id.hex()}", _pg_public(rec))
        return "CREATED"

    async def _bundle_call(self, node_id, method: str, pg_id, idx: int):
        """cancel_bundle / return_bundle on a node; a lost node has
        nothing left to give back."""
        conn_n = self.node_conns.get(node_id)
        if conn_n is None or conn_n.closed:
            return
        try:
            await conn_n.call(method, {"pg_id": pg_id, "bundle_index": idx})
        except Exception:
            pass

    def _place_bundles(self, bundles, strategy):
        """Map bundle_index -> node_id, or None if infeasible now
        (reference: gcs/server.py _place_bundles; strategies:
        gcs_placement_group_scheduler.h:133-160). ICI_RING orders
        consecutive ranks onto ICI neighbours in the reference; the port
        registers no topology coords, so it places as PACK, counted by
        `gcs.placement_topology_fallbacks_total`, as the reference does
        for nodes without coords."""
        if strategy == "ICI_RING":
            placed = self._place_bundles(bundles, "PACK")
            if placed is not None:
                # count only a placement: a capacity-starved group stays
                # PENDING and re-enters here on every retry
                M_TOPO_FALLBACKS.inc()
            return placed
        avail = {nid: r.copy() for nid, r in self.available.items()
                 if self.nodes.get(nid, {}).get("state") == "ALIVE"}
        node_ids = list(avail)
        if not node_ids:
            return None
        needs = [ResourceSet.from_raw(b["resources"]) for b in bundles]
        placement: dict[int, bytes] = {}

        def fits(node_id, res: ResourceSet):
            return res.is_subset_of(avail[node_id])

        if strategy in ("PACK", "STRICT_PACK"):
            # every bundle on one node first
            for node_id in sorted(node_ids,
                                  key=lambda n: -avail[n].get("CPU")):
                trial = avail[node_id].copy()
                ok = True
                for need in needs:
                    if not need.is_subset_of(trial):
                        ok = False
                        break
                    trial.subtract(need)
                if ok:
                    return {i: node_id for i in range(len(bundles))}
            if strategy == "STRICT_PACK":
                return None
            # PACK falls back to spread-fit
        if strategy == "STRICT_SPREAD":
            if len(bundles) > len(node_ids):
                return None
            used = set()
            for i, need in enumerate(needs):
                cands = [n for n in node_ids
                         if n not in used and fits(n, need)]
                if not cands:
                    return None
                node = random.choice(cands)
                used.add(node)
                avail[node].subtract(need)
                placement[i] = node
            return placement
        # PACK fallback / SPREAD: the least-used node that fits
        order = node_ids if strategy != "SPREAD" else random.sample(
            node_ids, len(node_ids))
        for i, need in enumerate(needs):
            cands = [n for n in order if fits(n, need)]
            if not cands:
                return None
            if strategy == "SPREAD":
                node = min(cands, key=lambda n: sum(
                    1 for p in placement.values() if p == n))
            else:
                node = cands[0]
            avail[node].subtract(need)
            placement[i] = node
        return placement

    async def h_remove_placement_group(self, conn, d):
        rec = self.placement_groups.pop(d["pg_id"], None)
        if rec is None:
            return False
        await self.publish(f"pg:{d['pg_id'].hex()}",
                           {"pg_id": d["pg_id"], "state": "REMOVED"})
        if rec["state"] == "CREATED":
            for b in rec["bundles"]:
                await self._bundle_call(b["node_id"], "return_bundle",
                                        d["pg_id"], b["bundle_index"])
        return True

    async def h_get_placement_group(self, conn, d):
        rec = self.placement_groups.get(d["pg_id"])
        return _pg_public(rec) if rec else None

    async def h_get_named_placement_group(self, conn, d):
        for rec in self.placement_groups.values():
            if rec.get("name") and rec["name"] == d["name"]:
                return _pg_public(rec)
        return None

    async def h_list_placement_groups(self, conn, d):
        return [_pg_public(r) for r in self.placement_groups.values()]

    # ---- events ----
    def _event(self, severity: str, label: str, message: str, **fields):
        """GCS-originated structured event (the GCS's event log file)."""
        from ray_tpu_torch._private import events

        events.report_event(severity, label, message, **fields)

    # ---- lifecycle ----
    async def _on_disconnect(self, conn):
        for subs in self.subscriptions.values():
            subs.discard(conn)
        node_id = conn.context.get("node_id")
        if node_id is not None and node_id in self.nodes:
            # Keep the node until heartbeats actually time out? No: a closed
            # raylet connection means the process died — remove immediately.
            await self._remove_node(node_id, reason="raylet disconnected")

    async def run(self, port: int, ready_file: str | None = None,
                  uds_dir: str | None = None):
        cfg = get_config()
        actual = await self.server.start_tcp(host=cfg.bind_host, port=port,
                                             uds_dir=uds_dir)
        asyncio.create_task(self.heartbeat_checker())
        logger.info("GCS listening on %s:%d (advertised %s)",
                    cfg.bind_host, actual, cfg.node_ip_address)
        if ready_file:
            tmp = ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(actual))
            os.rename(tmp, ready_file)
        while True:
            await asyncio.sleep(3600)


def _pg_public(rec):
    return {k: v for k, v in rec.items() if k != "creating"}


def _node_public(info):
    return {k: info.get(k) for k in (
        "node_id", "address", "resources", "hostname", "is_head", "state",
        "labels")}

def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--log-file", default=None)
    parser.add_argument("--uds-dir", default=None,
                        help="serve a sibling UDS listener here (same-node "
                             "clients skip the loopback-TCP tax)")
    args = parser.parse_args()
    from ray_tpu_torch._private.log_utils import setup_process_logging

    setup_process_logging("gcs_server", args.log_file)
    from ray_tpu_torch._private.events import init_events

    init_events("GCS", "gcs",
                os.path.dirname(args.log_file) if args.log_file else None)
    set_config(Config.load())
    server = GcsServer(get_config())
    asyncio.run(server.run(args.port, args.ready_file,
                           uds_dir=args.uds_dir))


if __name__ == "__main__":
    main()
