"""Sharded model serving: replica GROUPS (the serving analogue of the Ray
paper's distributed actors); port of ray_tpu/serve/replica_group.py.

A deployment with `num_shards=N` makes each "replica" a gang of N
member actors. Every member holds one Megatron-partitioned shard of the
model (ColumnParallel W1 -> activation -> RowParallel W2, slices cut
with `parallel.sharding.column_shard/row_shard`); the gang is joined in
one collective group (`ray_tpu_torch.collective`, backend "host") at
bootstrap. The router keeps talking to a single handle — the group
LEADER (rank 0): `handle_batch` fans the batch to the followers (large
bodies travel as LargePayload markers, so an N-way fan-out is N reads of
one stored object, not N pickled copies), every rank computes its
partial forward, and one allreduce(SUM) recovers the full output, which
only the leader returns. The partials are numpy, so the allreduce rides
the group's host tiers (shm/ring); members sharing one card never go to
NCCL, which refuses two ranks on one card.

Failure domains: any member death (or a member's forward error) starves
the group allreduce -> every rank times out within the group timeout ->
the leader raises typed `ReplicaGroupDied` to all in-flight callers and
the controller gang-restarts the WHOLE group (fresh pg-backed gang,
fresh collective group name — a half-dead gang is never reused).

Gang scheduling: members are placed via a placement group (the GCS's
atomic 2PC bundle reservation = the gang lease acquisition) with the
reference's ICI_RING strategy, which the port places as PACK (it has no
ICI coordinates, `util/placement_group.py`); the group votes its tier
per op. Each bundle holds `num_cpus_per_shard` CPU and, where set,
`num_gpus_per_shard` of a card, which the member leases (a "torch" KV
arena lives on it).
"""

from __future__ import annotations

import inspect
import time

import numpy as np

import cloudpickle

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import stats as _stats
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch.collective.collective import CollectiveActorMixin
from ray_tpu_torch.serve import payload as _payload
from ray_tpu_torch.serve.engine import StreamingEngineHost

M_GROUP_EXEC_S = _stats.Histogram(
    "serve.group_exec_s", _stats.LATENCY_BOUNDARIES_S,
    "sharded forward per batch, leader side: fan-out + partial + "
    "allreduce (pairs with serve.replica_exec_s for scalar replicas)")


# ---------------------------------------------------------------------------
# reference partitioned model (the Megatron MLP: a host gang computes in
# numpy and the allreduce rides the host tiers)
# ---------------------------------------------------------------------------


class ShardedMLP:
    """y = act(x @ W1) @ W2 with W1 column-parallel and W2 row-parallel.

    Deployed unsharded it is a plain callable (the bit-exactness
    reference); under a replica group each member calls `shard(rank, n)`
    once at init and `__call__` then returns the PARTIAL output the
    group sums. With integer-valued f32 weights/inputs the sharded sum
    is bit-exact with the unsharded matmul (all partials exactly
    representable), which is how the test pins the forward pass."""

    def __init__(self, w1, w2, activation: str = "relu"):
        self.w1 = np.asarray(w1, dtype=np.float32)
        self.w2 = np.asarray(w2, dtype=np.float32)
        if activation not in ("relu", "identity"):
            raise ValueError(f"unsupported activation {activation!r}")
        self.activation = activation
        self._shard = None  # (rank, num_shards) once sharded

    def shard(self, rank: int, num_shards: int) -> "ShardedMLP":
        from ray_tpu_torch.parallel.sharding import column_shard, row_shard

        self.w1 = column_shard(self.w1, rank, num_shards)
        self.w2 = row_shard(self.w2, rank, num_shards)
        self._shard = (rank, num_shards)
        return self

    def __call__(self, requests: list):
        x = np.asarray(
            [np.frombuffer(r, dtype=np.float32)
             if isinstance(r, (bytes, bytearray)) else r
             for r in requests], dtype=np.float32)
        h = x @ self.w1
        if self.activation == "relu":
            h = np.maximum(h, 0.0)
        return h @ self.w2


# ---------------------------------------------------------------------------
# group member actor
# ---------------------------------------------------------------------------


class ReplicaGroupMember(CollectiveActorMixin, StreamingEngineHost):
    """One shard of a replica group. Rank 0 is the LEADER: it is the
    handle the router dispatches to; `handle_batch` there drives the
    collective forward. Ranks 1..N-1 only ever see `shard_exec` pushes
    from their leader (actor-call ordering from one caller keeps every
    rank's op sequence aligned, so the allreduces pair up without a
    sequence protocol).

    Streaming backends (`streaming=True`) host the continuous-batching
    decode engine instead: the LEADER runs the scheduler + decode loop
    (started in set_peers, once the gang exists), followers run mirror
    engines driven one `decode_step_exec` per step — the Megatron gang
    forward becomes one *step*, not the whole request."""

    def __init__(self, pickled_callable: bytes, init_args: tuple,
                 user_config: dict | None, backend: str, group_name: str,
                 world_size: int, rank: int,
                 large_payload_threshold: int = 0,
                 group_timeout_s: float = 10.0,
                 config: dict | None = None):
        target = cloudpickle.loads(pickled_callable)
        inst = target(*init_args) if inspect.isclass(target) else target
        shard = getattr(inst, "shard", None)
        if not callable(shard):
            raise TypeError(
                f"num_shards={world_size} backend {backend!r} requires a "
                f"callable implementing shard(rank, num_shards) that "
                f"returns the per-shard partial-forward callable; "
                f"{type(inst).__name__} does not")
        self._callable = shard(rank, world_size) or inst
        if user_config is not None:
            reconfigure = getattr(self._callable, "reconfigure", None)
            if reconfigure:
                reconfigure(user_config)
        self._backend = backend
        self._group_name = group_name
        self._world = world_size
        self._rank = rank
        self._threshold = large_payload_threshold
        self._group_timeout_s = group_timeout_s
        self._config = dict(config or {})
        self._streaming = bool(self._config.get("streaming"))
        self._peers: list = []
        self._batches_handled = 0
        self._last_batch_at = 0.0
        if self._streaming and rank > 0:
            # follower mirror: same KV shard + model, no scheduler —
            # the leader drives it one decode_step_exec per step
            self._start_engine(self._callable, self._config, backend,
                               allreduce=self._group_allreduce,
                               driver=False)

    def _group_allreduce(self, arr):
        from ray_tpu_torch.collective import collective as col

        return col.allreduce(arr, self._group_name)

    # -- controller wiring ----------------------------------------------

    def set_peers(self, peers: list):
        """Leader only: handles of ranks 1..N-1, set once the collective
        group is bootstrapped. For streaming backends this is also where
        the decode engine starts — the gang is whole from here on."""
        self._peers = list(peers)
        if self._streaming and self._engine is None:
            self._start_engine(self._callable, self._config,
                               self._backend,
                               allreduce=self._group_allreduce,
                               peers=self._peers, driver=True)
        return True

    def decode_step_exec(self, plan: dict):
        """Follower entry, one call per decode step: replay the
        leader's step plan on this rank's KV shard (joins the step's
        allreduce; the plan keeps every rank's state identical)."""
        return self._require_engine().apply_plan(plan)

    def ping(self):
        return "pong"

    def reconfigure(self, user_config: dict):
        fn = getattr(self._callable, "reconfigure", None)
        if fn:
            fn(user_config)
        return True

    def arm_failpoint(self, name: str, action: str, **kw):
        """Test hook: arm a failpoint in THIS member's process (the
        chaos sweep picks one victim per seed; env/cluster arming would
        fire in every member at the same nth)."""
        _fp.arm(name, action, **kw)
        return True

    # -- forward ---------------------------------------------------------

    def _forward_partial(self, requests: list):
        """Unwrap zero-copy markers, fire the chaos seam, compute this
        shard's partial output."""
        local = [_payload.unwrap(r) for r in requests]
        if _fp.ARMED:
            # the member-kill seam: `exit` here is a shard dying
            # mid-forward, leaving every survivor starved in allreduce
            _fp.fire_strict("serve.group_forward")
        return local, np.asarray(self._callable(local))

    def shard_exec(self, requests: list):
        """Follower entry: partial forward + join the group allreduce
        (the reduced result is discarded here — only the leader
        answers)."""
        from ray_tpu_torch.collective import collective as col

        _, partial = self._forward_partial(requests)
        col.allreduce(partial, self._group_name)
        self._batches_handled += 1
        self._last_batch_at = time.time()
        return True

    def handle_batch(self, requests: list):
        """Leader entry (same contract as Replica.handle_batch: one RPC
        per batch, per-request results split by num_returns)."""
        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch.collective import collective as col

        if self._streaming:
            raise RuntimeError(
                "streaming backend: use the stream API "
                "(handle.stream(...) / SSE through the proxy), not "
                "request/response dispatch")
        start = time.time()
        # own partial FIRST: a leader-side user error (bad input) raises
        # plainly before any follower was involved — no gang restart
        local, partial = self._forward_partial(requests)
        refs = [p.shard_exec.remote(requests) for p in self._peers]
        try:
            reduced = col.allreduce(partial, self._group_name)
        except BaseException as e:
            # a member died or errored before its allreduce: starved
            # group -> TimeoutError within the group timeout. Name the
            # follower failure when one already surfaced.
            raise exc.ReplicaGroupDied(
                self._backend, self._group_name,
                self._peer_failure(refs) or f"{type(e).__name__}: {e}"
            ) from e
        finally:
            M_GROUP_EXEC_S.observe(time.time() - start,
                                   exemplar=_tracing.current_id())
            self._batches_handled += 1
            self._last_batch_at = time.time()
        failure = self._peer_failure(refs, wait_s=self._group_timeout_s)
        if failure:
            # follower completed its allreduce but failed afterwards (or
            # its reply was lost): the group's op streams may be skewed —
            # surface typed and let the controller restart the gang
            raise exc.ReplicaGroupDied(self._backend, self._group_name,
                                       failure)
        out = self._finalize(reduced, local)
        if self._threshold:
            # wrap responses only for zero-copy-protocol callers (the
            # HTTP proxy sends LargePayload markers; plain handle
            # callers get values)
            out = [_payload.wrap(r, self._threshold)
                   if isinstance(req, _payload.LargePayload) else r
                   for r, req in zip(out, requests)]
        return tuple(out) if len(out) > 1 else out[0]

    def _finalize(self, reduced, requests: list) -> list:
        fin = getattr(self._callable, "finalize", None)
        if callable(fin):
            out = list(fin(reduced, requests))
        else:
            out = [reduced[i] for i in range(len(requests))]
        if len(out) != len(requests):
            raise ValueError(
                f"sharded callable produced {len(out)} results for "
                f"{len(requests)} requests")
        return out

    def _peer_failure(self, refs, wait_s: float = 0.0) -> str:
        """First follower failure, if any surfaced (non-blocking probe by
        default; bounded wait when the leader's op already completed and
        follower replies are owed)."""
        import ray_tpu_torch

        if not refs:
            return ""
        try:
            done, pending = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                               timeout=wait_s)
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        if wait_s and pending:
            return (f"{len(pending)} follower(s) never completed the "
                    f"batch within {wait_s}s")
        for ref in done:
            try:
                ray_tpu_torch.get(ref, timeout=1.0)
            except BaseException as e:
                return f"follower failed: {type(e).__name__}: {e}"
        return ""

# ---------------------------------------------------------------------------
# gang bootstrap / teardown (controller-side helpers; run inside the
# ServeController actor's worker process)
# ---------------------------------------------------------------------------


def spawn_replica_group(backend: str, pickled_callable: bytes,
                        init_args: tuple, config: dict,
                        pg=None) -> dict:
    """Gang-schedule one replica group: reserve an N-bundle placement
    group (atomic 2PC — the gang lease acquisition: all members get
    resources or none do), spawn one member per bundle, bootstrap the
    collective group across them, wire the leader's peer handles.
    Returns the gang record the controller tracks. On ANY bootstrap
    failure every spawned member and the reservation are torn down —
    a half-bootstrapped gang never leaks."""
    import uuid

    import ray_tpu_torch
    from ray_tpu_torch.collective.collective import create_collective_group
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    n = int(config["num_shards"])
    gang_id = uuid.uuid4().hex[:8]
    group_name = f"serve:{backend}:{gang_id}"
    timeout_s = float(config.get("shard_group_timeout_s") or 10.0)
    own_pg = pg is None
    gpus = float(config.get("num_gpus_per_shard") or 0.0)
    if own_pg:
        # ICI_RING, as the reference reserves (placed as PACK here). The
        # reference's BackendConfig has no placement_cost_model field,
        # so the cost model is "" unless a caller's config dict names
        # one, which the port's placement_group refuses (ValueError).
        bundle = {"CPU": float(config.get("num_cpus_per_shard") or 0.001)}
        if gpus:
            bundle["GPU"] = gpus
        pg = placement_group(
            [dict(bundle) for _ in range(n)],
            strategy="ICI_RING",
            cost_model=config.get("placement_cost_model") or "",
            name=f"serve-gang-{backend}-{gang_id}")
    members: list = []
    try:
        if not pg.ready(timeout=30.0):
            raise TimeoutError(
                f"gang reservation for backend {backend!r} "
                f"({n} bundles) not placeable within 30s")
        member_cls = ray_tpu_torch.remote(ReplicaGroupMember)
        for rank in range(n):
            members.append(member_cls.options(
                num_gpus=gpus or None,
                placement_group=pg,
                placement_group_bundle_index=rank,
            ).remote(
                pickled_callable, init_args, config.get("user_config"),
                backend, group_name, n, rank,
                int(config.get("large_payload_threshold") or 0),
                timeout_s, dict(config)))
        create_collective_group(
            members, n, list(range(n)), backend="host",
            group_name=group_name, timeout=timeout_s,
            transport=config.get("shard_transport") or "auto",
            placement_group=pg)
        ray_tpu_torch.get(members[0].set_peers.remote(members[1:]), timeout=60)
    except BaseException:
        for m in members:
            try:
                ray_tpu_torch.kill(m)
            except Exception:
                pass
        if own_pg:
            try:
                remove_placement_group(pg)
            except Exception:
                pass
        raise
    return {"leader": members[0], "members": members, "pg": pg,
            "group_name": group_name, "gang_id": gang_id,
            "spawned_at": time.time()}


def kill_replica_group(gang: dict, remove_pg: bool = True) -> None:
    """Tear one gang down: hard-kill every member (collective segments
    are unlinked by the survivors'/owner's close paths) and release the
    reservation."""
    import ray_tpu_torch
    from ray_tpu_torch.util.placement_group import remove_placement_group

    for m in gang.get("members") or []:
        try:
            ray_tpu_torch.kill(m)
        except Exception:
            pass
    if remove_pg and gang.get("pg") is not None:
        try:
            remove_placement_group(gang["pg"])
        except Exception:
            pass
