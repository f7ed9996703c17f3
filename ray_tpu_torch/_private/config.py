"""The runtime's settings (the reference's RAY_CONFIG registry,
src/ray/common/ray_config_def.h).

One setting is the caller's: `object_store_memory`, which
`ray_tpu_torch.init(object_store_memory=)` sets. The driver passes it to
every process it spawns through the RAY_TPU_TORCH_SYSTEM_CONFIG env var
(JSON). Every other setting is a constant of the class.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, ClassVar

_ENV_VAR = "RAY_TPU_TORCH_SYSTEM_CONFIG"


@dataclasses.dataclass
class Config:
    # Shared-memory store capacity per node (bytes).
    object_store_memory: int = 2 * 1024**3

    # --- object plane ---
    # Objects at or below this size are passed inline through the owner's
    # in-process memory store instead of the shared-memory store
    # (reference: ray_config_def.h max_direct_call_object_size=100KB).
    max_direct_call_object_size: ClassVar[int] = 100 * 1024
    # Spill when store usage exceeds this fraction.
    object_spilling_threshold: ClassVar[float] = 0.8

    # --- control plane ---
    # Heartbeat cadence + miss tolerance (reference: raylet 100ms beats,
    # declared dead after 300 misses; we beat less often, die faster).
    heartbeat_interval_s: ClassVar[float] = 0.5
    num_heartbeats_timeout: ClassVar[int] = 20
    # Clients redial a lost GCS connection for this long before giving up
    # (reference: gcs_rpc_server_reconnect_timeout_s).
    gcs_reconnect_timeout_s: ClassVar[float] = 30.0

    # --- scheduling ---
    # Max in-flight lease-reused tasks pushed to one worker
    # (reference: direct_task_transport.h max_tasks_in_flight_per_worker).
    max_tasks_in_flight_per_worker: ClassVar[int] = 10
    # Lease pre-warm: max leases asked for in one batched
    # request_worker_lease RPC.
    max_lease_batch: ClassVar[int] = 4
    # While a lease is working a key, extra lease requests are SOFT
    # (granted from idle workers only, never spawning); they escalate to
    # hard once the queue has waited this long.
    lease_escalation_s: ClassVar[float] = 1.0
    # Idle leases are returned to the raylet after this grace.
    lease_idle_grace_s: ClassVar[float] = 0.25
    # Initial worker-pool size per node; -1 = min(num_cpus, 8).
    num_initial_workers: ClassVar[int] = -1
    # Hard cap on worker processes per node (0 = num_cpus).
    max_workers_per_node: ClassVar[int] = 0
    worker_register_timeout_s: ClassVar[float] = 30.0

    # --- fault tolerance ---
    task_max_retries: ClassVar[int] = 3

    # --- training ---
    # Batches each train worker keeps in flight against its DatasetShard
    # ingest actor (train/ingest.py). 2 = double buffering: the next batch
    # crosses the object store while the current step computes.
    train_ingest_prefetch_depth: ClassVar[int] = 2

    # Address the node's services listen on: loopback, one machine.
    node_ip_address: ClassVar[str] = "127.0.0.1"
    bind_host: ClassVar[str] = "127.0.0.1"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def load(cls, overrides: dict[str, Any] | None = None) -> "Config":
        merged: dict[str, Any] = {}
        env = os.environ.get(_ENV_VAR)
        if env:
            merged.update(json.loads(env))
        merged.update(overrides or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(merged) - known
        if unknown:
            raise ValueError(f"Unknown system config key: {sorted(unknown)}")
        return cls(**merged)

    def child_env(self) -> dict[str, str]:
        """Env vars to propagate this config to spawned processes."""
        return {_ENV_VAR: self.to_json()}


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.load()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
