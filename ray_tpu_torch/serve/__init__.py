"""ray_tpu_torch.serve — actor-based model serving with dynamic
micro-batching; port of ray_tpu.serve (the Serve equivalent; reference:
python/ray/serve/). The router groups queries to max_batch_size before
one replica RPC. Production tier: bounded admission queues with typed
load shedding, zero-copy large payloads through the object store,
sharded replica GROUPS whose forward pass is collective-backed
(serve/replica_group.py), and a STREAMING inference tier — token-level
continuous batching inside the replica/gang leader, a paged
shard-resident KV-cache (on the card with kv_backend="torch"), SSE
end-to-end, and session-affinity routing (serve/engine.py,
serve/kv_cache.py, serve/streaming.py)."""

from ray_tpu_torch.exceptions import (ReplicaGroupDied, SequenceAborted,
                                      ServeOverloadedError)
from ray_tpu_torch.serve.api import Client, connect, shutdown, start
from ray_tpu_torch.serve.config import BackendConfig
from ray_tpu_torch.serve.engine import ShardedTokenLM
from ray_tpu_torch.serve.payload import LargePayload
from ray_tpu_torch.serve.replica import accept_batch
from ray_tpu_torch.serve.replica_group import ShardedMLP
from ray_tpu_torch.serve.router import ServeHandle

__all__ = [
    "BackendConfig",
    "Client",
    "LargePayload",
    "ReplicaGroupDied",
    "SequenceAborted",
    "ServeHandle",
    "ServeOverloadedError",
    "ShardedMLP",
    "ShardedTokenLM",
    "accept_batch",
    "connect",
    "shutdown",
    "start",
]
