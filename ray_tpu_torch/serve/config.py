"""Backend configuration; port of ray_tpu/serve/config.py (reference:
python/ray/serve/config.py BackendConfig — num_replicas, max_batch_size,
batch_wait_timeout, max_concurrent_queries; extended with the
production-tier knobs: bounded admission queues, zero-copy payload
cutover, and sharded replica groups).

Departures from ray_tpu's BackendConfig:
- `kv_backend` admits "numpy" (the default) or "torch", whose page arena
  is a tensor on the card (serve/kv_cache.py), in place of "jax".
- `num_gpus_per_shard`: the share of a card each replica (or gang
  member) leases. The port's workers see only the cards of their lease
  (the raylet sets CUDA_VISIBLE_DEVICES), while JAX sees the TPU from
  any process, so a "torch" streaming backend must lease one: it
  requires num_gpus_per_shard > 0. Members sharing a card lease 1/k of
  it each. A numpy backend stays CPU-only (0, the default)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth autoscaling (reference: python/ray/serve/
    autoscaling_policy.py:137 calculate_desired_num_replicas — scale so
    each replica carries ~target_queued queued queries)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_queued: float = 2.0       # queued queries per replica
    downscale_delay_s: float = 5.0   # hold-down before shrinking
    # -- KV-aware scaling (streaming backends) ---------------------------
    # The tick also sizes the fleet by KV-page pressure: replicas polled
    # for pages_in_use/pages_total, a short linear prediction over
    # kv_horizon_s extrapolates prefill load, and the fleet grows so the
    # predicted occupancy stays under kv_target_util per replica.
    # desired = max(queue_desired, kv_desired). 0 disables.
    kv_target_util: float = 0.8      # predicted pool occupancy ceiling
    kv_horizon_s: float = 10.0       # prediction lookahead

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BackendConfig:
    num_replicas: int = 1
    max_batch_size: int | None = None     # None = no batching
    batch_wait_timeout: float = 0.01      # s to wait filling a batch
    max_concurrent_queries: int = 8       # in-flight cap per replica
    user_config: dict | None = None
    autoscaling: dict | None = None       # AutoscalingConfig.to_dict()
    # -- admission control (load shedding / backpressure) ---------------
    # Bounded router queue per endpoint: queries arriving when `queued
    # >= max_queued_requests` are refused with a typed
    # ServeOverloadedError (HTTP 503 + Retry-After) instead of growing
    # an unbounded backlog whose latency collapses under overload.
    # None = unbounded (legacy behavior).
    max_queued_requests: int | None = None
    # Hint callers receive with a shed (Retry-After seconds).
    overload_retry_after_s: float = 1.0
    # -- zero-copy payloads ---------------------------------------------
    # Request/response bodies at or over this many bytes ride the object
    # store as ObjectRefs instead of being pickled through
    # the router. 0/None = always pickle (legacy behavior).
    large_payload_threshold: int = 1 << 20
    # -- sharded replica groups -----------------------------------------
    # num_shards > 1 turns each replica into a GANG of num_shards
    # member actors holding a Megatron-partitioned model; the forward
    # pass is collective-backed (see serve/replica_group.py).
    num_shards: int = 1
    shard_group_timeout_s: float = 10.0   # collective op deadline
    shard_transport: str = "auto"         # pin shm/ring/device, or auto
    num_cpus_per_shard: float = 0.001     # gang bundle reservation size
    num_gpus_per_shard: float = 0.0       # card share a replica/member leases
    # -- streaming inference (continuous batching / paged KV-cache) -----
    # streaming=True hosts a token-level decode engine in each replica
    # (the gang LEADER for num_shards>1): requests are admitted into the
    # running batch between decode steps, finished sequences retire
    # early, and responses stream token-by-token (SSE over HTTP). The
    # model must speak the decode protocol (see engine.ShardedTokenLM).
    streaming: bool = False
    max_decode_batch: int = 8             # running sequences per engine
    max_waiting_sequences: int = 32       # admission bound (typed shed)
    kv_page_size: int = 16                # tokens per KV page
    kv_pages_total: int = 512             # page pool size per rank
    kv_backend: str = "numpy"             # or "torch" (arena on the card)
    session_cache_max: int = 32           # retained session KV tables
    stream_poll_s: float = 2.0            # router long-poll slice
    # -- KV-cache economy (cross-session prefix sharing) ----------------
    # prefix_sharing=True builds a radix tree over full KV pages:
    # admissions adopt the longest indexed page-aligned prefix
    # (refcounted, copy-on-write at divergence) and prefill only the
    # tail. The router mirrors the same page hashes to route new
    # sessions to the replica already holding their prefix.
    prefix_sharing: bool = True
    prefix_index_max_nodes: int = 256     # prefix-tree size per replica
    kv_warm_pages: int = 64               # pages pulled at scale-up (0=off)
    router_session_cap: int = 4096        # sticky-session LRU bound
    router_prefix_cap: int = 8192         # prefix-index LRU bound

    def __post_init__(self):
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_batch_size is not None and self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.max_concurrent_queries < 1:
            raise ValueError("max_concurrent_queries must be >= 1")
        if self.max_queued_requests is not None \
                and self.max_queued_requests < 1:
            raise ValueError("max_queued_requests must be >= 1 (or None)")
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.num_shards > 1 and self.shard_group_timeout_s <= 0:
            raise ValueError("shard_group_timeout_s must be > 0")
        if self.num_gpus_per_shard < 0:
            raise ValueError("num_gpus_per_shard must be >= 0")
        if self.streaming:
            if self.max_decode_batch < 1:
                raise ValueError("max_decode_batch must be >= 1")
            if self.max_waiting_sequences < 1:
                raise ValueError("max_waiting_sequences must be >= 1")
            if self.kv_page_size < 1 or self.kv_pages_total < 1:
                raise ValueError(
                    "kv_page_size and kv_pages_total must be >= 1")
            if self.kv_backend not in ("numpy", "torch"):
                raise ValueError("kv_backend must be 'numpy' or 'torch'")
            if self.kv_backend == "torch" and self.num_gpus_per_shard <= 0:
                raise ValueError(
                    "kv_backend 'torch' keeps the KV arena on a card: "
                    "num_gpus_per_shard must be > 0")
            if self.session_cache_max < 0:
                raise ValueError("session_cache_max must be >= 0")
            if self.prefix_index_max_nodes < 0:
                raise ValueError("prefix_index_max_nodes must be >= 0")
            if self.kv_warm_pages < 0:
                raise ValueError("kv_warm_pages must be >= 0")
            if self.router_session_cap < 1 or self.router_prefix_cap < 1:
                raise ValueError(
                    "router_session_cap and router_prefix_cap must be >= 1")
        if isinstance(self.autoscaling, AutoscalingConfig):
            self.autoscaling = self.autoscaling.to_dict()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BackendConfig":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})
