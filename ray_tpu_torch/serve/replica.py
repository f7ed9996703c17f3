"""Replica actor; port of ray_tpu/serve/replica.py (reference:
python/ray/serve/backend_worker.py:175 RayServeReplica). Batching lives
router-side here (the BatchQueue idea, backend_worker.py:33, moved to the
caller so one actor RPC carries a whole batch)."""

from __future__ import annotations

import inspect
import time

import cloudpickle

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import stats as _stats
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch.serve.engine import StreamingEngineHost

M_REPLICA_EXEC_S = _stats.Histogram(
    "serve.replica_exec_s", _stats.LATENCY_BOUNDARIES_S,
    "user-callable execution per batch (replica side; pairs with "
    "serve.router_queue_s as the autoscaler's latency feed)")


def _is_accept_batch(fn) -> bool:
    return getattr(fn, "_serve_accept_batch", False)


def accept_batch(fn):
    """Mark a callable as taking a LIST of requests per call (reference:
    serve/api.py:697 accept_batch)."""
    fn._serve_accept_batch = True
    return fn


class Replica(StreamingEngineHost):
    """Hosts one copy of the user's callable — and, for streaming
    backends, an unsharded decode engine (allreduce = identity): the
    continuous-batching tier doesn't require sharding."""

    def __init__(self, pickled_callable: bytes, init_args: tuple,
                 user_config: dict | None,
                 large_payload_threshold: int = 0,
                 config: dict | None = None):
        self._threshold = large_payload_threshold
        self._backend_name = (config or {}).get("_backend_name") or ""
        target = cloudpickle.loads(pickled_callable)
        if inspect.isclass(target):
            self._callable = target(*init_args)
            call = getattr(self._callable, "__call__", None)
            self._accept_batch = _is_accept_batch(
                getattr(type(self._callable), "__call__", None)) or \
                _is_accept_batch(call)
        else:
            self._callable = target
            self._accept_batch = _is_accept_batch(target)
        if user_config is not None:
            reconfigure = getattr(self._callable, "reconfigure", None)
            if reconfigure:
                reconfigure(user_config)
        self._streaming = bool((config or {}).get("streaming"))
        if self._streaming:
            self._start_engine(self._callable, config or {},
                               self._backend_name)
        self._batches_handled = 0
        self._last_batch_at = 0.0

    def arm_failpoint(self, name: str, action: str, **kw):
        """Test hook: arm a failpoint in THIS replica's process (chaos
        picks one victim; env arming would fire in every replica)."""
        _fp.arm(name, action, **kw)
        return True

    def reconfigure(self, user_config: dict):
        fn = getattr(self._callable, "reconfigure", None)
        if fn:
            fn(user_config)
        return True

    def handle_batch(self, requests: list):
        """One RPC per batch; returns per-request results (the runtime
        splits them into the callers' ObjectRefs via num_returns).
        Zero-copy plane: LargePayload markers resolve here (the bytes
        rode the object store, not the router), and results at or over
        the threshold ride the store back the same way."""
        from ray_tpu_torch.serve import payload as _payload

        if self._streaming:
            # the decode loop owns this replica's compute (and, sharded,
            # its collective op stream): request/response callers go
            # through the stream API instead of racing it
            raise RuntimeError(
                "streaming backend: use the stream API "
                "(handle.stream(...) / SSE through the proxy), not "
                "request/response dispatch")
        # wrap responses only for callers speaking the zero-copy
        # protocol (the HTTP proxy): a plain handle.remote() caller gets
        # values, never markers
        wrap_back = [isinstance(r, _payload.LargePayload)
                     for r in requests]
        requests = [_payload.unwrap(r) for r in requests]
        start = time.time()
        try:
            if self._accept_batch:
                out = self._callable(requests)
                if len(out) != len(requests):
                    raise ValueError(
                        f"accept_batch callable returned {len(out)} results "
                        f"for {len(requests)} requests")
            else:
                out = [self._callable(r) for r in requests]
        finally:
            # the batch executes inside the traced task's ambient
            # context (router's tracing.use around .remote()), so the
            # exemplar links this batch's slowest-request tree
            M_REPLICA_EXEC_S.observe(time.time() - start,
                                     exemplar=_tracing.current_id())
            self._batches_handled += 1
            self._last_batch_at = time.time()
        if self._threshold:
            out = [_payload.wrap(r, self._threshold) if w else r
                   for r, w in zip(out, wrap_back)]
        return tuple(out) if len(out) > 1 else out[0]

    def ping(self):
        return "pong"

