"""Public exception types (capability parity: python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Stored as the task's result object; re-raised (with the remote traceback
    appended) when the caller `get`s the result — matching the reference's
    RayTaskError behavior (python/ray/exceptions.py RayTaskError).
    """

    def __init__(self, cause_cls_name: str, cause_repr: str, traceback_str: str,
                 proctitle: str = ""):
        self.cause_cls_name = cause_cls_name
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str
        self.proctitle = proctitle
        super().__init__(self._format())

    def _format(self) -> str:
        return (
            f"Task raised {self.cause_cls_name}: {self.cause_repr}\n"
            f"Remote traceback:\n{self.traceback_str}"
        )

    def __reduce__(self):
        return (TaskError, (self.cause_cls_name, self.cause_repr,
                            self.traceback_str, self.proctitle))


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    """The actor is dead; pending and future calls fail with this."""

    def __init__(self, actor_id_hex: str = "", reason: str = ""):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"Actor {actor_id_hex} is dead: {reason or 'unknown'}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id_hex, self.reason))


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """The object's value was lost (all copies evicted/node died) and could
    not be reconstructed from lineage."""

    def __init__(self, object_id_hex: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(f"Object {object_id_hex} was lost and is unrecoverable")

    def __reduce__(self):
        return (ObjectLostError, (self.object_id_hex,))


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get` exceeded its timeout."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via `ray_tpu_torch.cancel`."""

    def __init__(self, task_id_hex: str = ""):
        self.task_id_hex = task_id_hex
        super().__init__(f"Task {task_id_hex} was cancelled")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id_hex,))


class PlacementGroupInfeasibleError(RayTpuError):
    """The GCS determined this placement group cannot be reserved on
    the CURRENT cluster (STRICT_SPREAD wanting more distinct nodes than
    exist). Unlike a PENDING group, which waits for resources to free,
    an infeasible one needs the cluster to grow; ready()/wait() raise
    this typed instead of blocking forever. The group stays registered:
    a joining node flips it back to PENDING and retries."""

    def __init__(self, pg_id_hex: str = "", detail: str = ""):
        self.pg_id_hex = pg_id_hex
        self.detail = detail
        super().__init__(
            f"placement group {pg_id_hex or '?'} is infeasible on the "
            f"current fleet: {detail or 'needs more nodes'}")

    def __reduce__(self):
        return (PlacementGroupInfeasibleError,
                (self.pg_id_hex, self.detail))


class ServeOverloadedError(RayTpuError):
    """A Serve endpoint shed this request at admission: the router's
    bounded queue was already at `max_queued_requests` depth. The typed
    503 of the serving tier — callers should back off `retry_after_s`
    and retry; the HTTP proxy maps it to 503 + Retry-After."""

    def __init__(self, endpoint: str = "", queued: int = 0,
                 max_queued: int = 0, retry_after_s: float = 1.0):
        self.endpoint = endpoint
        self.queued = queued
        self.max_queued = max_queued
        self.retry_after_s = retry_after_s
        super().__init__(
            f"endpoint {endpoint!r} overloaded: {queued} queued >= "
            f"max_queued_requests={max_queued}; retry after "
            f"{retry_after_s:.1f}s")

    def __reduce__(self):
        return (ServeOverloadedError,
                (self.endpoint, self.queued, self.max_queued,
                 self.retry_after_s))


class SequenceAborted(RayTpuError):
    """A streaming inference sequence was aborted before it finished:
    the client disconnected mid-stream, the KV page pool was exhausted,
    or the hosting engine shut down. The sequence's KV pages are freed
    on the abort path; any reader still parked on the stream surfaces
    this instead of hanging."""

    def __init__(self, seq_id: str = "", reason: str = ""):
        self.seq_id = seq_id
        self.reason = reason
        super().__init__(
            f"sequence {seq_id or '?'} aborted: {reason or 'aborted'}")

    def __reduce__(self):
        return (SequenceAborted, (self.seq_id, self.reason))


class ReplicaGroupDied(RayTpuError):
    """A sharded Serve replica group lost a member (or its leader) while
    this request was in flight. The whole gang is being restarted by the
    controller; the request did NOT complete. Retryable once the gang is
    back (the HTTP proxy maps it to 503)."""

    def __init__(self, backend: str = "", group: str = "",
                 reason: str = ""):
        self.backend = backend
        self.group = group
        self.reason = reason
        super().__init__(
            f"replica group {group or '?'} of backend {backend!r} died "
            f"mid-request: {reason or 'member lost'}")

    def __reduce__(self):
        return (ReplicaGroupDied, (self.backend, self.group, self.reason))
