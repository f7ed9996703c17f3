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
