"""Shared wire/value types: task specs, resource sets, addresses.

Parity targets: TaskSpecification (reference: src/ray/common/task/task_spec.h),
ResourceSet with fractional resources (reference:
src/ray/common/task/scheduling_resources.h FixedPoint), Address
(reference: src/ray/protobuf/common.proto Address). Everything here is
msgpack-plain (dicts/lists/bytes) so specs travel over the RPC layer without
a pickling step in the hot path.
"""

from __future__ import annotations

import hashlib
from typing import Any

# Task types
NORMAL_TASK = 0
ACTOR_CREATION_TASK = 1
ACTOR_TASK = 2

# Fractional resource precision — mirror the reference's FixedPoint(1/10000)
# (reference: src/ray/raylet/scheduling/fixed_point.h).
RESOURCE_QUANTUM = 10000


class InsufficientResources(RuntimeError):
    """Raylet-side admission miss: the GCS's availability snapshot raced a
    lease grant. Travels pickled inside rpc.RemoteError so the GCS can
    distinguish a benign scheduling bounce from a real actor-creation
    failure by type, not by matching error text (reference analog: the
    SCHEDULING_FAILED status on CreateActorReply,
    src/ray/protobuf/gcs_service.proto)."""


def quantize(value: float) -> int:
    return int(round(value * RESOURCE_QUANTUM))


def dequantize(value: int) -> float:
    return value / RESOURCE_QUANTUM


class ResourceSet:
    """Integer-quantized resource amounts keyed by name ("CPU", "GPU", ...).

    `gpu_ids` names the cards a raylet granted these amounts on (a
    lease's CUDA_VISIBLE_DEVICES), and `bundle` the placement-group
    bundle (pg_id, bundle_index) they were granted from, None for the
    node's own pool; both are local to the raylet and never travel."""

    __slots__ = ("_amounts", "gpu_ids", "bundle")

    def __init__(self, amounts: dict[str, float] | None = None, _raw=None):
        self.gpu_ids: tuple[int, ...] | None = ()
        self.bundle: tuple[bytes, int] | None = None
        if _raw is not None:
            self._amounts = dict(_raw)
        else:
            self._amounts = {
                k: quantize(v) for k, v in (amounts or {}).items() if v != 0
            }

    @classmethod
    def from_raw(cls, raw: dict[str, int]) -> "ResourceSet":
        return cls(_raw=raw)

    def raw(self) -> dict[str, int]:
        return dict(self._amounts)

    def to_dict(self) -> dict[str, float]:
        return {k: dequantize(v) for k, v in self._amounts.items()}

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(
            other._amounts.get(k, 0) >= v for k, v in self._amounts.items()
        )

    def subtract(self, other: "ResourceSet") -> None:
        for k, v in other._amounts.items():
            self._amounts[k] = self._amounts.get(k, 0) - v

    def add(self, other: "ResourceSet") -> None:
        for k, v in other._amounts.items():
            self._amounts[k] = self._amounts.get(k, 0) + v

    def get(self, key: str) -> float:
        return dequantize(self._amounts.get(key, 0))

    def copy(self) -> "ResourceSet":
        return ResourceSet(_raw=self._amounts)

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and {
            k: v for k, v in self._amounts.items() if v
        } == {k: v for k, v in other._amounts.items() if v}


def check_num_gpus(num_gpus):
    """A task or actor asks for a share of one GPU or for whole GPUs: a
    lease's CUDA_VISIBLE_DEVICES names whole cards."""
    if num_gpus is not None and (num_gpus < 0 or (
            num_gpus > 1 and num_gpus != int(num_gpus))):
        raise ValueError(f"num_gpus must be a fraction of one GPU or a "
                         f"whole number of GPUs, got {num_gpus}")
    return num_gpus


def function_id(pickled_function: bytes) -> bytes:
    return hashlib.sha1(pickled_function).digest()[:16]


def make_task_spec(
    *,
    task_id: bytes,
    job_id: bytes,
    name: str,
    fn_id: bytes,
    task_type: int = NORMAL_TASK,
    actor_id: bytes | None = None,
    method_name: str = "",
    seq_no: int = -1,
    owner_addr: str = "",
    owner_worker_id: bytes = b"",
    args: list[dict] | None = None,
    num_returns: int = 1,
    resources: dict[str, float] | None = None,
    max_retries: int = 0,
    actor_creation: dict | None = None,
    placement_group_id: bytes | None = None,
    bundle_index: int = -1,
) -> dict[str, Any]:
    """TaskSpec as a msgpack-plain dict."""
    return {
        "task_id": task_id,
        "job_id": job_id,
        "name": name,
        "fn_id": fn_id,
        "type": task_type,
        "actor_id": actor_id,
        "method_name": method_name,
        "seq_no": seq_no,
        "owner_addr": owner_addr,
        "owner_worker_id": owner_worker_id,
        "args": args or [],
        "num_returns": num_returns,
        "resources": ResourceSet(resources or {}).raw(),
        "max_retries": max_retries,
        "actor_creation": actor_creation,
        "pg_id": placement_group_id,
        "bundle_index": bundle_index,
    }


def scheduling_key(spec: dict) -> tuple:
    """Tasks with equal keys can reuse the same leased worker
    (reference: direct_task_transport.h:40-49 SchedulingKey)."""
    return (
        spec["fn_id"],
        tuple(sorted(spec["resources"].items())),
        spec.get("pg_id"),
        spec.get("bundle_index", -1),
    )
