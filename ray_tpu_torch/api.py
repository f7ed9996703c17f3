"""Public API (reference: python/ray/worker.py — init :490, get :1369,
put :1446, wait :1475, remote :1741, kill :1597, cancel :1625,
get_actor :1576)."""

from __future__ import annotations

import inspect
from typing import Any, Sequence

from ray_tpu_torch._private import global_state
from ray_tpu_torch._private.config import Config, set_config
from ray_tpu_torch._private.core_worker import DRIVER, CoreWorker
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.node import Node
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.object_ref import ObjectRef
from ray_tpu_torch.remote_function import RemoteFunction

_global_node: Node | None = None


def init(*, num_cpus: float | None = None, num_gpus: float | None = None,
         resources: dict | None = None, labels: dict | None = None,
         object_store_memory: int | None = None,
         ignore_reinit_error=False) -> dict:
    """Start a local cluster (a GCS and one raylet) and connect this
    process to it as the driver. `num_gpus=None` counts this machine's
    cards; `object_store_memory` sizes the node's shared-memory store."""
    global _global_node
    if global_state.get_core_worker() is not None:
        if ignore_reinit_error:
            return connection_info()
        raise RuntimeError("ray_tpu_torch.init() called twice")

    overrides = {}
    if object_store_memory is not None:
        overrides["object_store_memory"] = object_store_memory
    config = Config.load(overrides)
    set_config(config)

    if num_gpus is None:
        num_gpus = _detect_gpus()
    _global_node = Node(config=config, num_cpus=num_cpus, num_gpus=num_gpus,
                        resources=resources, labels=labels)
    CoreWorker(
        mode=DRIVER,
        raylet_address=_global_node.raylet_address,
        gcs_address=_global_node.gcs_address,
        session_dir=_global_node.session_dir,
        store_root=_global_node.store_root,
        config=config,
    )
    return connection_info()


def _detect_gpus() -> float:
    """Count this machine's GPUs (those CUDA_VISIBLE_DEVICES shows)
    WITHOUT creating a CUDA context in the driver: the cards belong to
    the workers the raylet pins to them. torch.cuda.device_count() asks
    NVML and creates no context. Pass num_gpus for precise control."""
    import torch

    return float(torch.cuda.device_count())


def connection_info() -> dict:
    cw = global_state.require_core_worker()
    return {
        "gcs_address": _global_node.gcs_address if _global_node else "",
        "raylet_address": cw.raylet.name if cw.raylet else "",
        "session_dir": cw.session_dir,
        "node_id": cw.node_id.hex() if cw.node_id else "",
    }


def is_initialized() -> bool:
    return global_state.get_core_worker() is not None


def shutdown():
    global _global_node
    cw = global_state.get_core_worker()
    if cw is not None:
        cw.shutdown()
    if _global_node is not None:
        _global_node.kill_all_processes()
        _global_node = None


def remote(*args, **kwargs):
    """@remote decorator for functions and classes, with or without options:

        @ray_tpu_torch.remote
        def f(): ...

        @ray_tpu_torch.remote(num_gpus=1, max_restarts=3)
        class A: ...
    """
    if len(args) == 1 and not kwargs and callable(args[0]):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only")

    def decorator(obj):
        return _make_remote(obj, kwargs)

    return decorator


def _make_remote(obj, opts):
    if inspect.isclass(obj):
        allowed = {"num_cpus", "num_gpus", "resources", "max_restarts",
                   "max_concurrency"}
        bad = set(opts) - allowed
        if bad:
            raise ValueError(f"unsupported actor options: {bad}")
        return ActorClass(obj, **opts)
    allowed = {"num_cpus", "num_gpus", "resources", "num_returns",
               "max_retries"}
    bad = set(opts) - allowed
    if bad:
        raise ValueError(f"unsupported task options: {bad}")
    return RemoteFunction(obj, **opts)


def put(value: Any) -> ObjectRef:
    return global_state.require_core_worker().put(value)


def get(refs, timeout: float | None = None):
    cw = global_state.require_core_worker()
    if isinstance(refs, ObjectRef):
        return cw.get([refs], timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError("get() expects an ObjectRef or a list of ObjectRefs")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() got a non-ObjectRef element: {type(r)}")
    return cw.get(list(refs), timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: float | None = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    cw = global_state.require_core_worker()
    return cw.wait(refs, num_returns=num_returns, timeout=timeout,
                   fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle; use cancel() for tasks")
    cw = global_state.require_core_worker()
    cw.kill_actor(actor._actor_id.binary(), no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    cw = global_state.require_core_worker()
    cw.cancel_task(ref, force=force, recursive=recursive)


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    cw = global_state.require_core_worker()
    info = cw.get_named_actor(name, namespace)
    if info is None or info["state"] == "DEAD":
        raise ValueError(f"Failed to look up actor {name!r}")

    # class fn_id is unknown to late-bound getters; methods resolve by name
    # at call time, so a nil cls id is fine.
    return ActorHandle(ActorID(info["actor_id"]), b"\x00" * 16,
                       info.get("class_name", "Actor"))


def nodes() -> list[dict]:
    cw = global_state.require_core_worker()
    info = cw.cluster_info()
    return [
        {
            "NodeID": n["node_id"].hex(),
            "Alive": True,
            "Address": n["address"],
            "Resources": {k: v / 10000 for k, v in n["resources"].items()},
            "IsHead": n.get("is_head", False),
            "Labels": n.get("labels", {}),
        }
        for n in info["nodes"]
    ]


def cluster_resources() -> dict:
    out: dict[str, float] = {}
    for node in nodes():
        for k, v in node["Resources"].items():
            out[k] = out.get(k, 0) + v
    return out


def available_resources() -> dict:
    cw = global_state.require_core_worker()
    info = cw.cluster_info()
    return {k: v / 10000 for k, v in info["available"].items()}
