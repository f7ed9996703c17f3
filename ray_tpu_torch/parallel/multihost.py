"""Process groups across processes; port of ray_tpu/parallel/multihost.py.

The JAX package joins K worker processes into one jax.distributed
runtime: rank 0 publishes the coordinator's address under a GCS KV key
and the others poll it (multihost.py:41-107); a global Mesh over
`jax.devices()` then spans the processes. The port does both in the same
way over torch.distributed:

- `initialize` joins this process to a multihost group as its DEFAULT
  process group (NCCL, a card a rank, or gloo on the CPU), once a
  process, as jax.distributed.initialize is once a process: the global
  runtime that `parallel.mesh` builds DeviceMeshes over and that
  `ProcessMeshGroup` (collective backend "xla" across processes) rides.
  NCCL refuses two ranks on one card, so a group whose ranks share one
  raises.
- `process_group` gives each per-process collective group (HostGroup) a
  process group of its own for its DEVICE tier. It is never the
  process's default group, so two groups in one process do not clash,
  and a group's teardown frees its communicator.

Rank 0 of either hosts the group's TCPStore and publishes its address;
the others poll the KV for it.
"""

from __future__ import annotations

import datetime
import time

_KV_PREFIX = "multihost"
_groups: dict[str, tuple] = {}  # group name -> (process group, store)
_initialized_group: str | None = None


def _key(group_name: str) -> str:
    return f"{_KV_PREFIX}:{group_name}:coordinator"


def _rendezvous(group_name: str, world_size: int, rank: int,
                delta: datetime.timedelta):
    """The group's TCPStore: rank 0 hosts it and publishes its address
    under the group's KV key; the others poll the key."""
    import torch.distributed as dist

    from ray_tpu_torch.experimental import internal_kv

    key = _key(group_name)
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world_size, True,
                              timeout=delta, wait_for_workers=False)
        internal_kv._kv_put(key, f"127.0.0.1:{store.port}".encode())
        return store
    deadline = time.monotonic() + delta.total_seconds()
    addr = None
    while time.monotonic() < deadline:
        addr = internal_kv._kv_get(key)
        if addr:
            break
        time.sleep(0.05)
    if not addr:
        raise TimeoutError(
            f"process group of {group_name!r}: the store's address never "
            "appeared in the GCS KV")
    host, port = addr.decode().rsplit(":", 1)
    return dist.TCPStore(host, int(port), world_size, False, timeout=delta)


def _check_own_cards(store, world_size: int, rank: int, group_name: str):
    """Every rank posts its card's UUID; two ranks on one card raise on
    every rank (NCCL refuses them; no other tier stands in)."""
    import torch

    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    store.set(f"card/{rank}", str(props.uuid))
    cards = [store.get(f"card/{r}").decode() for r in range(world_size)]
    shared = [r for r in range(world_size)
              if cards.count(cards[r]) > 1]
    if shared:
        raise RuntimeError(
            f"multihost group {group_name!r}: ranks {shared} share a card; "
            "NCCL refuses two ranks on one card, so a multihost group needs "
            "a card a rank")


def initialize(group_name: str, world_size: int, rank: int, *,
               backend: str | None = None, timeout: float = 60.0) -> str:
    """Joins this process to multihost group `group_name` as `rank`: the
    group becomes the process's default process group. backend: "nccl"
    (a card a rank; the default with CUDA) or "gloo". Idempotent per
    process; a second group raises. Returns the store's address."""
    global _initialized_group
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.experimental import internal_kv

    if _initialized_group is not None:
        if _initialized_group != group_name:
            raise RuntimeError(
                f"process already in multihost group {_initialized_group!r}")
        return internal_kv._kv_get(_key(group_name)).decode()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    delta = datetime.timedelta(seconds=timeout)
    store = _rendezvous(group_name, world_size, rank, delta)
    if backend == "nccl":
        _check_own_cards(store, world_size, rank, group_name)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=delta)
    _initialized_group = group_name
    return internal_kv._kv_get(_key(group_name)).decode()


def is_initialized() -> bool:
    return _initialized_group is not None


def ensure_runtime(device=None):
    """The process's runtime for a mesh: the multihost group it joined, or
    else a default group of this process alone (NCCL for a CUDA device,
    gloo for "cpu"), as JAX's local runtime without jax.distributed."""
    import torch.distributed as dist

    from ray_tpu_torch._private.device import check_device

    if dist.is_initialized():
        return
    backend = "nccl" if check_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def shutdown():
    """Leaves the multihost group (its default process group)."""
    global _initialized_group
    import torch.distributed as dist

    from ray_tpu_torch.experimental import internal_kv

    if dist.is_initialized():
        dist.destroy_process_group()
    if _initialized_group is not None:
        try:
            internal_kv._kv_del(_key(_initialized_group))
        except Exception:
            pass
    _initialized_group = None


def shard_host_batch(batch, sharding):
    """This process's rows of a batch -> DTensors on `sharding`'s mesh
    (reference: jax.make_array_from_process_local_data): each rank passes
    its slice of the global batch; its rows stay on its device."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import _tree_map

    places = sharding.placements()
    return _tree_map(lambda x: DTensor.from_local(
        x, sharding.mesh, places, run_check=False), batch)


def process_group(group_name: str, world_size: int, rank: int,
                  backend: str, *, timeout: float = 60.0):
    """This process's rank of the process group of collective group
    `group_name` (built at the first call; the ranks' calls must be
    concurrent). backend: "nccl" or "gloo"."""
    import torch.distributed as dist

    if group_name in _groups:
        return _groups[group_name][0]
    delta = datetime.timedelta(seconds=timeout)
    store = _rendezvous(group_name, world_size, rank, delta)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        pg = dist.ProcessGroupNCCL(store, rank, world_size, opts)
    elif backend == "gloo":
        pg = dist.ProcessGroupGloo(store, rank, world_size, delta)
    else:
        raise ValueError(f"unknown process group backend {backend!r}")
    _groups[group_name] = (pg, store)
    return pg


def destroy_process_group(group_name: str):
    """Frees the group's process group (its communicator) and store."""
    from ray_tpu_torch.experimental import internal_kv

    entry = _groups.pop(group_name, None)
    if entry is None:
        return
    pg, _ = entry
    shutdown = getattr(pg, "shutdown", None)
    if shutdown is not None:
        try:
            shutdown()
        except Exception:
            pass
    try:
        internal_kv._kv_del(_key(group_name))
    except Exception:
        pass
