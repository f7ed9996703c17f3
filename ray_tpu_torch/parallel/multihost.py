"""Process groups across a collective group's processes; port of
ray_tpu/parallel/multihost.py.

The JAX package joins K worker processes into one jax.distributed
runtime: rank 0 publishes the coordinator's address under a GCS KV key
and the others poll it (multihost.py:41-107). Here each collective group
gets a torch.distributed process group of its own in the same way: rank
0 hosts the group's TCPStore and publishes its address, the others poll
the KV for it, and every rank builds the group's process group over that
store (NCCL on CUDA, gloo on the CPU). It is never the process's default
group, so two groups in one process do not clash, and a group's teardown
frees its communicator.
"""

from __future__ import annotations

import datetime
import time

_KV_PREFIX = "multihost"
_groups: dict[str, tuple] = {}  # group name -> (process group, store)


def _key(group_name: str) -> str:
    return f"{_KV_PREFIX}:{group_name}:coordinator"


def process_group(group_name: str, world_size: int, rank: int,
                  backend: str, *, timeout: float = 60.0):
    """This process's rank of the process group of collective group
    `group_name` (built at the first call; the ranks' calls must be
    concurrent). backend: "nccl" or "gloo"."""
    import torch.distributed as dist

    from ray_tpu_torch.experimental import internal_kv

    if group_name in _groups:
        return _groups[group_name][0]
    key = _key(group_name)
    delta = datetime.timedelta(seconds=timeout)
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world_size, True,
                              timeout=delta, wait_for_workers=False)
        internal_kv._kv_put(key, f"127.0.0.1:{store.port}".encode())
    else:
        deadline = time.monotonic() + timeout
        addr = None
        while time.monotonic() < deadline:
            addr = internal_kv._kv_get(key)
            if addr:
                break
            time.sleep(0.05)
        if not addr:
            raise TimeoutError(
                f"process group of {group_name!r}: the store's address "
                "never appeared in the GCS KV")
        host, port = addr.decode().rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world_size, False,
                              timeout=delta)
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
