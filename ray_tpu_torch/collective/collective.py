"""Declarative collective groups; port of ray_tpu/collective/collective.py
(reference: python/ray/util/collective/collective.py — GroupManager :29,
init_collective_group :93, create_collective_group :126, allreduce :226,
barrier :266, reduce :279, allgather :391, reducescatter).

How a caller names its rank. In the JAX package each rank is a process,
and a group name resolves to the calling process's rank. Here the ring
kernels need every rank of a group in one address space until they
cross processes (ROADMAP.md A5), so every rank of a group lives in one
process: `init_collective_group(world_size, rank, ...)` is called once
per rank (as each actor calls it in the reference) and returns that
rank's `RankHandle`. The handle carries the rank's device and CUDA stream
and has the op methods; the module functions take the same arguments as
the reference's plus a keyword `rank=` and go through the handle of that
rank. A `TrainWorker` actor hosts the ranks of its trainer and holds
their handles.

Rank r of a CUDA group sits on cuda:(r % torch.cuda.device_count()): on
a machine with one card every rank shares it, each on its own stream;
with w cards or more, each rank has a card of its own (peer access on).
A rank's ops must run with its stream current
(`with torch.cuda.stream(handle.stream)`), and every rank must make the
same calls in the same order before the host waits on any of them:
`handle.check()` is that wait, and raises TimeoutError if a rank waited
longer than the group's timeout for a peer.

Transports: "auto" and "pallas" are the fused ring kernels
(backends/pallas_backend.py), for every payload size. "device" (the XLA
tier, NCCL in the port) and the runtime's host tiers ("hub", "ring",
"ring_unpipelined", "shm"), which carry ranks in processes of their own,
are ROADMAP.md A5.
"""

from __future__ import annotations

import threading

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.collective.backends.pallas_backend import PallasTransport
from ray_tpu_torch.collective.types import (Backend, ReduceOp, Transport,
                                            normalize_quantize)


def rank_devices(world_size: int, device=None) -> list[torch.device]:
    """Each rank's device: all "cpu" when the caller asks for the CPU,
    else rank r on cuda:(r % torch.cuda.device_count()). None means
    CUDA and raises without it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * world_size
    n = torch.cuda.device_count()
    return [torch.device("cuda", r % n) for r in range(world_size)]


def resolve_transport(transport) -> Transport:
    """The tier a group runs: PALLAS for "auto" and "pallas"; the others
    are not ported yet and raise."""
    t = Transport(transport)
    if t in (Transport.AUTO, Transport.PALLAS):
        return Transport.PALLAS
    if t == Transport.DEVICE:
        raise NotImplementedError(
            "collective transport 'device' (the XLA tier, NCCL here) is "
            "ROADMAP.md A5; this port carries every op on 'pallas'")
    raise NotImplementedError(
        f"collective transport {t.value!r} is a host tier of the runtime "
        "for ranks in processes of their own, which is ROADMAP.md A5; "
        "this port carries every op on 'pallas'")


class CollectiveGroup:
    """One group of ranks in this process, over one transport."""

    def __init__(self, group_name: str, world_size: int, timeout: float,
                 transport, quantize, device):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        resolve_transport(transport)
        self.group_name = group_name
        self.world_size = world_size
        self.timeout = timeout
        self.quantize = normalize_quantize(quantize)
        self.transport = PallasTransport(
            world_size, rank_devices(world_size, device), timeout)
        self._handles: dict[int, RankHandle] = {}

    def join(self, rank: int) -> "RankHandle":
        if not 0 <= rank < self.world_size:
            raise ValueError(f"rank {rank} outside a group of "
                             f"{self.world_size}")
        if rank in self._handles:
            raise RuntimeError(f"rank {rank} already joined group "
                               f"{self.group_name!r}")
        handle = self._handles[rank] = RankHandle(self, rank)
        return handle

    def handle(self, rank: int) -> "RankHandle":
        handle = self._handles.get(rank)
        if handle is None:
            raise ValueError(f"rank {rank} has not joined group "
                             f"{self.group_name!r}")
        return handle

    def _q(self, quantize):
        return self.quantize if quantize is None else quantize

    def destroy(self):
        self.transport.close()


class RankHandle:
    """One rank's membership of a group: its device, its stream (None on
    the CPU) and the op surface of the reference's group objects."""

    def __init__(self, group: CollectiveGroup, rank: int):
        self.group = group
        self.rank = rank
        self.world_size = group.world_size

    @property
    def device(self) -> torch.device:
        return self.group.transport.devices[self.rank]

    @property
    def stream(self):
        return self.group.transport.streams[self.rank]

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM, quantize=None):
        """quantize: None = the group's default; "int8" = block-scaled
        int8 wire format; False = exact."""
        return self.group.transport.allreduce(
            self.rank, tensor, op, quantize=self.group._q(quantize))

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        return self.group.transport.reduce(
            self.rank, tensor, dst_rank, op, quantize=self.group._q(None))

    def allgather(self, tensor) -> list:
        return self.group.transport.allgather(self.rank, tensor)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM,
                      quantize=None):
        return self.group.transport.reducescatter(
            self.rank, tensor, op, quantize=self.group._q(quantize))

    def broadcast(self, tensor, src_rank: int = 0):
        return self.group.transport.broadcast(self.rank, tensor, src_rank)

    def barrier(self):
        self.group.transport.barrier(self.rank)

    def check(self):
        """Waits for this rank's collectives; TimeoutError if one of them
        waited longer than the group's timeout for a peer."""
        self.group.transport.check(self.rank)


class GroupManager:
    """Per-process registry of collective groups (reference:
    collective.py:29)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: dict[str, CollectiveGroup] = {}

    def create_group(self, group_name: str, world_size: int, rank: int,
                     backend, timeout: float = 60.0,
                     transport: str = "auto", quantize=None,
                     device=None) -> RankHandle:
        """Joins `rank` to the group, creating the group at its first
        rank's call; a later rank's arguments must match the group's."""
        if Backend(backend) == Backend.XLA:
            raise NotImplementedError(
                "backend 'xla' (the single-controller device group) is "
                "ROADMAP.md A5; use backend 'host'")
        with self._lock:
            group = self._groups.get(group_name)
            if group is None:
                group = self._groups[group_name] = CollectiveGroup(
                    group_name, world_size, timeout, transport, quantize,
                    device)
            elif (group.world_size, group.timeout, group.quantize) != (
                    world_size, timeout, normalize_quantize(quantize)):
                raise ValueError(
                    f"group {group_name!r} exists with world_size "
                    f"{group.world_size}, timeout {group.timeout}, quantize "
                    f"{group.quantize}; rank {rank} asked for {world_size}, "
                    f"{timeout}, {quantize}")
            return group.join(rank)

    def get_group(self, group_name: str) -> CollectiveGroup:
        with self._lock:
            group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in "
                f"this process; call init_collective_group first")
        return group

    def destroy_group(self, group_name: str):
        with self._lock:
            group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy()


_manager = GroupManager()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default",
                          timeout: float = 60.0,
                          transport: str = "auto",
                          quantize=None, device=None) -> RankHandle:
    """Joins `rank` to a collective group of this process and returns its
    handle (reference: collective.py:93). `quantize="int8"` makes the
    group's default allreduce wire format block-scaled int8 (lossy);
    per-op `quantize=` overrides it. `device`: None for CUDA (rank r on
    cuda:(r % device_count)), "cpu" for the plain versions."""
    return _manager.create_group(group_name, world_size, rank, backend,
                                 timeout=timeout, transport=transport,
                                 quantize=quantize, device=device)


def create_collective_group(actors, world_size: int, ranks: list[int],
                            backend: str = "host",
                            group_name: str = "default",
                            timeout: float = 60.0, quantize=None,
                            transport: str = "auto"):
    """Declarative setup from the process that owns the actors
    (reference: collective.py:126): tells every actor (here an object of
    this process with an `init_collective_group` method, such as a
    TrainWorker) to join the group with its rank."""
    if len(actors) != len(ranks) or len(actors) != world_size:
        raise ValueError("actors/ranks/world_size mismatch")
    return [actor.init_collective_group(world_size, rank, backend,
                                        group_name, timeout, quantize,
                                        transport)
            for actor, rank in zip(actors, ranks)]


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _manager.get_group(group_name)
        return True
    except ValueError:
        return False


def destroy_collective_group(group_name: str = "default"):
    """Waits for every rank's stream, then frees the group."""
    _manager.destroy_group(group_name)


def get_handle(group_name: str, rank: int) -> RankHandle:
    return _manager.get_group(group_name).handle(rank)


def get_rank(group_name: str = "default") -> int:
    """The process's rank in the group, where it holds one; a process
    that holds several names each by its handle."""
    ranks = sorted(_manager.get_group(group_name)._handles)
    if len(ranks) != 1:
        raise ValueError(f"this process holds ranks {ranks} of group "
                         f"{group_name!r}; each rank's handle names it")
    return ranks[0]


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get_group(group_name).world_size


def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM, quantize=None, *, rank: int):
    """`quantize` (None = the group's default; "int8" = block-scaled int8
    wire format; False = exact)."""
    return get_handle(group_name, rank).allreduce(tensor, op, quantize)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM, *, rank: int):
    return get_handle(group_name, rank).reduce(tensor, dst_rank, op)


def allgather(tensor, group_name: str = "default", *, rank: int) -> list:
    return get_handle(group_name, rank).allgather(tensor)


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM, quantize=None, *, rank: int):
    return get_handle(group_name, rank).reducescatter(tensor, op, quantize)


def barrier(group_name: str = "default", *, rank: int):
    get_handle(group_name, rank).barrier()
