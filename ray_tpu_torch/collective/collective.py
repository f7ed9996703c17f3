"""Declarative collective groups; port of ray_tpu/collective/collective.py
(reference: python/ray/util/collective/collective.py — GroupManager :29,
init_collective_group :93, create_collective_group :126, allreduce :226,
barrier :266, reduce :279, broadcast :340, allgather :391, reducescatter,
send :496, recv :550).

Two kinds of group, as in the reference:

- backend="host" (the default): one rank a process, the reference's
  layout. `init_collective_group(world_size, rank, ...)` joins this
  process to the group as `rank` (backends/host_backend.HostGroup), and
  the module functions take the reference's arguments: a group name
  resolves to the process's own rank. The data plane is chosen per op
  (`Transport`): the fused ring kernels across processes when every rank
  holds a CUDA card, NCCL when each holds its own, then the host tiers.
  A rank computes on its process's current card and stream, and its
  calls block as the reference's do: a peer that does not come raises
  TimeoutError at the call, within the group's timeout; `check()` waits
  for the rank's work on the card.
  `create_collective_group` (or `declare_collective_group`) sets a group
  up from the process that owns the actors, through each actor's
  `__ray_collective_init__` (`CollectiveActorMixin`).
- backend="xla" from the processes of a multihost runtime
  (parallel/multihost.initialize), one rank each: `ProcessMeshGroup`
  (backends/device_backend.py), whose ops go to the DEVICE tier over the
  runtime's process group with no per-op vote (the reference's
  ProcessMeshGroup over the global mesh).
- backend="xla" otherwise: every rank of the group in this process, the
  counterpart of the reference's single-controller device group
  (xla_backend.XlaGroup), over the fused ring kernels of one address
  space (pallas_backend.LocalPallasTransport). `init_collective_group` is
  called once per rank and returns that rank's `RankHandle`; the module
  functions then take the rank by keyword (`rank=`). Rank r of a CUDA
  group sits on cuda:(r % torch.cuda.device_count()), each on its own
  stream; a rank's ops must run with its stream current (`with
  torch.cuda.stream(handle.stream)`), and every rank must make the same
  calls in the same order before the host waits on any: `handle.check()`
  is that wait.
"""

from __future__ import annotations

import threading

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.collective import metrics as _cm
from ray_tpu_torch.collective.types import (Backend, ReduceOp, Transport,
                                            normalize_quantize)


def rank_devices(world_size: int, device=None) -> list[torch.device]:
    """Each rank's device in an in-process group: all "cpu" when the
    caller asks for the CPU, else rank r on cuda:(r %
    torch.cuda.device_count()). None means CUDA and raises without it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * world_size
    n = torch.cuda.device_count()
    return [torch.device("cuda", r % n) for r in range(world_size)]


class LocalGroup:
    """Every rank of one group in this process (backend="xla")."""

    def __init__(self, group_name: str, world_size: int, timeout: float,
                 transport, quantize, device):
        from ray_tpu_torch.collective.backends.pallas_backend import (
            LocalPallasTransport)

        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if Transport(transport) not in (Transport.AUTO, Transport.PALLAS):
            raise ValueError(
                f"backend 'xla' runs the fused ring kernels in one process; "
                f"transport {Transport(transport).value!r} is a tier of "
                "backend 'host', one rank a process")
        self.group_name = group_name
        self.world_size = world_size
        self.timeout = timeout
        self.quantize = normalize_quantize(quantize)
        self.transport = LocalPallasTransport(
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
    """One rank's membership of an in-process group: its device, its
    stream (None on the CPU) and the op surface of the reference's group
    objects."""

    def __init__(self, group: LocalGroup, rank: int):
        self.group = group
        self.rank = rank
        self.world_size = group.world_size

    @property
    def device(self) -> torch.device:
        return self.group.transport.devices[self.rank]

    @property
    def stream(self):
        return self.group.transport.streams[self.rank]

    def _t(self):
        _cm.PALLAS_OPS += 1
        return self.group.transport

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM, quantize=None):
        """quantize: None = the group's default; "int8" = block-scaled
        int8 wire format; False = exact."""
        return self._t().allreduce(self.rank, tensor, op,
                                   quantize=self.group._q(quantize))

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        return self._t().reduce(self.rank, tensor, dst_rank, op,
                                quantize=self.group._q(None))

    def allgather(self, tensor) -> list:
        return self._t().allgather(self.rank, tensor)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM,
                      quantize=None):
        return self._t().reducescatter(self.rank, tensor, op,
                                       quantize=self.group._q(quantize))

    def broadcast(self, tensor, src_rank: int = 0):
        return self._t().broadcast(self.rank, tensor, src_rank)

    def shift_right(self, tensor):
        """Ring permute: this rank's tensor goes to rank (r + 1) % w, and
        rank (r - 1) % w's comes back."""
        return self._t().shift_right(self.rank, tensor)

    def barrier(self):
        self._t().barrier(self.rank)

    def check(self):
        """Waits for this rank's collectives; TimeoutError if one of them
        waited longer than the group's timeout for a peer."""
        self.group.transport.check(self.rank)


def _spans_processes(world_size: int) -> bool:
    """True when a group of world_size ranks is one rank a process of this
    process's multihost runtime (reference: collective.py:50-65)."""
    from ray_tpu_torch.parallel import multihost

    if world_size <= 1 or not multihost.is_initialized():
        return False
    import torch.distributed as dist

    return world_size == dist.get_world_size()


class GroupManager:
    """Per-process registry of collective groups (reference:
    collective.py:29)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: dict = {}

    def create_group(self, group_name: str, world_size: int, rank: int,
                     backend, timeout: float = 60.0,
                     transport: str = "auto", quantize=None, device=None):
        backend = Backend(backend)
        if backend == Backend.AUTO:
            backend = Backend.XLA if world_size == 1 else Backend.HOST
        if backend == Backend.XLA and _spans_processes(world_size):
            from ray_tpu_torch.collective.backends.device_backend import (
                ProcessMeshGroup)

            return self._add(group_name, lambda: ProcessMeshGroup(
                group_name, world_size, rank,
                quantize=normalize_quantize(quantize)))
        if backend == Backend.XLA:
            return self._join_local(group_name, world_size, rank, timeout,
                                    transport, quantize, device)
        from ray_tpu_torch.collective.backends.host_backend import HostGroup

        return self._add(group_name, lambda: HostGroup(
            group_name, world_size, rank, timeout=timeout,
            transport=Transport(transport).value,
            quantize=normalize_quantize(quantize)))

    def _add(self, group_name: str, make):
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(f"group {group_name!r} already exists")
        group = make()
        with self._lock:
            self._groups[group_name] = group
        return group

    def _join_local(self, group_name, world_size, rank, timeout, transport,
                    quantize, device) -> RankHandle:
        """Joins `rank` to the in-process group, creating the group at its
        first rank's call; a later rank's arguments must match the
        group's."""
        with self._lock:
            group = self._groups.get(group_name)
            if group is None:
                group = self._groups[group_name] = LocalGroup(
                    group_name, world_size, timeout, transport, quantize,
                    device)
            elif not isinstance(group, LocalGroup):
                raise RuntimeError(f"group {group_name!r} already exists")
            elif (group.world_size, group.timeout, group.quantize) != (
                    world_size, timeout, normalize_quantize(quantize)):
                raise ValueError(
                    f"group {group_name!r} exists with world_size "
                    f"{group.world_size}, timeout {group.timeout}, quantize "
                    f"{group.quantize}; rank {rank} asked for {world_size}, "
                    f"{timeout}, {quantize}")
            return group.join(rank)

    def get_group(self, group_name: str):
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
                          quantize=None, device=None):
    """Joins this process to a collective group as `rank` (reference:
    collective.py:93) and returns the group; with backend="xla", joins
    `rank` to the group of this process's ranks and returns its
    `RankHandle` (`device`: None for CUDA, "cpu" for the plain
    versions). `transport` pins the HOST data plane to one tier
    (pallas/device/shm/ring/ring_unpipelined/hub); "auto" routes per op.
    `quantize="int8"` makes the group's default allreduce wire format
    block-scaled int8 (lossy) on the tiers that have a wire; per-op
    `quantize=` overrides it."""
    return _manager.create_group(group_name, world_size, rank, backend,
                                 timeout=timeout, transport=transport,
                                 quantize=quantize, device=device)


def create_collective_group(actors, world_size: int, ranks: list[int],
                            backend: str = "host",
                            group_name: str = "default",
                            timeout: float = 60.0, quantize=None,
                            transport: str = "auto",
                            placement_group=None):
    """Driver-side declarative setup (reference: collective.py:126): tells
    every actor (a `CollectiveActorMixin` of the runtime) to join the
    group with its rank, all at once, and waits for every rank.

    `placement_group`: the gang's reservation, taken as the reference
    takes it. There, a record with an ICI_RING topology plan derives the
    tier under "auto"; the port's records carry no plan (no TPU
    topology, ROADMAP.md queue A item 4), so the groups vote per op as
    without one."""
    import ray_tpu_torch

    if len(actors) != len(ranks) or len(actors) != world_size:
        raise ValueError("actors/ranks/world_size mismatch")
    refs = [actor.__ray_collective_init__.remote(
        world_size, rank, backend, group_name, timeout, quantize, transport)
        for actor, rank in zip(actors, ranks)]
    return ray_tpu_torch.get(refs, timeout=max(120.0, 2 * timeout))


def declare_collective_group(actors, world_size: int, ranks: list[int],
                             backend: str = "host",
                             group_name: str = "default"):
    return create_collective_group(actors, world_size, ranks, backend,
                                   group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _manager.get_group(group_name)
        return True
    except ValueError:
        return False


def destroy_collective_group(group_name: str = "default"):
    """Frees the group (an in-process group waits for its ranks' streams
    first)."""
    _manager.destroy_group(group_name)


def get_group(group_name: str = "default"):
    return _manager.get_group(group_name)


def get_rank(group_name: str = "default") -> int:
    """The process's rank in the group; a process that holds several
    ranks of an in-process group names each by its handle."""
    group = _manager.get_group(group_name)
    if not isinstance(group, LocalGroup):
        return group.rank
    ranks = sorted(group._handles)
    if len(ranks) != 1:
        raise ValueError(f"this process holds ranks {ranks} of group "
                         f"{group_name!r}; each rank's handle names it")
    return ranks[0]


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get_group(group_name).world_size


def _member(group_name: str, rank: int | None):
    """The group's op surface for the caller: the process's HostGroup, or
    the named rank's handle of an in-process group."""
    group = _manager.get_group(group_name)
    if isinstance(group, LocalGroup):
        if rank is None:
            raise ValueError(f"group {group_name!r} holds every rank in this "
                             "process: name the calling rank (rank=)")
        return group.handle(rank)
    if rank is not None and rank != group.rank:
        raise ValueError(f"this process is rank {group.rank} of group "
                         f"{group_name!r}, not rank {rank}")
    return group


def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM, quantize=None, *, rank=None):
    """`quantize` (None = the group's default; "int8" = block-scaled int8
    wire format; False = exact) applies on the tiers that have a wire to
    compress: the fused kernels, the device ring and the host TCP ring.
    hub/shm always carry exact payloads."""
    return _member(group_name, rank).allreduce(tensor, op, quantize=quantize)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM, *, rank=None):
    return _member(group_name, rank).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default", *,
              rank=None):
    return _member(group_name, rank).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default", *, rank=None) -> list:
    return _member(group_name, rank).allgather(tensor)


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM, quantize=None, *, rank=None):
    return _member(group_name, rank).reducescatter(tensor, op,
                                                   quantize=quantize)


def barrier(group_name: str = "default", *, rank=None):
    _member(group_name, rank).barrier()


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0):
    """Point-to-point, HOST groups only (the reference's)."""
    _member(group_name, None).send(tensor, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    return _member(group_name, None).recv(src_rank, tag)


class CollectiveActorMixin:
    """Mixin giving an actor class the __ray_collective_init__ hook used by
    create_collective_group."""

    def __ray_collective_init__(self, world_size, rank, backend, group_name,
                                timeout=60.0, quantize=None,
                                transport="auto"):
        init_collective_group(world_size, rank, backend, group_name,
                              timeout=timeout, quantize=quantize,
                              transport=transport)
        return rank
