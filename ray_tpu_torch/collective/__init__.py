"""ray_tpu_torch.collective — collective groups; port of
ray_tpu/collective (see collective.py for the two kinds of group: one
rank a process, backend "host"; every rank in one process, backend
"xla")."""

from ray_tpu_torch.collective.collective import (
    CollectiveActorMixin, RankHandle, allgather, allreduce, barrier,
    broadcast, create_collective_group, declare_collective_group,
    destroy_collective_group, get_collective_group_size, get_group,
    get_rank, init_collective_group, is_group_initialized, recv,
    reduce, reducescatter, send)
from ray_tpu_torch.collective.types import Backend, ReduceOp, Transport

__all__ = ["Backend", "CollectiveActorMixin", "RankHandle", "ReduceOp",
           "Transport", "allgather", "allreduce", "barrier", "broadcast",
           "create_collective_group", "declare_collective_group",
           "destroy_collective_group", "get_collective_group_size",
           "get_group", "get_rank", "init_collective_group",
           "is_group_initialized", "recv", "reduce", "reducescatter", "send"]
