"""ray_tpu_torch.collective — collective groups over the fused ring
kernels; port of ray_tpu/collective (see collective.py for how ranks,
devices and streams map in one process)."""

from ray_tpu_torch.collective.collective import (
    RankHandle, allgather, allreduce, barrier,
    create_collective_group, destroy_collective_group,
    get_collective_group_size, get_handle, get_rank,
    init_collective_group, is_group_initialized, reduce, reducescatter)
from ray_tpu_torch.collective.types import Backend, ReduceOp, Transport

__all__ = ["Backend", "RankHandle", "ReduceOp", "Transport", "allgather",
           "allreduce", "barrier", "create_collective_group",
           "destroy_collective_group", "get_collective_group_size",
           "get_handle", "get_rank", "init_collective_group",
           "is_group_initialized", "reduce", "reducescatter"]
