"""Collective types; the port's own copy of ray_tpu/collective/types.py
(reference: python/ray/util/collective/types.py)."""

from __future__ import annotations

import enum

import torch


class Backend(str, enum.Enum):
    """Collective backends.

    HOST — one rank a process: the runtime's per-process collective group
          (backends/host_backend.HostGroup), whose data plane is chosen per
          op by `Transport`.
    XLA — every rank of a group in one process, each on its own CUDA
          stream (rank r on cuda:(r % device_count)), over the fused ring
          kernels: the counterpart of the JAX package's single-controller
          device group (xla_backend.XlaGroup). Its ranks are joined one by
          one and named by their handles.
    AUTO — XLA for a group of one, else HOST.
    """

    XLA = "xla"
    HOST = "host"
    AUTO = "auto"


class Transport(str, enum.Enum):
    """HOST-backend data-plane tiers (selected per op by a unanimous vote,
    payload size and node placement; pin one with transport=...).

    PALLAS — the fused ring collectives, one hand-written CUDA kernel per
          op and rank (backends/pallas_backend.py), the peers' buffers
          mapped through CUDA IPC: when every rank holds a card and a CUDA
          payload of a built instance. Where every rank holds a card of
          its own it carries unquantized payloads up to the reference's
          64 KB gate (HostGroup.PALLAS_MAX_BYTES) and larger ones go to
          DEVICE; where ranks share a card, and for an int8-quantized op
          (NCCL has no int8 wire), it carries every size.
    DEVICE — a torch.distributed process group of the group's own (NCCL
          when every rank holds a card of its own; gloo on the CPU when
          forced): backends/device_backend.DeviceTransport.
    SHM — one mmap'd tmpfs segment per group when every rank shares a
          node: collectives become pure memory traffic.
    RING — direct rank-to-rank TCP ring, chunk-pipelined and zero-copy.
    RING_UNPIPELINED — the reference's unpipelined ring ALLREDUCE, the
          control arm of its perf A/B; other ops run the pipelined ring.
    HUB — star topology through rank 0's socket; carries every op kind.
    AUTO — pallas, then device, by vote; else shm when node-local, else
          ring, else hub.
    """

    AUTO = "auto"
    HUB = "hub"
    RING = "ring"
    RING_UNPIPELINED = "ring_unpipelined"
    SHM = "shm"
    DEVICE = "device"
    PALLAS = "pallas"


class ReduceOp(str, enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    MEAN = "mean"


_NUMPY_REDUCE = {
    ReduceOp.SUM: "add",
    ReduceOp.PRODUCT: "multiply",
    ReduceOp.MIN: "minimum",
    ReduceOp.MAX: "maximum",
}

# Block-scaled int8 quantization (EQuARX-style): payloads are cut into
# QUANT_BLOCK-element blocks, each carried on the wire as int8 values
# plus one float32 scale (absmax/127); the reduce happens on the
# dequantized float32 values.
QUANT_BLOCK = 256
QUANTIZE_INT8 = "int8"


def is_cuda_tensor(tensor) -> bool:
    """True for a torch tensor on a CUDA device: the payloads the fused
    ring kernels take (the counterpart of the JAX package's
    `is_jax_array`)."""
    return isinstance(tensor, torch.Tensor) and tensor.device.type == "cuda"


def normalize_quantize(quantize) -> str | None:
    """Canonicalize the `quantize=` knob: None/""/"none"/False mean
    exact; "int8" selects block-scaled int8. Anything else is a typo
    that must fail loudly (a silently-ignored lossy knob would corrupt
    an A/B)."""
    if quantize in (None, False, "", "none"):
        return None
    if str(quantize).lower() == QUANTIZE_INT8:
        return QUANTIZE_INT8
    raise ValueError(
        f"unknown quantize mode {quantize!r} (expected None or 'int8')")
