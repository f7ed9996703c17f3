"""Collective types; the port's own copy of ray_tpu/collective/types.py
(reference: python/ray/util/collective/types.py)."""

from __future__ import annotations

import enum

import torch


class Backend(str, enum.Enum):
    """Collective backends.

    HOST — a group of ranks with a data plane chosen by `Transport`; in
          this port every rank of a group lives in one process, and the
          only data plane is PALLAS (the fused ring kernels).
    XLA — the JAX package's single-controller device group; not ported
          (ROADMAP.md queue A item 5).
    AUTO — HOST.
    """

    XLA = "xla"
    HOST = "host"
    AUTO = "auto"


class Transport(str, enum.Enum):
    """Data-plane tiers, named as in the JAX package.

    PALLAS — the fused ring collectives, one hand-written CUDA kernel
          per op and rank (backends/pallas_backend.py). It carries every
          payload size here: the JAX package's 64 KB gate and its
          fall-through to DEVICE come with ROADMAP.md A5 and A9.
    DEVICE — the device plane of the JAX package (XLA collectives); its
          port, over NCCL, is ROADMAP.md A5.
    HUB, RING, RING_UNPIPELINED, SHM — the runtime's host tiers, for
          ranks in processes of their own: ROADMAP.md A5.
    AUTO — PALLAS in this port.
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
