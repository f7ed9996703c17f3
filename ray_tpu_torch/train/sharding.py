"""Cross-replica weight-update shard math (ZeRO); the port's own copy of
ray_tpu/train/sharding.py:40-70.

Layout contract, shared by the operator's sharded step and the fused
reduce-scatter:
- the model's parameters flatten to ONE flat f32 bucket of `numel`
  elements (`model.parameters()` order);
- the bucket is zero-padded to ``padded_numel(numel, world)``, a
  multiple of world * QUANT_BLOCK, so every rank owns one uniform,
  QUANT_BLOCK-aligned span of ``padded_numel // world`` elements;
- rank r's span is ``[r*S, (r+1)*S)`` with ``S = padded_numel // world``;
- optimizer state is the user's optimizer over the rank's flat span.

`merge_opt_shards` and `reshard_opt_shards` (elastic resizes) wait for
ROADMAP.md A4 (Trainer.save/load and the elastic resize).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.collective.types import QUANT_BLOCK


def padded_numel(numel: int, world: int) -> int:
    """Smallest multiple of world * QUANT_BLOCK holding `numel`."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    unit = world * QUANT_BLOCK
    return -(-numel // unit) * unit


def shard_span(numel: int, world: int, rank: int) -> tuple[int, int]:
    """Rank's [lo, hi) span of the padded flat bucket."""
    s = padded_numel(numel, world) // world
    return rank * s, (rank + 1) * s


def shard_spans(numel: int, world: int) -> list[tuple[int, int]]:
    return [shard_span(numel, world, r) for r in range(world)]


def opt_nbytes(opt_state) -> int:
    """Bytes held by the tensors of an optimizer state (a
    `torch.optim.Optimizer.state_dict()` or any nest of dicts, lists and
    tensors): 1/N of the replicated figure in sharded mode."""
    if isinstance(opt_state, torch.Tensor):
        return opt_state.numel() * opt_state.element_size()
    if isinstance(opt_state, dict):
        return sum(opt_nbytes(v) for v in opt_state.values())
    if isinstance(opt_state, (list, tuple)):
        return sum(opt_nbytes(v) for v in opt_state)
    return 0
