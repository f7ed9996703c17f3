"""Cross-replica weight-update shard math (ZeRO); the port's own copy of
ray_tpu/train/sharding.py.

Layout contract, shared by the operator's sharded step and the fused
reduce-scatter:
- the model's parameters flatten to ONE flat f32 bucket of `numel`
  elements (`model.parameters()` order);
- the bucket is zero-padded to ``padded_numel(numel, world)``, a
  multiple of world * QUANT_BLOCK, so every rank owns one uniform,
  QUANT_BLOCK-aligned span of ``padded_numel // world`` elements;
- rank r's span is ``[r*S, (r+1)*S)`` with ``S = padded_numel // world``;
- optimizer state is the user's optimizer over the rank's flat span; its
  leaves (`TrainingOperator.opt_shard_state`) are torch CPU tensors in
  sorted state-name order, each either a 1-D vector of exactly the span's
  length (partitioned: momentum, AdamW's moments) or anything else
  (replicated: AdamW's 0-d `step`). Resharding relies on exactly that
  dichotomy.

Reshard-on-resize contract: pad-region gradients are identically zero,
so pad-region optimizer state stays at its zero init; merging shards and
re-splitting them to a new world size reconstructs the exact state any
world size would have reached.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.collective.types import QUANT_BLOCK

# reshard_opt_shards calls in this process (the driver's elastic restore
# and checkpoint load; the reference counts them through its failpoint
# "train.reshard")
RESHARDS = 0


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


def _is_partitioned(leaf, span_elems: int) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim == 1
            and leaf.numel() == span_elems)


def merge_opt_shards(shards: list[dict]) -> list:
    """Merge per-rank shard states (``opt_shard_state()`` dicts, rank
    order) back into full padded flat leaves: partitioned leaves
    concatenate across ranks, replicated leaves come from rank 0."""
    if not shards:
        raise ValueError("no shards to merge")
    order = sorted(shards, key=lambda s: s["rank"])
    ranks = [s["rank"] for s in order]
    if ranks != list(range(len(order))):
        raise ValueError(f"shard set is not ranks 0..N-1: {ranks}")
    span = order[0]["span"][1] - order[0]["span"][0]
    merged = []
    for j, leaf in enumerate(order[0]["leaves"]):
        if _is_partitioned(leaf, span):
            merged.append(torch.cat([s["leaves"][j] for s in order]))
        else:
            merged.append(leaf)
    return merged


def reshard_opt_shards(shards: list[dict], new_world: int) -> list[dict]:
    """Re-partition a saved or live shard set to `new_world` ranks: the
    elastic-resize restore and the any-world-size checkpoint load.
    Partitioned leaves are merged, trimmed to the real `numel`, then
    zero-padded to the NEW padded numel and split into uniform spans."""
    global RESHARDS
    if not shards:
        raise ValueError("no shards to reshard")
    numel = int(shards[0]["numel"])
    merged = merge_opt_shards(shards)
    old_span = shards[0]["span"][1] - shards[0]["span"][0]
    new_pad = padded_numel(numel, new_world)
    s = new_pad // new_world
    out = []
    for rank in range(new_world):
        lo, hi = rank * s, (rank + 1) * s
        leaves = []
        for j, full in enumerate(merged):
            if _is_partitioned(shards[0]["leaves"][j], old_span):
                vec = full.new_zeros(new_pad)
                vec[:numel] = full[:numel]
                leaves.append(vec[lo:hi].clone())
            else:
                leaves.append(full)
        out.append({"rank": rank, "world_size": new_world,
                    "span": (lo, hi), "numel": numel,
                    "pad_numel": new_pad, "leaves": leaves})
    RESHARDS += 1
    return out
