"""Logical-axis sharding rules; port of ray_tpu/parallel/sharding.py.

Model code annotates parameters with *logical* axis names ("embed",
"heads", "mlp", "vocab", ...); a rule table maps logical names to mesh
axes. Changing the parallelism layout = changing the table, not the
model. The specs are the port's `parallel.mesh.PartitionSpec` and the
shardings its `NamedSharding` over a DeviceMesh of the ranks.

A model's logical tree has the JAX package's layout (block parameters
stacked on a leading "layers" axis); `models.transformer.named_axes`
maps it onto the port's `named_parameters()`.
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec as P

# Default rule table for transformer-family models.
DEFAULT_RULES: dict[str, str | None] = {
    "batch": "dp",
    "seq": "sp",
    "embed": None,          # replicated across tp (activations gather)
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",          # stacked pipeline-stage leading axis
    "norm": None,
}


def spec_for(logical_axes: tuple[str | None, ...],
             rules: dict[str, str | None] | None = None) -> P:
    rules = {**DEFAULT_RULES, **(rules or {})}
    return P(*(None if name is None else rules.get(name)
               for name in logical_axes))


class WithLogicalAxes:
    """Wrapper marking an initializer's output with logical axes; used by
    models to attach metadata without depending on a framework's
    internals."""

    def __init__(self, init_fn, logical_axes: tuple[str | None, ...]):
        self.init_fn = init_fn
        self.logical_axes = logical_axes

    def __call__(self, *args, **kwargs):
        return self.init_fn(*args, **kwargs)


def is_axes(x) -> bool:
    """A leaf of a logical tree: a tuple of axis names or None."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, tree):
    """fn over every logical-axes leaf of a nest of dicts and lists."""
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_axes(fn, v) for v in tree)
    raise TypeError(f"not a logical-axes tree leaf: {tree!r}")


def tree_shardings(mesh, logical_tree: Any,
                   rules: dict[str, str | None] | None = None):
    """Map a tree of logical-axis tuples to NamedShardings."""
    return map_axes(lambda axes: NamedSharding(mesh, spec_for(axes, rules)),
                    logical_tree)


def shard_bounds(dim: int, rank: int, num_shards: int) -> tuple[int, int]:
    """Contiguous [lo, hi) range of a dimension owned by `rank` when the
    dimension is split over `num_shards` Megatron-style. Uneven splits
    spread the remainder over the FIRST shards (every rank still gets a
    non-degenerate slice as long as dim >= num_shards)."""
    if not 0 <= rank < num_shards:
        raise ValueError(f"rank {rank} outside [0, {num_shards})")
    if dim < num_shards:
        raise ValueError(
            f"cannot split dimension {dim} over {num_shards} shards")
    base, rem = divmod(dim, num_shards)
    lo = rank * base + min(rank, rem)
    hi = lo + base + (1 if rank < rem else 0)
    return lo, hi


def column_shard(w, rank: int, num_shards: int):
    """This rank's slice of a COLUMN-parallel weight (Megatron's
    ColumnParallelLinear: output features sharded, logical axes
    ("embed", "mlp") -> P(None, "model")): w[..., lo:hi] of the LAST
    axis. The activation after x @ w_col is already shard-local, so no
    communication follows it."""
    lo, hi = shard_bounds(w.shape[-1], rank, num_shards)
    return w[..., lo:hi]


def kv_slice(width: int, rank: int, num_shards: int) -> tuple[int, int]:
    """This rank's [lo, hi) slice of a KV vector's inner dimension: the
    per-shard page slice of a paged KV cache whose up-projection is
    column-sharded, so cache reads and writes stay shard-local. The same
    arithmetic as column_shard's last-axis bounds, named so cache sizing
    and weight slicing cannot drift apart."""
    return shard_bounds(width, rank, num_shards)


def row_shard(w, rank: int, num_shards: int):
    """This rank's slice of a ROW-parallel weight (Megatron's
    RowParallelLinear: input features sharded, logical axes
    ("mlp", "embed") -> P("model", None)): w[lo:hi] of the FIRST axis.
    The per-shard output is a PARTIAL sum: callers allreduce(SUM) it
    across the shard group to recover the full matmul."""
    lo, hi = shard_bounds(w.shape[0], rank, num_shards)
    return w[lo:hi]


def infer_param_logical_axes(params: Any) -> Any:
    """Heuristic logical axes for unannotated parameters: a 2-D leaf whose
    name holds "embedding" is ("vocab", "embed"), every other leaf is
    replicated. params: an nn.Module (its `named_parameters()`, giving a
    dict by dotted name), a dict of them by name, or a nest of dicts
    (names joined with "/", as the JAX package joins a pytree path)."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())

    def leaf_axes(name, leaf):
        rank = len(getattr(leaf, "shape", ()))
        if rank == 0:
            return ()
        if "embedding" in name.lower() and rank == 2:
            return ("vocab", "embed")
        return tuple([None] * rank)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return leaf_axes(prefix, tree)

    return walk(params, "")
