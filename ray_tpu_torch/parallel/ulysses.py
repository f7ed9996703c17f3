"""Ulysses sequence parallelism; port of ray_tpu/parallel/ulysses.py.

All-to-all head/sequence transposition (DeepSpeed-Ulysses). Each rank on
the `sp` axis holds a sequence shard [B, S/sp, H, D]. One all_to_all
re-partitions to [B, S, H/sp, D] (full sequence, head shard), so every
rank runs ordinary attention for its heads with no inner communication;
a second all_to_all transposes back. Total traffic is two all-to-alls of
the activation, against ring attention's sp-step ppermute pipeline.

Constraint: num_heads % sp == 0 (heads are the second shard axis)."""

from __future__ import annotations

import functools

from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.mesh import P, axis_size, shard_map
from ray_tpu_torch.parallel.ring_attention import reference_attention


def ulysses_attention(q, k, v, *, axis_name: str = "sp",
                      causal: bool = True, scale: float | None = None):
    """Call INSIDE shard_map: q,k,v local [B, S_local, H, D], sequence
    sharded over `axis_name`. Returns the local output shard."""
    sp = axis_size(axis_name)
    b, s_local, h, d = q.shape
    if h % sp:
        raise ValueError(
            f"ulysses needs num_heads divisible by the sp axis "
            f"({h} % {sp} != 0); use ring_attention instead")
    if sp == 1:
        return reference_attention(q, k, v, causal=causal, scale=scale)

    def seq_to_head(x):
        # [B, S/sp, H, D] -> [B, S, H/sp, D]: split heads across the
        # axis, gather the full sequence
        return spmd.all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                               tiled=True)

    qg, kg, vg = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    out = reference_attention(qg, kg, vg, causal=causal, scale=scale)
    # [B, S, H/sp, D] -> [B, S/sp, H, D]
    return spmd.all_to_all(out, axis_name, split_axis=1, concat_axis=2,
                           tiled=True)


def ulysses_attention_sharded(q, k, v, mesh, *,
                              causal: bool = True,
                              batch_axis: str = "dp",
                              seq_axis: str = "sp"):
    """Driver-level entry: q,k,v global [B, S, H, D] (every rank of the
    mesh passes the same); batch over dp, sequence over sp (heads stay
    replicated outside, sharded inside). Returns the global output on
    every rank."""
    spec = P(batch_axis, seq_axis, None, None)
    fn = shard_map(
        functools.partial(ulysses_attention, axis_name=seq_axis,
                          causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
