"""Pipeline parallelism; port of ray_tpu/parallel/pipeline.py.

GPipe microbatch schedule over the `pp` mesh axis. Each rank on the pp
axis holds one stage's parameters (a stacked leading `stage` axis sharded
over pp). Activations flow stage to stage with ppermute; the schedule
runs M + P - 1 ticks for M microbatches over P stages, a static loop.

The backward runs the mirrored schedule: `parallel.spmd.ppermute`'s
gradient sends each cotangent back along the inverse permutation, and
`psum`'s is psum.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.mesh import (P, _tree_map, axis_index,
                                         axis_size, shard_map)


def _pipeline_local(stage_params, x_micro, *, stage_fn: Callable,
                    axis_name: str):
    """Runs inside shard_map. stage_params: this stage's params (leading
    stage axis already sliced to size 1, squeezed here). x_micro:
    [M, mb, ...] microbatched input (replicated; only stage 0 reads it).
    Returns [M, mb, ...] outputs (replicated via masked psum)."""
    pp = axis_size(axis_name)
    idx = axis_index(axis_name)
    params = _tree_map(lambda p: p[0], stage_params)
    m = x_micro.shape[0]
    perm = [(i, (i + 1) % pp) for i in range(pp)]

    carry = torch.zeros_like(x_micro[0])  # inter-stage activation register
    outputs = [torch.zeros_like(x_micro[0]) for _ in range(m)]
    # selects and a 0/1 commit, not branches, as the reference's: every
    # stage builds the same graph, so the backward's ppermutes run on
    # every rank in the same order
    first = torch.tensor(idx == 0, device=x_micro.device)
    commit = 1.0 if idx == pp - 1 else 0.0
    for tick in range(m + pp - 1):
        # stage 0 injects microbatch `tick` (if still in range)
        inject = x_micro[min(tick, m - 1)]
        stage_in = torch.where(
            first, inject if tick < m else torch.zeros_like(inject), carry)
        y = stage_fn(params, stage_in)
        # last stage commits microbatch (tick - pp + 1)
        out_slot = tick - (pp - 1)
        if 0 <= out_slot < m:
            outputs[out_slot] = outputs[out_slot] + (commit * y).to(
                x_micro.dtype)
        carry = spmd.ppermute(y, axis_name, perm)
    # replicate last-stage outputs to all pp ranks
    return spmd.psum(torch.stack(outputs), axis_name)


def pipeline_apply(stage_fn: Callable, stage_params, x, *,
                   mesh, num_microbatches: int, axis_name: str = "pp",
                   data_axis: str = "dp"):
    """stage_fn(params, x) -> y with matching x/y shapes (transformer-block
    stack). stage_params: a dict of tensors with a leading `stage` axis of
    size pp. x: [B, ...] global batch (sharded over dp); every rank of the
    mesh passes the same. Returns [B, ...] on every rank."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError("batch not divisible by num_microbatches")
    x_micro = x.reshape((num_microbatches, b // num_microbatches)
                        + tuple(x.shape[1:]))
    fn = shard_map(
        functools.partial(_pipeline_local, stage_fn=stage_fn,
                          axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(axis_name), P(None, data_axis)),
        out_specs=P(None, data_axis),
    )
    y_micro = fn(stage_params, x_micro)
    return y_micro.reshape((b,) + tuple(y_micro.shape[2:]))


def stack_stage_params(per_stage_params: list):
    """Stack per-stage param dicts along a new leading `stage` axis."""
    first = per_stage_params[0]
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in first}
