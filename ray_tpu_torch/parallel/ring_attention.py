"""Ring attention; port of ray_tpu/parallel/ring_attention.py.

Exact attention over sequence shards with a ppermute ring (sequence /
context parallelism). Each rank on the `sp` axis holds a sequence block
of Q, K, V. K/V blocks rotate around the ring; every step each rank
accumulates its Q block's attention against the visiting K/V block with a
streaming (flash-style) softmax, max and denominator carried in float32,
so the result is exact regardless of ring size.

Causal masking uses global positions derived from each block's ring
origin, so blocks whose keys are entirely in the future are fully masked
and add exactly 0 (they still travel the ring: the schedule is uniform).
The ring's gradients come from `parallel.spmd.ppermute`, whose backward
sends each cotangent along the inverse permutation.
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.mesh import (P, axis_index, axis_size,
                                         shard_map)


def _block_attn(q, k, v, o, m, l, q_offset, kv_offset, causal, scale):
    """One streaming-softmax accumulation step.

    q: [B, Tq, H, D]   k/v: [B, Tk, H, D]
    o: [B, Tq, H, D] f32 accumulator, m/l: [B, H, Tq] f32 running max/denom.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(tk, device=q.device)[None, :]
        scores = torch.where((q_pos >= k_pos)[None, None], scores,
                             -torch.inf)
    block_max = scores.amax(dim=-1)  # [B,H,Tq]
    new_m = torch.maximum(m, block_max)
    # fully-masked rows have new_m == -inf; keep exp() finite
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    p = torch.exp(scores - safe_m[..., None])  # [B,H,Tq,Tk]
    if causal:
        p = torch.where(torch.isfinite(scores), p, 0.0)
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l_new = l * correction + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return o_new, new_m, l_new


def ring_attention(q, k, v, *, axis_name: str = "sp", causal: bool = True,
                   scale: float | None = None):
    """Call INSIDE shard_map: q,k,v are local blocks [B, T_local, H, D]
    sharded along T over `axis_name`. Returns the local output block."""
    sp = axis_size(axis_name)
    idx = axis_index(axis_name)
    b, t_local, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t_local), -torch.inf, device=q.device)
    l = torch.zeros((b, h, t_local), device=q.device)
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    q_offset = idx * t_local
    for step in range(sp):
        kv_origin = (idx - step) % sp
        o, m, l = _block_attn(q, k, v, o, m, l,
                              q_offset, kv_origin * t_local, causal, scale)
        if step != sp - 1:
            k = spmd.ppermute(k, axis_name, perm)
            v = spmd.ppermute(v, axis_name, perm)
    denom = torch.where(l > 0, l, 1.0).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, *, causal: bool = True,
                           batch_axis: str = "dp", seq_axis: str = "sp",
                           head_axis: str = "tp"):
    """Driver-level entry: q,k,v are global [B, T, H, D] (every rank of the
    mesh passes the same); batch sharded over dp, sequence over sp, heads
    over tp. Returns the global output on every rank."""
    spec = P(batch_axis, seq_axis, head_axis, None)
    fn = shard_map(
        functools.partial(ring_attention, axis_name=seq_axis, causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)


def reference_attention(q, k, v, causal: bool = True,
                        scale: float | None = None):
    """Dense reference used in tests and as the sp=1 fast path: f32
    scores and probabilities, one cast to q's dtype at the end."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        scores = torch.where(mask[None, None], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
