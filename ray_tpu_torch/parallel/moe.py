"""Expert parallelism; port of ray_tpu/parallel/moe.py.

Switch-style top-1 MoE with all_to_all dispatch over the `ep` mesh axis.
Dense-dispatch formulation (einsum with one-hot dispatch/combine masks):
no gathers or scatters of data-dependent shape, and the only traffic
between ranks is two all_to_alls on [experts, capacity, model] buffers.

Routing matches the reference exactly: softmax probabilities, the first
index of the largest under argmax, positions in each expert's buffer from
an f32 cumulative sum, and a capacity from the rank's LOCAL token count,
so which rows a rank holds decides which tokens are dropped.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.mesh import P, axis_size, shard_map


def _one_hot(idx, n, dtype):
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top1_routing(router_logits, capacity: int):
    """router_logits: [N, E]. Returns (dispatch [N,E,C], combine [N,E,C],
    aux_loss scalar)."""
    n, e = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # [N], first index on ties
    expert_mask = _one_hot(expert_idx, e, probs.dtype)  # [N,E]
    # load-balancing auxiliary loss (Switch Transformer eq. 4)
    density = expert_mask.mean(0)
    density_proxy = probs.mean(0)
    aux_loss = (density * density_proxy).sum() * e
    # position of each token within its expert's capacity buffer
    position = (torch.cumsum(expert_mask, dim=0) - 1.0) * expert_mask
    keep = (position < capacity).to(probs.dtype) * expert_mask
    pos_onehot = _one_hot(position.sum(-1).to(torch.int32), capacity,
                          probs.dtype)  # [N,C]
    dispatch = keep[:, :, None] * pos_onehot[:, None, :]  # [N,E,C]
    gate = (probs * expert_mask).sum(-1)  # [N]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, aux_loss


def _moe_local(x, router_w, w_in, w_out, *, axis_name: str,
               capacity_factor: float):
    """Inside shard_map over ep. x: [N_local, D] local tokens; router_w:
    [D, E_total]; w_in/w_out: this shard's experts [E_local, D, F] /
    [E_local, F, D]. The router and the experts run in their weights'
    dtype (f32), as the reference's promotion does; the output is cast
    to x's dtype. Returns (out [N_local, D], aux [1])."""
    ep = axis_size(axis_name)
    n_local, d = x.shape
    e_local = w_in.shape[0]
    e_total = e_local * ep
    capacity = max(1, int(capacity_factor * n_local / e_total))
    wdt = router_w.dtype
    xw = x.to(torch.promote_types(x.dtype, wdt))

    logits = xw @ router_w  # [N_local, E_total]
    dispatch, combine, aux = top1_routing(logits, capacity)

    # [N,E,C] x [N,D] -> [E_total, C, D] -> group by owner shard
    expert_in = torch.einsum("nec,nd->ecd", dispatch, xw)
    expert_in = expert_in.reshape(ep, e_local, capacity, d)
    # all_to_all: shard i sends block j to shard j; receives [ep, e_local,C,D]
    expert_in = spmd.all_to_all(expert_in, axis_name, split_axis=0,
                                concat_axis=0, tiled=False)
    # -> [ep(sources), e_local, C, D]; fold sources into capacity
    expert_in = expert_in.transpose(0, 1).reshape(e_local, ep * capacity, d)

    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_in),
               approximate="tanh")
    y = torch.einsum("ecf,efd->ecd", h, w_out)  # [e_local, ep*C, D]

    y = y.reshape(e_local, ep, capacity, d).transpose(0, 1)
    y = spmd.all_to_all(y, axis_name, split_axis=0, concat_axis=0,
                        tiled=False)  # back: [ep, e_local, C, D]
    y = y.reshape(e_total, capacity, d)
    out = torch.einsum("nec,ecd->nd", combine, y)
    return out.to(x.dtype), aux[None]


def moe_apply(x, router_w, w_in, w_out, *, mesh,
              capacity_factor: float = 1.25, axis_name: str = "ep",
              token_axis="dp"):
    """Driver-level entry. x: [N, D] tokens (sharded over token_axis);
    w_in/w_out: [E, D, F] / [E, F, D] sharded over ep on the expert axis;
    every rank of the mesh passes the same global tensors. Returns
    (out [N, D], the mean aux loss) on every rank."""
    fn = shard_map(
        functools.partial(_moe_local, axis_name=axis_name,
                          capacity_factor=capacity_factor),
        mesh=mesh,
        in_specs=(P(token_axis, None), P(), P(axis_name), P(axis_name)),
        out_specs=(P(token_axis, None), P(token_axis)),
    )
    out, aux = fn(x, router_w, w_in, w_out)
    return out, aux.mean()
