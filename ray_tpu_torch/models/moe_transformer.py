"""Long-context MoE transformer; port of ray_tpu/models/moe_transformer.py.

Switch-style decoder: every block is [attention over the sp axis] +
[top-1 MoE MLP over the ep axis], on any mesh of the five axes. Attention
is selectable:
  "ring"    — ppermute ring over sequence shards (huge S)
  "ulysses" — all-to-all head/sequence transpose (short rings)
  "dense"   — every rank attends against the gathered K/V (tests, sp=1)

The reference is one global program (GSPMD) whose attention and expert
dispatch are shard_map'd over the mesh. The port is the SPMD program
itself: every rank of the mesh calls `apply`/`loss_fn` with the same
global tokens; rank (dp i, sp j, ep k) keeps its own activation block
[B/dp, T/sp, D] between layers and calls the rank-local bodies
(`ring_attention`, `ulysses_attention`, `_moe_local`) on it under
`mesh.manual`; the global logits are assembled only at the end. The
expert MLP takes the reference's token rows: the flattened [B*T, D] rows
split over ("dp", "sp"), dp major, which differ from the attention block
when B/dp > 1, so each layer moves the rows between the sp ranks there
and back (`spmd.all_to_all_rows`); the capacity comes from those local
rows, as the reference's. Over tp, ring attention takes the rank's slice
of the heads (the reference's spec P(dp, sp, tp, None)) and gathers the
heads back; Ulysses, the MoE MLP and the projections keep heads and rows
whole, so the tp ranks compute them alike (the reference's GSPMD
replicates them, or shards the projections and sums: the same values).
Over pp every computation is replicated, as GSPMD replicates it.

Gradients are the global loss's on every rank: each parameter enters a
step through `spmd.pvary` (its cotangent psum'd over the axes it is
replicated on), and the loss leaves through shard_map's output rule.

Parameters are named as the JAX pytree's keys, blocks unstacked; a rank
holds its ep slice of `w_in`/`w_out` ([E/ep, ...]) and every other
parameter whole.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.ops import layernorm as ln
from ray_tpu_torch.parallel import moe, spmd
from ray_tpu_torch.parallel.mesh import (P, axis_index, axis_size,
                                         current_layout, layout, manual,
                                         mesh_device)
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention

ATTENTION = ("ring", "ulysses", "dense")
_BLOCK_KEYS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "wqkv", "wo", "router",
               "w_in", "w_out")
_EXPERT_KEYS = ("w_in", "w_out")
_TOKEN_AXES = ("dp", "sp")


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig:
    vocab_size: int = 32000
    n_layers: int = 4
    n_heads: int = 8
    d_model: int = 512
    d_ff: int = 1024          # per-expert hidden
    num_experts: int = 8
    capacity_factor: float = 1.25
    max_seq: int = 4096
    dtype: torch.dtype = torch.bfloat16
    attention: str = "ring"   # "ring" | "ulysses" | "dense"
    aux_loss_coeff: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


TINY_MOE = MoETransformerConfig(
    vocab_size=128, n_layers=2, n_heads=4, d_model=32, d_ff=64,
    num_experts=4, max_seq=64, dtype=torch.float32)


def _layernorm(x, w, b):
    """B3's wrapper (its plain version on a CPU tensor) under the
    reference's backward."""
    return ln.layernorm(x, w.to(x.dtype), b.to(x.dtype))


def _dense(gen, shape, fan_in):
    return torch.randn(shape, generator=gen) / math.sqrt(fan_in)


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoETransformerConfig, gen, experts: slice):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.ln1_w = nn.Parameter(torch.ones(d))
        self.ln1_b = nn.Parameter(torch.zeros(d))
        self.ln2_w = nn.Parameter(torch.ones(d))
        self.ln2_b = nn.Parameter(torch.zeros(d))
        self.wqkv = nn.Parameter(_dense(gen, (d, 3 * d), d))
        self.wo = nn.Parameter(_dense(gen, (d, d), d))
        self.router = nn.Parameter(_dense(gen, (d, e), d))
        self.w_in = nn.Parameter(_dense(gen, (e, d, f), d)[experts].clone())
        self.w_out = nn.Parameter(_dense(gen, (e, f, d), f)[experts].clone())


class MoETransformer(nn.Module):
    """This rank's part of the model on `mesh` (a MeshSpec's DeviceMesh):
    every parameter but its ep slice of the experts.
    The weights are drawn on the CPU from `seed` (the same on every rank)
    and moved to the mesh's device."""

    def __init__(self, cfg: MoETransformerConfig, mesh, seed: int = 0):
        super().__init__()
        if cfg.attention not in ATTENTION:
            raise ValueError(f"unknown attention {cfg.attention!r}: "
                             "expected 'ring', 'ulysses', or 'dense'")
        lay = layout(mesh)
        if cfg.attention == "ring" and cfg.n_heads % lay.size("tp"):
            raise ValueError(f"{cfg.n_heads} heads do not split over "
                             f"tp = {lay.size('tp')}")
        ep = lay.size("ep")
        if cfg.num_experts % ep:
            raise ValueError(f"{cfg.num_experts} experts do not split over "
                             f"ep = {ep}")
        e_local = cfg.num_experts // ep
        experts = slice(lay.index("ep") * e_local,
                        (lay.index("ep") + 1) * e_local)
        self.cfg, self.mesh = cfg, mesh
        gen = torch.Generator().manual_seed(seed)
        d = cfg.d_model
        self.wte = nn.Parameter(torch.randn((cfg.vocab_size, d),
                                            generator=gen) * 0.02)
        self.wpe = nn.Parameter(torch.randn((cfg.max_seq, d),
                                            generator=gen) * 0.01)
        self.blocks = nn.ModuleList(MoEBlock(cfg, gen, experts)
                                    for _ in range(cfg.n_layers))
        self.lnf_w = nn.Parameter(torch.ones(d))
        self.lnf_b = nn.Parameter(torch.zeros(d))
        self.to(mesh_device(mesh))

    def forward(self, tokens):
        return apply(self, tokens)


def logical_axes(cfg: MoETransformerConfig):
    """Logical axes for sharding.tree_shardings (JAX layout): experts
    shard over ep, attention/mlp projections over tp ("mlp"/"heads"
    rules)."""
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": {
            "ln1_w": ("layers", "norm"), "ln1_b": ("layers", "norm"),
            "ln2_w": ("layers", "norm"), "ln2_b": ("layers", "norm"),
            "wqkv": ("layers", "embed", "mlp"),
            "wo": ("layers", "mlp", "embed"),
            "router": ("layers", "embed", None),
            "w_in": ("layers", "expert", "embed", None),
            "w_out": ("layers", "expert", None, "embed"),
        },
        "lnf_w": ("norm",), "lnf_b": ("norm",),
    }


def named_axes(cfg: MoETransformerConfig) -> dict:
    """{parameter name: logical axes} of the port's MoETransformer."""
    return tfm.named_axes(logical_axes(cfg), cfg.n_layers)


# ---------------------------------------------------------------------------
# the rank-local program
# ---------------------------------------------------------------------------

def _token_rows(lay, b: int, t: int):
    """How rank (dp i, sp j)'s attention block [B/dp, T/sp] maps onto the
    reference's MoE rows (the dp block's flattened [B/dp * T] rows split
    over sp): the rows it sends each sp rank (its own rows in order are
    sorted by destination), the rows it receives from each, and the
    permutation that puts the received rows in flat order. None where the
    two layouts agree (sp = 1 or B/dp = 1)."""
    sp, j = lay.size("sp"), lay.index("sp")
    bl, tl = b // lay.size("dp"), t // sp
    if sp == 1 or bl == 1:
        return None
    rows = bl * tl  # rows of one (dp, sp) shard

    def flat(src):  # flat row indices of sp rank src's block, in its order
        return (np.arange(bl)[:, None] * t + src * tl
                + np.arange(tl)[None, :]).reshape(-1)

    mine = flat(j) // rows
    send = np.bincount(mine, minlength=sp)
    got = [flat(s)[flat(s) // rows == j] for s in range(sp)]
    recv = [len(g) for g in got]
    order = np.argsort(np.concatenate(got), kind="stable")
    return send.tolist(), recv, torch.from_numpy(order)


def _to_rows(y, plan):
    rows = y.reshape(-1, y.shape[-1])
    if plan is None:
        return rows
    send, recv, order = plan
    got = spmd.all_to_all_rows(rows, "sp", send, recv)
    return got.index_select(0, order.to(got.device))


def _from_rows(out, plan, shape):
    if plan is not None:
        send, recv, order = plan
        back = torch.argsort(order).to(out.device)
        out = spmd.all_to_all_rows(out.index_select(0, back), "sp", recv,
                                   send)
    return out.reshape(shape)


def _dense_attention(q, k, v):
    """Causal attention of the local queries against the K/V gathered
    over sp (the reference's "dense" path under GSPMD)."""
    lay = current_layout()
    k, v = (spmd.all_gather(z, "sp", axis=1) for z in (k, v))
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = lay.index("sp") * q.shape[1] + torch.arange(q.shape[1],
                                                        device=q.device)
    mask = q_pos[:, None] >= torch.arange(k.shape[1], device=q.device)
    scores = torch.where(mask[None, None], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _ring_tp(q, k, v):
    """Ring attention over sp on the rank's tp slice of the heads, the
    heads gathered back over tp (its transpose: psum_scatter)."""
    tp = axis_size("tp")
    if tp == 1:
        return ring_attention(q, k, v, axis_name="sp", causal=True)
    hl = q.shape[2] // tp
    i = axis_index("tp")
    q, k, v = (z[:, :, i * hl:(i + 1) * hl] for z in (q, k, v))
    out = ring_attention(q, k, v, axis_name="sp", causal=True)
    return spmd.all_gather(out, "tp", axis=2)


def _attend(q, k, v, attention):
    if attention == "ring":
        return _ring_tp(q, k, v)
    if attention == "ulysses":
        return ulysses_attention(q, k, v, axis_name="sp", causal=True)
    if attention == "dense":
        return _dense_attention(q, k, v)
    raise ValueError(f"unknown attention {attention!r}: expected 'ring', "
                     "'ulysses', or 'dense'")


def _local_block(tokens, lay):
    """The rank's [B/dp, T/sp] block of the global tokens and its first
    position."""
    b, t = tokens.shape
    bl, tl = b // lay.size("dp"), t // lay.size("sp")
    if bl * lay.size("dp") != b or tl * lay.size("sp") != t:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over "
                         f"dp = {lay.size('dp')}, sp = {lay.size('sp')}")
    i, j = lay.index("dp"), lay.index("sp")
    return tokens[i * bl:(i + 1) * bl, j * tl:(j + 1) * tl], j * tl


def _local(model: MoETransformer, tokens, attention):
    """Under manual(mesh): (the rank's logits [B/dp, T/sp, V] f32, the sum
    of its layers' aux losses, its first position)."""
    cfg = model.cfg
    lay = current_layout()
    dt, d = cfg.dtype, cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim
    tok, t0 = _local_block(tokens, lay)
    bl, tl = tok.shape
    plan = _token_rows(lay, tokens.shape[0], tokens.shape[1])
    wte = spmd.pvary(model.wte)
    x = F.embedding(tok.long(), wte).to(dt)
    x = x + spmd.pvary(model.wpe)[t0:t0 + tl].to(dt)[None]

    aux_sum = 0.0
    for blk in model.blocks:
        p = {k: spmd.pvary(getattr(blk, k),
                           P("ep") if k in _EXPERT_KEYS else None)
             for k in _BLOCK_KEYS}
        y = _layernorm(x, p["ln1_w"], p["ln1_b"])
        qkv = y @ p["wqkv"].to(dt)
        q, k, v = (z.reshape(bl, tl, h, hd) for z in qkv.split(d, dim=-1))
        attn = _attend(q, k, v, attention)
        x = x + attn.reshape(bl, tl, d) @ p["wo"].to(dt)
        # Switch MoE over the reference's token rows: dispatch rides ep
        y = _layernorm(x, p["ln2_w"], p["ln2_b"])
        out, aux = moe._moe_local(
            _to_rows(y, plan), p["router"], p["w_in"], p["w_out"],
            axis_name="ep", capacity_factor=cfg.capacity_factor)
        aux_sum = aux_sum + aux[0]
        x = x + _from_rows(out, plan, x.shape).to(dt)

    x = _layernorm(x, spmd.pvary(model.lnf_w), spmd.pvary(model.lnf_b))
    logits = (x @ wte.to(dt).T).float()
    return logits, aux_sum, t0


def _mean_aux(aux_sum, cfg, lay):
    """The reference's aux: each layer's mean over the (dp, sp) shards,
    averaged over the layers."""
    return spmd.psum(aux_sum, _TOKEN_AXES) / (lay.size(_TOKEN_AXES)
                                              * cfg.n_layers)


def apply(model: MoETransformer, tokens, attention: str | None = None):
    """tokens [B, T] int (every rank of the mesh passes the same) ->
    (logits [B, T, vocab] fp32, aux_loss), global on every rank.
    attention: cfg.attention by default."""
    cfg = model.cfg
    with manual(model.mesh) as lay:
        logits, aux_sum, _ = _local(model, tokens,
                                    attention or cfg.attention)
        aux = _mean_aux(aux_sum, cfg, lay)
    return (spmd.shard_out(logits, P(*_TOKEN_AXES, None), lay),
            spmd.shard_out(aux, P(), lay))


def loss_fn(model: MoETransformer, tokens):
    """Next-token NLL + load-balancing aux (Switch transformer loss):
    (loss, aux), global on every rank; loss.backward() leaves every
    parameter's global gradient in its .grad on every rank (an expert
    slice's: its slice of it)."""
    cfg = model.cfg
    b, t = tokens.shape
    with manual(model.mesh) as lay:
        logits, aux_sum, t0 = _local(model, tokens, cfg.attention)
        tok, _ = _local_block(tokens, lay)
        pos = t0 + torch.arange(tok.shape[1], device=tokens.device)
        i, bl = lay.index("dp"), tok.shape[0]
        targets = tokens[i * bl:(i + 1) * bl,
                         torch.clamp(pos + 1, max=t - 1)].long()
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        nll_sum = (nll * (pos < t - 1).to(nll.dtype)).sum()
        nll = spmd.psum(nll_sum, _TOKEN_AXES) / (b * (t - 1))
        aux = _mean_aux(aux_sum, cfg, lay)
        loss = nll + cfg.aux_loss_coeff * aux
    return spmd.shard_out(loss, P(), lay), aux.detach()


def num_params(model: MoETransformer) -> int:
    """Parameters of the whole model (every expert), from a rank's part."""
    ep = layout(model.mesh).size("ep")
    return sum(p.numel() * (ep if n.rsplit(".", 1)[-1] in _EXPERT_KEYS
                            else 1)
               for n, p in model.named_parameters())


# ---------------------------------------------------------------------------
# weights to and from the JAX package's pytree
# ---------------------------------------------------------------------------

def params_to_jax(model: MoETransformer) -> dict:
    """The JAX package's params tree as f32 numpy arrays, every expert
    (each rank's slices gathered over ep: a collective, every rank of
    the mesh calls it)."""
    lay = layout(model.mesh)
    params = {k: tfm._host(getattr(model, k))
              for k in ("wte", "wpe", "lnf_w", "lnf_b")}
    blocks = {}
    for key in _BLOCK_KEYS:
        leaves = []
        for blk in model.blocks:
            p = getattr(blk, key).detach()
            if key in _EXPERT_KEYS:
                p = spmd._all_gather(p, lay, ("ep",), 0)
            leaves.append(tfm._host(p))
        blocks[key] = np.stack(leaves)
    params["blocks"] = blocks
    return params


def load_jax_params(model: MoETransformer, params: dict) -> MoETransformer:
    """Copies the JAX params tree into `model` in place, this rank's ep
    slice of the experts; every key and shape must match."""
    top = {"wte", "wpe", "lnf_w", "lnf_b"}
    if (set(params) != top | {"blocks"}
            or set(params["blocks"]) != set(_BLOCK_KEYS)):
        raise ValueError(f"params keys {sorted(params)} differ from the "
                         f"model's {sorted(top)} + blocks "
                         f"{list(_BLOCK_KEYS)}")
    lay = layout(model.mesh)
    with torch.no_grad():
        for k in top:
            tfm._put(getattr(model, k), params[k], k)
        for key in _BLOCK_KEYS:
            stacked = np.asarray(params["blocks"][key], np.float32)
            if stacked.shape[0] != len(model.blocks):
                raise ValueError(f"blocks.{key}: {stacked.shape[0]} layers "
                                 f"in the pytree, {len(model.blocks)} in "
                                 "the model")
            for i, blk in enumerate(model.blocks):
                leaf = stacked[i]
                if key in _EXPERT_KEYS:
                    n = leaf.shape[0] // lay.size("ep")
                    leaf = leaf[lay.index("ep") * n:(lay.index("ep") + 1) * n]
                tfm._put(getattr(blk, key), leaf, f"blocks.{i}.{key}")
    return model


def params_from_jax(params: dict, cfg: MoETransformerConfig,
                    mesh) -> MoETransformer:
    """This rank's MoETransformer on `mesh` holding the JAX package's
    params (its ep slice of the experts)."""
    return load_jax_params(MoETransformer(cfg, mesh), params)
