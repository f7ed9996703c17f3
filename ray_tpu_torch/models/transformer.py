"""GPT-style transformer in PyTorch, port of ray_tpu/models/transformer.py.

Semantics follow the JAX package exactly, not torch's defaults:
- GELU is the tanh approximation (`jax.nn.gelu`'s default), not erf;
- layernorm weights and biases are cast to the compute dtype before the
  kernel, which promotes them to f32 inside and casts once at the store;
- the embedding gathers the f32 `wte` and casts to the compute dtype; the
  positional add is in the compute dtype;
- logits are `x @ wteᵀ` in the compute dtype (tied embeddings), cast to
  f32; the loss drops the last position and takes log_softmax in f32;
- q, k, v are columns [0:d], [d:2d], [2d:3d] of x @ wqkv, each reshaped
  (b, t, h, hd), head-major.

Parameters are named as the JAX pytree's keys and stored in its layout:
weights are [in, out] and used as `x @ W`, so moving weights between the
packages is a copy, never a transpose. The JAX tree stacks the block
parameters on a leading [L, ...] axis; here each block holds its own
slice (`blocks.<i>.wqkv`, ...), and `params_from_jax`/`params_to_jax`
split and stack them.

`ops_mode="kernel"` runs every layernorm and flash-attention forward
through the CUDA kernels' wrappers (the plain versions on CPU tensors);
`"plain"` runs the plain versions under the same backwards, so that the
two can be compared on the card. An `Ops` of two other forwards (one
that checks each kernel call, say) may stand in for the name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops import attention, layernorm as ln



@dataclasses.dataclass(frozen=True)
class Ops:
    """The forwards a model runs: `layernorm(x, w, b, eps)` and
    `flash_attention(q, k, v, causal, scale, block_q, block_k)`, each under
    its op's reference backward."""
    layernorm: Callable
    flash_attention: Callable


OPS = {"kernel": Ops(ln.layernorm_fwd, attention.flash_attention_fwd),
       "plain": Ops(ln.layernorm_plain, attention.flash_attention_plain)}
_BLOCK_KEYS = ("ln1_w", "ln1_b", "wqkv", "wo", "ln2_w", "ln2_b", "w_in",
               "b_in", "w_out", "b_out")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16
    causal: bool = True           # False → bidirectional encoder (BERT/ViT)
    tie_embeddings: bool = True
    remat: bool = True            # checkpoint each block
    ops_mode: str | Ops = "kernel"  # "kernel" | "plain" | an Ops

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# GPT-2 124M.
GPT2_SMALL = TransformerConfig()
# Tiny config for tests and dry runs.
TINY = TransformerConfig(vocab_size=256, n_layers=2, n_heads=4, d_model=64,
                         d_ff=256, max_seq=128)


def _dense_init(gen, shape, fan_in):
    return nn.Parameter(torch.randn(shape, generator=gen) / math.sqrt(fan_in))


class Block(nn.Module):
    """One pre-norm block; parameter names as the JAX block dict."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.ln1_w = nn.Parameter(torch.ones(d))
        self.ln1_b = nn.Parameter(torch.zeros(d))
        self.wqkv = _dense_init(gen, (d, 3 * d), d)
        self.wo = _dense_init(gen, (d, d), d)
        self.ln2_w = nn.Parameter(torch.ones(d))
        self.ln2_b = nn.Parameter(torch.zeros(d))
        self.w_in = _dense_init(gen, (d, f), d)
        self.b_in = nn.Parameter(torch.zeros(f))
        self.w_out = _dense_init(gen, (f, d), f)
        self.b_out = nn.Parameter(torch.zeros(d))


class Encoder(nn.Module):
    """The encoder trunk alone (blocks and the final layernorm), as the
    JAX package's ViT keeps it after deleting `wte` and `wpe` from
    `init`'s tree."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        _add_trunk(self, cfg, gen)


def _add_trunk(model: nn.Module, cfg: TransformerConfig,
               gen: torch.Generator):
    """Gives model what `encode` runs: `cfg`, `blocks` (drawn from gen)
    and the final layernorm `lnf_w`/`lnf_b`."""
    if not isinstance(cfg.ops_mode, Ops) and cfg.ops_mode not in OPS:
        raise ValueError(f"ops_mode {cfg.ops_mode!r}: expected one of "
                         f"{tuple(OPS)} or an Ops")
    model.cfg = cfg
    model.blocks = nn.ModuleList(Block(cfg, gen)
                                 for _ in range(cfg.n_layers))
    model.lnf_w = nn.Parameter(torch.ones(cfg.d_model))
    model.lnf_b = nn.Parameter(torch.zeros(cfg.d_model))


class GPT(nn.Module):
    """`forward(tokens [B, T])` -> logits [B, T, vocab] f32."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        d = cfg.d_model
        self.wte = nn.Parameter(torch.randn((cfg.vocab_size, d),
                                            generator=gen) * 0.02)
        self.wpe = nn.Parameter(torch.randn((cfg.max_seq, d),
                                            generator=gen) * 0.01)
        _add_trunk(self, cfg, gen)
        if not cfg.tie_embeddings:
            self.lm_head = _dense_init(gen, (d, cfg.vocab_size), d)

    def forward(self, tokens, pad_mask=None):
        return apply(self, tokens, pad_mask)


def _ops(cfg: TransformerConfig) -> Ops:
    return cfg.ops_mode if isinstance(cfg.ops_mode, Ops) else OPS[cfg.ops_mode]


def _layernorm(x, w, b, cfg):
    return ln.layernorm(x, w.to(x.dtype), b.to(x.dtype),
                        fwd=_ops(cfg).layernorm)


def _block(x, p: Block, cfg: TransformerConfig, pad_mask=None):
    """One pre-norm transformer block. x: [B, T, D] in compute dtype;
    pad_mask: optional [B, T] bool (True = real token)."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    dt = x.dtype

    y = _layernorm(x, p.ln1_w, p.ln1_b, cfg)
    qkv = y @ p.wqkv.to(dt)                                 # [B,T,3D]
    q, k, v = (z.view(b, t, h, hd) for z in qkv.split(d, dim=-1))
    if pad_mask is None:
        attn = attention.flash_attention(q, k, v, cfg.causal,
                                         fwd=_ops(cfg).flash_attention)
    else:
        # masked (padded-batch) attention: dense path with key masking
        attn = attention.masked_attention(q, k, v, pad_mask,
                                          causal=cfg.causal)
    x = x + attn.reshape(b, t, d) @ p.wo.to(dt)

    y = _layernorm(x, p.ln2_w, p.ln2_b, cfg)
    y = F.gelu(y @ p.w_in.to(dt) + p.b_in.to(dt), approximate="tanh")
    y = y @ p.w_out.to(dt) + p.b_out.to(dt)
    return x + y


def encode(model: GPT, x, pad_mask=None):
    """The shared encoder trunk: every block (each checkpointed when
    cfg.remat), then the final layernorm. `model`: a GPT or an Encoder.
    Used by GPT, BERT and ViT."""
    cfg = model.cfg
    for blk in model.blocks:
        if cfg.remat:
            x = checkpoint(_block, x, blk, cfg, pad_mask,
                           use_reentrant=False)
        else:
            x = _block(x, blk, cfg, pad_mask)
    return _layernorm(x, model.lnf_w, model.lnf_b, cfg)


def apply(model: GPT, tokens, pad_mask=None):
    """tokens: [B, T] int -> logits [B, T, vocab] (f32)."""
    cfg = model.cfg
    t = tokens.shape[1]
    x = F.embedding(tokens.long(), model.wte).to(cfg.dtype)
    x = x + model.wpe[:t].to(cfg.dtype)[None]
    x = encode(model, x, pad_mask)
    if cfg.tie_embeddings:
        logits = x @ model.wte.to(x.dtype).T
    else:
        logits = x @ model.lm_head.to(x.dtype)
    return logits.float()


def loss_fn(model: GPT, tokens):
    """Next-token cross-entropy. tokens: [B, T]. Attention runs at full T
    (the flash route's alignment); the last position's logits are dropped
    after."""
    logits = apply(model, tokens)[:, :-1]
    targets = tokens[:, 1:].long()
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def logical_axes(cfg: TransformerConfig):
    """Tree of logical-axis tuples matching the JAX package's init()
    tree (block parameters stacked on a leading "layers" axis).

    "layers" is the stacked-block axis (maps to pp only in the pipeline
    trainer; None otherwise); "embed"/"heads"/"mlp"/"vocab" follow
    parallel/sharding.py DEFAULT_RULES. `named_axes` maps the tree onto
    the port's parameter names.
    """
    ax = {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": {
            "ln1_w": ("layers", "norm"), "ln1_b": ("layers", "norm"),
            "wqkv": ("layers", "embed", "mlp"),
            "wo": ("layers", "mlp", "embed"),
            "ln2_w": ("layers", "norm"), "ln2_b": ("layers", "norm"),
            "w_in": ("layers", "embed", "mlp"),
            "b_in": ("layers", "mlp"),
            "w_out": ("layers", "mlp", "embed"),
            "b_out": ("layers", "embed"),
        },
        "lnf_w": ("norm",), "lnf_b": ("norm",),
    }
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    return ax


def named_axes(tree, n_layers: int, prefix: str = "") -> dict:
    """A logical tree in the JAX layout -> {the port's parameter name:
    logical axes}: a "blocks" subtree's stacked leaves become
    `blocks.<i>.<key>` for each of the n_layers blocks, without the
    leading "layers" axis (each block holds its own slice); other nested
    dicts join their keys with ".", as named_parameters() does."""
    out = {}
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if key == "blocks":
            for i in range(n_layers):
                for k, axes in sub.items():
                    out[f"{name}.{i}.{k}"] = tuple(axes[1:])
        elif isinstance(sub, dict):
            out.update(named_axes(sub, n_layers, f"{name}."))
        else:
            out[name] = tuple(sub)
    return out


# ---------------------------------------------------------------------------
# weights to and from the JAX package's pytree
# ---------------------------------------------------------------------------

def _top_keys(model: GPT) -> list[str]:
    return [n for n, _ in model.named_parameters(recurse=False)]


def _host(p):
    """p as f32 numpy: a copy, never a view of a CPU parameter's memory."""
    return p.detach().to("cpu", torch.float32, copy=True).numpy()


def params_to_jax(model: GPT) -> dict:
    """The JAX package's params tree as f32 numpy arrays, block parameters
    stacked on a leading [L, ...] axis."""
    params = {k: _host(getattr(model, k)) for k in _top_keys(model)}
    params["blocks"] = {key: np.stack([_host(getattr(blk, key))
                                       for blk in model.blocks])
                        for key in _BLOCK_KEYS}
    return params


def _put(t, v, name):
    """Copies the pytree leaf v into the parameter t of the same shape."""
    v = np.asarray(v, np.float32)
    if v.shape != tuple(t.shape):
        raise ValueError(f"{name}: shape {v.shape} from the pytree, "
                         f"{tuple(t.shape)} in the model")
    t.copy_(torch.tensor(v))


def load_jax_params(model: GPT, params: dict) -> GPT:
    """Copies the JAX params tree into `model` in place; every key and
    shape must match."""
    top = set(_top_keys(model))
    have = set(params) - {"blocks"}
    if top != have or set(params.get("blocks", {})) != set(_BLOCK_KEYS):
        raise ValueError(f"params keys {sorted(params)} (blocks "
                         f"{sorted(params.get('blocks', {}))}) differ from "
                         f"the model's {sorted(top)} + blocks "
                         f"{list(_BLOCK_KEYS)}")

    with torch.no_grad():
        for k in top:
            _put(getattr(model, k), params[k], k)
        for key in _BLOCK_KEYS:
            stacked = np.asarray(params["blocks"][key])
            if stacked.shape[0] != len(model.blocks):
                raise ValueError(f"blocks.{key}: {stacked.shape[0]} layers "
                                 f"in the pytree, {len(model.blocks)} in "
                                 "the model")
            for i, blk in enumerate(model.blocks):
                _put(getattr(blk, key), stacked[i], f"blocks.{i}.{key}")
    return model


def params_from_jax(params: dict, cfg: TransformerConfig,
                    device=None) -> GPT:
    """A GPT for `cfg` holding the JAX package's params."""
    model = load_jax_params(GPT(cfg), params)
    return model.to(device) if device is not None else model
