"""BERT-style bidirectional encoder for classification fine-tuning; port
of ray_tpu/models/bert.py.

Reuses the transformer blocks with causal=False; adds segment embeddings
(`token_types`) and a pooled [CLS] classification head (the GLUE
fine-tune shape). Without `pad_mask` the attention is the flash route
(at BERT-base's T = 512 the non-causal flash kernel); with `pad_mask` it
is the dense `ops.attention.masked_attention`, as in the reference.

Parameters are named as the JAX pytree's keys and in its layouts; the
encoder is a models.transformer.GPT (its `wte`, `wpe`, blocks and final
layernorm, as the reference's `encoder` subtree), blocks unstacked.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import check_device
from ray_tpu_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    num_classes: int = 2
    dtype: torch.dtype = torch.bfloat16
    ops_mode: str | tfm.Ops = "kernel"  # "kernel" | "plain" | an Ops

    def encoder_config(self) -> tfm.TransformerConfig:
        return tfm.TransformerConfig(
            vocab_size=self.vocab_size, n_layers=self.n_layers,
            n_heads=self.n_heads, d_model=self.d_model, d_ff=self.d_ff,
            max_seq=self.max_seq, dtype=self.dtype, causal=False,
            ops_mode=self.ops_mode)


def bert_base(num_classes=2) -> BertConfig:
    return BertConfig(num_classes=num_classes)


TINY = BertConfig(vocab_size=256, n_layers=2, n_heads=4, d_model=64,
                  d_ff=256, max_seq=128)

_TOP = ("wtt", "pool_w", "pool_b", "cls_w", "cls_b")


class Bert(nn.Module):
    """`forward(tokens, token_types=None, pad_mask=None)` -> (logits
    [B, classes] f32, sequence [B, T, D]). The weights are drawn on the
    CPU from `seed` and moved to `device`: None for the current CUDA
    device (raises without one), "cpu" for the plain versions."""

    def __init__(self, cfg: BertConfig, seed: int = 0, device=None):
        super().__init__()
        dev = check_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed + 1)
        d = cfg.d_model
        self.encoder = tfm.GPT(cfg.encoder_config(), seed=seed)
        self.wtt = nn.Parameter(torch.randn((cfg.type_vocab, d),
                                            generator=gen) * 0.02)
        self.pool_w = nn.Parameter(torch.randn((d, d), generator=gen) * 0.02)
        self.pool_b = nn.Parameter(torch.zeros(d))
        self.cls_w = nn.Parameter(torch.randn((d, cfg.num_classes),
                                              generator=gen) * 0.02)
        self.cls_b = nn.Parameter(torch.zeros(cfg.num_classes))
        self.to(dev)

    def forward(self, tokens, token_types=None, pad_mask=None):
        return apply(self, tokens, token_types, pad_mask)


def logical_axes(cfg: BertConfig):
    """The reference's logical tree (JAX layout)."""
    return {
        "encoder": tfm.logical_axes(cfg.encoder_config()),
        "wtt": (None, "embed"),
        "pool_w": ("embed", "embed"),
        "pool_b": ("embed",),
        "cls_w": ("embed", "vocab"),
        "cls_b": ("vocab",),
    }


def named_axes(cfg: BertConfig) -> dict:
    """{parameter name: logical axes} of the port's Bert."""
    return tfm.named_axes(logical_axes(cfg), cfg.n_layers)


def apply(model: Bert, tokens, token_types=None, pad_mask=None):
    """tokens: [B, T] int; pad_mask: [B, T] bool (True = real token),
    required for padded GLUE batches so [CLS] never attends to padding.
    Returns (logits [B, classes] f32, sequence [B, T, D])."""
    cfg = model.cfg
    dt = cfg.dtype
    t = tokens.shape[1]
    enc = model.encoder
    x = F.embedding(tokens.long(), enc.wte).to(dt)
    x = x + enc.wpe[:t].to(dt)[None]
    if token_types is not None:
        x = x + F.embedding(token_types.long(), model.wtt).to(dt)

    x = tfm.encode(enc, x, pad_mask)

    pooled = torch.tanh(x[:, 0].float() @ model.pool_w + model.pool_b)
    logits = pooled @ model.cls_w + model.cls_b
    return logits, x


def loss_fn(model: Bert, batch):
    """Cross-entropy of the logits. batch: (tokens, labels) or (tokens,
    labels, token_types, pad_mask), either of the last two None."""
    tokens, labels, *rest = batch
    logits, _ = apply(model, tokens, *rest)
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


# ---------------------------------------------------------------------------
# weights to and from the JAX package's pytree
# ---------------------------------------------------------------------------

def params_to_jax(model: Bert) -> dict:
    """The JAX package's params tree as f32 numpy arrays."""
    params = {k: tfm._host(getattr(model, k)) for k in _TOP}
    params["encoder"] = tfm.params_to_jax(model.encoder)
    return params


def load_jax_params(model: Bert, params: dict) -> Bert:
    """Copies the JAX params tree into `model` in place; every key and
    shape must match."""
    want = set(_TOP) | {"encoder"}
    if set(params) != want:
        raise ValueError(f"params keys {sorted(params)} differ from the "
                         f"model's {sorted(want)}")
    tfm.load_jax_params(model.encoder, params["encoder"])
    with torch.no_grad():
        for k in _TOP:
            tfm._put(getattr(model, k), params[k], k)
    return model


def params_from_jax(params: dict, cfg: BertConfig, device=None) -> Bert:
    """A Bert for `cfg` on `device` (as Bert's) holding the JAX package's
    params."""
    return load_jax_params(Bert(cfg, device=device), params)
