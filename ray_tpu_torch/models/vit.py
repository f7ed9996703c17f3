"""ViT-B/16 in PyTorch, port of ray_tpu/models/vit.py, reusing the
transformer encoder blocks.

The patch embedding is one strided convolution (cuDNN on the card, as XLA
did in the reference) -> [B, N, D] tokens, a learned [CLS] token and
positions in front; the encoder is models.transformer's with
causal=False. Images come in NHWC [B, H, W, 3], as the reference's; they
are convolved as a channels-last view, no copy.

Parameters are named as the JAX pytree's keys, in its layouts, except
`patch_w`: the reference's is HWIO [p, p, 3, d], the port's is torch's
OIHW [d, 3, p, p]; `params_from_jax`/`params_to_jax` transpose it. The
encoder's blocks are unstacked as in models.transformer.

ViT-B/16's sequence is 197 tokens, not a multiple of the flash kernel's
tiles, so its attention is dense here as in the reference
(`ops.attention._flash_aligned`); every layernorm runs in the kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import check_device
from ray_tpu_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    ops_mode: str | tfm.Ops = "kernel"  # "kernel" | "plain" | an Ops

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def encoder_config(self) -> tfm.TransformerConfig:
        return tfm.TransformerConfig(
            vocab_size=1, n_layers=self.n_layers, n_heads=self.n_heads,
            d_model=self.d_model, d_ff=self.d_ff,
            max_seq=self.n_patches + 1, dtype=self.dtype, causal=False,
            ops_mode=self.ops_mode)


def vit_b16(num_classes=1000, image_size=224) -> ViTConfig:
    return ViTConfig(image_size=image_size, num_classes=num_classes)


TINY = ViTConfig(image_size=32, patch_size=8, n_layers=2, n_heads=4,
                 d_model=64, d_ff=256, num_classes=10)


class ViT(nn.Module):
    """`forward(images [B, H, W, 3])` -> logits [B, classes] f32. The
    weights are drawn on the CPU from `seed` and moved to `device`: None
    for the current CUDA device (raises without one), "cpu" for the plain
    versions."""

    def __init__(self, cfg: ViTConfig, seed: int = 0, device=None):
        super().__init__()
        dev = check_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d, p = cfg.d_model, cfg.patch_size
        self.encoder = tfm.Encoder(cfg.encoder_config(), gen)
        hwio = torch.randn((p, p, 3, d), generator=gen) / math.sqrt(p * p * 3)
        self.patch_w = nn.Parameter(hwio.permute(3, 2, 0, 1).contiguous())
        self.patch_b = nn.Parameter(torch.zeros(d))
        self.cls = nn.Parameter(torch.randn((1, 1, d), generator=gen) * 0.02)
        self.pos = nn.Parameter(torch.randn((cfg.n_patches + 1, d),
                                            generator=gen) * 0.02)
        self.head_w = nn.Parameter(torch.zeros((d, cfg.num_classes)))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_classes))
        self.to(dev)

    def forward(self, images):
        return apply(self, images)


def logical_axes(cfg: ViTConfig):
    """The reference's logical tree (JAX layout; `patch_w` HWIO)."""
    enc = tfm.logical_axes(cfg.encoder_config())
    del enc["wte"], enc["wpe"]
    return {
        "patch_w": (None, None, None, "embed"),
        "patch_b": ("embed",),
        "cls": (None, None, "embed"),
        "pos": (None, "embed"),
        "encoder": enc,
        "head_w": ("embed", "vocab"),
        "head_b": ("vocab",),
    }


def named_axes(cfg: ViTConfig) -> dict:
    """{parameter name: logical axes} of the port's ViT; `patch_w` in its
    OIHW layout."""
    axes = tfm.named_axes(logical_axes(cfg), cfg.n_layers)
    axes["patch_w"] = ("embed", None, None, None)
    return axes


def apply(model: ViT, images):
    """images: [B, H, W, 3] -> logits [B, classes] fp32."""
    cfg = model.cfg
    dt = cfg.dtype
    b = images.shape[0]
    x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), model.patch_w.to(dt),
                 stride=cfg.patch_size)                   # [B, D, h, w]
    x = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.d_model) + \
        model.patch_b.to(dt)
    cls = model.cls.to(dt).expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + model.pos.to(dt)[None]

    x = tfm.encode(model.encoder, x)
    cls_out = x[:, 0].float()
    return cls_out @ model.head_w + model.head_b


def loss_fn(model: ViT, batch):
    """Cross-entropy of the logits. batch: (images [B, H, W, 3], labels
    [B] int)."""
    images, labels = batch
    logp = F.log_softmax(apply(model, images), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


# ---------------------------------------------------------------------------
# weights to and from the JAX package's pytree
# ---------------------------------------------------------------------------

_TOP = ("patch_b", "cls", "pos", "head_w", "head_b")


def params_to_jax(model: ViT) -> dict:
    """The JAX package's params tree as f32 numpy arrays (`patch_w` back
    to HWIO)."""
    params = {k: tfm._host(getattr(model, k)) for k in _TOP}
    params["patch_w"] = np.ascontiguousarray(
        tfm._host(model.patch_w).transpose(2, 3, 1, 0))
    params["encoder"] = tfm.params_to_jax(model.encoder)
    return params


def load_jax_params(model: ViT, params: dict) -> ViT:
    """Copies the JAX params tree into `model` in place; every key and
    shape must match."""
    want = set(_TOP) | {"patch_w", "encoder"}
    if set(params) != want:
        raise ValueError(f"params keys {sorted(params)} differ from the "
                         f"model's {sorted(want)}")
    tfm.load_jax_params(model.encoder, params["encoder"])
    with torch.no_grad():
        for k in _TOP:
            tfm._put(getattr(model, k), params[k], k)
        tfm._put(model.patch_w, np.asarray(params["patch_w"],
                                           np.float32).transpose(3, 2, 0, 1),
                 "patch_w")
    return model


def params_from_jax(params: dict, cfg: ViTConfig, device=None) -> ViT:
    """A ViT for `cfg` on `device` (as ViT's) holding the JAX package's
    params."""
    return load_jax_params(ViT(cfg, device=device), params)
