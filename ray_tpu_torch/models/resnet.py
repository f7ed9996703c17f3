"""ResNet in PyTorch, port of ray_tpu/models/resnet.py.

The public layout stays the JAX package's: `ResNet.forward` takes images
as [N, H, W, 3]. Inside, activations are NCHW tensors in channels-last
memory (the permute of an NHWC tensor is such a view, not a copy), which
is cuDNN's fast layout and keeps C contiguous for the batchnorm kernel.

Semantics follow the JAX package exactly, not torch's defaults:
- convolutions pad SAME as `lax.conv_general_dilated` does, which at
  stride 2 on an even size is asymmetric: (total // 2, total - total // 2);
  so is the SAME max-pool, padded with -inf;
- batchnorm uses one-pass f32 statistics E[x²]−E[x]² clamped at 0, running
  statistics 0.9·old + 0.1·batch with the biased variance, and a scale and
  offset cast to the compute dtype before the map (`nn.BatchNorm2d` keeps
  an unbiased running variance and weights the new value by `momentum`);
- master weights are f32 and cast to the activation dtype per call; the
  head is f32.
`bn_mode="kernel"` runs the training backward of every batchnorm through
`ops.batchnorm.bn_train` (the CUDA sums kernel); `"plain"` lets autograd
differentiate the same forward, as the JAX package's "xla" mode does.

Parameters are named as the JAX pytree's keys (`stem_conv`, `s0b0.conv1`,
`s0b0.bn1.scale`, `fc_w`, ...), so `params_from_jax` and `params_to_jax`
move weights between the two packages by name; conv weights are OIHW here
and HWIO there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.ops.batchnorm import bn_train, normalize

BN_MODES = ("plain", "kernel")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)
    bottleneck: bool = False
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    small_images: bool = False   # CIFAR stem: 3x3/1 conv, no maxpool
    bn_mode: str = "plain"       # "plain" | "kernel"
    # "s2d": the stem conv in 2x2 space-to-depth layout (the MLPerf TPU
    # trick of the JAX package): the same parameters and outputs, as a
    # 4x4 stride-1 conv over 12 channels instead of a 7x7 stride-2 conv
    # over 3
    stem_mode: str = "standard"


def resnet18(num_classes=1000, **kw) -> ResNetConfig:
    return ResNetConfig((2, 2, 2, 2), False, num_classes, **kw)


def resnet34(num_classes=1000, **kw) -> ResNetConfig:
    return ResNetConfig((3, 4, 6, 3), False, num_classes, **kw)


def resnet50(num_classes=1000, **kw) -> ResNetConfig:
    return ResNetConfig((3, 4, 6, 3), True, num_classes, **kw)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's SAME for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """SAME conv of NCHW x with OIHW f32 master weights cast to x.dtype.
    A symmetric pad goes to the conv itself; an asymmetric one is an
    explicit F.pad first."""
    if w.shape[2] == w.shape[3] == 1 and stride > 1:
        # a 1x1 conv at stride s reads every s-th pixel and SAME pads it
        # by 0: slice first, convolve at stride 1. Same result; it also
        # keeps CPU runs off oneDNN's strided 1x1 backward, which corrupts
        # the heap at 8 input channels in channels-last layout.
        x, stride = x[:, :, ::stride, ::stride], 1
    ph = same_pads(x.shape[2], w.shape[2], stride)
    pw = same_pads(x.shape[3], w.shape[3], stride)
    w = w.to(dtype=x.dtype, memory_format=torch.channels_last)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _stem_s2d(x, w):
    """The 7x7/2 SAME stem conv of NCHW x, computed in 2x2 space-to-depth
    layout, as the JAX package's `_stem_s2d`: for even H and W, SAME pads
    (2, 3), so output i reads input pixels 2i-2..2i+4; with the kernel
    padded to 8 taps (zeros at the end) that is blocks i-1..i+2 of the
    2x2 layout, a 4-tap stride-1 conv over blocks padded (1, 2)."""
    n, c, h, w_ = x.shape
    if h % 2 or w_ % 2:
        raise ValueError(
            f"stem_mode='s2d' needs even input H/W (got {h}x{w_}): the "
            "2x2 space-to-depth equivalence only holds for even sizes — "
            "use stem_mode='standard' for odd inputs")
    # [N,C,H,W] -> [N,(dy,dx,c),H/2,W/2], the JAX package's channel order
    x2 = x.reshape(n, c, h // 2, 2, w_ // 2, 2).permute(0, 3, 5, 1, 2, 4)
    x2 = x2.reshape(n, 4 * c, h // 2, w_ // 2).contiguous(
        memory_format=torch.channels_last)
    # [O,C,7,7] -> zero-pad to [O,C,8,8] -> block form [O,(dy,dx,c),4,4]
    cout = w.shape[0]
    k = F.pad(w, (0, 1, 0, 1)).reshape(cout, c, 4, 2, 4, 2)
    k = k.permute(0, 3, 5, 1, 2, 4).reshape(cout, 4 * c, 4, 4)
    k = k.to(dtype=x.dtype, memory_format=torch.channels_last)
    return F.conv2d(F.pad(x2, (1, 2, 1, 2)), k)


def _max_pool_same(x):
    """3x3/2 max-pool with SAME padding of -inf."""
    ph = same_pads(x.shape[2], 3, 2)
    pw = same_pads(x.shape[3], 3, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.max_pool2d(x, 3, 2, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _conv_init(gen, kh, kw, cin, cout):
    fan = kh * kw * cin
    return nn.Parameter(torch.randn((cout, cin, kh, kw), generator=gen)
                        * math.sqrt(2.0 / fan))


class BatchNorm(nn.Module):
    """Per-channel batchnorm of an NCHW (channels-last) activation, with
    the JAX package's semantics (module docstring)."""

    MOMENTUM = 0.9
    EPS = 1e-5

    def __init__(self, c: int, mode: str):
        super().__init__()
        if mode not in BN_MODES:
            raise ValueError(f"bn_mode {mode!r}: expected one of {BN_MODES}")
        self.mode = mode
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)  # NHWC view: C last and contiguous
        if not self.training:
            y = normalize(x, self.mean, self.var, self.scale, self.bias,
                          self.EPS)
            return y.permute(0, 3, 1, 2)
        if self.mode == "kernel":
            y, mean, var = bn_train(x, self.scale, self.bias, self.EPS)
        else:
            xf = x.float()
            mean = xf.mean((0, 1, 2))
            var = torch.clamp_min(
                torch.square(xf).mean((0, 1, 2)) - torch.square(mean), 0.0)
            y = normalize(x, mean, var, self.scale, self.bias, self.EPS)
        with torch.no_grad():
            m = self.MOMENTUM
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y.permute(0, 3, 1, 2)


class Block(nn.Module):
    """One residual block; parameter names as the JAX block dict."""

    def __init__(self, gen, cin, inner, cout, stride, bottleneck, proj,
                 mode):
        super().__init__()
        self.stride, self.bottleneck = stride, bottleneck
        if bottleneck:
            self.conv1 = _conv_init(gen, 1, 1, cin, inner)
            self.conv2 = _conv_init(gen, 3, 3, inner, inner)
            self.conv3 = _conv_init(gen, 1, 1, inner, cout)
            widths = (inner, inner, cout)
        else:
            self.conv1 = _conv_init(gen, 3, 3, cin, inner)
            self.conv2 = _conv_init(gen, 3, 3, inner, cout)
            widths = (inner, cout)
        for i, c in enumerate(widths, 1):
            self.add_module(f"bn{i}", BatchNorm(c, mode))
        if proj:
            self.proj = _conv_init(gen, 1, 1, cin, cout)
            self.proj_bn = BatchNorm(cout, mode)

    def forward(self, x):
        residual = x
        if hasattr(self, "proj"):
            residual = self.proj_bn(_conv(x, self.proj, self.stride))
        y = _conv(x, self.conv1, 1 if self.bottleneck else self.stride)
        y = F.relu(self.bn1(y))
        y = _conv(y, self.conv2, self.stride if self.bottleneck else 1)
        y = self.bn2(y)
        if self.bottleneck:
            y = F.relu(y)
            y = self.bn3(_conv(y, self.conv3))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """`forward(x [N, H, W, 3])` -> logits [N, classes] f32. Train mode
    (`.train()`) uses batch statistics and updates the running ones in
    place; eval mode uses the running ones."""

    def __init__(self, cfg: ResNetConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        stem_k = 3 if cfg.small_images else 7
        self.stem_conv = _conv_init(gen, stem_k, stem_k, 3, cfg.width)
        self.stem_bn = BatchNorm(cfg.width, cfg.bn_mode)
        self.block_names: list[str] = []
        cin = cfg.width
        for s, n_blocks in enumerate(cfg.stage_sizes):
            inner = cfg.width * (2 ** s)
            cout = inner * (4 if cfg.bottleneck else 1)
            for b in range(n_blocks):
                name = f"s{s}b{b}"
                proj = b == 0 and (cin != cout or s > 0)
                stride = 2 if (b == 0 and s > 0) else 1
                self.add_module(name, Block(gen, cin, inner, cout, stride,
                                            cfg.bottleneck, proj,
                                            cfg.bn_mode))
                self.block_names.append(name)
                cin = cout
        self.fc_w = nn.Parameter(
            torch.randn((cin, cfg.num_classes), generator=gen)
            / math.sqrt(cin))
        self.fc_b = nn.Parameter(torch.zeros(cfg.num_classes))

    def forward(self, x):
        cfg = self.cfg
        x = x.to(cfg.dtype).permute(0, 3, 1, 2)
        if cfg.stem_mode == "s2d" and not cfg.small_images:
            y = _stem_s2d(x, self.stem_conv)
        else:
            y = _conv(x, self.stem_conv, 1 if cfg.small_images else 2)
        y = F.relu(self.stem_bn(y))
        if not cfg.small_images:
            y = _max_pool_same(y)
        for name in self.block_names:
            y = getattr(self, name)(y)
        y = torch.mean(y, dim=(2, 3), dtype=torch.float32)
        return y @ self.fc_w + self.fc_b


def loss_fn(model: ResNet, images, labels):
    """Mean cross-entropy of `model(images)` against int labels [N]."""
    logp = F.log_softmax(model(images), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def num_bn_layers(model: nn.Module) -> int:
    """Batchnorm layers in `model`: one kernel launch each per training
    step under bn_mode="kernel" (53 for resnet50)."""
    return sum(isinstance(m, BatchNorm) for m in model.modules())


# ---------------------------------------------------------------------------
# weights to and from the JAX package's pytrees
# ---------------------------------------------------------------------------

def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tree_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _host(t: torch.Tensor) -> np.ndarray:
    """An f32 numpy copy of t (never a view of a CPU tensor's memory)."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def params_to_jax(model: ResNet) -> tuple[dict, dict]:
    """(params, state) as the JAX package's nested dicts of f32 numpy
    arrays, copies that later steps leave as they are; conv weights
    OIHW -> HWIO."""
    params: dict = {}
    state: dict = {}
    for name, p in model.named_parameters():
        v = _host(p)
        if v.ndim == 4:
            v = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        _tree_set(params, name.split("."), v)
    for name, b in model.named_buffers():
        _tree_set(state, name.split("."), _host(b))
    return params, state


def load_jax_params(model: ResNet, params: dict, state: dict) -> ResNet:
    """Copies the JAX pytrees into `model` in place; every key must match."""
    for tree, named in ((params, dict(model.named_parameters())),
                        (state, dict(model.named_buffers()))):
        want = {tuple(n.split(".")) for n in named}
        have = set(_tree_paths(tree))
        if want != have:
            raise ValueError(
                f"pytree keys differ from the model's: missing "
                f"{sorted(want - have)[:5]}, unexpected "
                f"{sorted(have - want)[:5]}")
        with torch.no_grad():
            for name, t in named.items():
                v = np.asarray(_tree_get(tree, name.split(".")), np.float32)
                if v.ndim == 4:
                    v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                if v.shape != tuple(t.shape):
                    raise ValueError(f"{name}: shape {v.shape} from the "
                                     f"pytree, {tuple(t.shape)} in the model")
                t.copy_(torch.tensor(v))
    return model


def params_from_jax(params: dict, state: dict, cfg: ResNetConfig,
                    device=None) -> ResNet:
    """A ResNet for `cfg` holding the JAX package's (params, state)."""
    model = load_jax_params(ResNet(cfg), params, state)
    return model.to(device) if device is not None else model
