"""Kernels written by hand for Hopper, each beside its plain PyTorch
version. Sources live in `csrc/`; `_build` compiles them at first use."""

from ray_tpu_torch.ops import attention, batchnorm, layernorm

__all__ = ["attention", "batchnorm", "layernorm"]
