"""Models of the port, each a torch counterpart of the module of the same
name in ray_tpu/models/."""

from ray_tpu_torch.models import (bert, moe_transformer, resnet, transformer,
                                  vit)

__all__ = ["bert", "moe_transformer", "resnet", "transformer", "vit"]
