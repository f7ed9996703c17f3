"""Models of the port, each a torch counterpart of the module of the same
name in ray_tpu/models/."""

from ray_tpu_torch.models import resnet, transformer

__all__ = ["resnet", "transformer"]
