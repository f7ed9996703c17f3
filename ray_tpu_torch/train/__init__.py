"""ray_tpu_torch.train — single-worker and data-parallel training on the
GPU; port of ray_tpu/train (the RaySGD equivalent)."""

from ray_tpu_torch.train.operator import TrainingOperator
from ray_tpu_torch.train.trainer import Trainer, TrainWorker

__all__ = ["Trainer", "TrainWorker", "TrainingOperator"]
