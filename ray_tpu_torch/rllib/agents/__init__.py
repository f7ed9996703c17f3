from ray_tpu_torch.rllib.agents.a3c import A3CTrainer
from ray_tpu_torch.rllib.agents.impala import ImpalaTrainer
from ray_tpu_torch.rllib.agents.pg import PGTrainer
from ray_tpu_torch.rllib.agents.ppo import PPOTrainer
from ray_tpu_torch.rllib.agents.trainer import Trainer, build_trainer

__all__ = ["A3CTrainer", "ImpalaTrainer", "PGTrainer", "PPOTrainer",
           "Trainer", "build_trainer"]
