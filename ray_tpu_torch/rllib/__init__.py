"""ray_tpu_torch.rllib — reinforcement learning, the port of
ray_tpu.rllib's on-policy path: TorchPolicy learners on the card
(config["device"], "cuda" unless the caller asks for "cpu") fed by CPU
rollout actors; PG, PPO, A3C and IMPALA with V-trace. The off-policy
agents, the model catalog, recurrent policies and offline IO are not
ported yet (ROADMAP.md queue A item 11)."""

from ray_tpu_torch.rllib.agents import (A3CTrainer, ImpalaTrainer,
                                        PGTrainer, PPOTrainer, Trainer,
                                        build_trainer)
from ray_tpu_torch.rllib.env import MultiAgentEnv, make_env, register_env
from ray_tpu_torch.rllib.execution import LearnerThread
from ray_tpu_torch.rllib.policy import (MultiAgentBatch, Policy,
                                        SampleBatch, TorchPolicy)

__all__ = [
    "A3CTrainer",
    "ImpalaTrainer",
    "LearnerThread",
    "MultiAgentBatch",
    "MultiAgentEnv",
    "PGTrainer",
    "PPOTrainer",
    "Policy",
    "SampleBatch",
    "TorchPolicy",
    "Trainer",
    "build_trainer",
    "make_env",
    "register_env",
]
