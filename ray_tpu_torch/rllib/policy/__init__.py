from ray_tpu_torch.rllib.policy.policy import Policy
from ray_tpu_torch.rllib.policy.sample_batch import (MultiAgentBatch,
                                                     SampleBatch)
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy

__all__ = ["MultiAgentBatch", "Policy", "SampleBatch", "TorchPolicy"]
