from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet

__all__ = ["RolloutWorker", "WorkerSet"]
