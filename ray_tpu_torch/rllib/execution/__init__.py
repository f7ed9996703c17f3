"""Execution building blocks (reference: rllib/execution/). The replay
buffers come with DQN (ROADMAP.md queue A item 11)."""

from ray_tpu_torch.rllib.execution.learner_thread import LearnerThread

__all__ = ["LearnerThread"]
