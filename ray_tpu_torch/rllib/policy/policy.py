"""Policy base (reference: rllib/policy/policy.py). The port's concrete
policy is `torch_policy.TorchPolicy`."""

from __future__ import annotations

from typing import Any

import numpy as np


class Policy:
    # Recurrent policies set True, implement get_initial_state() and
    # compute_actions_with_state(); the RolloutWorker threads (h, c)
    # per env (reference: policy/policy.py is_recurrent /
    # get_initial_state)
    is_recurrent = False

    def __init__(self, observation_space, action_space, config: dict):
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config

    def get_initial_state(self) -> list:
        return []

    def compute_actions(self, obs_batch: np.ndarray, explore: bool = True,
                        ) -> tuple[np.ndarray, dict]:
        """-> (actions, extra_fetches: {action_logp, vf_preds, ...})"""
        raise NotImplementedError

    def learn_on_batch(self, batch) -> dict:
        raise NotImplementedError

    def get_weights(self) -> Any:
        raise NotImplementedError

    def set_weights(self, weights: Any):
        raise NotImplementedError

    def postprocess_trajectory(self, batch, other_agent_batches=None,
                               episode=None):
        return batch
