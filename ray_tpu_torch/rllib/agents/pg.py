"""Vanilla policy gradient / REINFORCE (reference: rllib/agents/pg/pg.py
+ pg_torch_policy.py pg_torch_loss): loss = -logp(a|s) * R_t with
discounted Monte-Carlo returns computed in postprocessing. The recurrent
PG trainer comes with the recurrent policy (ROADMAP.md queue A item
11)."""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.agents.trainer import build_trainer
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy

PG_CONFIG: dict = {
    "rollout_fragment_length": 200,
    "train_batch_size": 1000,
    "lr": 1e-3,
    "gamma": 0.99,
}


def discounted_returns(rewards: np.ndarray, dones: np.ndarray,
                       gamma: float, last_value: float = 0.0) -> np.ndarray:
    """reference: rllib/evaluation/postprocessing.py discount_cumsum."""
    out = np.zeros(len(rewards))
    running = last_value
    for t in range(len(rewards) - 1, -1, -1):
        running = rewards[t] + gamma * running * (1.0 - dones[t])
        out[t] = running
    return out.astype(np.float32)


class PGPolicy(TorchPolicy):
    def __init__(self, observation_space, action_space, config):
        merged = {**PG_CONFIG, **config}
        super().__init__(observation_space, action_space, merged,
                         loss_fn=pg_loss)

    def postprocess_trajectory(self, batch, other_agent_batches=None,
                               episode=None):
        out = []
        for eb in batch.split_by_episode():
            if eb[SampleBatch.DONES][-1]:
                last_value = 0.0
            else:
                # bootstrap truncated tails so fragment boundaries don't
                # bias returns toward zero
                last_value = float(self.compute_values(
                    eb[SampleBatch.NEXT_OBS][-1:])[0])
            eb[SampleBatch.ADVANTAGES] = discounted_returns(
                eb[SampleBatch.REWARDS].astype(np.float64),
                eb[SampleBatch.DONES].astype(np.float64),
                self.config["gamma"], last_value)
            out.append(eb)
        return SampleBatch.concat_samples(out)


def pg_loss(params, batch, policy: PGPolicy):
    pi_out, _ = TorchPolicy.model_out(
        params, batch[SampleBatch.OBS].float())
    logp = policy.logp_fn()(pi_out, batch[SampleBatch.ACTIONS])
    returns = batch[SampleBatch.ADVANTAGES]
    # the population std (ddof 0), as jnp.std
    returns = (returns - returns.mean()) / (returns.std(correction=0) + 1e-8)
    loss = -(logp * returns).mean()
    return loss, {"policy_loss": loss}


def pg_train_step(workers, config) -> dict:
    target = config["train_batch_size"]
    batches, collected = [], 0
    while collected < target:
        b = workers.sample(config["rollout_fragment_length"])
        batches.append(b)
        collected += len(b)
    batch = SampleBatch.concat_samples(batches)
    metrics = workers.local_worker.learn_on_batch(batch)
    workers.sync_weights()
    metrics["num_env_steps_trained"] = len(batch)
    return metrics


PGTrainer = build_trainer("PG", PG_CONFIG, PGPolicy, pg_train_step)
