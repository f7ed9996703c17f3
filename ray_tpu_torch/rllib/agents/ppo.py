"""PPO (reference: rllib/agents/ppo/ppo.py + ppo_torch_policy.py):
GAE advantages (postprocessing.py compute_advantages), clipped surrogate
objective, value clipping, entropy bonus, minibatch SGD epochs on the
learner's device while CPU rollout actors collect the train batch."""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from ray_tpu_torch.rllib.agents.trainer import build_trainer
from ray_tpu_torch.rllib.policy.sample_batch import (MultiAgentBatch,
                                                     SampleBatch)
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy

_SHUFFLE_RNGS = weakref.WeakKeyDictionary()


def _shuffle_rng(workers, seed: int) -> np.random.RandomState:
    rng = _SHUFFLE_RNGS.get(workers)
    if rng is None:
        rng = np.random.RandomState(seed)
        _SHUFFLE_RNGS[workers] = rng
    return rng


PPO_CONFIG: dict = {
    "rollout_fragment_length": 256,
    "train_batch_size": 1024,
    "sgd_minibatch_size": 256,
    "num_sgd_iter": 8,
    "lr": 3e-4,
    "gamma": 0.99,
    "lambda": 0.95,
    "clip_param": 0.2,
    "vf_clip_param": 10.0,
    "vf_loss_coeff": 0.5,
    "entropy_coeff": 0.0,
}


def compute_gae(batch: SampleBatch, last_value: float, gamma: float,
                lam: float) -> SampleBatch:
    """reference: rllib/evaluation/postprocessing.py compute_advantages."""
    rewards = batch[SampleBatch.REWARDS].astype(np.float64)
    values = batch[SampleBatch.VF_PREDS].astype(np.float64)
    dones = batch[SampleBatch.DONES].astype(np.float64)
    n = len(rewards)
    adv = np.zeros(n)
    next_value = last_value
    next_adv = 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        next_adv = delta + gamma * lam * nonterminal * next_adv
        adv[t] = next_adv
        next_value = values[t]
    batch[SampleBatch.ADVANTAGES] = adv.astype(np.float32)
    batch[SampleBatch.VALUE_TARGETS] = (adv + values).astype(np.float32)
    return batch


class PPOPolicy(TorchPolicy):
    def __init__(self, observation_space, action_space, config):
        merged = {**PPO_CONFIG, **config}
        super().__init__(observation_space, action_space, merged,
                         loss_fn=ppo_loss)

    def postprocess_trajectory(self, batch, other_agent_batches=None,
                               episode=None):
        """Per-episode GAE; bootstrap non-terminated fragment tails with
        the value function."""
        out = []
        for episode_batch in batch.split_by_episode():
            if episode_batch[SampleBatch.DONES][-1]:
                last_value = 0.0
            else:
                last_value = float(self.compute_values(
                    episode_batch[SampleBatch.NEXT_OBS][-1:])[0])
            out.append(compute_gae(episode_batch, last_value,
                                   self.config["gamma"],
                                   self.config["lambda"]))
        return SampleBatch.concat_samples(out)


def ppo_loss(params, batch, policy: PPOPolicy):
    """reference: ppo_torch_policy.py ppo_surrogate_loss."""
    cfg = policy.config
    pi_out, values = TorchPolicy.model_out(
        params, batch[SampleBatch.OBS].float())
    logp = policy.logp_fn()(pi_out, batch[SampleBatch.ACTIONS])
    entropy = policy.entropy_fn()(pi_out).mean()

    adv = batch[SampleBatch.ADVANTAGES]
    # the population std (ddof 0), as jnp.std; torch's default is ddof 1
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = (logp - batch[SampleBatch.ACTION_LOGP]).exp()
    surrogate = torch.minimum(
        adv * ratio,
        adv * ratio.clamp(1 - cfg["clip_param"], 1 + cfg["clip_param"]))
    policy_loss = -surrogate.mean()

    # Dual-clip value loss (reference ppo_torch_policy.py): clip the
    # prediction's movement from the old value, keep the max of the two
    # losses — clipping the error itself would zero gradients exactly
    # when the value function is far from its targets.
    targets = batch[SampleBatch.VALUE_TARGETS]
    old_values = batch[SampleBatch.VF_PREDS]
    vf_loss1 = (values - targets) ** 2
    clipped = old_values + (values - old_values).clamp(
        -cfg["vf_clip_param"], cfg["vf_clip_param"])
    vf_loss2 = (clipped - targets) ** 2
    vf_loss = torch.maximum(vf_loss1, vf_loss2).mean()

    total = (policy_loss + cfg["vf_loss_coeff"] * vf_loss
             - cfg["entropy_coeff"] * entropy)
    return total, {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "mean_ratio": ratio.mean(),
    }


def _sgd_epochs(policy, batch: SampleBatch, config, rng) -> tuple:
    """The SGD epochs; returns the last step's metrics and the number of
    learn_on_batch calls."""
    metrics: dict = {}
    calls = 0
    for _ in range(config["num_sgd_iter"]):
        for mb in batch.minibatches(config["sgd_minibatch_size"], rng):
            metrics = policy.learn_on_batch(mb)
            calls += 1
    return metrics, calls


def ppo_train_step(workers, config) -> dict:
    """Collect → minibatch SGD epochs → broadcast (reference:
    ppo.py:238 execution_plan = ParallelRollouts → TrainOneStep).
    learner_grad_time_s is the epochs' wall time: each learn_on_batch
    waits for its step's metrics, so on the card it holds the device
    time. learner_calls counts their learn_on_batch calls."""
    target = config["train_batch_size"]
    batches = []
    collected = 0
    while collected < target:
        b = workers.sample(config["rollout_fragment_length"])
        batches.append(b)
        collected += (b.count if isinstance(b, MultiAgentBatch)
                      else len(b))
    # One shuffle stream per worker set (not per call, and not stashed in
    # the user-visible config) so minibatch composition decorrelates
    # across iterations.
    rng = _shuffle_rng(workers, config.get("seed", 0))
    lw = workers.local_worker
    t0 = time.perf_counter()
    if isinstance(batches[0], MultiAgentBatch):
        batch = MultiAgentBatch.concat_samples(batches)
        metrics, calls = {}, 0
        for pid in lw.policies_to_train:
            if pid in batch.policy_batches:
                metrics[pid], n = _sgd_epochs(
                    lw.policies[pid], batch.policy_batches[pid], config, rng)
                calls += n
        metrics["num_env_steps_trained"] = batch.count
    else:
        batch = SampleBatch.concat_samples(batches)
        metrics, calls = _sgd_epochs(lw.policy, batch, config, rng)
        metrics["num_env_steps_trained"] = len(batch)
    metrics["learner_grad_time_s"] = time.perf_counter() - t0
    metrics["learner_calls"] = calls
    workers.sync_weights()
    return metrics


PPOTrainer = build_trainer("PPO", PPO_CONFIG, PPOPolicy, ppo_train_step,
                           supports_multiagent=True)
