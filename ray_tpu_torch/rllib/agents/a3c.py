"""A3C — asynchronous advantage actor-critic (reference:
rllib/agents/a3c/a3c.py execution_plan = AsyncGradients → ApplyGradients,
a3c_torch_policy.py loss).

Execution shape: each rollout actor samples a fragment, computes
gradients *locally* on its CPU (stale weights are the point of A3C),
ships them to the learner, which applies them on its device and sends
fresh weights back to just that worker — no barrier across workers
(reference: rllib/execution/rollout_ops.py:92 AsyncGradients)."""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.agents.pg import discounted_returns
from ray_tpu_torch.rllib.agents.trainer import build_trainer
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy

A3C_CONFIG: dict = {
    "rollout_fragment_length": 64,
    "num_workers": 2,
    "lr": 1e-3,
    "gamma": 0.99,
    "vf_loss_coeff": 0.5,
    "entropy_coeff": 0.01,
    # gradient applications per Trainable.step() call
    "grads_per_step": 16,
}


class A3CPolicy(TorchPolicy):
    def __init__(self, observation_space, action_space, config):
        merged = {**A3C_CONFIG, **config}
        super().__init__(observation_space, action_space, merged,
                         loss_fn=a3c_loss)

    def postprocess_trajectory(self, batch, other_agent_batches=None,
                               episode=None):
        out = []
        for eb in batch.split_by_episode():
            if eb[SampleBatch.DONES][-1]:
                last_value = 0.0
            else:
                last_value = float(self.compute_values(
                    eb[SampleBatch.NEXT_OBS][-1:])[0])
            returns = discounted_returns(
                eb[SampleBatch.REWARDS].astype(np.float64),
                eb[SampleBatch.DONES].astype(np.float64),
                self.config["gamma"], last_value)
            eb[SampleBatch.VALUE_TARGETS] = returns
            eb[SampleBatch.ADVANTAGES] = (
                returns - eb[SampleBatch.VF_PREDS]).astype(np.float32)
            out.append(eb)
        return SampleBatch.concat_samples(out)


def a3c_loss(params, batch, policy: A3CPolicy):
    """reference: a3c_torch_policy.py actor_critic_loss."""
    cfg = policy.config
    pi_out, values = TorchPolicy.model_out(
        params, batch[SampleBatch.OBS].float())
    logp = policy.logp_fn()(pi_out, batch[SampleBatch.ACTIONS])
    entropy = policy.entropy_fn()(pi_out).mean()
    pi_loss = -(logp * batch[SampleBatch.ADVANTAGES]).mean()
    vf_loss = ((values - batch[SampleBatch.VALUE_TARGETS]) ** 2).mean()
    total = (pi_loss + cfg["vf_loss_coeff"] * vf_loss
             - cfg["entropy_coeff"] * entropy)
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


def a3c_train_step(workers, config) -> dict:
    """Async gradients: wait for any worker's grads, apply on the learner,
    refresh only that worker, immediately relaunch it."""
    policy = workers.local_worker.policy
    metrics: dict = {}
    trained = 0

    if not workers.remote_workers:
        # degenerate single-process mode: synchronous A2C-style steps
        for _ in range(config["grads_per_step"]):
            batch = workers.local_worker.sample(
                config["rollout_fragment_length"])
            grads, metrics = policy.compute_gradients(batch)
            policy.apply_gradients(grads)
            trained += metrics.pop("batch_count", len(batch))
        metrics["num_env_steps_trained"] = trained
        return metrics

    frag = config["rollout_fragment_length"]
    inflight = {
        w.sample_and_gradients.remote(frag): w
        for w in workers.remote_workers
    }
    applied = 0
    while applied < config["grads_per_step"]:
        ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1,
                                      timeout=300)
        if not ready:
            raise TimeoutError(
                f"A3C: no gradients from {len(inflight)} rollout workers "
                "within 300s (worker hung or dead?)")
        ref = ready[0]
        worker = inflight.pop(ref)
        grads, info = ray_tpu_torch.get(ref)
        policy.apply_gradients(grads)
        trained += info.pop("batch_count", 0)
        metrics = info
        applied += 1
        worker.set_weights.remote(policy.get_weights())
        inflight[worker.sample_and_gradients.remote(frag)] = worker
    # drain stragglers so next step starts clean (one shared timeout)
    try:
        ray_tpu_torch.get(list(inflight), timeout=300)
    except Exception:
        pass
    metrics["num_env_steps_trained"] = trained
    metrics["grads_applied"] = applied
    return metrics


A3CTrainer = build_trainer("A3C", A3C_CONFIG, A3CPolicy, a3c_train_step)
