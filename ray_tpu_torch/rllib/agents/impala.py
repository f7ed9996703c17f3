"""IMPALA — importance-weighted actor-learner architecture (reference:
rllib/agents/impala/impala.py + execution/learner_thread.py:16; algorithm:
Espeholt et al. 2018).

Architecture here: CPU rollout actors sample continuously and
asynchronously (each completed fragment immediately triggers the next
sample call with refreshed weights — no synchronous barrier), and a
LearnerThread drains fragments into the V-trace SGD step on the learner's
device (the card unless the caller asks for the CPU), so env stepping and
device compute overlap. The policy's lock keeps the weight broadcast
from reading half a step."""

from __future__ import annotations

import queue
import time

import ray_tpu_torch
from ray_tpu_torch.rllib.agents.trainer import COMMON_CONFIG, Trainer
from ray_tpu_torch.rllib.agents.vtrace import vtrace_returns
from ray_tpu_torch.rllib.execution.learner_thread import LearnerThread
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy

IMPALA_CONFIG = {
    **COMMON_CONFIG,
    "num_workers": 2,
    "num_envs_per_worker": 1,
    "rollout_fragment_length": 50,
    "train_batch_size": 500,
    "lr": 5e-4,
    "entropy_coeff": 0.01,
    "vf_loss_coeff": 0.5,
    "vtrace_clip_rho_threshold": 1.0,
    "vtrace_clip_pg_rho_threshold": 1.0,
    "broadcast_interval": 1,   # fragments between weight refreshes
    "learner_queue_size": 16,
}


def impala_loss(params, batch, policy):
    """V-trace actor-critic loss over time-major [T, B] fragments."""
    cfg = policy.config
    n_envs = int(cfg.get("num_envs_per_worker", 1))
    obs = batch[SampleBatch.OBS]
    n = obs.shape[0]
    b, t = n_envs, n // n_envs

    def tm(x):
        # env-major flat [B*T, ...] -> time-major [T, B, ...]
        return x.reshape(b, t, *x.shape[1:]).transpose(0, 1)

    pi_out, values = TorchPolicy.model_out(params, obs.reshape(n, -1))
    target_logp = policy.logp_fn()(pi_out, batch[SampleBatch.ACTIONS])
    entropy = policy.entropy_fn()(pi_out).mean()

    dones = tm(batch[SampleBatch.DONES].float())
    discounts = cfg.get("gamma", 0.99) * (1.0 - dones)
    last_next_obs = tm(batch[SampleBatch.NEXT_OBS])[-1]
    _, bootstrap_v = TorchPolicy.model_out(
        params, last_next_obs.reshape(b, -1))

    vs, pg_adv = vtrace_returns(
        behaviour_logp=tm(batch[SampleBatch.ACTION_LOGP]),
        target_logp=tm(target_logp),
        discounts=discounts,
        rewards=tm(batch[SampleBatch.REWARDS]),
        values=tm(values),
        bootstrap_value=bootstrap_v,
        clip_rho=cfg.get("vtrace_clip_rho_threshold", 1.0),
        clip_pg_rho=cfg.get("vtrace_clip_pg_rho_threshold", 1.0))

    pg_loss = -(tm(target_logp) * pg_adv).mean()
    vf_loss = 0.5 * ((vs - tm(values)) ** 2).mean()
    total = (pg_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
             - cfg.get("entropy_coeff", 0.01) * entropy)
    return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


class ImpalaPolicy(TorchPolicy):
    # V-trace needs dones + the bootstrap observation on device.
    _NON_LOSS_COLUMNS = frozenset({SampleBatch.EPS_ID, "infos"})

    def __init__(self, observation_space, action_space, config):
        super().__init__(observation_space, action_space, config,
                         loss_fn=impala_loss)

    def postprocess_trajectory(self, batch: SampleBatch) -> SampleBatch:
        return batch  # advantages come from v-trace on the learner


class ImpalaTrainer(Trainer):
    """reference: rllib/agents/impala/impala.py ImpalaTrainer."""

    _default_config = IMPALA_CONFIG
    _name = "IMPALA"

    @staticmethod
    def policy_builder(obs_space, action_space, config):
        return ImpalaPolicy(obs_space, action_space, config)

    def setup(self, config):
        super().setup(config)
        self._learner = LearnerThread(
            self.workers.local_worker,
            max_queue=config.get("learner_queue_size", 16))
        self._learner.start()
        self._sampled = 0
        self._t0 = time.perf_counter()
        # One always-in-flight sample call per rollout actor.
        self._inflight: dict = {
            w.sample.remote(): w for w in self.workers.remote_workers}
        self._since_broadcast = {id(w): 0
                                 for w in self.workers.remote_workers}

    def train_step(self) -> dict:
        target = self.config.get("train_batch_size", 500)
        trained = 0
        if not self.workers.remote_workers:
            # Degenerate sync mode (num_workers=0): sample/learn inline.
            while trained < target:
                batch = self.workers.local_worker.sample()
                self._sampled += batch.count
                self._put(batch)
                while True:
                    self._learner.check()
                    try:
                        n, _ = self._learner.outqueue.get(timeout=1.0)
                        break
                    except queue.Empty:
                        continue
                trained += n
            return self._metrics(trained)
        while trained < target:
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=60)
            for ref in ready:
                w = self._inflight.pop(ref)
                batch = ray_tpu_torch.get(ref)
                self._sampled += batch.count
                # Backpressure: blocks when the learner is the bottleneck.
                self._put(batch)
                self._since_broadcast[id(w)] += 1
                if (self._since_broadcast[id(w)]
                        >= self.config.get("broadcast_interval", 1)):
                    self._since_broadcast[id(w)] = 0
                    w.set_weights.remote(
                        self.workers.local_worker.get_weights())
                self._inflight[w.sample.remote()] = w
            while not self._learner.outqueue.empty():
                n, _ = self._learner.outqueue.get()
                trained += n
            self._learner.check()
        return self._metrics(trained)

    def _put(self, batch):
        """inqueue.put that raises the learner thread's error instead of
        blocking forever on a queue nobody drains."""
        while True:
            self._learner.check()
            try:
                self._learner.inqueue.put(batch, timeout=1.0)
                return
            except queue.Full:
                continue

    def _metrics(self, trained: int) -> dict:
        wall = time.perf_counter() - self._t0
        return {
            "env_steps_sampled": self._sampled,
            "env_steps_trained": self._learner.num_steps_trained,
            "env_steps_per_s": round(self._sampled / wall, 1),
            **self._learner.stats(),
        }

    def cleanup(self):
        self._learner.stop()
        super().cleanup()
