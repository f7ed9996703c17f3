"""WorkerSet — local learner worker + remote rollout actors (reference:
rllib/evaluation/worker_set.py:27). The local worker holds the learner on
config["device"] (the card unless the caller asks for the CPU); each
remote worker is a CPU actor ({"CPU": num_cpus_per_worker}, so the raylet
shows it no card) whose policy is built with device "cpu"."""

from __future__ import annotations

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.rllib.evaluation.multi_agent import MultiAgentRolloutWorker
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.policy.sample_batch import (MultiAgentBatch,
                                                     SampleBatch)


class WorkerSet:
    def __init__(self, env_spec, policy_builder, config: dict,
                 num_workers: int = 0):
        ma = config.get("multiagent") or {}
        if ma.get("policies"):
            worker_cls = MultiAgentRolloutWorker
            # spec carries the callables (builders, mapping fn); strip it
            # from the plain config dict shipped to remote actors
            config = {k: v for k, v in config.items() if k != "multiagent"}
            pickled = cloudpickle.dumps({
                "policies": {pid: (spec[0] or policy_builder, *spec[1:])
                             for pid, spec in ma["policies"].items()},
                "policy_mapping_fn": ma["policy_mapping_fn"],
                "policies_to_train": ma.get("policies_to_train"),
            })
        else:
            worker_cls = RolloutWorker
            pickled = cloudpickle.dumps(policy_builder)
        self.local_worker = worker_cls(env_spec, pickled, config,
                                       worker_index=0)
        remote_cls = ray_tpu_torch.remote(
            resources={"CPU": config.get("num_cpus_per_worker", 1)})(
            worker_cls)
        remote_config = {**config, "device": "cpu"}
        self.remote_workers = [
            remote_cls.remote(env_spec, pickled, remote_config, i + 1)
            for i in range(num_workers)
        ]

    def sync_weights(self):
        """Broadcast local (learner) weights to all rollout actors."""
        if not self.remote_workers:
            return
        weights = self.local_worker.get_weights()
        ray_tpu_torch.get([w.set_weights.remote(weights)
                           for w in self.remote_workers], timeout=120)

    def sample(self, num_steps: int | None = None) -> SampleBatch:
        """ParallelRollouts (reference: execution/rollout_ops.py:21):
        gather one fragment from every worker."""
        if not self.remote_workers:
            return self.local_worker.sample(num_steps)
        batches = ray_tpu_torch.get(
            [w.sample.remote(num_steps) for w in self.remote_workers],
            timeout=600)
        if batches and isinstance(batches[0], MultiAgentBatch):
            return MultiAgentBatch.concat_samples(batches)
        return SampleBatch.concat_samples(batches)

    def collect_metrics(self) -> dict:
        metrics = [self.local_worker.get_metrics()]
        if self.remote_workers:
            metrics += ray_tpu_torch.get(
                [w.get_metrics.remote() for w in self.remote_workers],
                timeout=120)
        rewards = [r for m in metrics for r in m["episode_rewards"]]
        lengths = [l for m in metrics for l in m["episode_lengths"]]
        return {
            "episode_reward_mean": (sum(rewards) / len(rewards)
                                    if rewards else float("nan")),
            "episode_reward_min": min(rewards) if rewards else float("nan"),
            "episode_reward_max": max(rewards) if rewards else float("nan"),
            "episode_len_mean": (sum(lengths) / len(lengths)
                                 if lengths else float("nan")),
            "episodes_this_iter": len(rewards),
        }

    def stop(self):
        self.local_worker.stop()
        for w in self.remote_workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.remote_workers = []
