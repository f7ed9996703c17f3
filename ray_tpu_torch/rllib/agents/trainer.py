"""Trainer — RL algorithm shell extending tune.Trainable (reference:
rllib/agents/trainer.py:414 Trainer, train :503, setup :551;
trainer_template.py build_trainer). config["device"] is where the learner
runs: "cuda" unless the caller asks for "cpu"; the rollout actors run on
the CPU either way."""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet
from ray_tpu_torch.tune.trainable import Trainable

COMMON_CONFIG: dict = {
    "env": None,
    "env_config": {},
    "num_workers": 0,
    "num_envs_per_worker": 1,
    "num_cpus_per_worker": 1,
    "rollout_fragment_length": 200,
    "train_batch_size": 2000,
    "gamma": 0.99,
    "lr": 5e-4,
    "fcnet_hiddens": [64, 64],
    "seed": None,
    # the learner's device (the local worker's policy); remote rollout
    # workers always build theirs on the CPU
    "device": "cuda",
    # greedy-policy evaluation episodes every N train() calls
    # (reference: trainer.py evaluation_interval/evaluation_num_episodes)
    "evaluation_interval": 0,
    "evaluation_num_episodes": 5,
}


class Trainer(Trainable):
    """Subclasses define: default_config() -> dict,
    policy_builder(obs_space, act_space, config) -> Policy,
    train_step(worker_set, config) -> metrics dict."""

    _default_config: dict = COMMON_CONFIG
    _name = "Trainer"

    def __init__(self, config: dict | None = None, env=None):
        config = dict(config or {})
        if env is not None:
            config["env"] = env
        merged = {**COMMON_CONFIG, **self._default_config, **config}
        super().__init__(merged)

    # trainers whose train_step understands MultiAgentBatch set this
    _supports_multiagent = False

    def setup(self, config: dict):
        if config.get("env") is None:
            raise ValueError("config['env'] must be set")
        if (config.get("multiagent", {}).get("policies")
                and not self._supports_multiagent):
            raise ValueError(
                f"{self._name} does not support config['multiagent'] "
                "(its train step consumes single-policy SampleBatches); "
                "use PPO or write a custom train_step")
        self.workers = WorkerSet(
            config["env"], type(self).policy_builder, config,
            num_workers=config.get("num_workers", 0))

    # -- to implement ---------------------------------------------------

    @staticmethod
    def policy_builder(obs_space, action_space, config):
        raise NotImplementedError

    def train_step(self) -> dict:
        raise NotImplementedError

    # -- Trainable surface ----------------------------------------------

    def step(self) -> dict:
        metrics = self.train_step()
        metrics.update(self.workers.collect_metrics())
        interval = self.config.get("evaluation_interval") or 0
        # iteration is 0-based DURING a step: +1 so interval=N evaluates
        # on calls N, 2N, ... (not on the untrained first call)
        if interval and (self.iteration + 1) % interval == 0:
            # multi-agent raises a clear unsupported error from
            # evaluate() itself — no silent skip
            metrics["evaluation"] = self.evaluate()
        return metrics

    def evaluate(self, num_episodes: int | None = None) -> dict:
        """Greedy-policy episodes on a fresh env (reference:
        rllib/agents/trainer.py _evaluate / evaluation_workers — here a
        driver-side env since the greedy forward is cheap).
        Single-agent only: multi-agent envs act through dict obs the
        greedy loop doesn't speak."""
        import numpy as np

        from ray_tpu_torch.rllib.env import make_env

        lw = getattr(self.workers, "local_worker", None)
        if lw is not None and hasattr(lw, "policies"):
            raise ValueError(
                "evaluate() supports single-agent trainers only; roll "
                "multi-agent evaluation with your env's dict API")
        n = (self.config.get("evaluation_num_episodes", 5)
             if num_episodes is None else num_episodes)
        if n <= 0:
            raise ValueError(
                "evaluation_num_episodes must be >= 1 (unset "
                "evaluation_interval to disable evaluation)")
        env = make_env(self.config["env"],
                       self.config.get("env_config", {}))
        policy = self.get_policy()
        rewards, lengths = [], []
        try:
            for ep in range(n):
                obs, _ = env.reset(seed=10_000 + ep)
                total, steps = 0.0, 0
                done = False
                while not done and steps < 10_000:
                    acts, _ = policy.compute_actions(
                        np.asarray(obs, np.float32).ravel()[None],
                        explore=False)
                    act = int(acts[0]) if policy.discrete else acts[0]
                    obs, r, term, trunc, _ = env.step(act)
                    total += float(r)
                    steps += 1
                    done = term or trunc
                rewards.append(total)
                lengths.append(steps)
        finally:
            try:
                env.close()
            except Exception:
                pass
        return {
            "episode_reward_mean": float(np.mean(rewards)),
            "episode_reward_min": float(np.min(rewards)),
            "episode_reward_max": float(np.max(rewards)),
            "episode_len_mean": float(np.mean(lengths)),
            "episodes": n,
        }

    def save_checkpoint(self, checkpoint_dir: str):
        return {"weights": self.workers.local_worker.get_weights()}

    def load_checkpoint(self, state):
        self.workers.local_worker.set_weights(state["weights"])
        self.workers.sync_weights()

    def get_policy(self, policy_id: str | None = None):
        lw = self.workers.local_worker
        policies = getattr(lw, "policies", None)
        if policy_id is not None:
            if policies is None:
                raise ValueError(
                    "policy_id given but this is a single-policy trainer")
            return policies[policy_id]
        if policies is None:
            return lw.policy
        if len(policies) == 1:
            return next(iter(policies.values()))
        raise ValueError(
            f"multi-agent trainer has policies {sorted(policies)}; "
            "pass get_policy(policy_id=...)")

    def compute_action(self, obs, explore: bool = False):
        import numpy as np

        actions, _ = self.get_policy().compute_actions(
            np.asarray(obs)[None], explore=explore)
        return actions[0]

    def cleanup(self):
        self.workers.stop()


def build_trainer(name: str, default_config: dict,
                  policy_builder: Callable,
                  train_step: Callable,
                  supports_multiagent: bool = False) -> type:
    """reference: rllib/agents/trainer_template.py:build_trainer."""

    cls = type(name, (Trainer,), {
        "_name": name,
        "_default_config": default_config,
        "_supports_multiagent": supports_multiagent,
        "policy_builder": staticmethod(policy_builder),
        "train_step": lambda self: train_step(self.workers, self.config),
    })
    return cls
