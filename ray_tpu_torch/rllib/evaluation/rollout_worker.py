"""RolloutWorker — runs the policy in env(s) to produce SampleBatches
(reference: rllib/evaluation/rollout_worker.py:74; sample :655,
learn_on_batch :839). Vectorized over num_envs with a python loop; the
policy batches the forward pass across envs. As a remote actor it runs
on the CPU (WorkerSet builds its policy with device "cpu"); as the local
worker it holds the learner on config["device"].

Not ported yet (ROADMAP.md queue A item 11): offline IO (config
"output" / "input") and recurrent policies."""

from __future__ import annotations

import cloudpickle
import numpy as np

from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def set_lease_threads(config: dict, worker_index: int):
    """A remote worker (index > 0; WorkerSet's local worker is 0) sets
    torch's threads to its CPU lease. With torch's default, a thread a
    core in every actor, the thread pools of two actors stepping their
    policies at once contend, and a fragment takes many times longer than
    with a thread each."""
    if worker_index > 0:
        import torch

        torch.set_num_threads(max(1, int(config.get("num_cpus_per_worker",
                                                    1))))


class RolloutWorker:
    def __init__(self, env_spec, policy_builder: bytes | None = None,
                 config: dict | None = None, worker_index: int = 0):
        """policy_builder: cloudpickled fn(obs_space, act_space, config)
        -> Policy. Pickled so driver-defined builders reach worker actors."""
        self.config = dict(config or {})
        if self.config.get("output") or self.config.get("input") not in (
                None, "", "sampler"):
            raise NotImplementedError(
                "offline IO (config 'output' / 'input') is not ported yet "
                "(ROADMAP.md queue A item 11)")
        self.worker_index = worker_index
        set_lease_threads(self.config, worker_index)
        num_envs = self.config.get("num_envs_per_worker", 1)
        env_config = dict(self.config.get("env_config", {}))
        self.envs = [make_env(env_spec, env_config) for _ in range(num_envs)]
        base_seed = self.config.get("seed")
        self._obs = []
        for i, env in enumerate(self.envs):
            seed = (None if base_seed is None
                    else base_seed + worker_index * 1000 + i)
            obs, _ = env.reset(seed=seed)
            self._obs.append(obs)
        self._eps_ids = [worker_index * 1_000_000 + i
                         for i in range(num_envs)]
        self._next_eps = worker_index * 1_000_000 + num_envs
        self._episode_rewards = [0.0] * num_envs
        self._completed_rewards: list[float] = []
        self._completed_lengths: list[int] = []
        self._episode_lengths = [0] * num_envs
        builder = cloudpickle.loads(policy_builder)
        # worker_index rides in the config so builders can vary per
        # worker (e.g. APEX's spread of exploration epsilons)
        self.policy = builder(self.envs[0].observation_space,
                              self.envs[0].action_space,
                              {**self.config,
                               "worker_index": worker_index})
        if getattr(self.policy, "is_recurrent", False):
            raise NotImplementedError(
                "recurrent policies are not ported yet (ROADMAP.md queue A "
                "item 11)")

    def sample(self, num_steps: int | None = None) -> SampleBatch:
        """Collect `num_steps` total env steps (across the env vector).

        Columns come out env-major (each env's fragment contiguous in
        time) so split_by_episode/GAE see real trajectories. DONES means
        *terminated*: truncated episodes reset the env but keep
        dones=False so GAE bootstraps their tail with the value fn."""
        horizon = num_steps or self.config.get("rollout_fragment_length",
                                               200)
        n = len(self.envs)
        cols_keys = [
            SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
            SampleBatch.DONES, SampleBatch.NEXT_OBS, SampleBatch.EPS_ID,
            SampleBatch.ACTION_LOGP, SampleBatch.VF_PREDS]
        per_env: list[dict[str, list]] = [
            {k: [] for k in cols_keys} for _ in range(n)]
        steps = 0
        while steps < horizon:
            obs_batch = np.stack([np.asarray(o, np.float32).ravel()
                                  for o in self._obs])
            actions, extra = self.policy.compute_actions(obs_batch)
            for i, env in enumerate(self.envs):
                act = actions[i]
                if not self.policy.discrete:
                    act = np.clip(act, env.action_space.low,
                                  env.action_space.high)
                next_obs, reward, terminated, truncated, _ = env.step(
                    act if not hasattr(env.action_space, "n")
                    else int(act))
                cols = per_env[i]
                cols[SampleBatch.OBS].append(obs_batch[i])
                cols[SampleBatch.ACTIONS].append(actions[i])
                cols[SampleBatch.REWARDS].append(np.float32(reward))
                cols[SampleBatch.DONES].append(bool(terminated))
                cols[SampleBatch.NEXT_OBS].append(
                    np.asarray(next_obs, np.float32).ravel())
                cols[SampleBatch.EPS_ID].append(self._eps_ids[i])
                cols[SampleBatch.ACTION_LOGP].append(
                    extra[SampleBatch.ACTION_LOGP][i])
                cols[SampleBatch.VF_PREDS].append(
                    extra[SampleBatch.VF_PREDS][i])
                self._episode_rewards[i] += float(reward)
                self._episode_lengths[i] += 1
                if terminated or truncated:
                    self._completed_rewards.append(self._episode_rewards[i])
                    self._completed_lengths.append(self._episode_lengths[i])
                    self._episode_rewards[i] = 0.0
                    self._episode_lengths[i] = 0
                    self._eps_ids[i] = self._next_eps
                    self._next_eps += 1
                    next_obs, _ = env.reset()
                self._obs[i] = next_obs
                steps += 1
        batch = SampleBatch.concat_samples([
            SampleBatch({k: np.asarray(v) for k, v in cols.items()})
            for cols in per_env])
        return self.policy.postprocess_trajectory(batch)

    # -- learner/weights plumbing ---------------------------------------

    def learn_on_batch(self, batch: SampleBatch) -> dict:
        return self.policy.learn_on_batch(batch)

    def sample_and_gradients(self, num_steps: int | None = None):
        """Sample a fragment and compute (but don't apply) gradients on it
        — the A3C async-gradients unit (reference:
        execution/rollout_ops.py:92 AsyncGradients)."""
        batch = self.sample(num_steps)
        grads, info = self.policy.compute_gradients(batch)
        info["batch_count"] = batch.count
        return grads, info

    def apply_gradients(self, grads):
        self.policy.apply_gradients(grads)
        return True

    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights):
        self.policy.set_weights(weights)
        return True

    def apply(self, fn, *args):
        """fn(this worker, *args), in the worker's process (reference:
        RLlib's RolloutWorker.apply)."""
        return fn(self, *args)

    def get_metrics(self) -> dict:
        """Drain completed-episode stats (reference:
        collect_metrics/evaluation/metrics.py)."""
        out = {
            "episode_rewards": list(self._completed_rewards),
            "episode_lengths": list(self._completed_lengths),
        }
        self._completed_rewards = []
        self._completed_lengths = []
        return out

    def stop(self):
        for env in self.envs:
            try:
                env.close()
            except Exception:
                pass
