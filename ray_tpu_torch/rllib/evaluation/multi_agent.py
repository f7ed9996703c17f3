"""Multi-agent rollout worker (reference: rllib/evaluation/rollout_worker.py
multi-agent paths + sampler.py _env_runner; policy mapping per
rllib/policy/policy.py and agents/trainer.py config["multiagent"]).

Each env step: group live agents by the policy that controls them
(policy_mapping_fn), run one batched compute_actions per policy, step the
env with the joint action dict. Trajectories accumulate per agent and are
postprocessed by that agent's policy at episode/fragment end, yielding a
MultiAgentBatch keyed by policy id."""

from __future__ import annotations

import cloudpickle
import numpy as np

from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.evaluation.rollout_worker import set_lease_threads
from ray_tpu_torch.rllib.policy.sample_batch import (MultiAgentBatch,
                                                     SampleBatch)

_COLS = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
         SampleBatch.DONES, SampleBatch.NEXT_OBS, SampleBatch.EPS_ID,
         SampleBatch.ACTION_LOGP, SampleBatch.VF_PREDS)


class MultiAgentRolloutWorker:
    """config["multiagent"] = {
        "policies": {pid: (builder|None, obs_space|None, act_space|None,
                           per_policy_config)},
        "policy_mapping_fn": agent_id -> pid,
        "policies_to_train": [pid, ...]  (default: all),
    }
    `spec` arrives cloudpickled so driver-defined builders/mapping fns
    reach remote worker actors (same convention as RolloutWorker)."""

    def __init__(self, env_spec, spec: bytes, config: dict | None = None,
                 worker_index: int = 0):
        self.config = dict(config or {})
        self.worker_index = worker_index
        set_lease_threads(self.config, worker_index)
        ma = cloudpickle.loads(spec)
        self.policy_mapping_fn = ma["policy_mapping_fn"]
        self.policies_to_train = ma.get("policies_to_train") or list(
            ma["policies"])
        self.env = make_env(env_spec, self.config.get("env_config", {}))
        self.policies = {}
        for pid, (builder, obs_space, act_space, pcfg) in (
                ma["policies"].items()):
            obs_space = obs_space or self.env.observation_space
            act_space = act_space or self.env.action_space
            # the device is the trainer's, not a policy's: a remote
            # worker's policies all run on its CPU
            pconf = {**self.config, **(pcfg or {})}
            if "device" in self.config:
                pconf["device"] = self.config["device"]
            self.policies[pid] = builder(obs_space, act_space, pconf)
        seed = self.config.get("seed")
        obs, _ = self.env.reset(
            seed=None if seed is None else seed + worker_index)
        self._agent_obs: dict = dict(obs)
        self._eps_id = worker_index * 1_000_000
        self._episode_reward = 0.0
        self._episode_len = 0
        self._completed_rewards: list[float] = []
        self._completed_lengths: list[int] = []
        self._buffers: dict = {}  # agent_id -> {col: [..]}

    def _buf(self, agent_id):
        if agent_id not in self._buffers:
            self._buffers[agent_id] = {k: [] for k in _COLS}
        return self._buffers[agent_id]

    def _flush_agent(self, agent_id, out: dict):
        """Postprocess one agent's finished fragment into its policy's
        batch list."""
        buf = self._buffers.pop(agent_id, None)
        if not buf or not buf[SampleBatch.OBS]:
            return
        pid = self.policy_mapping_fn(agent_id)
        batch = SampleBatch({k: np.asarray(v) for k, v in buf.items()})
        out.setdefault(pid, []).append(
            self.policies[pid].postprocess_trajectory(batch))

    def sample(self, num_steps: int | None = None) -> MultiAgentBatch:
        horizon = num_steps or self.config.get("rollout_fragment_length",
                                               200)
        out: dict = {}
        env_steps = 0
        while env_steps < horizon:
            # group live agents by policy, one batched forward per policy
            by_policy: dict = {}
            for agent_id, obs in self._agent_obs.items():
                by_policy.setdefault(
                    self.policy_mapping_fn(agent_id), []).append(agent_id)
            actions: dict = {}
            extras: dict = {}
            for pid, agent_ids in by_policy.items():
                obs_batch = np.stack([
                    np.asarray(self._agent_obs[a], np.float32).ravel()
                    for a in agent_ids])
                acts, extra = self.policies[pid].compute_actions(obs_batch)
                for i, a in enumerate(agent_ids):
                    act = acts[i]
                    env_act = (int(act) if self.policies[pid].discrete
                               else act)
                    actions[a] = env_act
                    extras[a] = (obs_batch[i], acts[i],
                                 extra[SampleBatch.ACTION_LOGP][i],
                                 extra[SampleBatch.VF_PREDS][i])
            next_obs, rewards, terminated, truncated, _ = self.env.step(
                actions)
            env_steps += 1
            term_all = bool(terminated.get("__all__"))
            # truncation ends the episode but keeps dones=False so
            # postprocessing bootstraps the tail (same convention as
            # rollout_worker.py)
            done_all = term_all or bool(truncated.get("__all__"))
            for agent_id in actions:
                obs_row, act_row, logp, vf = extras[agent_id]
                term = bool(terminated.get(agent_id, term_all))
                buf = self._buf(agent_id)
                buf[SampleBatch.OBS].append(obs_row)
                buf[SampleBatch.ACTIONS].append(act_row)
                buf[SampleBatch.REWARDS].append(
                    np.float32(rewards.get(agent_id, 0.0)))
                buf[SampleBatch.DONES].append(term)
                nxt = next_obs.get(agent_id)
                buf[SampleBatch.NEXT_OBS].append(
                    obs_row if nxt is None
                    else np.asarray(nxt, np.float32).ravel())
                buf[SampleBatch.EPS_ID].append(self._eps_id)
                buf[SampleBatch.ACTION_LOGP].append(logp)
                buf[SampleBatch.VF_PREDS].append(vf)
                self._episode_reward += float(rewards.get(agent_id, 0.0))
                if term or (agent_id not in next_obs and not done_all):
                    self._flush_agent(agent_id, out)
            self._episode_len += 1
            if done_all:
                for agent_id in list(self._buffers):
                    self._flush_agent(agent_id, out)
                self._completed_rewards.append(self._episode_reward)
                self._completed_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                self._eps_id += 1
                next_obs, _ = self.env.reset()
            self._agent_obs = dict(next_obs)
        for agent_id in list(self._buffers):
            self._flush_agent(agent_id, out)
        return MultiAgentBatch(
            {pid: SampleBatch.concat_samples(bs)
             for pid, bs in out.items()}, env_steps)

    # -- learner/weights plumbing ---------------------------------------

    def learn_on_batch(self, batch: MultiAgentBatch) -> dict:
        metrics = {}
        for pid in self.policies_to_train:
            pb = batch.policy_batches.get(pid)
            if pb is not None and pb.count:
                metrics[pid] = self.policies[pid].learn_on_batch(pb)
        return metrics

    def get_weights(self):
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    def set_weights(self, weights):
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)
        return True

    def get_metrics(self) -> dict:
        out = {"episode_rewards": list(self._completed_rewards),
               "episode_lengths": list(self._completed_lengths)}
        self._completed_rewards = []
        self._completed_lengths = []
        return out

    def stop(self):
        try:
            self.env.close()
        except Exception:
            pass
