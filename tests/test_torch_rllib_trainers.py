"""Port check: ray_tpu_torch.rllib's trainers on the port's runtime, on the
CPU (`"device": "cpu"` for the learner; the rollout workers are CPU
actors either way), at the configurations and bars of the reference's
own tests.

One module-scoped cluster (`tests.test_torch_runtime.port_cluster`, 8
CPUs, with its leak check at shutdown) serves every case:
- PPO at tests/test_rllib.py:68-89's config with 2 rollout actors:
  episode_reward_mean > 60 after 8 train()s; after sync_weights every
  actor's weights equal the learner's, bit for bit; each actor sees no
  card and built its policy on the CPU; rlbench.measure over the 7
  after the first counts every learn_on_batch of the SGD epochs.
- IMPALA at tests/test_rllib_agents.py:142-166's config: best > 60
  within 20 steps, more than 1000 env steps trained; rlbench.measure
  of each step sees the LearnerThread's calls and grad time.
- A3C with 2 rollout actors: grads_applied == grads_per_step.
- the checkpoint round trip of tests/test_rllib.py:92-110.
- one multi-agent PPO step on tests/test_rllib_breadth.py's SignGame.
"""

import os
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.rlbench import measure
from ray_tpu_torch.rllib import MultiAgentBatch, MultiAgentEnv
from ray_tpu_torch.rllib.agents.a3c import A3CTrainer
from ray_tpu_torch.rllib.agents.impala import ImpalaTrainer
from ray_tpu_torch.rllib.agents.ppo import PPOTrainer
from ray_tpu_torch.rllib.env import Box, Discrete
from ray_tpu_torch.rllib.policy.torch_policy import tree_leaves
from tests.test_torch_runtime import port_cluster

# functions of this module go to the rollout actors by value, so an actor
# never imports it
cloudpickle.register_pickle_by_value(sys.modules[__name__])

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(num_cpus=8) as info:
        yield info


def _whoami(worker):
    import torch

    return {"pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda": torch.cuda.is_available(),
            "device": str(worker.policy.device)}


def test_ppo_learns_cartpole(cluster):
    trainer = PPOTrainer(config={
        "env": "CartPole-v1",
        "num_workers": 2,
        "num_envs_per_worker": 2,
        "rollout_fragment_length": 128,
        "train_batch_size": 1024,
        "sgd_minibatch_size": 256,
        "num_sgd_iter": 8,
        "lr": 3e-4,
        "entropy_coeff": 0.01,
        "seed": 0,
        **CPU,
    })
    try:
        first = trainer.train()
        window, rows = measure(trainer, trains=7)
        rewards = [m["episode_reward_mean"] for m in [first] + rows]
        want = tree_leaves(trainer.get_policy().get_weights())
        remotes = trainer.workers.remote_workers
        for got in ray_tpu_torch.get([w.get_weights.remote()
                                      for w in remotes]):
            for g, w in zip(tree_leaves(got), want, strict=True):
                np.testing.assert_array_equal(g, w)
        who = ray_tpu_torch.get([w.apply.remote(_whoami) for w in remotes])
    finally:
        trainer.cleanup()
    # untrained CartPole hovers ~20; after ~8k steps PPO must be well up
    assert rewards[-1] > 60, f"no learning: {rewards}"
    # every minibatch of every epoch, as the batches were cut
    assert window["learner_calls"] == sum(
        8 * -(-m["num_env_steps_trained"] // 256) for m in rows)
    assert window["env_steps"] == sum(m["num_env_steps_trained"]
                                      for m in rows)
    assert window["learner_utilization"] == 1.0
    assert len({w["pid"] for w in who} | {os.getpid()}) == 3
    for w in who:
        assert w["cuda_visible_devices"] == "" and not w["cuda"], who
        assert w["device"] == "cpu", who


def test_impala_learns_cartpole(cluster):
    trainer = ImpalaTrainer(config={
        "env": "CartPole-v1",
        "num_workers": 2,
        "num_envs_per_worker": 2,
        "rollout_fragment_length": 80,
        "train_batch_size": 800,
        "lr": 5e-4,
        "entropy_coeff": 0.01,
        "seed": 0,
        **CPU,
    })
    best, windows = 0.0, []
    try:
        for _ in range(20):
            window, (m,) = measure(trainer, trains=1)
            windows.append(window)
            r = m.get("episode_reward_mean")
            if r == r:
                best = max(best, r)
            if best > 60:
                break
    finally:
        trainer.cleanup()
    assert best > 60, f"IMPALA failed to learn CartPole (best={best})"
    assert m["env_steps_per_s"] > 0
    assert m["env_steps_trained"] > 1000
    for w in windows:
        assert w["learner_calls"] >= 1 and w["learner_grad_s"] > 0, w
        assert w["env_steps"] > 0 and w["per_second"] > 0, w


def test_a3c_async_gradients(cluster):
    trainer = A3CTrainer(config={"env": "CartPole-v1", "num_workers": 2,
                                 "seed": 0, **CPU})
    try:
        m = trainer.train()
    finally:
        trainer.cleanup()
    assert m["grads_applied"] == trainer.config["grads_per_step"] == 16
    assert m["num_env_steps_trained"] == 16 * 64


def test_trainer_checkpoint_roundtrip(cluster):
    trainer = PPOTrainer(config={
        "env": "CartPole-v1",
        "train_batch_size": 256,
        "rollout_fragment_length": 128,
        "sgd_minibatch_size": 128,
        "num_sgd_iter": 2,
        **CPU,
    })
    try:
        trainer.train()
        blob = trainer.save()
        w_before = trainer.get_policy().get_weights()
        trainer.train()
        moved = trainer.get_policy().get_weights()
        trainer.restore(blob)
        w_after = trainer.get_policy().get_weights()
    finally:
        trainer.cleanup()
    assert not np.array_equal(moved["pi"][0]["w"], w_before["pi"][0]["w"])
    for g, w in zip(tree_leaves(w_after), tree_leaves(w_before)):
        np.testing.assert_array_equal(g, w)
    assert trainer.iteration == 1


class SignGame(MultiAgentEnv):
    """tests/test_rllib_breadth.py's: two independent agents; obs in
    {-1,+1}; reward 1 iff action matches the sign. 8-step episodes."""

    observation_space = Box(-1, 1, (1,), np.float32)
    action_space = Discrete(2)

    def __init__(self, config=None):
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _obs(self):
        return {a: np.array([self._rng.choice([-1.0, 1.0])], np.float32)
                for a in ("a0", "a1")}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        self._last = self._obs()
        return self._last, {}

    def step(self, action_dict):
        rewards = {a: float(int(act) == int(self._last[a][0] > 0))
                   for a, act in action_dict.items()}
        self._t += 1
        done = self._t >= 8
        self._last = self._obs()
        return (self._last, rewards,
                {"__all__": done}, {"__all__": False}, {})


def test_multi_agent_ppo_step(cluster):
    trainer = PPOTrainer(config={
        "env": SignGame,
        "multiagent": {
            "policies": {"p0": (None, None, None, {}),
                         "p1": (None, None, None, {})},
            "policy_mapping_fn": lambda aid: "p0" if aid == "a0" else "p1",
        },
        "rollout_fragment_length": 64,
        "train_batch_size": 256,
        "sgd_minibatch_size": 64,
        "num_sgd_iter": 4,
        "lr": 5e-3,
        "seed": 0,
        **CPU,
    })
    try:
        batch = trainer.workers.local_worker.sample(32)
        result = trainer.train()
    finally:
        trainer.cleanup()
    assert isinstance(batch, MultiAgentBatch)
    assert set(batch.policy_batches) == {"p0", "p1"}
    assert batch.count == 32 and batch.policy_batches["p0"].count == 32
    assert set(result) >= {"p0", "p1", "num_env_steps_trained"}
    assert result["num_env_steps_trained"] == 256
    assert result["episodes_this_iter"] == (32 + 256) // 8
