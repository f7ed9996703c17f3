"""The port's own classic-control envs and the two spaces they need.

`CartPole-v1` is gymnasium's (`gymnasium/envs/classic_control/
cartpole.py` behind `TimeLimit(max_episode_steps=500)`), bit for bit:
the same float64 dynamics in the same order of operations, float32
observations, the reset drawn from `np.random.default_rng(seed)` (the
generator gymnasium's `seeding.np_random` builds) uniform in ±0.05,
termination at |x| > 2.4 or |θ| > 12°, truncation at 500 steps. The card's
machine has no gymnasium; with these the RL path needs none.

The spaces carry what the rollout worker and the policies read
(`.n`; `.shape`, `.low`, `.high`), and Discrete the `contains` that
CartPole's step checks its action with.
"""

from __future__ import annotations

import math

import numpy as np


class Discrete:
    """{start, ..., start + n - 1} (gymnasium.spaces.Discrete)."""

    def __init__(self, n: int, start: int = 0):
        self.n = int(n)
        self.start = int(start)

    def contains(self, x) -> bool:
        if isinstance(x, int):
            value = np.int64(x)
        elif (isinstance(x, (np.generic, np.ndarray))
              and np.issubdtype(x.dtype, np.integer) and x.shape == ()):
            value = np.int64(x)
        else:
            return False
        return bool(self.start <= value < self.start + self.n)


class Box:
    """A box in R^shape with bounds low and high (gymnasium.spaces.Box)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype),
                                   self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype),
                                    self.shape).copy()


class CartPoleEnv:
    """CartPole-v1: reset(seed=None) -> (obs, info); step(action) ->
    (obs, reward, terminated, truncated, info)."""

    max_episode_steps = 500

    def __init__(self):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.np_random = None
        self.state = None
        self.steps_beyond_terminated = None
        self._elapsed_steps = None

    def reset(self, *, seed: int | None = None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self.steps_beyond_terminated = None
        self._elapsed_steps = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("CartPole-v1: call reset before step")
        if not self.action_space.contains(action):
            raise ValueError(f"{action!r} ({type(action)}) invalid")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = (temp - self.polemass_length * thetaacc * costheta
                / self.total_mass)
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = 1.0
        else:  # stepped past the end without a reset
            self.steps_beyond_terminated += 1
            reward = 0.0
        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= self.max_episode_steps
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                truncated, {})

    def close(self):
        pass


# the port's built-in env ids: id -> creator(**env_config)
BUILTIN_ENVS = {"CartPole-v1": CartPoleEnv}
