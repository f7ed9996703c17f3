"""Env registry + creation (reference: rllib/env/ + tune/registry.py
register_env). An env spec is a creator fn, a registered name, one of the
port's built-in ids (`classic_control.BUILTIN_ENVS`: CartPole-v1, so the
RL path needs no gymnasium), or a gymnasium id where gymnasium is
installed."""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.rllib.env.classic_control import (BUILTIN_ENVS, Box,
                                                     CartPoleEnv, Discrete)

_ENV_REGISTRY: dict[str, Callable] = {}


class MultiAgentEnv:
    """Multi-agent env interface (reference: rllib/env/multi_agent_env.py).

    reset() -> (obs_dict, info_dict); step(action_dict) ->
    (obs_dict, reward_dict, terminated_dict, truncated_dict, info_dict).
    Dicts are keyed by agent id; terminated/truncated carry the special
    "__all__" key ending the episode for everyone. Agents may appear and
    disappear between steps — only agents present in obs act next step."""

    observation_space = None
    action_space = None

    def reset(self, seed=None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError

    def close(self):
        pass


def register_env(name: str, creator: Callable):
    """register_env("my_env", lambda config: MyEnv(config))"""
    _ENV_REGISTRY[name] = creator


__all__ = ["Box", "CartPoleEnv", "Discrete", "MultiAgentEnv", "make_env",
           "register_env"]


def make_env(env_spec, env_config: dict | None = None):
    """Registered creators first, then the port's built-in ids, then
    gymnasium.make where gymnasium is importable."""
    env_config = env_config or {}
    if callable(env_spec):
        return env_spec(env_config)
    if env_spec in _ENV_REGISTRY:
        return _ENV_REGISTRY[env_spec](env_config)
    if env_spec in BUILTIN_ENVS:
        return BUILTIN_ENVS[env_spec](**env_config)
    try:
        import gymnasium
    except ImportError:
        raise ValueError(
            f"unknown env {env_spec!r}: not registered (register_env), not "
            f"one of the port's built-in envs {sorted(BUILTIN_ENVS)}, and "
            "gymnasium is not installed") from None
    return gymnasium.make(env_spec, **env_config)
