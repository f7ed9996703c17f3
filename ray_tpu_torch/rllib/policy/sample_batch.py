"""SampleBatch — columnar trajectory storage (reference:
rllib/policy/sample_batch.py:17 SampleBatch, :525 MultiAgentBatch)."""

from __future__ import annotations

import numpy as np

# canonical column names (reference: SampleBatch class attrs)
OBS = "obs"
NEXT_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
INFOS = "infos"
EPS_ID = "eps_id"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    """dict[str, np.ndarray] with equal first dims."""

    OBS = OBS
    NEXT_OBS = NEXT_OBS
    ACTIONS = ACTIONS
    REWARDS = REWARDS
    DONES = DONES
    EPS_ID = EPS_ID
    ACTION_LOGP = ACTION_LOGP
    VF_PREDS = VF_PREDS
    ADVANTAGES = ADVANTAGES
    VALUE_TARGETS = VALUE_TARGETS

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)
        lengths = {v.shape[0] for v in self.values()
                   if isinstance(v, np.ndarray) and v.ndim}
        if len(lengths) > 1:
            raise ValueError(f"ragged SampleBatch columns: { {k: v.shape for k, v in self.items()} }")

    @property
    def count(self) -> int:
        for v in self.values():
            return int(v.shape[0])
        return 0

    def __len__(self) -> int:  # row count, matching the reference
        return self.count

    @staticmethod
    def concat_samples(batches: list["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = set(batches[0])
        for b in batches[1:]:
            keys &= set(b)
        return SampleBatch({
            k: np.concatenate([b[k] for b in batches], axis=0)
            for k in keys
        })

    def concat(self, other: "SampleBatch") -> "SampleBatch":
        return SampleBatch.concat_samples([self, other])

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: np.random.RandomState | None = None):
        idx = (rng or np.random).permutation(self.count)
        for k in self:
            self[k] = self[k][idx]
        return self

    def split_by_episode(self) -> list["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        out = []
        eps = self[EPS_ID]
        boundaries = np.where(eps[1:] != eps[:-1])[0] + 1
        prev = 0
        for b in list(boundaries) + [self.count]:
            if b > prev:
                out.append(self.slice(prev, b))
            prev = b
        return out

    def minibatches(self, size: int, rng=None):
        """Shuffled minibatch views for SGD epochs."""
        idx = (rng or np.random).permutation(self.count)
        for start in range(0, self.count, size):
            sel = idx[start:start + size]
            yield SampleBatch({k: v[sel] for k, v in self.items()})


class MultiAgentBatch:
    """policy_id -> SampleBatch (reference: sample_batch.py:525)."""

    def __init__(self, policy_batches: dict[str, SampleBatch], count: int):
        self.policy_batches = policy_batches
        self.count = count

    @staticmethod
    def concat_samples(batches: list["MultiAgentBatch"]) -> "MultiAgentBatch":
        keys = {k for b in batches for k in b.policy_batches}
        return MultiAgentBatch(
            {k: SampleBatch.concat_samples(
                [b.policy_batches[k] for b in batches
                 if k in b.policy_batches]) for k in keys},
            sum(b.count for b in batches))
