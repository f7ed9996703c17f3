"""TorchPolicy — the port of the reference's JAXPolicy: a functional
actor-critic MLP (the fcnet: two tanh layers of 64 for both π and V), a
pluggable loss of (params, batch, policy) and torch.optim.Adam.

Device: config["device"] ("cuda" unless the caller asks for "cpu"; no
CUDA with "cuda" raises). The weights come from a CPU generator seeded
with config["seed"], so a policy starts from the same weights on every
device, as the reference's threefry key gives on every backend; actions
are drawn from a generator on the policy's device seeded with seed + 1.

Weights keep the reference's layout, {"pi": [{"w": [n_in, n_out], "b":
[n_out]}, ...], "vf": [...]}, leaf tensors on the device:
get_weights/set_weights/compute_gradients move the numpy pytree the
reference moves, so a reference checkpoint loads unchanged
(params_from_jax / params_to_jax).

torch.optim updates the weights in place, where the reference swaps in a
new pytree. A lock makes each update (forward, backward, step) and each
read or write of the weights atomic to one another, so a broadcast from
another thread (IMPALA's LearnerThread learns while the trainer's thread
calls get_weights) reads the weights before or after a step, never a
mix."""

from __future__ import annotations

import math
import threading
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._private.device import check_device
from ray_tpu_torch.rllib.policy.policy import Policy
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

_HEADS = ("pi", "vf")
_LEAF_KEYS = ("w", "b")


def _mlp_init(gen, sizes):
    return [{"w": torch.randn(n_in, n_out, generator=gen) / math.sqrt(n_in),
             "b": torch.zeros(n_out)}
            for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def _mlp_apply(params, x, final_linear=True):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


def tree_leaves(params) -> list:
    """The leaves of a weights pytree: π's layers, then V's, "w" before
    "b" in each."""
    return [layer[k] for head in _HEADS for layer in params[head]
            for k in _LEAF_KEYS]


def tree_map(fn, params) -> dict:
    return {head: [{k: fn(layer[k]) for k in _LEAF_KEYS}
                   for layer in params[head]] for head in _HEADS}


def tree_unflatten(leaves, like) -> dict:
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def params_from_jax(params, device=None) -> dict:
    """The reference's weights pytree (jax or numpy leaves) as float32
    tensors on `device` (the CPU when None), in the same layout."""
    return tree_map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                           device=device), params)


def params_to_jax(params) -> dict:
    """The port's weights as the reference's numpy pytree (copies)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(),
                    params)


def categorical_logp(logits, actions):
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(1, actions[:, None].long())[:, 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)


def gaussian_logp(mean_logstd, actions):
    mean, log_std = mean_logstd.chunk(2, dim=-1)
    var = torch.exp(2 * log_std)
    return (-0.5 * ((actions - mean) ** 2 / var)
            - log_std - 0.5 * math.log(2 * math.pi)).sum(dim=-1)


def gaussian_entropy(mean_logstd):
    _, log_std = mean_logstd.chunk(2, dim=-1)
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(dim=-1)


class TorchPolicy(Policy):
    """loss_fn(params, batch_tensors, policy) -> (loss, metrics)."""

    def __init__(self, observation_space, action_space, config: dict,
                 loss_fn: Callable | None = None):
        super().__init__(observation_space, action_space, config)
        self.device = check_device(config.get("device", "cuda"))
        obs_dim = int(np.prod(observation_space.shape))
        hiddens = list(config.get("fcnet_hiddens", [64, 64]))
        self.discrete = hasattr(action_space, "n")
        if self.discrete:
            act_out = int(action_space.n)
        else:
            act_dim = int(np.prod(action_space.shape))
            act_out = 2 * act_dim  # mean + log_std

        seed = config.get("seed")
        seed = 0 if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        params = {"pi": _mlp_init(gen, [obs_dim] + hiddens + [act_out]),
                  "vf": _mlp_init(gen, [obs_dim] + hiddens + [1])}
        self.params = tree_map(
            lambda t: t.to(self.device).requires_grad_(), params)
        self._leaves = tree_leaves(self.params)
        self._optimizer = None  # built at the first update (_step)
        self._loss_fn = loss_fn
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._lock = threading.Lock()

    # -- model fns (used by losses too) ---------------------------------

    @staticmethod
    def model_out(params, obs):
        return (_mlp_apply(params["pi"], obs),
                _mlp_apply(params["vf"], obs)[:, 0])

    def logp_fn(self):
        return categorical_logp if self.discrete else gaussian_logp

    def entropy_fn(self):
        return categorical_entropy if self.discrete else gaussian_entropy

    # -- host <-> device -------------------------------------------------

    def _obs(self, obs_batch):
        obs = np.asarray(obs_batch, np.float32).reshape(len(obs_batch), -1)
        return torch.as_tensor(obs, device=self.device)

    # Columns losses never read — skipped at host->device transfer time
    # (NEXT_OBS alone would double the obs volume shipped per minibatch).
    _NON_LOSS_COLUMNS = frozenset({
        SampleBatch.EPS_ID, SampleBatch.NEXT_OBS, SampleBatch.DONES,
        "infos",
    })

    def _tensors(self, batch) -> dict:
        """The loss's columns on the device; float64 goes down to
        float32, as the reference's jnp.asarray does without x64."""
        out = {}
        for k, v in batch.items():
            if k in self._NON_LOSS_COLUMNS or v.dtype == object:
                continue
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            # a copy: a batch from the object store is read-only
            out[k] = torch.tensor(v, device=self.device)
        return out

    @staticmethod
    def _info(loss, metrics) -> dict:
        """The loss and its metrics as floats, in one copy to the host."""
        values = torch.stack([loss.detach()] + [
            m.detach() for m in metrics.values()]).tolist()
        return dict(zip(["total_loss", *metrics], values))

    def _step(self):
        """Adam's step on the gradients in .grad. The optimizer is built
        at the first: a rollout actor never updates, and a process's
        first torch optimizer imports torch._dynamo, which takes
        seconds."""
        if self._optimizer is None:
            self._optimizer = torch.optim.Adam(
                self._leaves, lr=self.config.get("lr", 5e-4))
        self._optimizer.step()

    def _loss(self, tb):
        if self._loss_fn is None:
            raise ValueError(f"{type(self).__name__} was built without a "
                             "loss_fn: it acts but cannot learn")
        return self._loss_fn(self.params, tb, self)

    # -- Policy interface ------------------------------------------------

    def compute_actions(self, obs_batch, explore=True):
        obs = self._obs(obs_batch)
        with torch.no_grad(), self._lock:
            pi_out, vf = self.model_out(self.params, obs)
            if not explore:
                actions = (pi_out.argmax(dim=-1) if self.discrete
                           else pi_out.chunk(2, dim=-1)[0])
                logp = torch.zeros(len(obs_batch))
            elif self.discrete:
                actions = torch.multinomial(torch.softmax(pi_out, dim=-1), 1,
                                            generator=self._gen)[:, 0]
                logp = categorical_logp(pi_out, actions)
            else:
                mean, log_std = pi_out.chunk(2, dim=-1)
                noise = torch.randn(mean.shape, generator=self._gen,
                                    device=self.device)
                actions = mean + torch.exp(log_std) * noise
                logp = gaussian_logp(pi_out, actions)
        return (actions.cpu().numpy(),
                {SampleBatch.ACTION_LOGP: logp.cpu().numpy(),
                 SampleBatch.VF_PREDS: vf.cpu().numpy()})

    def compute_log_likelihoods(self, obs_batch, actions) -> np.ndarray:
        """logp of given actions under the current policy (reference:
        rllib/policy/policy.py compute_log_likelihoods)."""
        obs = self._obs(obs_batch)
        actions = torch.as_tensor(np.asarray(actions), device=self.device)
        with torch.no_grad(), self._lock:
            pi_out, _ = self.model_out(self.params, obs)
            return self.logp_fn()(pi_out, actions).cpu().numpy()

    def compute_values(self, obs_batch) -> np.ndarray:
        obs = self._obs(obs_batch)
        with torch.no_grad(), self._lock:
            _, vf = self.model_out(self.params, obs)
            return vf.cpu().numpy()

    def learn_on_batch(self, batch: SampleBatch) -> dict:
        tb = self._tensors(batch)
        with self._lock:
            loss, metrics = self._loss(tb)
            for p in self._leaves:
                p.grad = None
            loss.backward()
            self._step()
        return self._info(loss, metrics)

    def compute_gradients(self, batch: SampleBatch):
        """Gradients without applying them (reference:
        rllib/policy/policy.py compute_gradients; used by A3C's async
        gradients). Returns (numpy grad pytree, info)."""
        tb = self._tensors(batch)
        with self._lock:
            loss, metrics = self._loss(tb)
            # a weight the loss does not reach (PG's value head) gets a
            # zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(loss, self._leaves,
                                        materialize_grads=True)
        return (params_to_jax(tree_unflatten(grads, self.params)),
                self._info(loss, metrics))

    def apply_gradients(self, grads):
        """reference: rllib/policy/policy.py apply_gradients."""
        flat = tree_leaves(params_from_jax(grads, self.device))
        with self._lock:
            for p, g in zip(self._leaves, flat, strict=True):
                if g.shape != p.shape:
                    raise ValueError(f"gradient of shape {tuple(g.shape)} "
                                     f"for a weight of {tuple(p.shape)}")
                p.grad = g
            self._step()

    def get_weights(self):
        with self._lock:
            return params_to_jax(self.params)

    def set_weights(self, weights):
        flat = tree_leaves(params_from_jax(weights, self.device))
        with self._lock, torch.no_grad():
            for p, v in zip(self._leaves, flat, strict=True):
                if v.shape != p.shape:
                    raise ValueError(f"weight of shape {tuple(v.shape)} "
                                     f"for one of {tuple(p.shape)}")
                p.copy_(v)
