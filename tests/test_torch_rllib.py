"""Port check: ray_tpu_torch.rllib against ray_tpu.rllib in one process, no
cluster, on the CPU (`"device": "cpu"`).

Inputs come from numpy seeds. One set of weights in the reference's
layout ({"pi": [{"w", "b"}, ...], "vf": [...]}, the fcnet [64, 64]) is
made with numpy and carried to the port with `params_from_jax`; the
reference's policies get the same weights through `set_weights`.

Tolerances:
- CartPole-v1 against gymnasium.make("CartPole-v1"): bit for bit
  (observations' bytes, rewards, terminated, truncated), 3 seeds x 600
  steps under a balancing rule (reaches the 500-step truncation) and a
  random rule (crosses resets).
- compute_gae and discounted_returns: exact (the same float64 numpy).
- vtrace_returns at T 50, B 4, off-policy: 1e-5 absolute.
- pg_loss, ppo_loss, the A3C loss and impala_loss at batch 256, for a
  Discrete(2) and a Box(2,) action space: the loss and every metric
  within 1e-5 relative of jax.value_and_grad's, each gradient leaf within
  1e-5 relative L2.
- one learn_on_batch (Adam) against the reference's jitted sgd_step:
  every weight within 1e-6 absolute; a whole PPO _sgd_epochs (8 epochs x
  4 minibatches of 256, one shuffle seed): 1e-4 relative L2 over all
  weights. torch.optim.Adam and optax.adam share the formula, not the
  rounding.
- greedy actions equal, values within 1e-6; over 20000 exploring draws
  the action frequencies within 0.01 of the softmax (Discrete) or the
  mean within 0.05 and the std within 5% (Box), and every draw's logp
  within 1e-5 of the reference's logp of that action. Draws are never
  compared one by one: jax.random and torch.Generator differ.
- weights: a reference PPOPolicy's get_weights loads through set_weights
  and gives logits within 1e-6; params_from_jax / params_to_jax round
  trip exactly; one seed gives one rollout.
- the weight lock: get_weights from another thread while a learner
  thread steps returns exactly the weights before or after some step.
"""

import hashlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.agents import a3c as ra3c
from ray_tpu.rllib.agents import impala as rimpala
from ray_tpu.rllib.agents import pg as rpg
from ray_tpu.rllib.agents import ppo as rppo
from ray_tpu.rllib.agents import vtrace as rvtrace
from ray_tpu.rllib.policy import jax_policy as rjp
from ray_tpu_torch.rllib.agents import a3c as ta3c
from ray_tpu_torch.rllib.agents import impala as timpala
from ray_tpu_torch.rllib.agents import pg as tpg
from ray_tpu_torch.rllib.agents import ppo as tppo
from ray_tpu_torch.rllib.agents import vtrace as tvtrace
from ray_tpu_torch.rllib.env import Box, CartPoleEnv, Discrete, make_env
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (TorchPolicy,
                                                     params_from_jax,
                                                     params_to_jax,
                                                     tree_leaves)

OBS_DIM, HIDDENS, N = 4, [64, 64], 256
OBS_SPACE = Box(-np.inf, np.inf, (OBS_DIM,), np.float32)
SPACES = {"discrete": Discrete(2), "box": Box(-1.0, 1.0, (2,), np.float32)}
LOSS_TOL, VTRACE_TOL, ADAM_STEP_TOL, EPOCHS_TOL = 1e-5, 1e-5, 1e-6, 1e-4
VALUE_TOL, FREQ_TOL, LOGP_TOL = 1e-6, 0.01, 1e-5
CPU = {"device": "cpu"}


def _weights(act_out, seed=0):
    """The reference's weights layout, made with numpy (biases non-zero so
    their gradients and updates show)."""
    rng = np.random.default_rng(seed)

    def mlp(sizes):
        return [{"w": (rng.standard_normal((i, o)) / np.sqrt(i)
                       ).astype(np.float32),
                 "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
                for i, o in zip(sizes[:-1], sizes[1:])]

    return {"pi": mlp([OBS_DIM] + HIDDENS + [act_out]),
            "vf": mlp([OBS_DIM] + HIDDENS + [1])}


def _act_out(space):
    return space.n if hasattr(space, "n") else 2 * space.shape[0]


def _rel_l2(got, want):
    """||got - want|| / ||want||; where want is all zeros (PG's value
    head), ||got||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (scale if scale else 1.0)


def _flat(weights):
    return np.concatenate([np.ravel(v) for v in tree_leaves(weights)])


def _batch(space, weights, n=N, num_envs=4, seed=1):
    """A batch of every column the four losses read: env-major fragments
    of num_envs envs, behaviour logp near the weights' own (so PPO's
    ratio straddles its clip), a few terminations."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, OBS_DIM)).astype(np.float32)
    if hasattr(space, "n"):
        actions = rng.integers(0, space.n, n)
    else:
        actions = rng.uniform(-1, 1, (n, space.shape[0])).astype(np.float32)
    pi_out, _ = rjp.JAXPolicy.model_out(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(obs))
    logp_fn = (rjp.categorical_logp if hasattr(space, "n")
               else rjp.gaussian_logp)
    logp = np.asarray(logp_fn(pi_out, jnp.asarray(actions)))
    dones = rng.random(n) < 0.05
    return SampleBatch({
        SampleBatch.OBS: obs,
        SampleBatch.NEXT_OBS: rng.standard_normal((n, OBS_DIM)).astype(
            np.float32),
        SampleBatch.ACTIONS: actions,
        SampleBatch.REWARDS: rng.random(n).astype(np.float32),
        SampleBatch.DONES: dones,
        SampleBatch.EPS_ID: np.repeat(np.arange(num_envs), n // num_envs),
        SampleBatch.ACTION_LOGP: (logp + 0.2 * rng.standard_normal(n)
                                  ).astype(np.float32),
        SampleBatch.VF_PREDS: rng.standard_normal(n).astype(np.float32),
        SampleBatch.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.standard_normal(n).astype(
            np.float32),
    })


# -- the env -----------------------------------------------------------------

def _balance(obs, rng):
    return int(obs[2] + 0.5 * obs[3] > 0)


def _random(obs, rng):
    return int(rng.integers(2))


@pytest.mark.parametrize("rule", [_balance, _random],
                         ids=["balance", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cartpole_matches_gymnasium(seed, rule):
    import gymnasium

    ref, port = gymnasium.make("CartPole-v1"), make_env("CartPole-v1")
    assert isinstance(port, CartPoleEnv)  # the port's own, not gymnasium's
    rng = np.random.default_rng(seed)
    (want, _), (got, _) = ref.reset(seed=seed), port.reset(seed=seed)
    ends = set()
    for _ in range(600):
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
        action = rule(got, rng)
        want, *want_rest, _ = ref.step(action)
        got, *got_rest, _ = port.step(action)
        assert got.tobytes() == want.tobytes()
        assert got_rest == want_rest  # reward, terminated, truncated
        if got_rest[1] or got_rest[2]:
            ends.add("truncated" if got_rest[2] else "terminated")
            (want, _), (got, _) = ref.reset(), port.reset()
    assert ends == ({"truncated"} if rule is _balance else {"terminated"})


def test_make_env_without_gymnasium(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    assert isinstance(make_env("CartPole-v1"), CartPoleEnv)
    with pytest.raises(ValueError, match="MountainCar-v0"):
        make_env("MountainCar-v0")


def test_cuda_learner_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tppo.PPOPolicy(OBS_SPACE, SPACES["discrete"], {})
    with pytest.raises(RuntimeError, match="CUDA"):
        tppo.PPOTrainer(config={"env": "CartPole-v1"})


# -- returns and V-trace -----------------------------------------------------

def test_returns_exact():
    rng = np.random.default_rng(2)
    n = 300
    rewards = rng.random(n).astype(np.float32)
    dones = rng.random(n) < 0.05
    values = rng.standard_normal(n).astype(np.float32)
    args = (rewards.astype(np.float64), dones.astype(np.float64), 0.99, 0.7)
    np.testing.assert_array_equal(tpg.discounted_returns(*args),
                                  rpg.discounted_returns(*args))

    def batch():
        return SampleBatch({SampleBatch.REWARDS: rewards,
                            SampleBatch.VF_PREDS: values,
                            SampleBatch.DONES: dones})

    want = rppo.compute_gae(batch(), 0.3, 0.99, 0.95)
    got = tppo.compute_gae(batch(), 0.3, 0.99, 0.95)
    for k in (SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS):
        np.testing.assert_array_equal(got[k], want[k])


def test_vtrace_matches_jax():
    rng = np.random.default_rng(3)
    t, b = 50, 4
    args = {
        "behaviour_logp": np.log(rng.uniform(0.1, 1, (t, b))),
        "target_logp": np.log(rng.uniform(0.1, 1, (t, b))),
        "discounts": 0.99 * (rng.random((t, b)) > 0.05),
        "rewards": rng.random((t, b)),
        "values": rng.standard_normal((t, b)),
        "bootstrap_value": rng.standard_normal(b),
    }
    args = {k: v.astype(np.float32) for k, v in args.items()}
    want = rvtrace.vtrace_returns(**jax.tree.map(jnp.asarray, args),
                                  clip_rho=1.0, clip_pg_rho=1.2)
    got = tvtrace.vtrace_returns(**{k: torch.tensor(v)
                                    for k, v in args.items()},
                                 clip_rho=1.0, clip_pg_rho=1.2)
    assert not any(g.requires_grad for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=VTRACE_TOL)


# -- losses and gradients ----------------------------------------------------

ALGOS = {  # name: (reference policy, its loss, port policy, its loss, cfg)
    "pg": (rpg.PGPolicy, rpg.pg_loss, tpg.PGPolicy, tpg.pg_loss, {}),
    "ppo": (rppo.PPOPolicy, rppo.ppo_loss, tppo.PPOPolicy, tppo.ppo_loss,
            {"entropy_coeff": 0.01, "vf_clip_param": 0.5}),
    "a3c": (ra3c.A3CPolicy, ra3c.a3c_loss, ta3c.A3CPolicy, ta3c.a3c_loss,
            {}),
    "impala": (rimpala.ImpalaPolicy, rimpala.impala_loss,
               timpala.ImpalaPolicy, timpala.impala_loss,
               {**rimpala.IMPALA_CONFIG, "num_envs_per_worker": 4}),
}


def _policies(algo, space, **extra):
    rcls, _, tcls, _, cfg = ALGOS[algo]
    cfg = {**cfg, "fcnet_hiddens": HIDDENS, "seed": 0, **extra}
    return (rcls(OBS_SPACE, space, dict(cfg)),
            tcls(OBS_SPACE, space, {**cfg, **CPU}))


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_loss_and_grads_match_jax(algo, space):
    space = SPACES[space]
    _, rloss, _, tloss, _ = ALGOS[algo]
    rpol, tpol = _policies(algo, space)
    weights = _weights(_act_out(space))
    batch = _batch(space, weights)
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in rpol._NON_LOSS_COLUMNS}
    (want, want_m), want_g = jax.jit(
        lambda p, b: jax.value_and_grad(rloss, has_aux=True)(p, b, rpol))(
        jax.tree.map(jnp.asarray, weights), jb)
    params = params_from_jax(weights, "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    got, got_m = tloss(params, tpol._tensors(batch), tpol)
    got_g = torch.autograd.grad(got, leaves, materialize_grads=True)
    assert set(got_m) == set(want_m)
    for g, w in [(got, want)] + [(got_m[k], want_m[k]) for k in want_m]:
        assert abs(g.item() - float(w)) <= LOSS_TOL * abs(float(w)), (g, w)
    for i, (g, w) in enumerate(zip(got_g, tree_leaves(want_g))):
        assert _rel_l2(g.numpy(), w) <= LOSS_TOL, (i, _rel_l2(g.numpy(), w))


# -- Adam steps --------------------------------------------------------------

def test_learn_on_batch_matches_sgd_step():
    space = SPACES["discrete"]
    rpol, tpol = _policies("ppo", space)
    weights = _weights(_act_out(space))
    rpol.set_weights(weights)
    tpol.set_weights(weights)
    batch = _batch(space, weights)
    want_info = rpol.learn_on_batch(batch)
    got_info = tpol.learn_on_batch(batch)
    assert set(got_info) == set(want_info)
    for g, w in zip(tree_leaves(tpol.get_weights()),
                    tree_leaves(rpol.get_weights())):
        np.testing.assert_allclose(g, w, rtol=0, atol=ADAM_STEP_TOL)
    moved = _flat(tpol.get_weights()) - _flat(weights)
    assert np.abs(moved).max() > 100 * ADAM_STEP_TOL  # the step is real


def test_sgd_epochs_match():
    space = SPACES["discrete"]
    cfg = {"num_sgd_iter": 8, "sgd_minibatch_size": 256}
    rpol, tpol = _policies("ppo", space)
    weights = _weights(_act_out(space))
    rpol.set_weights(weights)
    tpol.set_weights(weights)
    batch = _batch(space, weights, n=1024)
    rppo._sgd_epochs(rpol, SampleBatch(batch), cfg,
                     np.random.RandomState(5))
    tppo._sgd_epochs(tpol, SampleBatch(batch), cfg,
                     np.random.RandomState(5))
    got, want = _flat(tpol.get_weights()), _flat(rpol.get_weights())
    assert _rel_l2(got, want) <= EPOCHS_TOL
    # the control: the epochs moved the weights far beyond the tolerance
    assert _rel_l2(_flat(weights), want) > 100 * EPOCHS_TOL


# -- actions -----------------------------------------------------------------

@pytest.mark.parametrize("space", sorted(SPACES))
def test_greedy_actions_and_values(space):
    space = SPACES[space]
    rpol, tpol = _policies("ppo", space)
    weights = _weights(_act_out(space))
    rpol.set_weights(weights)
    tpol.set_weights(weights)
    obs = np.random.default_rng(4).standard_normal((512, OBS_DIM)).astype(
        np.float32)
    want_a, want_x = rpol.compute_actions(obs, explore=False)
    got_a, got_x = tpol.compute_actions(obs, explore=False)
    if hasattr(space, "n"):
        np.testing.assert_array_equal(got_a, want_a)
    else:
        np.testing.assert_allclose(got_a, want_a, rtol=0, atol=VALUE_TOL)
    np.testing.assert_allclose(got_x[SampleBatch.VF_PREDS],
                               want_x[SampleBatch.VF_PREDS], rtol=0,
                               atol=VALUE_TOL)


@pytest.mark.parametrize("space", sorted(SPACES))
def test_exploring_draws_follow_the_distribution(space):
    space = SPACES[space]
    rpol, tpol = _policies("ppo", space)
    weights = _weights(_act_out(space))
    tpol.set_weights(weights)
    one = np.random.default_rng(6).standard_normal((1, OBS_DIM)).astype(
        np.float32)
    obs = np.repeat(one, 20000, axis=0)
    actions, extra = tpol.compute_actions(obs, explore=True)
    pi_out, _ = rjp.JAXPolicy.model_out(jax.tree.map(jnp.asarray, weights),
                                        jnp.asarray(obs))
    want_logp = rpol.logp_fn()(pi_out, jnp.asarray(actions))
    np.testing.assert_allclose(extra[SampleBatch.ACTION_LOGP],
                               np.asarray(want_logp), rtol=0,
                               atol=LOGP_TOL)
    if hasattr(space, "n"):
        probs = np.asarray(jax.nn.softmax(pi_out[0]))
        freq = np.bincount(actions, minlength=space.n) / len(actions)
        np.testing.assert_allclose(freq, probs, rtol=0, atol=FREQ_TOL)
    else:
        mean, log_std = np.split(np.asarray(pi_out[0]), 2)
        np.testing.assert_allclose(actions.mean(0), mean, rtol=0, atol=0.05)
        np.testing.assert_allclose(actions.std(0), np.exp(log_std),
                                   rtol=0.05)


# -- weights and determinism -------------------------------------------------

def test_reference_weights_load():
    space = SPACES["discrete"]
    rpol, tpol = _policies("ppo", space)
    weights = rpol.get_weights()  # the reference's own init
    tpol.set_weights(weights)
    got = tpol.get_weights()
    assert jax.tree.structure(got) == jax.tree.structure(weights)
    for g, w in zip(tree_leaves(got), tree_leaves(weights)):
        np.testing.assert_array_equal(g, w)
    obs = np.random.default_rng(7).standard_normal((64, OBS_DIM)).astype(
        np.float32)
    want, _ = rjp.JAXPolicy.model_out(rpol.params, jnp.asarray(obs))
    logits, _ = TorchPolicy.model_out(tpol.params, torch.tensor(obs))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=0, atol=VALUE_TOL)
    back = params_to_jax(params_from_jax(weights))
    for g, w in zip(tree_leaves(back), tree_leaves(weights)):
        np.testing.assert_array_equal(g, w)


def test_same_seed_same_rollout():
    import cloudpickle

    from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker

    def rollout():
        worker = RolloutWorker(
            "CartPole-v1",
            cloudpickle.dumps(lambda o, a, c: tppo.PPOPolicy(o, a, c)),
            {"rollout_fragment_length": 64, "seed": 0, **CPU})
        try:
            return worker.sample()
        finally:
            worker.stop()

    first, second = rollout(), rollout()
    assert len(first) == 64 and first[SampleBatch.OBS].shape == (64, 4)
    assert first[SampleBatch.ADVANTAGES].shape == (64,)
    assert np.all(first[SampleBatch.ACTION_LOGP] <= 0)
    for k in first:
        np.testing.assert_array_equal(first[k], second[k])


def test_get_weights_never_reads_half_a_step():
    space = SPACES["discrete"]
    _, tpol = _policies("ppo", space)
    batch = _batch(space, tpol.get_weights(), n=64)

    def digest(weights):
        return hashlib.sha256(_flat(weights).tobytes()).hexdigest()

    steps = [digest(tpol.get_weights())]
    reads, done = [], threading.Event()

    def learner():
        for _ in range(100):
            tpol.learn_on_batch(batch)
            steps.append(digest(tpol.get_weights()))
        done.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads inside optimizer.step
    try:
        thread = threading.Thread(target=learner, daemon=True)
        thread.start()
        while not done.is_set() and thread.is_alive():
            reads.append(digest(tpol.get_weights()))
        thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert done.is_set() and not thread.is_alive()
    assert len(set(steps)) == len(steps)  # every step moved the weights
    assert len(reads) > 100
    torn = [r for r in reads if r not in set(steps)]
    assert not torn, f"{len(torn)} of {len(reads)} reads mixed two steps"
