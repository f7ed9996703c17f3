"""Port check: ray_tpu_torch.models.transformer against
ray_tpu.models.transformer, and the port's Trainer against the JAX
TrainingOperator on it.

TINY (2 layers, 4 heads, d 64, vocab 256) at batch 2 x 32 tokens. Both
sides get one set of weights in the JAX params layout, made from a seed
with numpy (`_init`) and moved with `params_from_jax`, and the same numpy
tokens. The JAX side runs its
Pallas kernels as its own tests do on the CPU (interpret mode); the port
runs on the CPU, where its kernel wrappers take the plain versions. Every
result is computed once, in the module's fixtures.

Tolerances:
- float32 logits and loss: max |port − jax| / max |jax| ≤ 1e-5; the same
  f32 arithmetic summed in another order.
- float32 gradients, per leaf of the params tree: Σ|port − jax| / Σ|jax|
  ≤ 1e-4.
- bfloat16 logits: 3e-2 of max |jax|, and the loss 1e-2 relative. Both
  round every matmul and elementwise result to bf16, but XLA fuses the
  bias add, GELU and residual add and rounds once per fusion where torch
  rounds after each op (2^-8 relative each), and two blocks and the tied
  head carry those differences into the logits.
- remat on against off: identical gradients (the recompute repeats the
  same operations).
- three SGD steps (lr 0.1) through the port's `Trainer(device="cpu")` (its
  rank in a TrainWorker actor of a module-scoped `ray_tpu_torch.init`)
  against a JAX `TrainingOperator` with optax.sgd(0.1), float32: each
  loss 1e-4 relative and each parameter Σ|port − jax| / Σ|jax| ≤ 1e-4.
"""

import dataclasses
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtr
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.train import Trainer, TrainingOperator
from tests.test_torch_runtime import port_cluster

# the worker builds this module's operator class from its pickle: by
# value, so it never imports this module (and with it jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

B, T, STEPS = 2, 32, 3
JCFG = dataclasses.replace(jtr.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(ttr.TINY, dtype=torch.float32)
F32_TOL, GRAD_TOL, TRAIN_TOL = 1e-5, 1e-4, 1e-4
BF16_LOGITS_TOL, BF16_LOSS_TOL = 3e-2, 1e-2
LEAVES = (["wte", "wpe", "lnf_w", "lnf_b"]
          + [f"blocks.{k}" for k in ttr._BLOCK_KEYS])


class _Stream:
    """A loader that hands out the next batch each time it is iterated,
    so that train_epoch(num_steps=1) walks through the batches."""

    def __init__(self, batches):
        self.batches, self.pos = batches, 0

    def __iter__(self):
        while self.pos < len(self.batches):
            self.pos += 1
            yield self.batches[self.pos - 1]


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


def _grads_tree(model):
    """The gradients of `model` in the JAX params layout."""
    tree = {k: getattr(model, k).grad.numpy()
            for k in ("wte", "wpe", "lnf_w", "lnf_b")}
    tree["blocks"] = {k: np.stack([getattr(b, k).grad.numpy()
                                   for b in model.blocks])
                      for k in ttr._BLOCK_KEYS}
    return tree


class PortOp(TrainingOperator):
    def setup(self, config):
        self.register(
            model=ttr.params_from_jax(config["params"], TCFG),
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1),
            loss_fn=ttr.loss_fn,
            to_tree=lambda m: (ttr.params_to_jax(m), None),
            from_tree=lambda m, params, _: ttr.load_jax_params(m, params))
        self.register_data(train_loader=_Stream(config["batches"]))


def _jax_op_cls():
    import optax

    from ray_tpu.train.operator import TrainingOperator as JaxOperator

    # optax.sgd(0.1) behind a pass-through stage that keeps the gradient
    # it was handed in its state: the first step's state is jax.grad of
    # the loss at the initial weights, from the operator's own jitted step
    record = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))

    class Op(JaxOperator):
        def setup(self, config):
            self.register(
                model_init=lambda key: jax.tree.map(jnp.asarray,
                                                    config["params"]),
                loss_fn=lambda p, b: jtr.loss_fn(p, b, JCFG),
                optimizer=optax.chain(record, optax.sgd(0.1)))
            self.register_data(train_loader=_Stream(config["batches"]))

    return Op


def _init(cfg, rng):
    """Weights in the JAX params layout, drawn as `jtr.init` draws them
    but with numpy (layernorms at 1 and 0 plus noise, so that their
    gradients are not all alike)."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def norm_pair(shape):
        return 1 + normal(shape, 0.1), normal(shape, 0.1)

    blocks = {"wqkv": normal((n, d, 3 * d), d ** -0.5),
              "wo": normal((n, d, d), d ** -0.5),
              "w_in": normal((n, d, f), d ** -0.5),
              "b_in": normal((n, f), 0.02),
              "w_out": normal((n, f, d), f ** -0.5),
              "b_out": normal((n, d), 0.02)}
    blocks["ln1_w"], blocks["ln1_b"] = norm_pair((n, d))
    blocks["ln2_w"], blocks["ln2_b"] = norm_pair((n, d))
    lnf_w, lnf_b = norm_pair((d,))
    return {"wte": normal((cfg.vocab_size, d), 0.02),
            "wpe": normal((cfg.max_seq, d), 0.01), "blocks": blocks,
            "lnf_w": lnf_w, "lnf_b": lnf_b}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    params = _init(JCFG, rng)
    tokens = rng.integers(0, JCFG.vocab_size, (STEPS, B, T)).astype(np.int32)
    return params, tokens


@pytest.fixture(scope="module")
def jax_results(data):
    params, tokens = data
    tok = jnp.asarray(tokens[0])
    # logits in both dtypes in one jit; loss and gradients in f32 from the
    # operator's first step on the same tokens
    logits, logits16, loss16 = jax.jit(lambda p: (
        jtr.apply(p, tok, JCFG), jtr.apply(p, tok, jtr.TINY),
        jtr.loss_fn(p, tok, jtr.TINY)))(params)
    op = _jax_op_cls()({"params": params, "batches": list(tokens)}, 0, 1)
    losses = [op.train_epoch(num_steps=1)["last_train_loss"]]
    grads = jax.tree.map(np.array, op.opt_state[0])  # a copy: donated next
    losses += [op.train_epoch(num_steps=1)["last_train_loss"]
               for _ in range(STEPS - 1)]
    return {"loss": losses[0], "logits": np.asarray(logits), "grads": grads,
            "loss16": float(loss16), "logits16": np.asarray(logits16),
            "train_losses": losses, "trained": op.state_dict()["params"]}


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(num_cpus=4):
        yield


@pytest.fixture(scope="module")
def port_results(data, cluster):
    params, tokens = data
    tok = torch.from_numpy(tokens[0])
    out = {}
    for remat in (True, False):
        model = ttr.params_from_jax(
            params, dataclasses.replace(TCFG, remat=remat))
        logits = model(tok)
        loss = ttr.loss_fn(model, tok)
        loss.backward()
        out[remat] = {"loss": loss.item(), "logits": logits.detach().numpy(),
                      "grads": _grads_tree(model)}
    model16 = ttr.params_from_jax(params, ttr.TINY)
    with torch.no_grad():
        out["logits16"] = model16(tok).numpy()
        out["loss16"] = ttr.loss_fn(model16, tok).item()
    trainer = Trainer(PortOp, config={"params": params,
                                      "batches": list(tokens)},
                      device="cpu")
    try:
        out["train_losses"] = [trainer.train(num_steps=1)["last_train_loss"]
                               for _ in range(STEPS)]
        out["trained"] = trainer.state_dict()["params"]
    finally:
        trainer.shutdown()
    return out


def _rel_max(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l1(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def test_logits_match_jax_f32(jax_results, port_results):
    err = _rel_max(port_results[True]["logits"], jax_results["logits"])
    assert err <= F32_TOL, err


def test_loss_matches_jax_f32(jax_results, port_results):
    got, want = port_results[True]["loss"], jax_results["loss"]
    assert abs(got - want) <= F32_TOL * abs(want), (got, want)


def test_logits_match_jax_bf16(jax_results, port_results):
    err = _rel_max(port_results["logits16"], jax_results["logits16"])
    assert err <= BF16_LOGITS_TOL, err


def test_loss_matches_jax_bf16(jax_results, port_results):
    got, want = port_results["loss16"], jax_results["loss16"]
    assert abs(got - want) <= BF16_LOSS_TOL * abs(want), (got, want)


@pytest.mark.parametrize("leaf", LEAVES)
def test_grads_match_jax(jax_results, port_results, leaf):
    err = _rel_l1(_leaf(port_results[True]["grads"], leaf),
                  _leaf(jax_results["grads"], leaf))
    assert err <= GRAD_TOL, err


@pytest.mark.parametrize("leaf", LEAVES)
def test_remat_does_not_change_grads(port_results, leaf):
    on = _leaf(port_results[True]["grads"], leaf)
    off = _leaf(port_results[False]["grads"], leaf)
    assert np.array_equal(on, off)


def test_params_round_trip_bit_exact(data):
    params, _ = data
    back = ttr.params_to_jax(ttr.params_from_jax(params, TCFG))
    for leaf in LEAVES:
        assert _leaf(back, leaf).tobytes() == _leaf(params, leaf).tobytes()
    assert ttr.num_params(ttr.params_from_jax(params, TCFG)) == sum(
        x.size for x in jax.tree.leaves(params))


@pytest.mark.parametrize("step", range(STEPS))
def test_trainer_loss_matches_jax_operator(jax_results, port_results, step):
    got = port_results["train_losses"][step]
    want = jax_results["train_losses"][step]
    assert abs(got - want) <= TRAIN_TOL * abs(want), (got, want)


@pytest.mark.parametrize("leaf", LEAVES)
def test_trainer_weights_match_jax_operator(jax_results, port_results, leaf):
    err = _rel_l1(_leaf(port_results["trained"], leaf),
                  _leaf(jax_results["trained"], leaf))
    assert err <= TRAIN_TOL, err


def test_load_rejects_a_foreign_tree(data):
    params, _ = data
    bad = dict(params, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="keys"):
        ttr.params_from_jax(bad, TCFG)
    with pytest.raises(ValueError, match="ops_mode"):
        ttr.GPT(dataclasses.replace(TCFG, ops_mode="fast"))


def test_ops_mode_takes_the_given_forwards(data):
    """An Ops in ops_mode runs its own forwards, once per layernorm and
    attention of the model, under the same backwards."""
    params, tokens = data
    calls = {"layernorm": 0, "flash_attention": 0}

    def counted(name, fwd):
        def run(*args):
            calls[name] += 1
            return fwd(*args)
        return run

    ops = ttr.Ops(counted("layernorm", ttr.OPS["plain"].layernorm),
                  counted("flash_attention", ttr.OPS["plain"].flash_attention))
    cfg = dataclasses.replace(TCFG, remat=False)
    tok = torch.from_numpy(tokens[0])
    want = ttr.loss_fn(ttr.params_from_jax(params, cfg), tok)
    got = ttr.loss_fn(ttr.params_from_jax(
        params, dataclasses.replace(cfg, ops_mode=ops)), tok)
    assert torch.equal(got, want)
    assert calls == {"layernorm": 2 * cfg.n_layers + 1,
                     "flash_attention": cfg.n_layers}
