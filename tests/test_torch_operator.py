"""Port check: ray_tpu_torch.train against ray_tpu.train.operator.

Three fused SGD-momentum steps (lr 0.1, momentum 0.9, as bench.py) of a
tiny bottleneck ResNet in float32: through the port's
`Trainer(device="cpu")` with bn_mode="kernel" (its rank in a TrainWorker
actor of a module-scoped `ray_tpu_torch.init` cluster), and through the JAX
`TrainingOperator`, instantiated directly as bench.py's `Op` (no runtime,
no JAX Trainer) with bn_mode="pallas" (the Pallas sums kernel in
interpret mode). Both start from the same weights in the JAX pytree
layout and see the same numpy batches, one new batch per step.

Tolerances, on Σ|port − jax| / Σ|jax|: 1e-4 for each loss, parameter and
running statistic after the steps (up to 6e-6 observed). Both sides are
float32; the convolutions sum in different orders (XLA's CPU
convolutions, oneDNN), about 1e-5 per gradient
(tests/test_torch_resnet.py), and three updates at lr 0.1 carry those
differences forward.
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import resnet as jres
from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.train import Trainer, TrainingOperator
from tests.test_torch_runtime import port_cluster

# the worker builds this module's operator classes from their pickles:
# by value, so it never imports this module (and with it jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STEPS = 3
BATCH = 4
HW = 32
TOL = 1e-4
EPOCH_KEYS = {"epoch", "batch_count", "num_samples", "train_loss",
              "last_train_loss", "samples_per_s"}
ARCH = dict(stage_sizes=(1, 1), bottleneck=True, width=8, num_classes=10)


class _Stream:
    """A loader that hands out the next batch each time it is iterated,
    so that train_epoch(num_steps=1) walks through the batches."""

    def __init__(self, batches):
        self.batches, self.pos = batches, 0

    def __iter__(self):
        while self.pos < len(self.batches):
            self.pos += 1
            yield self.batches[self.pos - 1]


def _data():
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((BATCH, HW, HW, 3)).astype(np.float32),
                rng.integers(0, 10, BATCH).astype(np.int32))
               for _ in range(STEPS + 1)]
    params, state = tres.params_to_jax(
        tres.ResNet(tres.ResNetConfig(dtype=torch.float32, **ARCH), seed=3))
    return params, state, batches


class PortOp(TrainingOperator):
    def setup(self, config):
        cfg = tres.ResNetConfig(dtype=torch.float32, bn_mode="kernel", **ARCH)
        self.register(
            model=tres.params_from_jax(config["params"], config["state"],
                                       cfg),
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
            loss_fn=lambda model, b: tres.loss_fn(model, b[0], b[1]),
            to_tree=tres.params_to_jax, from_tree=tres.load_jax_params)
        self.register_data(train_loader=_Stream(config["batches"]),
                           validation_loader=config.get("val"))


def _jax_op_cls():
    from ray_tpu.train.operator import TrainingOperator as JaxOperator

    class Op(JaxOperator):
        def setup(self, config):
            import optax

            cfg = jres.ResNetConfig(dtype=jnp.float32, bn_mode="pallas",
                                    **ARCH)
            self.register(
                model_init=lambda key: jax.tree.map(
                    jnp.asarray, (config["params"], config["state"])),
                loss_fn=lambda p, s, b: jres.loss_fn(p, s, b[0], b[1], cfg),
                optimizer=optax.sgd(0.1, momentum=0.9),
                stateful=True)
            self.register_data(train_loader=_Stream(config["batches"]))

    return Op


def _rel_l1(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(num_cpus=4):
        yield


def _on_worker(trainer, fn):
    """fn(operators) run in the trainer's worker process."""
    return ray_tpu_torch.get(trainer.workers[0].run.remote(fn))


@pytest.fixture(scope="module")
def runs(cluster):
    """The three steps of each package. The port's trainer goes on to the
    next batch after them, and its validation loader holds that batch
    twice; a second port trainer (the clone) has the next batch to train
    and to validate on. Both trainers' workers start (seconds of torch
    import each) while the JAX side runs."""
    params, state, batches = _data()
    config = {"params": params, "state": state, "batches": batches[:STEPS]}
    nxt = batches[STEPS]
    with ThreadPoolExecutor(2) as pool:
        made = [pool.submit(Trainer, PortOp, device="cpu", config={
                    **config, "batches": batches[:STEPS + 1],
                    "val": [nxt] * 2}),
                pool.submit(Trainer, PortOp, device="cpu", config={
                    **config, "batches": [nxt], "val": [nxt]})]
        jop = _jax_op_cls()(config, 0, 1)
        jax_epochs = [jop.train_epoch(num_steps=1) for _ in range(STEPS)]
        jop.register_data(validation_loader=[nxt])
        jax_val = jop.validate()
    trainer, clone = (f.result() for f in made)
    try:
        port_epochs = [trainer.train(num_steps=1) for _ in range(STEPS)]
        yield {"jax": {"epochs": jax_epochs, "state": jop.state_dict()},
               "port": {"epochs": port_epochs,
                        "state": trainer.state_dict()},
               "trainer": trainer, "clone": clone, "config": config,
               "next": nxt, "jax_val": jax_val}
    finally:
        trainer.shutdown()
        clone.shutdown()


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_trajectory_matches_jax(runs, step):
    got = runs["port"]["epochs"][step]["last_train_loss"]
    want = runs["jax"]["epochs"][step]["last_train_loss"]
    assert abs(got - want) <= TOL * abs(want), (got, want)


@pytest.mark.parametrize("tree", ["params", "model_state"])
def test_final_weights_match_jax(runs, tree):
    got = _leaves(runs["port"]["state"][tree])
    want = _leaves(runs["jax"]["state"][tree])
    assert got.keys() == want.keys()
    errs = {k: _rel_l1(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("step", range(STEPS))
def test_train_epoch_keys_and_counts_match_jax(runs, step):
    got, want = runs["port"]["epochs"][step], runs["jax"]["epochs"][step]
    assert set(got) == set(want) == EPOCH_KEYS
    for k in ("epoch", "batch_count", "num_samples"):
        assert got[k] == want[k], k
    assert got["samples_per_s"] > 0


def test_state_dict_round_trip_resumes_identically(runs):
    """A second trainer loaded from the first's state_dict takes the next
    step exactly as the first does."""
    state = runs["trainer"].state_dict()
    clone = runs["clone"]
    clone.load_state_dict(state)
    trainers = (runs["trainer"], clone)
    losses = [t.train(num_steps=1)["last_train_loss"] for t in trainers]
    assert losses[0] == losses[1]
    a, b = (_leaves(t.state_dict()["params"]) for t in trainers)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert clone.state_dict()["global_step"] == STEPS + 1


def test_validate_uses_running_stats_and_changes_nothing(runs):
    """validate() is the mean train-mode loss (batch statistics, as the
    JAX operator's default eval), computed without a gradient; parameters
    and running statistics stay as they were. The name is kept from when
    validate ran in eval mode on the running statistics: what it checks
    now is that validate uses batch statistics and leaves the running
    ones unchanged."""
    trainer = runs["trainer"]  # its validation loader: the next batch twice
    images, labels = (torch.from_numpy(a) for a in runs["next"])
    before = trainer.state_dict()
    out = trainer.validate()
    assert _on_worker(trainer, lambda ops: ops[0].model.training)
    after = trainer.state_dict()
    for tree in ("params", "model_state"):
        a, b = _leaves(before[tree]), _leaves(after[tree])
        assert all(np.array_equal(a[k], b[k]) for k in a), tree

    def loss_then_restore(ops):
        with torch.no_grad():
            loss = tres.loss_fn(ops[0].model, images, labels).item()
        tres.load_jax_params(ops[0].model, before["params"],
                             before["model_state"])
        return loss

    want = _on_worker(trainer, loss_then_restore)
    assert out["num_samples"] == 2 * BATCH
    assert out["val_loss"] == pytest.approx(want, rel=1e-6)


def test_validate_matches_jax_operator(runs):
    """Trainer.validate against the JAX operator's validate on the same
    batch after the same three steps (f32, rel 1e-4), and the running
    statistics unchanged by it."""
    trainer = runs["clone"]  # its validation loader: the next batch
    trainer.load_state_dict(runs["port"]["state"])  # after the three steps
    before = _leaves(trainer.state_dict()["model_state"])
    got, want = trainer.validate(), runs["jax_val"]
    assert got["num_samples"] == want["num_samples"] == BATCH
    assert abs(got["val_loss"] - want["val_loss"]) <= (
        TOL * abs(want["val_loss"])), (got, want)
    after = _leaves(trainer.state_dict()["model_state"])
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_validate_takes_eval_fn(cluster):
    """register(eval_fn=...) replaces the default metrics; each is
    averaged over the loader."""
    class Op(TrainingOperator):
        def setup(self, config):
            cfg = tres.ResNetConfig(dtype=torch.float32, **ARCH)
            self.register(
                model=tres.ResNet(cfg),
                optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1),
                loss_fn=lambda model, b: tres.loss_fn(model, b[0], b[1]),
                to_tree=tres.params_to_jax, from_tree=tres.load_jax_params,
                eval_fn=lambda model, b: {"top": b[1].max()})
            self.register_data(validation_loader=config["batches"])

    batches = _data()[2][:2]
    trainer = Trainer(Op, config={"batches": batches}, device="cpu")
    try:
        out = trainer.validate()
    finally:
        trainer.shutdown()
    assert out == {"top": float(np.mean([b[1].max() for b in batches])),
                   "num_samples": 2 * BATCH}


def test_trainer_without_cuda_raises_instead_of_using_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(PortOp, config={})


@pytest.mark.parametrize("kwargs,err,match", [
    ({"num_workers": 2, "collective_transport": "nccl"}, ValueError, "nccl"),
    ({"num_workers": 2, "collective_transport": "bogus"}, ValueError,
     "bogus"),
    ({"mesh_mode": "tensor"}, ValueError, "unknown mesh_mode")])
def test_trainer_unported_options_raise(kwargs, err, match):
    """A collective transport that is no tier of the reference, and a mesh
    mode the reference does not know, raise before any worker starts.
    Every tier of the reference is carried (num_workers > 1 and
    sharded=True too): tests/test_torch_collective_procs.py; so is
    mesh_mode="fsdp": tests/test_torch_train_mesh.py."""
    with pytest.raises(err, match=match):
        Trainer(PortOp, config={}, device="cpu", **kwargs)


def test_trainer_rejects_more_gpus_than_present(cluster, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="GPU"):
        Trainer(PortOp, config={}, device="cpu",
                resources_per_worker={"GPU": 1})
