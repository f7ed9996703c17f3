"""Port check: data-parallel and ZeRO training through the port's
`Trainer(num_workers=2)` on the CPU, held against the JAX package. Each
rank runs in a TrainWorker actor of its own (a process a rank), in a
module-scoped `ray_tpu_torch.init` cluster, and the ranks' collectives
cross processes (the HOST group's shm tier; the int8 trainer's DEVICE
tier over gloo); what a check reads of a rank (its weights, gradients,
steps, counters) comes from that rank's process.

A small GPT (2 layers, 4 heads, d 64, vocab 256, T 64, f32) on
`device="cpu"`, where the ring collectives take their plain versions.
Both packages get one set of weights in the JAX params layout and the
same numpy tokens; rank r trains on batch r.

Tolerances:
- ranks after 3 steps: bit-identical parameters (both ranks apply the
  same reduced gradient; a two-term ring sum is the same on every rank).
- one DP step (2 ranks x 2 sequences) against the JAX TrainingOperator's
  single-worker step on the combined batch of 4, from the same weights:
  the averaged gradient, per leaf, Σ|port − jax| / Σ|jax| ≤ 1e-4, as the
  single-worker transformer check (f32 in another summation order, and
  the mean over 4 sequences taken as a mean of two means).
- sharded=True against replicated at w = 2, AdamW, 3 steps: bit-identical
  parameters and losses (two-term sums commute, AdamW is elementwise).
- quantize="int8" (forced onto the DEVICE tier, whose int8 ring is the
  quantized wire on the CPU at w = 2): the saved-bytes counter grows by
  `_qring_saved_bytes` per rank and step, exactly, and the ranks stay
  bit-identical.
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import transformer as jtr
from ray_tpu.train import sharding as jshard
from ray_tpu_torch.collective.backends import device_backend as db
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.train import Trainer, TrainingOperator
from ray_tpu_torch.train import sharding as tshard
from tests.test_torch_runtime import port_cluster

# the worker builds this module's operator class (and runs its probes)
# from their pickles: by value, so it never imports this module or jax
cloudpickle.register_pickle_by_value(sys.modules[__name__])

B, T, STEPS, W = 2, 64, 3, 2
JCFG = dataclasses.replace(jtr.TINY, dtype=jnp.float32, max_seq=T)
TCFG = dataclasses.replace(ttr.TINY, dtype=torch.float32, max_seq=T,
                           remat=False)
GRAD_TOL = 1e-4
# the mismatched trainer's collective timeout: rendezvous and each op
MISMATCH_TIMEOUT_S = 5.0
LEAVES = (["wte", "wpe", "lnf_w", "lnf_b"]
          + [f"blocks.{k}" for k in ttr._BLOCK_KEYS])


class _Stream:
    """Hands out the next batch each time it is iterated."""

    def __init__(self, batches):
        self.batches, self.pos = batches, 0

    def __iter__(self):
        while self.pos < len(self.batches):
            self.pos += 1
            yield self.batches[self.pos - 1]


class DPOp(TrainingOperator):
    def setup(self, config):
        opt = config.get("opt", "sgd")
        self.register(
            model=ttr.params_from_jax(config["params"], TCFG),
            optimizer=(lambda ps: torch.optim.SGD(ps, lr=0.1)) if opt == "sgd"
            else (lambda ps: torch.optim.AdamW(ps, lr=1e-2,
                                               weight_decay=0.1)),
            loss_fn=ttr.loss_fn,
            to_tree=lambda m: (ttr.params_to_jax(m), None),
            from_tree=lambda m, params, _: ttr.load_jax_params(m, params))
        self.register_data(
            train_loader=_Stream(config["batches"][self.world_rank]))


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


def _rel_l1(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def _grads_tree(model):
    tree = {k: getattr(model, k).grad.numpy()
            for k in ("wte", "wpe", "lnf_w", "lnf_b")}
    tree["blocks"] = {k: np.stack([getattr(b, k).grad.numpy()
                                   for b in model.blocks])
                      for k in ttr._BLOCK_KEYS}
    return tree


def _params(named):
    """A rank's parameters, flat, from its named parameters."""
    return torch.cat([p.detach().reshape(-1) for p in named.values()])


def _named_params(ops):
    """Every rank's named parameters (run in the worker)."""
    return [{n: p.detach() for n, p in op.model.named_parameters()}
            for op in ops]


def _on_worker(trainer, fn):
    """fn(operators) run in every rank's worker process, whose operators
    are its rank's alone; the lists it returns, concatenated in rank
    order."""
    return [r for rs in ray_tpu_torch.get(
        [w.run.remote(fn) for w in trainer.workers]) for r in rs]


def _on_rank(trainer, rank, fn):
    """fn(operator) run in rank `rank`'s worker process."""
    return ray_tpu_torch.get(trainer.workers[rank].run.remote(
        lambda ops: fn(ops[0])))


def _raised_in_worker(cls, match):
    """An exception of type cls raised in the worker comes back as the
    runtime's TaskError naming it."""
    return pytest.raises(TaskError, match=rf"Task raised {cls.__name__}: "
                                          rf".*{match}")


@pytest.fixture(scope="module")
def cluster():
    # a CPU a rank's worker: room for every worker this file holds at once
    # (`built`'s fourteen and a restore test's four)
    with port_cluster(num_cpus=18):
        yield


@pytest.fixture(scope="module")
def data(cluster):
    params = ttr.params_to_jax(ttr.GPT(TCFG, seed=3))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TCFG.vocab_size, (W, STEPS, B, T),
                          dtype=np.int32)
    return params, tokens


def _trainer(data, epochs=1, **kwargs):
    """A W-rank trainer whose rank r trains on tokens[r], `epochs` times
    over."""
    params, tokens = data
    return Trainer(DPOp, num_workers=W, device="cpu", config={
        "params": params, "batches": [list(t) * epochs for t in tokens],
        "opt": kwargs.pop("opt", "sgd")}, **kwargs)


def _build(*makers):
    """Trainers made at once (each worker spends seconds importing
    torch); all are shut down if one fails."""
    with ThreadPoolExecutor(len(makers)) as pool:
        futures = [pool.submit(make) for make in makers]
    built = [f.result() for f in futures if f.exception() is None]
    for f in futures:
        if f.exception() is not None:
            for trainer in built:
                trainer.shutdown()
            raise f.exception()
    return built


def _steps(trainer, steps=STEPS):
    """The losses of `steps` steps and every rank's named parameters."""
    losses = [trainer.train(num_steps=1)["last_train_loss"]
              for _ in range(steps)]
    return losses, _on_worker(trainer, _named_params)


def _single(data, sharded):
    """A one-rank AdamW trainer on rank 0's tokens."""
    params, tokens = data
    return Trainer(DPOp, device="cpu", sharded=sharded, config={
        "params": params, "batches": [list(tokens[0])], "opt": "adamw"})


def _mismatched(data):
    """Rank 1 has one batch where rank 0 has three."""
    params, tokens = data
    return Trainer(DPOp, num_workers=W, device="cpu",
                   collective_timeout=MISMATCH_TIMEOUT_S, config={
                       "params": params,
                       "batches": [list(tokens[0]), list(tokens[1][:1])]})


@pytest.fixture(scope="module")
def built(data):
    """Every trainer of this file but the restore tests', made at once
    (each worker spends seconds importing torch). A test that is done
    with one shuts it down; the rest go at the module's end."""
    makers = {
        "sgd": lambda: _trainer(data),
        "sgd_sharded": lambda: _trainer(data, sharded=True),
        # loaders of two epochs: the checkpoint tests step past three
        "adamw": lambda: _trainer(data, epochs=2, opt="adamw"),
        "adamw_sharded": lambda: _trainer(data, epochs=2, opt="adamw",
                                          sharded=True),
        "int8": lambda: _trainer(data, quantize="int8",
                                 collective_transport="device"),
        "mismatched": lambda: _mismatched(data),
        "single": lambda: _single(data, False),
        "single_sharded": lambda: _single(data, True)}
    trainers = dict(zip(makers, _build(*makers.values())))
    try:
        yield trainers
    finally:
        for trainer in trainers.values():
            trainer.shutdown()


@pytest.fixture(scope="module")
def sgd_runs(built):
    """Three SGD steps, replicated and sharded: every rank's gradients
    after the replicated first step, and each run's losses and named
    parameters after the third."""
    replicated, sharded = built["sgd"], built["sgd_sharded"]
    try:
        losses = [replicated.train(num_steps=1)["last_train_loss"]]
        grads = _on_worker(replicated, lambda ops: [_grads_tree(op.model)
                                                     for op in ops])
        losses += [replicated.train(num_steps=1)["last_train_loss"]
                   for _ in range(STEPS - 1)]
        return {"replicated": (losses, _on_worker(replicated,
                                                   _named_params)),
                "sharded": _steps(sharded), "grads": grads,
                "pids": {t: list(t._pids) for t in (replicated, sharded)}}
    finally:
        replicated.shutdown()
        sharded.shutdown()


@pytest.fixture(scope="module")
def adamw_runs(built):
    """Three AdamW steps, replicated and sharded, with the trainers kept
    for the checkpoint tests."""
    trainers = {False: built["adamw"], True: built["adamw_sharded"]}
    return {"replicated": _steps(trainers[False]),
            "sharded": _steps(trainers[True]), "trainers": trainers}


@pytest.fixture(scope="module")
def replicated(sgd_runs):
    return sgd_runs["replicated"], sgd_runs["pids"]


@pytest.fixture(scope="module")
def jax_grads(data):
    import optax

    from ray_tpu.train.operator import TrainingOperator as JaxOperator

    params, tokens = data
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))

    class Op(JaxOperator):
        def setup(self, config):
            self.register(
                model_init=lambda key: jax.tree.map(jnp.asarray, params),
                loss_fn=lambda p, b: jtr.loss_fn(p, b, JCFG),
                optimizer=optax.chain(record, optax.sgd(0.1)))
            self.register_data(train_loader=[
                np.concatenate([tokens[0, 0], tokens[1, 0]])])

    with pytest.MonkeyPatch.context() as mp:
        # one step: the AOT compile cache would only add its export
        mp.setenv("RAY_TPU_COMPILE_CACHE", "0")
        op = Op({}, 0, 1)
        op.train_epoch(num_steps=1)
    return jax.tree.map(np.array, op.opt_state[0])


@pytest.fixture(scope="module")
def one_dp_step(sgd_runs):
    return sgd_runs["grads"]


def test_ranks_stay_bit_identical(replicated):
    """Each rank in a worker process of its own, and the driver in none."""
    (losses, (m0, m1)), pids = replicated
    for trainer_pids in pids.values():
        assert len(set(trainer_pids)) == W
        assert os.getpid() not in trainer_pids
    assert len(losses) == STEPS and all(np.isfinite(losses))
    assert m0.keys() == m1.keys()
    for n in m0:
        assert torch.equal(m0[n], m1[n]), n


@pytest.mark.parametrize("leaf", LEAVES)
def test_dp_step_matches_jax_operator_at_combined_batch(one_dp_step,
                                                        jax_grads, leaf):
    err = _rel_l1(_leaf(one_dp_step[0], leaf), _leaf(jax_grads, leaf))
    assert err <= GRAD_TOL, err
    assert np.array_equal(_leaf(one_dp_step[0], leaf),
                          _leaf(one_dp_step[1], leaf))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_sharded_bit_identical_to_replicated(request, opt):
    runs = request.getfixturevalue(f"{opt}_runs")
    want_losses, want = runs["replicated"]
    got_losses, got = runs["sharded"]
    assert got_losses == want_losses
    for r in range(W):
        assert torch.equal(_params(got[r]), _params(want[r])), r


def test_sharded_single_worker_matches_replicated(built):
    """sharded=True stays on at world size 1 (no collective: the padded
    bucket is the rank's span), with the same update as the fused
    single-worker step."""
    out = []
    for trainer in (built["single"], built["single_sharded"]):
        try:
            trainer.train(num_steps=2)
            out.append(_params(_on_worker(trainer, _named_params)[0]))
        finally:
            trainer.shutdown()
    assert torch.equal(out[0], out[1])


def _counter(trainer, name):
    """A counter summed over the ranks' workers (read_counter: each
    rank's process counts its own)."""
    return sum(ray_tpu_torch.get([w.read_counter.remote(name)
                                  for w in trainer.workers]))


def test_int8_counts_saved_bytes(built):
    """The counters are the workers': read through read_counter. Every
    op of the two steps went over the DEVICE tier."""
    numel = ttr.num_params(ttr.GPT(TCFG))
    trainer = built["int8"]
    name = "collective.quantized_bytes_saved_total"
    before = _counter(trainer, name)
    device_before = _counter(trainer, "collective.device_ops_total")
    losses = [trainer.train(num_steps=1)["last_train_loss"]
              for _ in range(2)]
    after = _counter(trainer, name)
    assert (_counter(trainer, "collective.device_ops_total")
            - device_before) == 2 * W
    m0, m1 = _on_worker(trainer, _named_params)
    per_call = db._qring_saved_bytes(db._qring_pad(numel, W), W,
                                     torch.float32, "sum")
    assert per_call > 0
    assert after - before == 2 * W * per_call
    assert all(np.isfinite(losses))
    assert torch.equal(_params(m0), _params(m1))


@pytest.mark.parametrize("numel,world", [(1, 1), (1000, 2), (124402944, 2),
                                         (70001, 3), (65536, 4)])
def test_sharding_matches_reference(numel, world):
    assert tshard.padded_numel(numel, world) == jshard.padded_numel(numel,
                                                                    world)
    assert tshard.shard_spans(numel, world) == jshard.shard_spans(numel,
                                                                  world)
    for r in range(world):
        assert tshard.shard_span(numel, world, r) == jshard.shard_span(
            numel, world, r)


def test_opt_nbytes_matches_reference():
    """AdamW's state over a shard holds what optax.adam's does: two moments
    of the shard and one 4-byte step count."""
    import optax

    s = 4096
    shard = torch.zeros(s, requires_grad=True)
    opt = torch.optim.AdamW([shard])
    shard.grad = torch.ones(s)
    opt.step()
    want = jshard.opt_nbytes(optax.adam(1e-3).init(jnp.zeros(s)))
    assert tshard.opt_nbytes(opt.state_dict()) == want


def test_trainer_rejects_mismatched_step_counts(built):
    """Rank 0's second step waits for rank 1, which has no second batch:
    its collective times out naming rank 1 (ranks in processes of their
    own cannot know a peer's step count otherwise)."""
    with _raised_in_worker(TimeoutError, r"\[1\]"):
        built["mismatched"].train(num_steps=2)


# ---------------------------------------------------------------------------
# sharded checkpoints: the restore (C1) and the reference's format (C2)
# ---------------------------------------------------------------------------

def _sharded_trainer(data, world, opt, first=0):
    """A sharded trainer whose ranks train on batches first, first+1, ..."""
    params, tokens = data
    return Trainer(DPOp, num_workers=world, device="cpu", sharded=True,
                   config={"params": params, "opt": opt,
                           "batches": [list(t[first:]) for t in tokens]})


@pytest.mark.parametrize("world,opt", [(1, "adamw"), (2, "sgd")])
def test_sharded_restore_then_step_equals_fresh_first_step(data, world,
                                                           opt):
    """Two steps, load the initial state, one step (on batch 2): every
    rank's parameters equal a fresh trainer's after its first step on
    batch 2, bit for bit. Plain SGD at world 2 holds no optimizer state,
    so no rank keeps any from the two steps (the state's opt_shard is
    rank 0's and installs on rank 0 alone)."""
    trainer, fresh = _build(
        lambda: _sharded_trainer(data, world, opt),
        lambda: _sharded_trainer(data, world, opt, first=2))
    try:
        initial = trainer.state_dict()
        trainer.train(num_steps=2)
        trainer.load_state_dict(initial)
        trainer.train(num_steps=1)
        fresh.train(num_steps=1)
        got, want = (_on_worker(t, _named_params) for t in (trainer, fresh))
        steps = _on_worker(trainer, lambda ops: [op.global_step
                                                 for op in ops])
        for r in range(world):
            assert torch.equal(_params(got[r]), _params(want[r])), r
            assert steps[r] == 1
    finally:
        trainer.shutdown()
        fresh.shutdown()


@pytest.fixture(scope="module")
def jax_sharded(data):
    """The JAX operator's opt_shard_state of each rank at world W, and
    its two refusals' messages (no step runs, so nothing compiles)."""
    import optax

    from ray_tpu.train.operator import TrainingOperator as JaxOperator

    params, _ = data

    class Op(JaxOperator):
        def setup(self, config):
            self.register(
                model_init=lambda key: jax.tree.map(jnp.asarray, params),
                loss_fn=lambda p, b: jtr.loss_fn(p, b, JCFG),
                optimizer=optax.sgd(0.1))

    shards = [Op({"sharded_update": True}, r, W).opt_shard_state()
              for r in range(W)]
    state = {"params": params, "model_state": None, "epoch": 0,
             "global_step": 0}
    messages = {}
    for sharded, extra in ((True, {"opt_state": ()}),
                           (False, {"sharded_update": True})):
        op = Op({"sharded_update": sharded}, 0, 1 if not sharded else W)
        with pytest.raises(ValueError) as err:
            op.load_state_dict({**state, **extra})
        messages[sharded] = str(err.value)
    return shards, messages


def test_sharded_state_dict_carries_the_reference_format(adamw_runs,
                                                        jax_sharded):
    """Each rank's state_dict after its AdamW steps."""
    shards, _ = jax_sharded
    trainer = adamw_runs["trainers"][True]
    states = _on_worker(trainer, lambda ops: [op.state_dict() for op in ops])
    for r in range(W):
        state = states[r]
        assert state["sharded_update"] is True and "opt_state" not in state
        got, want = state["opt_shard"], shards[r]
        assert got.keys() == want.keys()
        for k in ("rank", "world_size", "span", "numel", "pad_numel"):
            assert got[k] == want[k], k
        span = want["span"][1] - want["span"][0]
        # AdamW: exp_avg, exp_avg_sq (the rank's span each), step
        assert [tuple(t.shape) for t in got["leaves"]] == [
            (span,), (span,), ()]
        assert all(t.device.type == "cpu" for t in got["leaves"])


@pytest.mark.parametrize("sharded", [True, False])
def test_cross_loads_raise_the_reference_errors(adamw_runs, jax_sharded,
                                                sharded):
    """A replicated checkpoint into a sharded trainer, and the reverse
    (the refusal comes before anything of the trainer changes)."""
    _, messages = jax_sharded
    trainers = adamw_runs["trainers"]
    src, dst = trainers[not sharded], trainers[sharded]
    with _raised_in_worker(ValueError, "") as err:
        dst.load_state_dict(src.state_dict())
    assert err.value.cause_repr == repr(ValueError(messages[sharded]))


def test_opt_shard_round_trip_and_geometry_mismatch(adamw_runs):
    """On the sharded AdamW trainer, past its three steps (its loaders
    hold two epochs)."""
    trainer = adamw_runs["trainers"][True]
    trainer.train(num_steps=1)
    shard = _on_rank(trainer, 0, lambda op: op.opt_shard_state())
    with _raised_in_worker(ValueError, "does not match rank 1"):
        _on_rank(trainer, 1, lambda op: op.load_opt_shard(shard))
    with _raised_in_worker(ValueError, "does not match rank 0"):
        _on_rank(trainer, 0, lambda op: op.load_opt_shard(
            {**shard, "world_size": 3}))
    trainer.train(num_steps=1)  # moves rank 0's state on

    def reload(op):
        op.load_opt_shard(shard)
        return op.opt_shard_state()["leaves"]

    for a, b in zip(_on_rank(trainer, 0, reload), shard["leaves"]):
        assert torch.equal(a, b)
