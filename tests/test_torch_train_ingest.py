"""Port check: the streamed ingest (train/ingest.py) and the training
metrics (train/metrics.py) on the CPU, held against the JAX package's
tests/test_train_sharded.py: losses fed by the stream equal the
in-memory losses (==, the dyadic recipe of tests/test_torch_train_elastic.py
makes the trajectory world-size- and layout-invariant); every worker
pulls through the stream; `hist_quantile` reads a snapshot as the
reference's does; killing an ingest actor and a worker leaves a working
gang with one ingest actor a rank. The trainers share one module-scoped
`ray_tpu_torch.init` cluster.
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.train import ingest as jingest
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import stats
from ray_tpu_torch.train import Trainer, TrainingOperator
from ray_tpu_torch.train import ingest as tingest
from ray_tpu_torch.train import metrics as tmetrics
from tests.test_torch_runtime import port_cluster

# the workers build this module's classes from their pickles: by value,
# so they never import this module (and with it jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

EPOCHS = 2
BATCHES = 4  # an epoch, of 8 rows


def _dyadic_batches():
    """tests/test_train_sharded.py's data, four batches of 8."""
    X = np.array([[((5 * i + 7 * j) % 16 - 8) / 4.0 for j in range(4)]
                  for i in range(32)], dtype=np.float32)
    y = X @ np.array([1.0, -2.0, 0.5, 0.25], dtype=np.float32)
    return [(X[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]


def _ingest_dataset_fn(shard_index, num_shards, config):
    """The batches DyadicOp registers in memory."""
    return _dyadic_batches()


class DyadicOp(TrainingOperator):
    """y = x @ w + b, SGD(0.125, momentum=0.5), its batches in memory."""

    def setup(self, config):
        model = torch.nn.Linear(4, 1)
        with torch.no_grad():
            model.weight.zero_()
            model.bias.zero_()
        self.register(
            model=model,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.125, momentum=0.5),
            loss_fn=lambda m, b: ((m(b[0])[:, 0] - b[1]) ** 2).mean(),
            to_tree=lambda m: ({"w": m.weight.detach().numpy().copy(),
                                "b": m.bias.detach().numpy().copy()}, None),
            from_tree=_load_tree)
        self.register_data(train_loader=_dyadic_batches())


def _load_tree(model, params, _state):
    with torch.no_grad():
        model.weight.copy_(torch.as_tensor(params["w"]))
        model.bias.copy_(torch.as_tensor(params["b"]))


@pytest.mark.parametrize("snap,q", [
    ({"count": 0, "counts": [], "boundaries": []}, 0.5),
    ({"count": 10, "counts": [8, 1, 1, 0], "boundaries": [1, 2, 3]}, 0.5),
    ({"count": 10, "counts": [8, 1, 1, 0], "boundaries": [1, 2, 3]}, 0.95),
    ({"count": 4, "counts": [0, 1, 1, 2], "boundaries": [1, 2, 3]}, 0.99),
    ({"count": 3, "counts": [3, 0], "boundaries": [0.5]}, 1.0)])
def test_hist_quantile_matches_reference(snap, q):
    assert tingest.hist_quantile(snap, q) == jingest.hist_quantile(snap, q)


def test_ingest_wait_histogram_reads_as_the_reference():
    """The port's train.ingest_wait_s, observed, read back through
    hist_quantile as the reference's readback reads it."""
    h = stats.Histogram("test.ingest_wait_probe", [0.001, 0.01, 0.1])
    for v in (0.0005, 0.0005, 0.005, 0.5):
        h.observe(v)
    snap = h.snapshot()
    assert [tingest.hist_quantile(snap, q) for q in (0.5, 0.75, 1.0)] == [
        jingest.hist_quantile(snap, q) for q in (0.5, 0.75, 1.0)] == [
        0.001, 0.01, float("inf")]
    assert tmetrics.INGEST_WAIT_S.boundaries == stats.LATENCY_BOUNDARIES_S
    assert stats.snapshot()["train.optim_shard_bytes"]["type"] == "gauge"


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(num_cpus=10):
        yield


@pytest.fixture(scope="module")
def trainers(cluster):
    def make(**kw):
        return Trainer(DyadicOp, num_workers=2, device="cpu",
                       collective_timeout=10.0, **kw)

    spec = tingest.IngestSpec(_ingest_dataset_fn)
    makers = {"control": lambda: make(),
              "stream": lambda: make(sharded=True, ingest=spec),
              "chaos": lambda: make(sharded=True, ingest=spec,
                                    max_retries=3)}
    with ThreadPoolExecutor(len(makers)) as pool:
        futures = {k: pool.submit(m) for k, m in makers.items()}
    built = {k: f.result() for k, f in futures.items()
             if f.exception() is None}
    try:
        for f in futures.values():
            if f.exception() is not None:
                raise f.exception()
        yield built
    finally:
        for tr in built.values():
            tr.shutdown(force=True)


def _metric(tr, name):
    return ray_tpu_torch.get([w.read_metric.remote(name) for w in tr.workers])


@pytest.fixture(scope="module")
def runs(trainers):
    """Every trainer's run, made here so that each test only reads them."""
    ctl, tr = trainers["control"], trainers["stream"]
    out = {"stream_actors": (len(tr._ingest_actors), len(tr._ingest_pids)),
           "ctl_losses": [ctl.train()["train_loss"] for _ in range(EPOCHS)],
           "losses": [tr.train()["train_loss"] for _ in range(EPOCHS)]}
    for name in ("train.ingest_wait_s", "train.step_s", "train.tokens_total",
                 "train.optim_shard_bytes"):
        out[name] = _metric(tr, name)
    out["ctl_opt_bytes"] = _metric(ctl, "train.optim_shard_bytes")
    span = tr._last_shards[0]["span"]
    out["span"] = span[1] - span[0]

    tr = trainers["chaos"]
    tr.train()
    gen = tr._generation
    ray_tpu_torch.kill(tr._ingest_actors[1])
    ray_tpu_torch.kill(tr.workers[0])
    try:
        first = tr.train()
    except (exc.ActorDiedError, exc.WorkerCrashedError, exc.TaskError,
            exc.GetTimeoutError):
        first = tr.train()
    out["chaos"] = {"first": first, "regang": tr._generation > gen,
                    "world": tr.num_workers,
                    "ingest_actors": len(tr._ingest_actors),
                    "next": tr.train()}
    return out


def test_stream_matches_in_memory(runs):
    """tests/test_train_sharded.py::test_ingest_stream_matches_in_memory:
    the stream-fed losses are the in-memory control's (the same bytes);
    every worker pulled at least 8 batches through its stream; the step
    metrics count every step and row."""
    assert runs["stream_actors"] == (2, 2)
    assert runs["losses"] == runs["ctl_losses"]
    waits = runs["train.ingest_wait_s"]
    assert all(s and s["count"] >= 8 for s in waits), waits
    assert [s["count"] for s in runs["train.step_s"]] == [
        EPOCHS * BATCHES] * 2
    assert [s["value"] for s in runs["train.tokens_total"]] == [
        EPOCHS * BATCHES * 8.0] * 2
    # SGD's momentum: the replicated state holds w and b (5 floats); each
    # ZeRO rank holds its span of the padded flat bucket
    assert [s["value"] for s in runs["ctl_opt_bytes"]] == [20.0] * 2
    assert [s["value"] for s in runs["train.optim_shard_bytes"]] == [
        4.0 * runs["span"]] * 2


def test_chaos_kill_worker_and_ingest_actor(runs):
    """tests/test_train_sharded.py::test_chaos_kill_worker_and_ingest_actor:
    the gang scan treats the dead DatasetShard like a dead worker; train()
    completes after an in-call re-gang (or raises a typed error once), and
    the re-ganged gang keeps one ingest actor a rank and keeps training."""
    chaos = runs["chaos"]
    assert "train_loss" in chaos["first"] and chaos["regang"]
    assert chaos["world"] >= 1
    assert chaos["ingest_actors"] == chaos["world"]
    assert "train_loss" in chaos["next"]
