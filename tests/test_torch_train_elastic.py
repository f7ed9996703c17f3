"""Port check: the Trainer's fault tolerance on the CPU, held against the
JAX package's: the optimizer-shard reshard math against
ray_tpu.train.sharding, then elastic resizes, the sharded checkpoint
manifest, a re-gang after a rank's death and the gang reservation through
the port's `Trainer(device="cpu")` (a worker process a rank, in one
module-scoped `ray_tpu_torch.init` cluster).

Bit-exactness, the recipe of the reference's tests/test_train_sharded.py:
every rank trains on the same dyadic data (values on the 1/4 grid) with
SGD(lr=0.125, momentum=0.5), so every rank's gradient is the same and
the averaged gradient is the rank's own ((g + g) / 2 == g). The loss and
parameter trajectory then does not depend on the world size, and one
uninterrupted replicated run at world 2 is the control for the sharded
resizes, the checkpoint loaded at world 1, and the run that re-gangs
after a death: losses compare with ==, parameters by their bytes.
"""

import os
import pickle
import signal
import sys
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.train import sharding as jshard
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.train import Trainer, TrainingOperator
from ray_tpu_torch.train import sharding as tshard
from ray_tpu_torch.util import placement_group_table
from tests.test_torch_runtime import port_cluster

# the worker builds this module's operator class from its pickle: by
# value, so it never imports this module (and with it jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

EPOCHS = 4
TIMEOUT_S = 10.0  # a rank's wait for a peer


def _dyadic_data(n=32, d=4):
    """tests/test_train_sharded.py's data: rows on the dyadic 1/4 grid."""
    X = np.array([[((5 * i + 7 * j) % 16 - 8) / 4.0 for j in range(d)]
                  for i in range(n)], dtype=np.float32)
    w_true = np.array([1.0, -2.0, 0.5, 0.25], dtype=np.float32)
    return X, X @ w_true


class DyadicOp(TrainingOperator):
    """y = x @ w + b regression on rank-identical dyadic data, four
    batches of 8 an epoch."""

    def setup(self, config):
        model = torch.nn.Linear(4, 1)
        with torch.no_grad():
            model.weight.zero_()
            model.bias.zero_()
        X, y = _dyadic_data()
        batches = [(X[i:i + 8], y[i:i + 8]) for i in range(0, len(X), 8)]
        self.boom = False
        self.register(
            model=model,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.125, momentum=0.5),
            loss_fn=lambda m, b: ((m(b[0])[:, 0] - b[1]) ** 2).mean(),
            to_tree=lambda m: ({"w": m.weight.detach().numpy().copy(),
                                "b": m.bias.detach().numpy().copy()}, None),
            from_tree=_load_tree)
        self.register_data(train_loader=batches)

    def train_epoch(self, num_steps=None):
        if self.boom:
            raise ValueError("boom from the operator")
        return super().train_epoch(num_steps)


def _load_tree(model, params, _state):
    with torch.no_grad():
        model.weight.copy_(torch.as_tensor(params["w"]))
        model.bias.copy_(torch.as_tensor(params["b"]))


def _params(trainer) -> bytes:
    params = trainer.state_dict()["params"]
    return params["w"].tobytes() + params["b"].tobytes()


# ---------------------------------------------------------------------------
# (a) the reshard math against the reference, on the same leaves
# ---------------------------------------------------------------------------

def _fake_shards(numel, world):
    """tests/test_train_sharded.py's shard set: one partitioned leaf of
    increasing values (zero in the pad region) and one replicated 0-d
    leaf; numpy for the reference, the same bytes as torch tensors for
    the port."""
    pad = jshard.padded_numel(numel, world)
    full = np.zeros(pad, np.float32)
    full[:numel] = np.arange(numel, dtype=np.float32)
    s = pad // world
    ref = [{"rank": r, "world_size": world, "span": (r * s, (r + 1) * s),
            "numel": numel, "pad_numel": pad,
            "leaves": [full[r * s:(r + 1) * s].copy(),
                       np.asarray(7.0, np.float32)]}
           for r in range(world)]
    port = [{**sh, "leaves": [torch.from_numpy(np.array(leaf))
                              for leaf in sh["leaves"]]} for sh in ref]
    return ref, port


def _same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("rank", "world_size", "span", "numel", "pad_numel"):
            assert g[k] == w[k], k
        assert len(g["leaves"]) == len(w["leaves"])
        for gl, wl in zip(g["leaves"], w["leaves"]):
            gl = gl.numpy()
            assert gl.dtype == wl.dtype and gl.shape == wl.shape
            assert gl.tobytes() == wl.tobytes()


@pytest.mark.parametrize("numel,old,new", [(1000, 3, 2), (70001, 2, 3),
                                           (65536, 4, 1), (1, 1, 4)])
def test_reshard_matches_reference(numel, old, new):
    ref, port = _fake_shards(numel, old)
    want = jshard.merge_opt_shards(ref)
    got = tshard.merge_opt_shards(port)
    assert [g.numpy().tobytes() for g in got] == [
        np.asarray(w).tobytes() for w in want]
    before = tshard.RESHARDS
    _same_shards(tshard.reshard_opt_shards(port, new),
                 jshard.reshard_opt_shards(ref, new))
    assert tshard.RESHARDS == before + 1


@pytest.mark.parametrize("pick", [[0, 2], []], ids=["missing_rank", "empty"])
def test_merge_rejects_bad_rank_set(pick):
    ref, port = _fake_shards(1000, 3)
    with pytest.raises(ValueError) as want:
        jshard.merge_opt_shards([ref[i] for i in pick])
    with pytest.raises(ValueError) as got:
        tshard.merge_opt_shards([port[i] for i in pick])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the trainers: one control, one elastic run, one checkpoint load
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    with port_cluster(num_cpus=8):
        yield


def _make(**kw):
    return Trainer(DyadicOp, device="cpu", collective_timeout=TIMEOUT_S,
                   **kw)


@pytest.fixture(scope="module")
def trainers(cluster):
    """Every trainer of this file, made at once from threads (each worker
    spends seconds importing torch); all shut down at the module's end."""
    makers = {"control": lambda: _make(num_workers=2),
              "elastic": lambda: _make(num_workers=2, sharded=True,
                                       max_retries=2),
              "loaded": lambda: _make(sharded=True),
              "replicated": lambda: _make()}
    with ThreadPoolExecutor(len(makers)) as pool:
        futures = {k: pool.submit(make) for k, make in makers.items()}
    built = {k: f.result() for k, f in futures.items()
             if f.exception() is None}
    try:
        for f in futures.values():
            if f.exception() is not None:
                raise f.exception()
        yield built
    finally:
        for trainer in built.values():
            trainer.shutdown(force=True)


@pytest.fixture(scope="module")
def control(trainers):
    """The uninterrupted replicated run at world 2: each epoch's loss and
    the parameters after it, and its one generation."""
    tr = trainers["control"]
    pg = tr._pg
    losses, params = [], []
    for _ in range(EPOCHS):
        losses.append(tr.train()["train_loss"])
        params.append(_params(tr))
    return {"losses": losses, "params": params,
            "generation": tr._generation, "pg": pg}


@pytest.fixture(scope="module")
def elastic(trainers, control, tmp_path_factory):
    """Sharded at world 2: epoch 1, save, resize to 1, epoch 2, resize
    to 2, epoch 3; a no-op resize; rank 1's process killed, epoch 4."""
    tr = trainers["elastic"]
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt")
    out = {"path": path, "losses": [tr.train()["train_loss"]]}
    tr.save(path)
    reshards = tshard.RESHARDS
    tr._num_workers = 1
    tr._resize_worker_group()
    out["world_after_shrink"] = tr.num_workers
    out["losses"].append(tr.train()["train_loss"])
    tr._num_workers = 2
    tr._resize_worker_group()
    out["world_after_grow"] = tr.num_workers
    out["losses"].append(tr.train()["train_loss"])
    out["reshards"] = tshard.RESHARDS - reshards
    out["params3"] = _params(tr)
    before = list(tr.workers), tr._generation
    tr._resize_worker_group()  # the gang is intact at full size
    out["noop_kept"] = (all(a is b for a, b in zip(before[0], tr.workers))
                        and tr._generation == before[1])
    out["generation_before_death"] = tr._generation
    os.kill(tr._pids[1], signal.SIGKILL)
    result = tr.train()
    out.update(epoch4=result, params4=_params(tr),
               generation_after_death=tr._generation,
               regangs=list(tr._regangs), world_after_death=tr.num_workers)
    return out


def test_resize_2_1_2_is_bit_identical_to_the_control(control, elastic):
    assert elastic["world_after_shrink"] == 1
    assert elastic["world_after_grow"] == 2
    assert elastic["losses"] == control["losses"][:3]
    assert elastic["params3"] == control["params"][2]
    assert elastic["reshards"] >= 2  # 2 -> 1 and 1 -> 2


def test_noop_resize_keeps_the_generation(elastic):
    assert elastic["noop_kept"]


def test_dead_rank_is_recovered_within_max_retries(control, elastic):
    """Rank 1's process SIGKILLed between epochs: train() kills the
    generation, starts the next at full size, restores the epoch-3 state
    and runs epoch 4 bit for bit as the control's."""
    assert elastic["generation_after_death"] == (
        elastic["generation_before_death"] + 1)
    assert elastic["world_after_death"] == 2
    assert [r["world_size"] for r in elastic["regangs"]] == [2]
    assert elastic["epoch4"]["epoch"] == 4
    assert elastic["epoch4"]["train_loss"] == control["losses"][3]
    assert elastic["params4"] == control["params"][3]


def test_control_needs_one_generation(control):
    assert control["generation"] == 1


def test_sharded_checkpoint_round_trip(control, elastic, trainers):
    """The manifest as the reference writes it; a 1-rank load reshards the
    two saved shards and continues bit for bit."""
    path = elastic["path"]
    for suffix in ("", ".params", ".shard0", ".shard1"):
        assert os.path.exists(path + suffix), suffix
    with open(path, "rb") as f:
        manifest = pickle.load(f)
    assert manifest["format"] == "ray_tpu.sharded_ckpt"
    assert manifest["world_size"] == 2
    assert manifest["spans"] == tshard.shard_spans(manifest["numel"], 2)
    assert manifest["spans"] == jshard.shard_spans(manifest["numel"], 2)
    assert (manifest["epoch"], manifest["params_file"],
            manifest["shard_files"]) == (1, "ckpt.params",
                                         ["ckpt.shard0", "ckpt.shard1"])
    loaded = trainers["loaded"]
    loaded.load(path)
    assert loaded.train()["train_loss"] == control["losses"][1]
    assert _params(loaded) == control["params"][1]


def test_replicated_load_of_a_manifest_raises(elastic, trainers):
    with pytest.raises(ValueError, match="sharded"):
        trainers["replicated"].load(elastic["path"])


def test_operator_error_with_every_rank_alive_is_raised(control, trainers):
    """An error of the operator on every rank, with the gang intact, is
    the user's: train() raises it at once, in the same generation."""
    tr = trainers["control"]

    def arm(ops):
        ops[0].boom = True

    ray_tpu_torch.get([w.run.remote(arm) for w in tr.workers])
    with pytest.raises(TaskError, match="boom from the operator"):
        tr.train()
    assert tr._generation == 1 and tr._regangs == []


def test_gang_reserved_as_pack_and_released(control, trainers):
    """The control's workers sit in its ICI_RING reservation, placed as
    PACK (no topology plan, every bundle on the one node); shutdown
    removes it."""
    pg = control["pg"]
    assert pg is not None
    rec = placement_group_table()[pg.id.hex()]
    assert (rec["state"], rec["strategy"], rec["topology_plan"]) == (
        "CREATED", "ICI_RING", None)
    assert len({b["node_id"] for b in rec["bundles"]}) == 1
    assert [b["resources"] for b in rec["bundles"]] == [{"CPU": 1.0}] * 2
    trainers.pop("replicated").shutdown()
    tr = trainers.pop("control")
    tr.shutdown()
    assert pg.id.hex() not in placement_group_table()
