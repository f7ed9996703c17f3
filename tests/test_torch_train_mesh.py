"""Port check: the Trainer's mesh modes on the CPU, held against the JAX
package: the (data, fsdp) table, MeshSpec.auto and fsdp_param_specs
against ray_tpu's; the trainer's mode checks; the multihost runtime over
gloo (a worker process a rank, in one module-scoped `ray_tpu_torch.init`
cluster) training the reference's MultiHostOp on a mesh of the ranks,
through a killed rank too; mesh_mode="fsdp"; a small GPT whose
parameters are sharded over an explicit (1, 2) ('data','fsdp') mesh
against the same GPT on the (2, 1) mesh of mesh_mode="fsdp", where they
are replicated; and the collective ops of a multihost runtime
(`ProcessMeshGroup`) and shift_right, against the reference's values.

The port runs one device a process, so its mesh is over ranks: where the
reference's MultiHostOp builds MeshSpec.auto(devices, tp=2) over 8 CPU
devices a process (dp = devices / 2 across the processes), the port's
builds MeshSpec.auto(ranks), dp over the ranks; each rank feeds its half
of the global batch either way.

Tolerances:
- MultiHostOp: full-batch gradient descent in numpy, and the JAX
  operator's single-process step on the whole batch, within rtol 1e-4,
  atol 1e-5 after 10 steps (the reference's bar); after a killed rank
  and a re-gang, 2 x 4 steps within rtol 1e-3, atol 1e-4 (the
  reference's).
- The GPT (2 layers, d 64, f32, AdamW): the sharded run's parameters
  after 3 steps equal the replicated run's to 1e-6 relative L2 (gloo's
  sum of the two ranks' gradients is one addition in either layout, so
  the two differ only where a reduce-scatter and an allreduce round
  differently).
- Collectives: exact (small integers in float32).
"""

import dataclasses
import re
import sys
import types
import uuid
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch
from ray_tpu._private import topology as jtopo
from ray_tpu.collective.backends.xla_backend import XlaGroup
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import TrainingOperator as JaxOperator
from ray_tpu.train import Trainer as JaxTrainer
from ray_tpu_torch import collective as col
from ray_tpu_torch._private import topology as ttopo
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import multihost
from ray_tpu_torch.train import Trainer, TrainingOperator
from tests.test_torch_runtime import port_cluster

# the workers build this module's classes from their pickles: by value,
# so they never import this module (and with it jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

_D, _B = 8, 16  # tests/test_multihost.py: 16 global rows, 8 a rank
LR = 0.05
GPT_STEPS, GPT_ROWS, GPT_T = 3, 2, 32  # rows a rank
GPT_TOL = 1e-6


def _global_data():
    rng = np.random.RandomState(0)
    x = rng.randn(_B, _D).astype(np.float32)
    w_true = rng.randn(_D).astype(np.float32)
    return x, x @ w_true


def _full_batch_gd(steps):
    x, y = _global_data()
    w = np.zeros(_D, np.float32)
    for _ in range(steps):
        w = w - LR * (2.0 * x.T @ (x @ w - y) / _B)
    return w


class _Repeat:
    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def __iter__(self):
        for _ in range(self.n):
            yield self.batch


def _load_w(model, params, _state):
    with torch.no_grad():
        model.weight.copy_(torch.as_tensor(params["w"])[None])


class MultiHostOp(TrainingOperator):
    """tests/test_multihost.py's MultiHostOp: y = x @ w on a mesh of every
    rank, each rank feeding its half of the global batch, SGD(0.05)."""

    def setup(self, config):
        import torch.distributed as dist

        assert dist.get_world_size() == self.world_size
        mesh = tmesh.MeshSpec.auto(dist.get_world_size()).build("cpu")
        model = torch.nn.Linear(_D, 1, bias=False)
        with torch.no_grad():
            model.weight.zero_()
        self.register(
            model=model, optimizer=lambda ps: torch.optim.SGD(ps, lr=LR),
            loss_fn=lambda m, b: ((m(b[0])[:, 0] - b[1]) ** 2).mean(),
            to_tree=lambda m: ({"w": m.weight.detach()[0].numpy().copy()},
                               None),
            from_tree=_load_w, mesh=mesh, batch_spec=tmesh.P("dp"))
        x, y = _global_data()
        half = _B // self.world_size
        lo = self.world_rank * half
        self.register_data(train_loader=_Repeat(
            (x[lo:lo + half], y[lo:lo + half]), 32))


def _dyadic_data(n=32, d=4):
    X = np.array([[((5 * i + 7 * j) % 16 - 8) / 4.0 for j in range(d)]
                  for i in range(n)], dtype=np.float32)
    return X, X @ np.array([1.0, -2.0, 0.5, 0.25], dtype=np.float32)


class DyadicOp(TrainingOperator):
    """tests/test_train_sharded.py's DyadicOperator: y = x @ w + b."""

    def setup(self, config):
        model = torch.nn.Linear(4, 1)
        with torch.no_grad():
            model.weight.zero_()
            model.bias.zero_()
        X, y = _dyadic_data()
        self.register(
            model=model,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.125, momentum=0.5),
            loss_fn=lambda m, b: ((m(b[0])[:, 0] - b[1]) ** 2).mean(),
            to_tree=lambda m: ({"w": m.weight.detach().numpy().copy(),
                                "b": m.bias.detach().numpy().copy()}, None),
            from_tree=lambda m, p, s: None)
        self.register_data(train_loader=[(X[i:i + 8], y[i:i + 8])
                                         for i in range(0, len(X), 8)])


def _gpt_tokens(rank):
    gen = torch.Generator().manual_seed(100 + rank)
    return torch.randint(0, 256, (GPT_ROWS, GPT_T), generator=gen)


class TinyGPTOp(TrainingOperator):
    """A 2-layer GPT (d 64, f32, the plain ops) under AdamW, each rank
    feeding its own rows. config["explicit"]: parameters sharded over an
    explicit (1, w) ('data','fsdp') mesh, the batch over both axes; else
    the mesh of mesh_mode="fsdp"."""

    def setup(self, config):
        from torch.distributed.device_mesh import DeviceMesh

        from ray_tpu_torch.models import transformer

        cfg = dataclasses.replace(transformer.TINY, dtype=torch.float32,
                                  ops_mode="plain", max_seq=GPT_T)
        model = transformer.GPT(cfg, seed=0)
        kw = {}
        if config.get("explicit"):
            mesh = DeviceMesh("cpu", torch.arange(self.world_size).reshape(
                1, self.world_size), mesh_dim_names=("data", "fsdp"))
            kw = dict(mesh=mesh, param_spec=tmesh.fsdp_param_specs(
                dict(model.named_parameters()), mesh),
                batch_spec=tmesh.P(("data", "fsdp")))
        self.register(
            model=model,
            optimizer=lambda ps: torch.optim.AdamW(ps, lr=1e-3),
            loss_fn=transformer.loss_fn,
            to_tree=lambda m: (transformer.params_to_jax(m), None),
            from_tree=lambda m, p, _: transformer.load_jax_params(m, p),
            **kw)
        self.register_data(train_loader=_Repeat(_gpt_tokens(self.world_rank),
                                                GPT_STEPS))


# ---------------------------------------------------------------------------
# tables and specs against the reference (no cluster)
# ---------------------------------------------------------------------------

def test_mesh_shape_for_matches_reference():
    assert ttopo.MESH_SHAPES == jtopo.MESH_SHAPES
    assert tmesh.mesh_shape_for is ttopo.mesh_shape_for
    for n in range(1, 1025):
        assert ttopo.mesh_shape_for(n) == jtopo.mesh_shape_for(n), n
    with pytest.raises(ValueError) as want:
        jtopo.mesh_shape_for(0)
    with pytest.raises(ValueError) as got:
        ttopo.mesh_shape_for(0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fsdp", [4, 2, 1])
def test_fsdp_param_specs_match_jax(fsdp):
    """tests/test_train_sharded.py::test_fsdp_param_spec_rules's cases, and
    the same shapes as torch tensors."""
    mesh = types.SimpleNamespace(shape={"fsdp": fsdp})
    params = {"w": np.zeros((8, 3)), "v": np.zeros((4,)),
              "odd": np.zeros((3, 5)), "s": np.zeros(()),
              "nest": [np.zeros((2, 2)), (np.zeros((12,)),)]}
    want = jmesh.fsdp_param_specs(params, mesh)
    got = tmesh.fsdp_param_specs(params, mesh)
    as_torch = tmesh.fsdp_param_specs(
        {"w": torch.zeros(8, 3), "v": torch.zeros(4),
         "odd": torch.zeros(3, 5), "s": torch.zeros(()),
         "nest": [torch.zeros(2, 2), (torch.zeros(12),)]}, mesh)
    flat = lambda t: [t["w"], t["v"], t["odd"], t["s"], t["nest"][0],
                      t["nest"][1][0]]
    for g, t, w in zip(flat(got), flat(as_torch), flat(want)):
        assert isinstance(g, tmesh.PartitionSpec)
        assert tuple(g) == tuple(t) == tuple(w)
    if fsdp == 4:
        assert got["w"] == tmesh.P("fsdp", None) and got["odd"] == tmesh.P()


@pytest.mark.parametrize("n,axes", [
    (8, {"tp": 2}), (8, {"tp": 2, "pp": 2}), (16, {"tp": 2, "sp": 2,
                                                   "ep": 2}),
    (1, {}), (6, {"tp": 4}), (12, {"pp": 5})])
def test_mesh_spec_auto_matches_jax(n, axes):
    try:
        want = jmesh.MeshSpec.auto(n, **axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec.auto(n, **axes)
        assert str(got.value) == str(e)
        return
    got = tmesh.MeshSpec.auto(n, **axes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.size, got.axis_sizes()) == (want.size, want.axis_sizes())
    assert tmesh.AXES == jmesh.AXES
    bundles = [{"GPU": 2}] * (n // 2) if n % 2 == 0 else [{"GPU": 1}] * n
    assert tmesh.MeshSpec.from_placement_group(bundles, **axes) == got


def test_from_placement_group_needs_gpus():
    with pytest.raises(ValueError, match="without GPUs"):
        tmesh.MeshSpec.from_placement_group([{"CPU": 1}])
    with pytest.raises(ValueError, match="heterogeneous"):
        tmesh.MeshSpec.from_placement_group([{"GPU": 1}, {"GPU": 2}])


@pytest.mark.parametrize("kwargs,err", [
    (dict(num_workers=1, sharded=True, mesh_mode="fsdp"),
     "mutually exclusive"),
    (dict(num_workers=1, mesh_mode="tensor"), "unknown mesh_mode"),
    (dict(num_workers=2, mesh_mode="fsdp"), "multihost"),
    (dict(num_workers=2, sharded=True, config={"multihost": True}),
     "HOST collective")])
def test_trainer_mode_validation(kwargs, err):
    """tests/test_train_sharded.py::test_trainer_mode_validation: each
    raises, in the reference and in the port, with the same words."""
    with pytest.raises(ValueError, match=err):
        JaxTrainer(DyadicOp, **kwargs)
    with pytest.raises(ValueError, match=err):
        Trainer(DyadicOp, device="cpu", **kwargs)


@pytest.mark.parametrize("cards,shared", [
    (["GPU-a", "GPU-b"], []), (["GPU-a", "GPU-b", "GPU-a"], [0, 2])])
def test_ranks_on_one_card_refuse_nccl(monkeypatch, cards, shared):
    """A multihost runtime whose ranks share a card raises on every rank
    (NCCL refuses them; no other tier stands in); cards of their own pass.
    The group's store and the ranks' cards are stood in for."""
    kv = {f"card/{r}": c.encode() for r, c in enumerate(cards)}
    store = types.SimpleNamespace(
        set=lambda k, v: kv.__setitem__(k, v.encode()), get=kv.__getitem__)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for rank, card in enumerate(cards):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda d, c=card: types.SimpleNamespace(uuid=c))
        if shared:
            with pytest.raises(RuntimeError, match=re.escape(
                    f"ranks {shared} share a card; NCCL refuses")):
                multihost._check_own_cards(store, len(cards), rank, "g")
        else:
            multihost._check_own_cards(store, len(cards), rank, "g")


# ---------------------------------------------------------------------------
# the JAX side, once
# ---------------------------------------------------------------------------

class _JaxWholeBatchOp(JaxOperator):
    """The reference's MultiHostOp model, one process on the whole batch."""

    def setup(self, config):
        x, y = _global_data()
        self.register(
            model_init=lambda key: {"w": jnp.zeros(_D, jnp.float32)},
            loss_fn=lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(),
            optimizer=optax.sgd(LR))
        self.register_data(train_loader=_Repeat((x, y), 10))


@pytest.fixture(scope="module")
def jax_results():
    op = _JaxWholeBatchOp({}, 0, 1)
    op.train_epoch(10)
    stacked = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    return {"w10": np.asarray(op.params["w"]), "stacked": stacked,
            "shifted": np.asarray(XlaGroup(f"shift_{uuid.uuid4().hex[:6]}")
                                  .shift_right(stacked))}


def test_shift_right_on_the_in_process_group(jax_results):
    """The in-process group (backend "xla", the plain versions on the
    CPU): rank r's tensor to rank (r + 1) % 8, bit for bit the reference
    XlaGroup's ppermute over its 8 devices."""
    stacked = jax_results["stacked"]
    name = f"shift_{uuid.uuid4().hex[:6]}"
    hs = [col.init_collective_group(8, r, backend="xla", group_name=name,
                                    device="cpu") for r in range(8)]
    try:
        outs = [h.shift_right(torch.from_numpy(stacked[r]))
                for r, h in enumerate(hs)]
        assert np.array_equal(np.stack([o.numpy() for o in outs]),
                              jax_results["shifted"])
    finally:
        col.destroy_collective_group(name)


# ---------------------------------------------------------------------------
# the multihost runtime: trainers and the process-mesh group
# ---------------------------------------------------------------------------

class MHWorker:
    """tests/test_multihost.py's MHWorker: a process of a multihost runtime
    over gloo, with a collective group of backend "xla" over it."""

    def __init__(self, group, rank, world):
        multihost.initialize(group, world, rank, backend="gloo")
        col.init_collective_group(world, rank, backend="xla",
                                  group_name="gmesh")
        self.rank, self.world = rank, world

    def run(self):
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard

        from ray_tpu_torch.collective import ReduceOp
        from ray_tpu_torch.collective.backends.device_backend import (
            GlobalMeshGroup, ProcessMeshGroup)

        g = col.get_group("gmesh")
        out = {"type": type(g).__name__,
               "is_global": GlobalMeshGroup is ProcessMeshGroup
               and isinstance(g, ProcessMeshGroup),
               "world": dist.get_world_size()}
        r = self.rank
        out["sum"] = g.allreduce(np.full(6, float(r + 1), np.float32))
        out["max"] = g.allreduce(np.full(6, float(r), np.float32),
                                 ReduceOp.MAX)
        out["bcast"] = g.broadcast(np.full(3, float(r), np.float32),
                                   src_rank=1)
        out["gather"] = g.allgather(np.full(2, float(r), np.float32))
        out["rs"] = g.reducescatter(np.arange(4, dtype=np.float32)
                                    * (r + 1))
        out["shift"] = g.shift_right(np.full(3, float(r), np.float32))
        out["shift_t"] = g.shift_right(torch.full((2, 2), float(r)))
        g.barrier()
        try:
            g.send(np.zeros(1), 0)
        except NotImplementedError as e:
            out["send"] = str(e)
        mesh = tmesh.fsdp_mesh("cpu")
        out["fsdp_mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names)
        mesh = tmesh.MeshSpec.auto(self.world).build("cpu")
        sharding = tmesh.NamedSharding(mesh, tmesh.P("dp"))
        out["placements"] = sharding.placements() == [
            Shard(0)] + [Replicate()] * 4
        rows = torch.full((2, 3), float(r))
        batch = multihost.shard_host_batch({"x": rows}, sharding)["x"]
        out["global_shape"] = tuple(batch.shape)
        out["global"] = batch.full_tensor().numpy()
        return out


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(num_cpus=12):
        yield


def _make(cls, **kw):
    return Trainer(cls, device="cpu", collective_timeout=30.0, **kw)


@pytest.fixture(scope="module")
def built(cluster):
    """Every trainer and actor of this file, made at once from threads;
    all shut down at the module's end."""
    mh = {"config": {"multihost": True}, "num_workers": 2}
    makers = {
        "mh": lambda: _make(MultiHostOp, **mh),
        "mh_kill": lambda: _make(MultiHostOp, max_retries=2, **mh),
        "fsdp1": lambda: _make(DyadicOp, mesh_mode="fsdp"),
        "gpt_sharded": lambda: _make(
            TinyGPTOp, num_workers=2,
            config={"multihost": True, "explicit": True}),
        "gpt_replicated": lambda: _make(TinyGPTOp, mesh_mode="fsdp", **mh)}
    name = f"mh_coll_{uuid.uuid4().hex[:6]}"
    mh_cls = ray_tpu_torch.remote(num_cpus=1)(MHWorker)
    makers["mh_actors"] = lambda: [mh_cls.remote(name, r, 2)
                                   for r in range(2)]
    with ThreadPoolExecutor(len(makers)) as pool:
        futures = {k: pool.submit(make) for k, make in makers.items()}
    made = {k: f.result() for k, f in futures.items()
            if f.exception() is None}
    try:
        for f in futures.values():
            if f.exception() is not None:
                raise f.exception()
        yield made
    finally:
        for k, v in made.items():
            if k == "mh_actors":
                for a in v:
                    ray_tpu_torch.kill(a)
            else:
                v.shutdown(force=True)


@pytest.fixture(scope="module")
def runs(built):
    """Every trainer's run, made here so that each test only reads them
    (the runs happen before any test's own checks begin)."""
    out = {}
    tr = built["mh"]
    out["mh_has_group"] = col.is_group_initialized(tr._group_name)
    tr.train(num_steps=10)
    out["mh_w10"] = tr.state_dict()["params"]["w"]

    tr = built["mh_kill"]
    tr.train(num_steps=4)
    out["kill_w_mid"] = tr.state_dict()["params"]["w"]
    gen_before = tr._generation
    ray_tpu_torch.kill(tr.workers[1])
    tr.train(num_steps=4)
    out["kill_w8"] = tr.state_dict()["params"]["w"]
    out["kill_generations"] = (gen_before, tr._generation, tr.num_workers)

    tr = built["fsdp1"]
    out["fsdp_losses"] = [tr.train()["train_loss"] for _ in range(4)]
    out["fsdp_mesh_shape"] = ray_tpu_torch.get(tr.workers[0].run.remote(
        lambda ops: tuple(ops[0]._mesh.shape)))

    sharded, replicated = built["gpt_sharded"], built["gpt_replicated"]
    out["gpt_batch_counts"] = [sharded.train()["batch_count"],
                               replicated.train()["batch_count"]]
    out["gpt_entries"] = ray_tpu_torch.get(
        [w.run.remote(_entries) for w in sharded.workers])
    out["gpt_repl_entries"] = ray_tpu_torch.get(
        replicated.workers[0].run.remote(_entries))
    out["gpt_states"] = [sharded.state_dict(), replicated.state_dict()]
    out["gpt_opt_bytes"] = [ray_tpu_torch.get(t.workers[0].read_metric.remote(
        "train.optim_shard_bytes"))["value"] for t in (sharded, replicated)]

    out["coll"] = ray_tpu_torch.get(
        [a.run.remote() for a in built["mh_actors"]], timeout=120)
    return out


def test_two_processes_one_mesh_match_full_batch_gd(runs, jax_results):
    """Each rank feeds its half of the batch: the weights match full-batch
    gradient descent, and the JAX operator on the whole batch, only if the
    mesh's allreduce combined the two ranks' gradients; a multihost
    generation has no collective group."""
    assert not runs["mh_has_group"]
    got = runs["mh_w10"]
    np.testing.assert_allclose(got, _full_batch_gd(10), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got, jax_results["w10"], rtol=1e-4,
                               atol=1e-5)


def test_rank_death_regangs_and_restores(runs):
    """tests/test_multihost.py::test_rank_death_resizes_and_restores: a
    killed rank between epochs; train() re-gangs a new runtime (the next
    generation's), restores the state and continues as 2 x 4
    uninterrupted steps."""
    gen_before, gen_after, world = runs["kill_generations"]
    assert gen_after > gen_before and world == 2
    got = runs["kill_w8"]
    np.testing.assert_allclose(got, _full_batch_gd(8), rtol=1e-3, atol=1e-4)
    assert not np.allclose(runs["kill_w_mid"], got)


def test_fsdp_mesh_mode_smoke(runs):
    """tests/test_train_sharded.py::test_fsdp_mesh_mode_smoke: one worker
    on its (1, 1) mesh; the loss halves."""
    first, *_, last = runs["fsdp_losses"]
    assert last < first * 0.5
    assert runs["fsdp_mesh_shape"] == ttopo.mesh_shape_for(1)


def _entries(ops):
    return [(shape, axes, None if sh is None else tuple(sh.shape))
            for _, shape, axes, sh in ops[0]._layout._entries]


def test_gpt_sharded_over_fsdp_equals_replicated(runs):
    """The GPT on an explicit (1, 2) mesh: every parameter whose leading
    dimension splits in two is held as half its rows on each rank (as
    JAX's fsdp_param_specs lays it out), and after 3 AdamW steps its
    parameters equal the replicated run's (mesh_mode="fsdp" on two ranks:
    the (2, 1) mesh) to GPT_TOL relative L2; the optimizer's state is
    half as large on each rank."""
    assert runs["gpt_batch_counts"] == [2 * GPT_STEPS] * 2
    entries = runs["gpt_entries"]
    want = jmesh.fsdp_param_specs(
        {i: np.zeros(shape) for i, (shape, _, _) in enumerate(entries[0])},
        types.SimpleNamespace(shape={"fsdp": 2}))
    n_sharded = 0
    for i, (shape, axes, shard) in enumerate(entries[0]):
        assert axes == tuple(want[i])[:1]
        if axes:
            n_sharded += 1
            assert shard == (shape[0] // 2,) + shape[1:]
    assert n_sharded == len(entries[0]) and entries[0] == entries[1]
    assert all(axes == () for _, axes, _ in runs["gpt_repl_entries"])
    got, ref = runs["gpt_states"]

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [np.asarray(tree, np.float64).ravel()]

    a, b = np.concatenate(leaves(got["params"])), np.concatenate(
        leaves(ref["params"]))
    assert np.linalg.norm(a - b) <= GPT_TOL * np.linalg.norm(b)
    # the gathered optimizer state has the replicated layout
    sa = got["opt_state"]["state"]
    sb = ref["opt_state"]["state"]
    assert sorted(sa) == sorted(sb)
    for i in sb:
        for k in ("exp_avg", "exp_avg_sq"):
            assert sa[i][k].shape == sb[i][k].shape
    sharded_bytes, replicated_bytes = runs["gpt_opt_bytes"]
    assert sharded_bytes * 2 == pytest.approx(replicated_bytes, rel=1e-3)


def test_collective_rides_the_process_mesh_when_multihost(runs):
    """tests/test_multihost.py::test_collective_rides_global_mesh_when_
    multihost: backend "xla" from the processes of a multihost runtime is
    a ProcessMeshGroup (alias GlobalMeshGroup); its ops and shift_right
    give the reference's values; point-to-point raises."""
    for r, out in enumerate(runs["coll"]):
        assert out["type"] == "ProcessMeshGroup" and out["is_global"]
        assert out["world"] == 2
        assert np.array_equal(out["sum"], np.full(6, 3.0, np.float32))
        assert np.array_equal(out["max"], np.full(6, 1.0, np.float32))
        assert np.array_equal(out["bcast"], np.full(3, 1.0, np.float32))
        assert [g.tolist() for g in out["gather"]] == [[0.0] * 2, [1.0] * 2]
        assert out["rs"].tolist() == ([0.0, 3.0] if r == 0 else [6.0, 9.0])
        assert out["shift"].tolist() == [float(1 - r)] * 3
        assert torch.equal(out["shift_t"], torch.full((2, 2), float(1 - r)))
        assert "HOST-backend only" in out["send"]
        assert out["fsdp_mesh"] == ((2, 1), ("data", "fsdp"))
        assert out["placements"]
        assert out["global_shape"] == (4, 3)
        assert out["global"].tolist() == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
