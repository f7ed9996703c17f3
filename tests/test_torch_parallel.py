"""Port check: ray_tpu_torch's parallel axes against ray_tpu's, on a mesh
of four ranks.

The port runs one device a process, so its mesh is over ranks: a
module-scoped pool of four processes joined by gloo (started once,
shared by every case) runs each case on every rank, each rank passing
the same global inputs. The JAX side runs the same case on a mesh of the
same shape over `jax.devices()[:4]` of the conftest's virtual CPU
devices. All inputs are numpy arrays from a seed; all arithmetic is
float32. Every JAX result is computed once, in a module fixture, and so
is every port result.

Cases:
- axis_size/axis_index (tuples of axes too) and the collectives of
  `parallel.spmd` on integers: all_to_all tiled (Ulysses' split 2 /
  concat 1) and untiled (the MoE's [ep, ...] blocks), ppermute and psum,
  also over a tuple of axes named minor first: exact.
- ring attention, causal and full, on (dp 2, sp 2): forward and the
  gradients of q, k, v (sharded over dp and sp) and of a weight w
  replicated over the mesh (P(): its cotangent psum'd over every axis),
  through shard_map(ring_attention) as the reference's.
- Ulysses, causal, on (sp 2, ep 2): the same with q, k, v sharded over
  sp and replicated over ep (their cotangents divided and psum'd over
  ep); heads indivisible by sp raise the reference's ValueError.
- ring against Ulysses (full, sp 4), each against the dense reference.
- the GPipe pipeline on (pp 4) and (dp 2, pp 2): outputs and the
  gradients of the stage weights (sharded over pp) and of x (replicated
  over pp).
- moe_apply on (dp 2, ep 2), capacity 1.25 (tokens are dropped): outputs,
  aux and the gradients of x (replicated over ep), router_w (replicated)
  and w_in, w_out (sharded over ep); the conservation check of
  tests/test_parallel.py:118 at capacity 8; the routing's dispatch
  tensors exactly.
- the MoE transformer TINY_MOE on (sp 2, ep 2) at 4 x 64 tokens (so the
  MoE rows move between the sp ranks each layer): logits and aux with
  ring, Ulysses and dense attention against the reference's ring; loss
  and every parameter's gradient (wte replicated, w_in sharded over ep)
  against jax.grad of the reference loss_fn.
- the same model with ring attention on (tp 2, sp 2), heads split over
  tp, and on (pp 2, ep 2), everything replicated over pp: logits, aux,
  loss and every gradient against the reference on meshes of the same
  shape.
Every rank returns the global results, which must agree across ranks.

Tolerances (float32, the same arithmetic in another order):
- outputs, logits, losses and aux: max |port − jax| / max |jax| <= 2e-5
  (the reference's own bound for ring attention against dense);
- gradients, per tensor: Σ|port − jax| / Σ|jax| <= 1e-4;
- integer collectives and dispatch tensors: exact.
"""

import dataclasses
import os
import subprocess
import sys
import threading
from multiprocessing.connection import Listener

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ray_tpu.models import moe_transformer as jmoe
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import moe as jmoe_ops
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel import ring_attention as jring
from ray_tpu.parallel import sharding as jsh
from ray_tpu.parallel import ulysses as july
from ray_tpu_torch.models import moe_transformer as tmoe
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import moe as tmoe_ops
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel import ring_attention as tring
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel import ulysses as tuly

# the ranks build this module's functions from their pickles: by value,
# so they never import this module (and with it jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

WORLD = 4
OUT_TOL, GRAD_TOL = 2e-5, 1e-4
CALL_TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys, traceback
import cloudpickle, torch
import torch.distributed as dist
from multiprocessing.connection import Client

host, port, store_port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
rank, world, key = int(sys.argv[4]), int(sys.argv[5]), bytes.fromhex(sys.argv[6])
torch.set_num_threads(1)
conn = Client((host, port), authkey=key)
conn.send(rank)
store = dist.TCPStore(host, store_port, world + 1, False)
dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
while True:
    msg = conn.recv_bytes()
    if not msg:
        break
    fn, args = cloudpickle.loads(msg)
    try:
        out = ("ok", fn(rank, *args))
    except BaseException:
        out = ("error", traceback.format_exc())
    conn.send_bytes(cloudpickle.dumps(out))
dist.destroy_process_group()
"""


class RankPool:
    """WORLD processes in one gloo group; `run(fn, *args)` calls
    fn(rank, *args) on every rank at once and returns their results."""

    def __init__(self, world: int = WORLD):
        import torch.distributed as dist

        key = os.urandom(16)
        self.listener = Listener(("127.0.0.1", 0), authkey=key)
        self.store = dist.TCPStore("127.0.0.1", 0, world + 1, True,
                                   wait_for_workers=False)
        host, port = self.listener.address
        env = dict(os.environ, PYTHONPATH=REPO)
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, host, str(port),
             str(self.store.port), str(r), str(world), key.hex()],
            cwd=REPO, env=env) for r in range(world)]
        conns = {}

        def accept():
            for _ in range(world):
                conn = self.listener.accept()
                conns[conn.recv()] = conn

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        t.join(CALL_TIMEOUT_S)
        if len(conns) != world:
            self.close()
            raise TimeoutError(f"{len(conns)} of {world} ranks connected")
        self.conns = [conns[r] for r in range(world)]

    def run(self, fn, *args):
        msg = cloudpickle.dumps((fn, args))
        for conn in self.conns:
            conn.send_bytes(msg)
        results = []
        for r, conn in enumerate(self.conns):
            if not conn.poll(CALL_TIMEOUT_S):
                raise TimeoutError(f"rank {r} did not answer {fn.__name__}")
            status, value = cloudpickle.loads(conn.recv_bytes())
            if status != "ok":
                raise RuntimeError(f"rank {r}: {value}")
            results.append(value)
        return results

    def close(self):
        for conn in getattr(self, "conns", []):
            try:
                conn.send_bytes(b"")
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.listener.close()


# ---------------------------------------------------------------------------
# the inputs and the JAX side
# ---------------------------------------------------------------------------

def _jmesh(shape):
    return jmesh.MeshSpec(**shape).build(jax.devices()[:WORLD])


def _normal(rng, shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


ATT = {"ring-causal": ("ring", True, {"dp": 2, "sp": 2}, (4, 16, 2, 8)),
       "ring-full": ("ring", False, {"dp": 2, "sp": 2}, (4, 16, 2, 8)),
       "ulysses-causal": ("ulysses", True, {"sp": 2, "ep": 2},
                          (2, 16, 4, 8))}
PIPE = {"pp4": {"pp": 4}, "dp2-pp2": {"dp": 2, "pp": 2}}
MOE_MESH = {"dp": 2, "ep": 2}
MODEL_MESH = {"sp": 2, "ep": 2}
TP_PP_MESHES = {"tp2-sp2": {"tp": 2, "sp": 2}, "pp2-ep2": {"pp": 2, "ep": 2}}
MODEL_TOKENS = (4, 64)
COLLECTIVES = {
    # name: (mesh, global input shape, in spec, out spec)
    "axes": ({"dp": 2, "sp": 2}, (4, 3), (("dp", "sp"),), (("dp", "sp"),)),
    "all_to_all_tiled": ({"sp": 4}, (2, 8, 4, 3), (None, "sp"),
                         (None, None, "sp")),
    "all_to_all_untiled": ({"dp": 2, "ep": 2}, (8, 2, 3), (("dp", "ep"),),
                           (("dp", "ep"),)),
    "ppermute": ({"sp": 4}, (8, 3), ("sp",), ("sp",)),
    "psum": ({"dp": 2, "sp": 2}, (8, 3), (("dp", "sp"),), (("dp", "sp"),)),
    # axes named minor first: the group's rank order is not axis order
    "minor_first": ({"dp": 2, "sp": 2}, (16, 3), (("sp", "dp"),),
                    (("sp", "dp"),)),
}


def _collective_body(name, size, index, all_to_all, ppermute, psum):
    """The case's body over either package's primitives."""
    if name == "axes":
        return lambda x: (x + 100 * index(("dp", "sp")) + 10 * size("sp")
                          + size(("dp", "sp")))
    if name == "all_to_all_tiled":
        return lambda x: all_to_all(x, "sp", 2, 1, True)
    if name == "all_to_all_untiled":
        return lambda x: all_to_all(x, "ep", 0, 0, False)
    if name == "ppermute":
        return lambda x: ppermute(x, "sp", [(i, (i + 1) % 4)
                                            for i in range(4)])
    if name == "minor_first":
        axes = ("sp", "dp")
        return lambda x: all_to_all(ppermute(
            x + 100 * index(axes), axes, [(i, (i + 1) % 4)
                                          for i in range(4)]),
            axes, 0, 0, True) + psum(x, axes)
    return lambda x: psum(x, "sp")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    out = {"coll": {n: np.arange(np.prod(c[1]), dtype=np.int32).reshape(c[1])
                    for n, c in COLLECTIVES.items()}}
    for name, (_, _, _, shape) in ATT.items():
        out[name] = {k: _normal(rng, shape) for k in ("q", "k", "v", "cot")}
        out[name]["w"] = 1 + _normal(rng, shape[-1:], 0.2)
    out["ring-vs-ulysses"] = {k: _normal(rng, (2, 32, 4, 8))
                              for k in ("q", "k", "v")}
    d = 16
    out["pipe"] = {name: {"w": _normal(rng, (shape.get("pp"), d, d), 0.3),
                          "x": _normal(rng, (8, d)),
                          "cot": _normal(rng, (8, d))}
                   for name, shape in PIPE.items()}
    n, d, f, e = 64, 8, 16, 8
    out["moe"] = {"x": _normal(rng, (n, d)),
                  "router_w": _normal(rng, (d, e), 0.5),
                  "w_in": _normal(rng, (e, d, f), 0.3),
                  "w_out": _normal(rng, (e, f, d), 0.3),
                  "cot": _normal(rng, (n, d))}
    params = jmoe.init(jax.random.PRNGKey(3), jmoe.TINY_MOE)
    out["model"] = {
        "params": jax.tree.map(lambda a: (np.asarray(a, np.float32) + _normal(
            rng, np.shape(a), 0.05)), params),
        "tokens": rng.integers(0, jmoe.TINY_MOE.vocab_size,
                               MODEL_TOKENS).astype(np.int32)}
    return out


def _jax_collectives(data):
    from jax.sharding import PartitionSpec as JP

    out = {}
    for name, (shape, _, ins, outs) in COLLECTIVES.items():
        body = _collective_body(
            name, jmesh.axis_size, lax.axis_index,
            lambda x, a, s, c, t: lax.all_to_all(x, a, s, c, tiled=t),
            lambda x, a, perm: lax.ppermute(x, a, perm),
            lambda x, a: lax.psum(x, a))
        fn = jmesh.shard_map(body, _jmesh(shape), (JP(*ins),), JP(*outs))
        out[name] = np.asarray(jax.jit(fn)(jnp.asarray(data["coll"][name])))
    return out


def _jax_attention(case, data):
    from jax.sharding import PartitionSpec as JP

    kind, causal, shape, _ = ATT[case]
    mesh = _jmesh(shape)
    d = data[case]
    body = jring.ring_attention if kind == "ring" else july.ulysses_attention
    spec = JP("dp", "sp", None, None)
    fn = jmesh.shard_map(lambda q, k, v, w: body(q * w, k, v, causal=causal),
                         mesh, (spec, spec, spec, JP()), spec)

    def loss(q, k, v, w):
        return (fn(q, k, v, w) * d["cot"]).sum()

    sharded = (jring.ring_attention_sharded if kind == "ring"
               else july.ulysses_attention_sharded)
    args = [jnp.asarray(d[k]) for k in ("q", "k", "v", "w")]
    out = jax.jit(lambda q, k, v: sharded(q, k, v, mesh, causal=causal))(
        *args[:3])
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)
    return {"out": np.asarray(out),
            **{f"d{k}": np.asarray(g) for k, g in zip("qkvw", grads)}}


def _jax_pipe(case, data):
    mesh = _jmesh(PIPE[case])
    d = data["pipe"][case]

    def loss(w, x):
        y = jpipe.pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"]),
                                 {"w": w}, x, mesh=mesh, num_microbatches=4)
        return (y * d["cot"]).sum(), y

    (_, y), (dw, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                  has_aux=True))(
        jnp.asarray(d["w"]), jnp.asarray(d["x"]))
    return {"out": np.asarray(y), "dw": np.asarray(dw), "dx": np.asarray(dx)}


def _jax_moe(data):
    mesh = _jmesh(MOE_MESH)
    d = data["moe"]
    keys = ("x", "router_w", "w_in", "w_out")

    def loss(*args):
        out, aux = jmoe_ops.moe_apply(*args, mesh=mesh)
        return (out * d["cot"]).sum() + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(d[k]) for k in keys))
    return {"out": np.asarray(out), "aux": float(aux),
            **{f"d{k}": np.asarray(g) for k, g in zip(keys, grads)}}


def _jax_model(data, shape=MODEL_MESH):
    cfg = jmoe.TINY_MOE
    mesh = _jmesh(shape)
    params = jax.device_put(
        jax.tree.map(jnp.asarray, data["model"]["params"]),
        jsh.tree_shardings(mesh, jmoe.logical_axes(cfg)))
    tokens = jnp.asarray(data["model"]["tokens"])
    logits, aux = jax.jit(lambda p, t: jmoe.apply(p, t, cfg, mesh))(params,
                                                                   tokens)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, t: jmoe.loss_fn(p, t, cfg, mesh), has_aux=True))(params,
                                                                   tokens)
    return {"logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def jax_results(data):
    return {"coll": _jax_collectives(data),
            **{case: _jax_attention(case, data) for case in ATT},
            "ring-vs-ulysses": np.asarray(jax.jit(
                lambda q, k, v: july.ulysses_attention_sharded(
                    q, k, v, _jmesh({"sp": 4}), causal=False))(
                *(jnp.asarray(data["ring-vs-ulysses"][k]) for k in "qkv"))),
            "pipe": {case: _jax_pipe(case, data) for case in PIPE},
            "moe": _jax_moe(data), "model": _jax_model(data),
            "tp_pp": {name: _jax_model(data, shape)
                      for name, shape in TP_PP_MESHES.items()}}


# ---------------------------------------------------------------------------
# the port's side: run on every rank of the pool
# ---------------------------------------------------------------------------

def _tmesh(shape):
    return tmesh.MeshSpec(**shape).build("cpu")


def _tensors(d, keys, grad=False):
    return [torch.from_numpy(d[k]).requires_grad_(grad) for k in keys]


def _rank_collectives(rank, data):
    out = {}
    for name, (shape, _, ins, outs) in COLLECTIVES.items():
        body = _collective_body(
            name, tmesh.axis_size, tmesh.axis_index,
            lambda x, a, s, c, t: spmd.all_to_all(x, a, s, c, tiled=t),
            spmd.ppermute, spmd.psum)
        fn = tmesh.shard_map(body, _tmesh(shape), (tmesh.P(*ins),),
                             tmesh.P(*outs))
        out[name] = fn(torch.from_numpy(data["coll"][name]).long()).numpy()
    return out


def _rank_attention(rank, case, data):
    kind, causal, shape, _ = ATT[case]
    mesh = _tmesh(shape)
    d = data[case]
    body = tring.ring_attention if kind == "ring" else tuly.ulysses_attention
    spec = tmesh.P("dp", "sp", None, None)
    fn = tmesh.shard_map(lambda q, k, v, w: body(q * w, k, v, causal=causal),
                         mesh, (spec, spec, spec, tmesh.P()), spec)
    args = _tensors(d, ("q", "k", "v", "w"), grad=True)
    (fn(*args) * torch.from_numpy(d["cot"])).sum().backward()
    sharded = (tring.ring_attention_sharded if kind == "ring"
               else tuly.ulysses_attention_sharded)
    with torch.no_grad():
        out = sharded(*args[:3], mesh, causal=causal)
        dense = tring.reference_attention(*args[:3], causal=causal)
    res = {"out": out.numpy(), "dense": dense.numpy(),
           **{f"d{k}": a.grad.numpy() for k, a in zip("qkvw", args)}}
    if kind == "ulysses":
        q = torch.zeros((2, 16, 3, 8))
        try:
            tuly.ulysses_attention_sharded(q, q, q, _tmesh({"sp": 4}))
        except ValueError as e:
            res["error"] = str(e)
    return res


def _rank_ring_vs_ulysses(rank, data):
    mesh = _tmesh({"sp": 4})
    q, k, v = _tensors(data["ring-vs-ulysses"], "qkv")
    return {"ring": tring.ring_attention_sharded(q, k, v, mesh,
                                                 causal=False).numpy(),
            "ulysses": tuly.ulysses_attention_sharded(q, k, v, mesh,
                                                      causal=False).numpy(),
            "dense": tring.reference_attention(q, k, v,
                                               causal=False).numpy()}


def _rank_pipe(rank, data):
    out = {}
    for case, shape in PIPE.items():
        d = data["pipe"][case]
        w, x = _tensors(d, ("w", "x"), grad=True)
        y = tpipe.pipeline_apply(lambda p, x: torch.tanh(x @ p["w"]),
                                 {"w": w}, x, mesh=_tmesh(shape),
                                 num_microbatches=4)
        (y * torch.from_numpy(d["cot"])).sum().backward()
        seq = x.detach()
        for i in range(w.shape[0]):
            seq = torch.tanh(seq @ w.detach()[i])
        out[case] = {"out": y.detach().numpy(), "dw": w.grad.numpy(),
                     "dx": x.grad.numpy(), "sequential": seq.numpy()}
    return out


def _rank_moe(rank, data):
    d = data["moe"]
    keys = ("x", "router_w", "w_in", "w_out")
    args = _tensors(d, keys, grad=True)
    mesh = _tmesh(MOE_MESH)
    out, aux = tmoe_ops.moe_apply(*args, mesh=mesh)
    ((out * torch.from_numpy(d["cot"])).sum() + aux).backward()
    with torch.no_grad():
        generous, _ = tmoe_ops.moe_apply(*args, mesh=mesh,
                                         capacity_factor=8.0)
    return {"out": out.detach().numpy(), "aux": aux.item(),
            "generous": generous.numpy(),
            **{f"d{k}": a.grad.numpy() for k, a in zip(keys, args)}}


def _rank_model(rank, data):
    mesh = _tmesh(MODEL_MESH)
    tokens = torch.from_numpy(data["model"]["tokens"])
    out = {}
    for att in tmoe.ATTENTION:
        cfg = dataclasses.replace(tmoe.TINY_MOE, attention=att)
        model = tmoe.params_from_jax(data["model"]["params"], cfg, mesh)
        with torch.no_grad():
            logits, aux = tmoe.apply(model, tokens)
        out[att] = {"logits": logits.numpy(), "aux": aux.item()}
        if att == "ring":
            loss, _ = tmoe.loss_fn(model, tokens)
            loss.backward()
            out["loss"] = loss.item()
            out["grads"] = {n: p.grad.numpy()
                            for n, p in model.named_parameters()}
            out["ep_index"] = tmesh.layout(mesh).index("ep")
            out["round_trip"] = tmoe.params_to_jax(model)
    return out


def _rank_model_tp_pp(rank, data):
    tokens = torch.from_numpy(data["model"]["tokens"])
    out = {}
    for name, shape in TP_PP_MESHES.items():
        mesh = _tmesh(shape)
        model = tmoe.params_from_jax(data["model"]["params"], tmoe.TINY_MOE,
                                     mesh)
        with torch.no_grad():
            logits, aux = tmoe.apply(model, tokens)
        loss, _ = tmoe.loss_fn(model, tokens)
        loss.backward()
        out[name] = {"logits": logits.numpy(), "aux": aux.item(),
                     "loss": loss.item(),
                     "grads": {n: p.grad.numpy()
                               for n, p in model.named_parameters()},
                     "ep_index": tmesh.layout(mesh).index("ep")}
    return out


@pytest.fixture(scope="module")
def pool():
    p = RankPool()
    try:
        yield p
    finally:
        p.close()


@pytest.fixture(scope="module")
def port_results(pool, data):
    return {"coll": pool.run(_rank_collectives, data),
            **{case: pool.run(_rank_attention, case, data) for case in ATT},
            "ring-vs-ulysses": pool.run(_rank_ring_vs_ulysses, data),
            "pipe": pool.run(_rank_pipe, data),
            "moe": pool.run(_rank_moe, data),
            "model": pool.run(_rank_model, data),
            "tp_pp": pool.run(_rank_model_tp_pp, data)}


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l1(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collectives_match_jax_exactly(jax_results, port_results, name):
    want = jax_results["coll"][name]
    for rank in port_results["coll"]:
        assert np.array_equal(rank[name], want), (name, rank[name], want)


@pytest.mark.parametrize("case", list(ATT))
@pytest.mark.parametrize("quantity", ["out", "dq", "dk", "dv", "dw"])
def test_attention_matches_jax(jax_results, port_results, case, quantity):
    ranks = port_results[case]
    _same_on_every_rank(ranks, quantity)
    got, want = ranks[0][quantity], jax_results[case][quantity]
    err = (_rel_max(got, want) if quantity == "out"
           else _rel_l1(got, want))
    assert err <= (OUT_TOL if quantity == "out" else GRAD_TOL), err


@pytest.mark.parametrize("case", list(ATT))
def test_attention_matches_dense(port_results, case):
    rank = port_results[case][0]
    assert _rel_max(rank["out"], rank["dense"]) <= OUT_TOL


def test_ulysses_rejects_indivisible_heads(port_results):
    assert "divisible" in port_results["ulysses-causal"][0]["error"]


def test_ring_matches_ulysses(jax_results, port_results):
    for rank in port_results["ring-vs-ulysses"]:
        assert _rel_max(rank["ring"], rank["ulysses"]) <= OUT_TOL
        assert _rel_max(rank["ulysses"], rank["dense"]) <= OUT_TOL
        assert _rel_max(rank["ulysses"],
                        jax_results["ring-vs-ulysses"]) <= OUT_TOL


@pytest.mark.parametrize("case", list(PIPE))
@pytest.mark.parametrize("quantity", ["out", "dw", "dx"])
def test_pipeline_matches_jax(jax_results, port_results, case, quantity):
    ranks = [r[case] for r in port_results["pipe"]]
    _same_on_every_rank(ranks, quantity)
    got, want = ranks[0][quantity], jax_results["pipe"][case][quantity]
    err = (_rel_max(got, want) if quantity == "out"
           else _rel_l1(got, want))
    assert err <= (OUT_TOL if quantity == "out" else GRAD_TOL), err


@pytest.mark.parametrize("case", list(PIPE))
def test_pipeline_matches_sequential(port_results, case):
    rank = port_results["pipe"][0][case]
    assert _rel_max(rank["out"], rank["sequential"]) <= OUT_TOL


@pytest.mark.parametrize("quantity", ["out", "aux", "dx", "drouter_w",
                                      "dw_in", "dw_out"])
def test_moe_apply_matches_jax(jax_results, port_results, quantity):
    ranks = port_results["moe"]
    _same_on_every_rank(ranks, quantity)
    got, want = ranks[0][quantity], jax_results["moe"][quantity]
    if quantity in ("out", "aux"):
        assert _rel_max(got, want) <= OUT_TOL
    else:
        assert _rel_l1(got, want) <= GRAD_TOL


def test_moe_top1_conserves_tokens(data, port_results):
    """tests/test_parallel.py:118: with generous capacity every token is
    processed by exactly its top-1 expert."""
    d = data["moe"]
    logits = d["x"] @ d["router_w"]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top = probs.argmax(-1)
    expected = np.zeros_like(d["x"])
    for i, e in enumerate(top):
        h = np.asarray(jax.nn.gelu(d["x"][i] @ d["w_in"][e]))
        expected[i] = probs[i, e] * (h @ d["w_out"][e])
    np.testing.assert_allclose(port_results["moe"][0]["generous"], expected,
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("capacity", [1, 5, 16])
def test_top1_routing_dispatch_is_exact(capacity):
    rng = np.random.default_rng(capacity)
    logits = _normal(rng, (48, 6))
    logits[5] = logits[5].max()  # a tie: the first index wins
    want = jax.tree.map(np.asarray, jmoe_ops.top1_routing(
        jnp.asarray(logits), capacity))
    got = tmoe_ops.top1_routing(torch.from_numpy(logits), capacity)
    assert np.array_equal(got[0].numpy(), want[0])
    assert _rel_max(got[1].numpy(), want[1]) <= OUT_TOL
    assert _rel_max(got[2].numpy(), want[2]) <= OUT_TOL


@pytest.mark.parametrize("attention", ["ring", "ulysses", "dense"])
def test_moe_model_logits_match_jax(jax_results, port_results, attention):
    want = jax_results["model"]
    for rank in port_results["model"]:
        got = rank[attention]
        assert _rel_max(got["logits"], want["logits"]) <= OUT_TOL
        assert abs(got["aux"] - want["aux"]) <= OUT_TOL * abs(want["aux"])
    assert 0.5 < port_results["model"][0][attention]["aux"] < 4.0


def test_moe_model_loss_matches_jax(jax_results, port_results):
    want = jax_results["model"]["loss"]
    for rank in port_results["model"]:
        assert abs(rank["loss"] - want) <= OUT_TOL * abs(want)


def _model_grads(ranks):
    """Every rank's .grad -> the JAX tree: blocks stacked, experts
    concatenated over the ep ranks (those of sp index 0)."""
    by_ep = {r["ep_index"]: r["grads"] for r in ranks[::-1]}
    grads = ranks[0]["grads"]
    cfg = tmoe.TINY_MOE
    tree = {k: grads[k] for k in ("wte", "wpe", "lnf_w", "lnf_b")}
    tree["blocks"] = {}
    for key in tmoe._BLOCK_KEYS:
        layers = []
        for i in range(cfg.n_layers):
            name = f"blocks.{i}.{key}"
            if key in tmoe._EXPERT_KEYS:
                layers.append(np.concatenate([by_ep[e][name]
                                              for e in sorted(by_ep)]))
            else:
                layers.append(grads[name])
        tree["blocks"][key] = np.stack(layers)
    return tree


MODEL_LEAVES = (["wte", "wpe", "lnf_w", "lnf_b"]
                + [f"blocks.{k}" for k in tmoe._BLOCK_KEYS])


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("leaf", MODEL_LEAVES)
def test_moe_model_grads_match_jax(jax_results, port_results, leaf):
    ranks = port_results["model"]
    err = _rel_l1(_leaf(_model_grads(ranks), leaf),
                  _leaf(jax_results["model"]["grads"], leaf))
    assert err <= GRAD_TOL, (leaf, err)
    if not leaf.endswith(tmoe._EXPERT_KEYS):
        # a replicated parameter's gradient is the global one on every rank
        names = [n for n in ranks[0]["grads"]
                 if n == leaf or n.endswith("." + leaf.split(".")[-1])]
        for r in ranks[1:]:
            for n in names:
                np.testing.assert_allclose(r["grads"][n],
                                           ranks[0]["grads"][n],
                                           rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mesh", list(TP_PP_MESHES))
@pytest.mark.parametrize("quantity", ["logits", "aux", "loss"])
def test_moe_model_on_tp_pp_matches_jax(jax_results, port_results, mesh,
                                        quantity):
    want = jax_results["tp_pp"][mesh][quantity]
    for rank in port_results["tp_pp"]:
        assert _rel_max(rank[mesh][quantity], want) <= OUT_TOL, (mesh,
                                                                 quantity)


@pytest.mark.parametrize("mesh", list(TP_PP_MESHES))
@pytest.mark.parametrize("leaf", MODEL_LEAVES)
def test_moe_model_on_tp_pp_grads_match_jax(jax_results, port_results, mesh,
                                            leaf):
    ranks = [r[mesh] for r in port_results["tp_pp"]]
    err = _rel_l1(_leaf(_model_grads(ranks), leaf),
                  _leaf(jax_results["tp_pp"][mesh]["grads"], leaf))
    assert err <= GRAD_TOL, (mesh, leaf, err)


def test_moe_model_params_round_trip(data, port_results):
    for rank in port_results["model"]:
        back = rank["round_trip"]
        for leaf in MODEL_LEAVES:
            assert _leaf(back, leaf).tobytes() == _leaf(
                data["model"]["params"], leaf).tobytes(), leaf


def test_mesh_and_moe_model_refuse_the_cpu_unless_asked():
    """The driver-level entries run on the mesh's device: without CUDA a
    mesh built without device="cpu" raises before any process group."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.MeshSpec(sp=2, ep=2).build()
