"""Port check: the per-process collective group (`backend="host"`, one
rank a process) of ray_tpu_torch on the CPU, held against the JAX
package's `HostGroup`.

The port's ranks are three CPU actors of one module-scoped
`ray_tpu_torch.init` cluster (tests/test_torch_runtime.port_cluster),
reused by every case: each tier is one group over them, joined once
(a second group over the first two for the cases at w = 2). The reference runs the same op in
threads of this process, its GCS KV calls monkeypatched to a dict, on the
same seeded numpy inputs; nothing of `ray_tpu/` changes.

Tolerances:
- hub, ring, ring_unpipelined and shm: bit-identical to the reference's
  same tier (the same numpy reductions in the same fold order: the hub's
  sequential reduce, the ring's schedule, the shm stripes in rank order),
  including the int8 ring's bytes.
- device (gloo on the CPU, forced): gloo's allreduce folds in its own
  order, so float SUM, MEAN and PRODUCT agree with the reference's hub
  within rtol 1e-6 (three-term f32 sums and products); MAX, MIN, int32
  SUM, the allgather and the broadcast are exact.
"""

import itertools
import os
import shutil
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import collective as col
from ray_tpu_torch.exceptions import TaskError
from tests.test_torch_runtime import port_cluster

# the actors build this module's class from its pickle: by value, so they
# never import this module (or jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

W = 3
N = 70001  # f32: 280 KB, past the ring's 256 KB pipeline slice
TIMEOUT = 30.0
DEVICE_RTOL = 1e-6
EXACT = ["hub", "ring", "ring_unpipelined", "shm"]
TIERS = EXACT + ["device"]
ALLREDUCE = [("sum", np.float32), ("max", np.float32), ("min", np.float32),
             ("product", np.float32), ("mean", np.float32),
             ("sum", np.int32)]
_NAMES = itertools.count()


class Rank(col.CollectiveActorMixin):
    """One rank: the module functions of ray_tpu_torch.collective on a
    torch tensor made from the numpy input; the result back as numpy."""

    def op(self, group, name, x=None, kw=None):
        kw = kw or {}
        t = None if x is None else torch.from_numpy(x.copy())
        if name == "allreduce":
            out = col.allreduce(t, group, **kw)
        elif name == "reducescatter":
            out = col.reducescatter(t, group, **kw)
        elif name == "allgather":
            out = col.allgather(t, group)
        elif name == "broadcast":
            out = col.broadcast(t, kw["src"], group)
        elif name == "barrier":
            out = col.barrier(group)
        elif name == "send":
            out = col.send(t, kw["dst"], group, kw.get("tag", 0))
        elif name == "recv":
            out = col.recv(kw["src"], group, kw.get("tag", 0))
        else:
            raise ValueError(name)
        return _to_np(out)

    def join(self, world, rank, group, transport, quantize, timeout):
        col.init_collective_group(world, rank, "host", group,
                                  timeout=timeout, transport=transport,
                                  quantize=quantize)
        return rank

    def destroy(self, group):
        col.destroy_collective_group(group)

    def tiers(self):
        from ray_tpu_torch.collective import metrics

        return metrics.tier_counts()

    def shm_mapped(self, group):
        return col.get_group(group)._shm is not None

    def timed(self, group, x):
        t0 = time.monotonic()
        try:
            col.allreduce(torch.from_numpy(x.copy()), group)
            return {"ok": True, "elapsed": time.monotonic() - t0}
        except TimeoutError as e:
            return {"ok": False, "elapsed": time.monotonic() - t0,
                    "error": str(e)}


def _to_np(out):
    if isinstance(out, list):
        return [_to_np(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return out


@pytest.fixture(scope="module")
def actors():
    with port_cluster(num_cpus=W):
        cls = ray_tpu_torch.remote(num_cpus=1)(Rank)
        ranks = [cls.remote() for _ in range(W)]
        yield ranks


@pytest.fixture(scope="module")
def groups(actors):
    """tier -> group name over the three actors; (tier, 2) -> over the
    first two. Each made once, all at once."""
    names = {}
    refs = []
    for tier in TIERS:
        for w in (W, 2):
            if w == 2 and tier in ("ring", "ring_unpipelined"):
                continue  # the reference's ring needs three ranks
            name = names[tier if w == W else (tier, 2)] = f"{tier}_{w}"
            refs += [a.join.remote(w, r, name, tier, None, TIMEOUT)
                     for r, a in enumerate(actors[:w])]
    names["int8"] = "int8_3"
    refs += [a.join.remote(W, r, "int8_3", "ring", "int8", TIMEOUT)
             for r, a in enumerate(actors)]
    ray_tpu_torch.get(refs, timeout=120)
    return names


@pytest.fixture(scope="module")
def reference():
    """run(w, transport, fn, quantize=None) -> [fn(group, rank) of every
    rank]: the reference's HostGroup in threads, its KV a dict."""
    from ray_tpu.collective.backends.host_backend import HostGroup
    from ray_tpu.experimental import internal_kv
    from ray_tpu.native.store import segment

    kv = {}
    # the reference's shm segments in a directory of this test's own:
    # /dev/shm/ray_tpu_colseg is what the suite's leak check watches for
    # the tests of other workers
    seg_dir = f"/dev/shm/ray_tpu_torch_ref_{os.getpid()}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(internal_kv, "_kv_put",
                   lambda k, v, overwrite=True: kv.__setitem__(k, v))
        mp.setattr(internal_kv, "_kv_get", kv.get)
        mp.setattr(internal_kv, "_kv_del", lambda k: kv.pop(k, None))
        mp.setattr(segment, "segment_dir", lambda: seg_dir)

        def run(w, transport, fn, quantize=None):
            name = f"ref_{next(_NAMES)}"
            out, errors = [None] * w, []
            # every rank joined before any leaves: rank 0's teardown
            # deletes the KV entry a late rank would still be polling for
            joined = threading.Barrier(w)

            def rank(r):
                try:
                    g = HostGroup(name, w, r, timeout=TIMEOUT,
                                  transport=transport, quantize=quantize)
                    joined.wait()
                    try:
                        out[r] = fn(g, r)
                    finally:
                        g.destroy()
                except Exception as e:  # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=rank, args=(r,))
                       for r in range(w)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            return out

        try:
            yield run
        finally:
            shutil.rmtree(seg_dir, ignore_errors=True)


def _inputs(seed, w, shape, dtype, op="sum"):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, (w,) + shape, dtype=np.int32)
    x = rng.standard_normal((w,) + shape).astype(np.float32)
    return 1 + 0.01 * x if op == "product" else x


def _port(actors, group, name, xs, **kw):
    return ray_tpu_torch.get([a.op.remote(group, name, x, kw)
                              for a, x in zip(actors, xs)], timeout=120)


def _same(got, want, tier, exact_always=False):
    """Bit-identical, or (device, float) within DEVICE_RTOL."""
    for g, r in zip(got, want):
        if isinstance(r, list):
            _same(g, r, tier, exact_always)
            continue
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (g.dtype, r.dtype)
        if tier == "device" and not exact_always and g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=DEVICE_RTOL,
                                       atol=DEVICE_RTOL * np.abs(r).max())
        else:
            assert np.array_equal(g, r, equal_nan=True)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("op,dtype", ALLREDUCE,
                         ids=[f"{o}-{np.dtype(d).name}" for o, d in ALLREDUCE])
def test_allreduce(actors, groups, reference, tier, op, dtype):
    xs = _inputs(10 * TIERS.index(tier) + ALLREDUCE.index((op, dtype)), W,
                 (N,), dtype, op)
    got = _port(actors, groups[tier], "allreduce", xs, op=op)
    want = reference(W, "hub" if tier == "device" else tier,
                     lambda g, r: g.allreduce(xs[r], op))
    _same(got, want, tier, exact_always=op in ("max", "min"))


@pytest.mark.parametrize("tier,w", [(t, W) for t in TIERS]
                         + [("hub", 2), ("shm", 2)])
def test_reducescatter(actors, groups, reference, tier, w):
    """Rows split as np.array_split splits them (7 rows over w ranks)."""
    xs = _inputs(11 + w, w, (7, 500), np.float32)
    name = groups[tier if w == W else (tier, 2)]
    got = _port(actors[:w], name, "reducescatter", xs)
    want = reference(w, "hub" if tier == "device" else tier,
                     lambda g, r: g.reducescatter(xs[r]))
    _same(got, want, tier)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("ragged", [False, True])
def test_allgather(actors, groups, reference, tier, ragged):
    """Uniform payloads on every tier; ragged ones (rank r's of r + 1
    rows) go to the hub on every tier."""
    xs = [_inputs(20 + r, 1, (r + 1 if ragged else 2, 3000),
                  np.float32)[0] for r in range(W)]
    got = _port(actors, groups[tier], "allgather", xs)
    want = reference(W, "hub" if tier == "device" else tier,
                     lambda g, r: g.allgather(xs[r]))
    _same(got, want, tier, exact_always=True)


@pytest.mark.parametrize("tier", TIERS)
def test_broadcast(actors, groups, reference, tier):
    xs = _inputs(30, W, (N,), np.float32)
    got = _port(actors, groups[tier], "broadcast", xs, src=1)
    want = reference(W, "hub" if tier == "device" else tier,
                     lambda g, r: g.broadcast(xs[r], 1))
    _same(got, want, tier, exact_always=True)
    assert all(np.array_equal(g, xs[1]) for g in got)


@pytest.mark.parametrize("n", [100, 1 << 16], ids=["mailbox", "direct"])
def test_send_recv(actors, groups, reference, n):
    """Through the hub's mailbox, and peer-direct above RING_MIN_BYTES."""
    x = _inputs(40, 1, (n,), np.float32)[0]
    name = groups[("hub", 2)]
    send = actors[1].op.remote(name, "send", x, {"dst": 0, "tag": 3})
    got = ray_tpu_torch.get(actors[0].op.remote(name, "recv", None,
                                                {"src": 1, "tag": 3}))
    assert ray_tpu_torch.get(send) is None
    want = reference(2, "hub", lambda g, r: (
        g.send(x, 0, 3) if r == 1 else g.recv(1, 3)))[0]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, x)


def test_barrier(actors, groups):
    assert _port(actors, groups["hub"], "barrier", [None] * W) == [None] * W


@pytest.mark.parametrize("name,op", [("allreduce", "sum"),
                                     ("allreduce", "max"),
                                     ("reducescatter", "sum")])
def test_int8_ring(actors, groups, reference, name, op):
    """The group's quantize="int8" default on the pipelined ring: the
    quantized bytes, bit for bit (the reduce-scatter on a flat bucket of
    w * QUANT_BLOCK multiples, the sharded trainer's layout)."""
    shape = (W * 256 * 40,) if name == "reducescatter" else (N,)
    xs = _inputs(50, W, shape, np.float32)
    got = _port(actors, groups["int8"], name, xs, op=op)
    want = reference(W, "ring", lambda g, r: getattr(g, name)(xs[r], op),
                     quantize="int8")
    _same(got, want, "ring")
    exact = reference(W, "ring", lambda g, r: getattr(g, name)(xs[r], op))
    assert not np.array_equal(got[0], exact[0])  # the wire was int8


def test_auto_routing_prefers_shm_on_one_node(actors, groups):
    """The reference's test: a large CPU payload of an "auto" group goes
    to the shm tier when every rank is on one node (the vote rounds of
    the device tiers are not paid: no rank holds a card)."""
    name = f"auto_{next(_NAMES)}"
    ray_tpu_torch.get([a.join.remote(W, r, name, "auto", None, TIMEOUT)
                       for r, a in enumerate(actors)])
    before = ray_tpu_torch.get([a.tiers.remote() for a in actors])
    xs = _inputs(60, W, (1 << 18,), np.float32)
    got = _port(actors, name, "allreduce", xs)
    after = ray_tpu_torch.get([a.tiers.remote() for a in actors])
    assert ray_tpu_torch.get([a.shm_mapped.remote(name) for a in actors]) \
        == [True] * W
    for b, a in zip(before, after):
        assert a["shm"] - b["shm"] == 1
        assert all(a[t] == b[t] for t in ("hub", "ring", "device", "pallas"))
    assert all(np.array_equal(g, got[0]) for g in got)
    ray_tpu_torch.get([a.destroy.remote(name) for a in actors])


def test_forced_pallas_on_cpu_raises(actors, reference):
    """No rank holds a card: a forced "pallas" group raises the
    reference's RuntimeError at its first op, as the reference's does
    without a multihost runtime."""
    name = f"pallas_{next(_NAMES)}"
    ray_tpu_torch.get([a.join.remote(2, r, name, "pallas", None, TIMEOUT)
                       for r, a in enumerate(actors[:2])])
    match = "forced collective transport 'pallas' is unavailable"
    with pytest.raises(TaskError, match=match):
        _port(actors[:2], name, "allreduce", _inputs(70, 2, (8,),
                                                     np.float32))
    with pytest.raises(RuntimeError, match=match):
        reference(2, "pallas", lambda g, r: g.allreduce(np.ones(8)))
    ray_tpu_torch.get([a.destroy.remote(name) for a in actors[:2]])


def _port_threads(w, transport, fn):
    """[fn(group, rank) of every rank, or the exception it raised]: the
    port's HostGroup in threads of this process, its KV a dict."""
    from ray_tpu_torch.collective.backends.host_backend import HostGroup
    from ray_tpu_torch.experimental import internal_kv

    kv, name = {}, f"threads_{next(_NAMES)}"
    out = [None] * w
    joined = threading.Barrier(w)

    def rank(r):
        g = HostGroup(name, w, r, timeout=TIMEOUT, transport=transport)
        joined.wait()
        try:
            out[r] = fn(g, r)
        except Exception as e:
            out[r] = e
        finally:
            joined.wait()
            g.destroy()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(internal_kv, "_kv_put",
                   lambda k, v, overwrite=True: kv.__setitem__(k, v))
        mp.setattr(internal_kv, "_kv_get", kv.get)
        mp.setattr(internal_kv, "_kv_del", lambda k: kv.pop(k, None))
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(w)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return out


class _FailingKernels:
    """A PALLAS tier whose launch fails on one rank: the peers' phase
    counters would be out of step after it."""

    def __init__(self, rank, bad):
        self.rank, self.bad = rank, bad

    def supports(self, kind, arr, op=None, quantize=None):
        return True

    def allreduce(self, arr, op, quantize=None):
        if self.rank == self.bad:
            raise RuntimeError("allreduce launch failed: injected")
        return arr


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_cuda_payload_never_leaves_a_broken_pallas_tier(fault):
    """Under "auto", a CUDA payload whose kernel tier fails (the build or
    the IPC mapping at the vote; a launch) raises on every rank, at that
    op and at every later one; no host tier carries it. The card is
    stood in for: every tensor counts as CUDA and the group as one whose
    ranks all hold a card."""
    from ray_tpu_torch.collective import metrics
    from ray_tpu_torch.collective.backends import host_backend

    w = 2

    def fn(g, r):
        g._pallas_shaped = True
        if fault == "build":
            def broken():
                raise RuntimeError("nvcc failed: injected")
            g._ensure_pallas = broken
        else:
            g._pallas = _FailingKernels(r, bad=1)
            g._ensure_pallas = lambda: g._pallas
        errors = []
        for _ in range(2):
            try:
                g.allreduce(torch.ones(1 << 16))
                errors.append(None)
            except Exception as e:
                errors.append(e)
        return errors

    before = metrics.tier_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host_backend, "is_cuda_tensor",
                   lambda t: isinstance(t, torch.Tensor))
        out = _port_threads(w, "auto", fn)
    assert metrics.tier_counts() == before  # no tier carried an op
    for r, errors in enumerate(out):
        assert not isinstance(errors, Exception), errors
        for i, e in enumerate(errors):
            if fault == "launch" and i == 0:
                if r == 1:  # the launch that failed
                    assert "injected" in str(e)
                else:  # its peer's kernel ran
                    assert e is None
                continue
            assert isinstance(e, RuntimeError), (r, i, e)
            assert "'pallas'" in str(e) and "rank(s) [" in str(e), str(e)


class _Tier:
    """A device tier that takes every CUDA payload and records each op it
    carries in `log`."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def supports(self, kind, arr, op=None, quantize=None):
        return True

    def dtype_ok(self, dtype):
        return True

    def allreduce(self, arr, op, quantize=None):
        self.log.append(self.name)
        return arr


def _reference_votes_pallas(n, forced):
    """The reference's HostGroup._pallas_route, run as it is on a group
    whose every rank holds a device of its own, for an f32 jax payload of
    n elements: True where it takes the PALLAS tier, False where the op
    falls through to the device tier."""
    import types

    import jax.numpy as jnp

    from ray_tpu.collective.backends.host_backend import HostGroup as Ref

    g = object.__new__(Ref)
    g.force_transport, g._device_shaped, g._destroyed = forced, True, False
    g._dbg, g._probe_rounds, g._pallas_disabled = {}, 0, False
    g._transport_derived = False
    g._ensure_pallas = lambda: types.SimpleNamespace(dtype_ok=lambda d: True)
    g._hub_allgather = lambda arr, kind=None: [arr, arr]
    return g._pallas_route(jnp.zeros(n, jnp.float32))


@pytest.mark.parametrize("shape,transport", [
    ("own_cards", "auto"), ("own_cards", "pallas"),
    ("shared_card", "auto")])
def test_size_gate_routes_as_the_reference(shape, transport):
    """C1: where every rank holds a card of its own, an f32 payload of
    64 KB takes the fused kernels and one element more falls through to
    the device tier (NCCL), a forced "pallas" pin too, exactly where the
    reference's gate (PALLAS_MAX_BYTES, 64 KB) sends it; where the ranks
    share a card, and for an int8-quantized allreduce on either shape,
    every size stays on the kernels (NCCL has no int8 wire). The group's
    shape is stubbed and every tensor counts as CUDA."""
    from ray_tpu.collective.backends.host_backend import HostGroup as Ref

    from ray_tpu_torch.collective.backends import host_backend

    assert host_backend.HostGroup.PALLAS_MAX_BYTES == Ref.PALLAS_MAX_BYTES
    gate = Ref.PALLAS_MAX_BYTES // 4
    sizes = (gate, gate + 1, 1 << 20)

    def fn(g, r):
        log = []
        g._pallas_shaped = True
        g._device_shaped = shape == "own_cards"
        g._pallas, g._device = _Tier("pallas", log), _Tier("device", log)
        g._ensure_pallas = lambda: g._pallas
        g._ensure_device = lambda: g._device
        for n in sizes:
            g.allreduce(torch.ones(n))
        for n in sizes:
            g.allreduce(torch.ones(n), quantize="int8")
        return log

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host_backend, "is_cuda_tensor",
                   lambda t: isinstance(t, torch.Tensor))
        out = _port_threads(2, transport, fn)
    if shape == "own_cards":
        forced = None if transport == "auto" else "pallas"
        want = ["pallas" if _reference_votes_pallas(n, forced) else "device"
                for n in sizes]
        assert want == ["pallas", "device", "device"]
    else:
        want = ["pallas"] * len(sizes)
    want = want + ["pallas"] * len(sizes)
    assert out == [want, want]


def test_rank_death_aborts_not_hangs(actors):
    """The reference's test, on the shm tier: kill a rank after a warm op;
    every survivor raises TimeoutError within the group timeout, and the
    survivors' group is destroyable and rebuildable at the surviving
    size. Runs last: it kills the module's third actor."""
    timeout = 2.0
    name = f"death_{next(_NAMES)}"
    ray_tpu_torch.get([a.join.remote(W, r, name, "shm", None, timeout)
                       for r, a in enumerate(actors)])
    x = _inputs(80, 1, (1 << 16,), np.float32)[0]
    assert all(r["ok"] for r in ray_tpu_torch.get(
        [a.timed.remote(name, x) for a in actors]))
    ray_tpu_torch.kill(actors[-1])
    t0 = time.monotonic()
    outs = ray_tpu_torch.get([a.timed.remote(name, x) for a in actors[:-1]],
                             timeout=60)
    wall = time.monotonic() - t0
    for out in outs:
        assert not out["ok"], out
        assert out["elapsed"] < timeout * 3 + 5, out
    assert wall < timeout * 6 + 10
    ray_tpu_torch.get([a.destroy.remote(name) for a in actors[:-1]])
    rebuilt = f"{name}_rebuilt"
    ray_tpu_torch.get([a.join.remote(2, r, rebuilt, "shm", None, timeout)
                       for r, a in enumerate(actors[:-1])])
    assert all(r["ok"] for r in ray_tpu_torch.get(
        [a.timed.remote(rebuilt, x) for a in actors[:-1]]))
