"""Port check: the runtime of ray_tpu_torch against ray_tpu's, on the CPU.

The same small driver programs (after tests/test_basic.py and
tests/test_actor.py) run through one module-scoped cluster of each
package, `ray_tpu.init(num_cpus=4, num_tpus=2)` and
`ray_tpu_torch.init(num_cpus=4, num_gpus=2)`; each program's result, or
the name of the exception it raised, must be the same on both. Then what
only the port has: torch tensors through put/get and through an actor,
bit for bit; GPU leases that pin each worker to its own card
(CUDA_VISIBLE_DEVICES) on this GPU-less machine; a task worker that
imports neither jax, nor ray_tpu, nor torch.

`port_cluster` is this file's leak check, which the port's Trainer tests
use too: after `shutdown()` no process of the session and nothing of it
under /dev/shm/ray_tpu_torch-<tag> may remain (the reference's leak
check in tests/conftest.py matches only ray_tpu's own names).
"""

import contextlib
import os
import signal
import sys
import tempfile
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private.object_store import session_root, shm_root

# remote functions and classes of this module travel by value: a worker
# never imports this module (and with it jax)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

LEAK_WAIT_S = 20.0


def _session_procs(session: str) -> dict:
    """pid -> cmdline of live processes of a port session."""
    procs = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace").replace("\0", " ")
        except OSError:
            continue
        if "-m ray_tpu_torch." in cmd and session in cmd:
            procs[int(pid)] = cmd.strip()
    return procs


@contextlib.contextmanager
def port_cluster(**init_kwargs):
    """ray_tpu_torch.init(**init_kwargs) for the body; after shutdown,
    every process of the session must be gone and its object-store
    arena removed (under /dev/shm, or in the session directory) (leftovers are killed
    and deleted, and fail the check)."""
    info = ray_tpu_torch.init(**init_kwargs)
    session_dir = info["session_dir"]
    session = os.path.basename(session_dir)
    try:
        yield info
    finally:
        ray_tpu_torch.shutdown()
        deadline = time.monotonic() + LEAK_WAIT_S
        while _session_procs(session) and time.monotonic() < deadline:
            time.sleep(0.1)
        leaked = _session_procs(session)
        for pid in leaked:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        arenas = [os.path.join(shm_root(os.path.dirname(session_dir)),
                               session),
                  os.path.join(session_dir, "store")]
        assert not leaked, f"port processes outlived shutdown: {leaked}"
        for arena in arenas:
            assert not os.path.exists(arena), f"{arena} outlived shutdown"


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4, num_tpus=2)
    try:
        with port_cluster(num_cpus=4, num_gpus=2):
            yield
    finally:
        ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# the same programs through both packages
# ---------------------------------------------------------------------------

class _Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value

    def read(self):
        return self.value


class _Flaky:
    def __init__(self):
        self.count = 0

    def bump(self):
        self.count += 1
        return self.count

    def die(self):
        os._exit(1)


def _put_get_numpy(rt):
    value = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
             "b": [np.ones(500_000), "text"]}
    return rt.get(rt.put(value))


def _task_chain(rt):
    @rt.remote
    def f(x):
        return x + 1

    ref = f.remote(0)
    for _ in range(5):
        ref = f.remote(ref)
    return rt.get(ref)


def _num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @rt.remote
    def two():
        return "a", "b"

    return rt.get(list(three.remote())
                  + list(two.options(num_returns=2).remote()))


def _error_through_dependency(rt):
    @rt.remote
    def fail():
        raise ValueError("inner")

    @rt.remote
    def consume(x):
        return x

    return rt.get(consume.remote(fail.remote()))


def _wait_timeout(rt):
    @rt.remote
    def sleep_then(i, t):
        time.sleep(t)
        return i

    fast, slow = sleep_then.remote(1, 0.0), sleep_then.remote(2, 4.0)
    ready, not_ready = rt.wait([fast, slow], num_returns=1, timeout=2.0)
    return [ready == [fast], not_ready == [slow], rt.get(fast)]


def _named_actor(rt):
    counter = rt.remote(_Counter).options(name="runtime_named").remote(5)
    rt.get(counter.increment.remote())
    return rt.get(rt.get_actor("runtime_named").read.remote())


def _method_order(rt):
    counter = rt.remote(_Counter).remote()
    return rt.get([counter.increment.remote() for _ in range(20)])


def _kill_then_call(rt):
    counter = rt.remote(_Counter).remote()
    rt.get(counter.increment.remote())
    rt.kill(counter)
    return rt.get(counter.read.remote(), timeout=15)


def _max_restarts(rt):
    flaky = rt.remote(max_restarts=2)(_Flaky).remote()
    first = rt.get(flaky.bump.remote())
    flaky.die.remote()
    time.sleep(1.5)
    return [first, rt.get(flaky.bump.remote(), timeout=30)]


def _cluster_resources(rt):
    """The accelerator is the TPU in ray_tpu, the GPU in the port."""
    return {("accelerator" if k in ("TPU", "GPU") else k): v
            for k, v in rt.cluster_resources().items()
            if k in ("CPU", "TPU", "GPU")}


def _util(rt):
    import importlib

    return importlib.import_module(rt.__name__ + ".util")


def _accelerator(rt) -> str:
    return "TPU" if rt.__name__ == "ray_tpu" else "GPU"


def _pg_create_ready_remove(rt):
    util = _util(rt)
    pg = util.placement_group([{"CPU": 1}, {"CPU": 1}])
    ready = pg.ready(timeout=30)
    listed = pg.id.hex() in util.placement_group_table()
    specs, count = pg.bundle_specs, pg.bundle_count
    util.remove_placement_group(pg)
    return [ready, listed, specs, count,
            pg.id.hex() in util.placement_group_table()]


def _pg_named(rt):
    util = _util(rt)
    pg = util.placement_group([{"CPU": 1}], name="runtime_pg")
    pg.ready(timeout=30)
    found = util.get_placement_group("runtime_pg").id == pg.id
    util.remove_placement_group(pg)
    try:
        util.get_placement_group("runtime_pg")
        after = "found"
    except ValueError as e:
        after = type(e).__name__
    return [found, after]


def _pg_invalid_arguments(rt):
    util = _util(rt)
    out = []
    for kwargs in ({"bundles": [{"CPU": 1}], "strategy": "BOGUS"},
                   {"bundles": []}, {"bundles": [{}]},
                   {"bundles": [{"CPU": -1}]}, {"bundles": ["CPU"]},
                   {"bundles": [{"CPU": 1}], "tpu_slice": "v5e-16",
                    "strategy": "SPREAD"},
                   {"bundles": [{"CPU": 1}], "cost_model": "ring"}):
        try:
            util.placement_group(**kwargs)
            out.append("created")
        except Exception as e:
            out.append(type(e).__name__)
    return out


def _pg_task_and_actor_in_a_bundle(rt):
    util = _util(rt)
    pg = util.placement_group([{"CPU": 1}, {"CPU": 1}])
    pg.ready(timeout=30)

    @rt.remote
    def plus_one(x):
        return x + 1

    try:
        task = plus_one.options(placement_group=pg,
                                placement_group_bundle_index=0).remote(41)
        counter = rt.remote(_Counter).options(
            placement_group=pg, placement_group_bundle_index=1,
            num_cpus=1).remote(10)
        out = rt.get([task, counter.increment.remote(5)], timeout=60)
        rt.kill(counter)
        return out
    finally:
        util.remove_placement_group(pg)


def _pg_removal_frees_resources(rt):
    """A second group that needs the node's whole accelerator waits for
    the first, and is placed once the first is removed."""
    util = _util(rt)
    bundle = [{_accelerator(rt): 2}]
    first = util.placement_group(bundle)
    out = [first.ready(timeout=30)]
    second = util.placement_group(bundle)
    out.append(second.ready(timeout=1))
    util.remove_placement_group(first)
    out.append(second.ready(timeout=30))
    util.remove_placement_group(second)
    return out


def _pg_strict_spread_on_one_node(rt):
    util = _util(rt)
    pg = util.placement_group([{"CPU": 1}, {"CPU": 1}],
                              strategy="STRICT_SPREAD")
    try:
        return pg.ready(timeout=10)
    finally:
        util.remove_placement_group(pg)


def _pg_ici_ring_places_as_pack(rt):
    util = _util(rt)
    pg = util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="ICI_RING")
    try:
        ready = pg.ready(timeout=30)
        rec = util.placement_group_table()[pg.id.hex()]
        return [ready, rec["state"], rec["strategy"], rec["topology_plan"],
                len({b["node_id"] for b in rec["bundles"]}),
                [b["resources"] for b in rec["bundles"]]]
    finally:
        util.remove_placement_group(pg)


PROGRAMS = [_put_get_numpy, _task_chain, _num_returns,
            _error_through_dependency, _wait_timeout, _named_actor,
            _method_order, _kill_then_call, _max_restarts,
            _cluster_resources, _pg_create_ready_remove, _pg_named,
            _pg_invalid_arguments, _pg_task_and_actor_in_a_bundle,
            _pg_removal_frees_resources, _pg_strict_spread_on_one_node,
            _pg_ici_ring_places_as_pack]


def _outcome(program, rt):
    try:
        return "returned", program(rt)
    except Exception as e:  # the exception's type is the result
        return "raised", (type(e).__name__,
                          isinstance(e, rt.exceptions.TaskError),
                          isinstance(e, rt.exceptions.ActorDiedError))


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__[1:])
def test_program_matches_reference(clusters, program):
    want = _outcome(program, ray_tpu)
    got = _outcome(program, ray_tpu_torch)
    assert _same(got, want), (got, want)


# ---------------------------------------------------------------------------
# what the port adds: tensors, GPU leases, a jax-free worker
# ---------------------------------------------------------------------------

def _probe_modules():
    import sys

    return sorted(m for m in sys.modules
                  if m in ("jax", "ray_tpu", "torch")
                  or m.startswith(("jax.", "ray_tpu.")))


def test_task_worker_imports_neither_jax_nor_ray_tpu_nor_torch(clusters):
    """A plain task runs in a worker that has not imported jax, nothing
    of ray_tpu, and not torch (the tensor reducer must not import it)."""
    probe = ray_tpu_torch.remote(_probe_modules)
    assert ray_tpu_torch.get(probe.remote()) == []


def _tensors():
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(4, 6, generator=gen)
    return {
        "f32": base,
        "bf16": base.to(torch.bfloat16),
        "f16": base.half(),
        "int8": torch.randint(-128, 127, (5, 3), dtype=torch.int8,
                              generator=gen),
        "bool": base > 0,
        "noncontiguous": base.t()[::2],
        "zero_d": torch.tensor(3.5, dtype=torch.float64),
        "requires_grad": base.clone().requires_grad_(True),
        "parameter": torch.nn.Parameter(base.clone()),
        "nested": {"a": [base[:1], {"b": base.to(torch.bfloat16)[1:]}],
                   "n": np.arange(3)},
    }


def _bit_equal(got, want) -> bool:
    if isinstance(want, torch.Tensor):
        return (type(got) is type(want) and got.dtype == want.dtype
                and got.shape == want.shape and got.device.type == "cpu"
                and got.requires_grad == want.requires_grad
                and torch.equal(got.detach().reshape(-1).view(torch.uint8),
                                want.detach().reshape(-1).view(torch.uint8)))
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _bit_equal(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(
            _bit_equal(g, w) for g, w in zip(got, want))
    return _same(got, want)


class _Echo:
    def echo(self, value):
        return value


@pytest.fixture(scope="module")
def echo(clusters):
    return ray_tpu_torch.remote(_Echo).remote()


@pytest.mark.parametrize("route", ["put_get", "actor"])
@pytest.mark.parametrize("key", list(_tensors()))
def test_tensor_round_trip_is_bit_exact(clusters, echo, route, key):
    """A tensor comes back as a CPU tensor of the same type, dtype, shape,
    requires_grad and bytes (non-contiguous ones contiguous, bf16 as raw
    bytes)."""
    value = _tensors()[key]
    if route == "put_get":
        got = ray_tpu_torch.get(ray_tpu_torch.put(value))
    else:
        got = ray_tpu_torch.get(echo.echo.remote(value))
    assert _bit_equal(got, value)


class _Pinned:
    def visible(self):
        return os.environ["CUDA_VISIBLE_DEVICES"]


def test_gpu_actors_are_pinned_to_their_own_card(clusters):
    """Two num_gpus=1 actors see different cards; a third waits for a
    card until one of them is killed, and then gets its card."""
    pinned = ray_tpu_torch.remote(num_gpus=1)(_Pinned)
    a, b = pinned.remote(), pinned.remote()
    seen = ray_tpu_torch.get([a.visible.remote(), b.visible.remote()],
                             timeout=60)
    assert sorted(seen) == ["0", "1"]
    c = pinned.remote()
    pending = c.visible.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=2.0)
    assert ready == []
    ray_tpu_torch.kill(a)
    assert ray_tpu_torch.get(pending, timeout=60) == seen[0]
    for actor in (b, c):
        ray_tpu_torch.kill(actor)


@pytest.mark.parametrize("bundles,shares", [
    ([{"GPU": 1}, {"GPU": 1}], [[0.5, 0.5], [1]]),
    ([{"GPU": 0.5}, {"GPU": 0.5}], [[0.25, 0.25], [0.5]])],
    ids=["a_card_a_bundle", "two_bundles_one_card"])
def test_gpu_bundle_pins_its_leases_to_its_card(clusters, bundles, shares):
    """A GPU bundle fixes its card when it is reserved, and every lease in
    it, fractional shares included, runs with exactly that card in
    CUDA_VISIBLE_DEVICES: bundles of whole cards get a card each, two
    half-card bundles share one."""
    from ray_tpu_torch.util import placement_group, remove_placement_group

    pg = placement_group(bundles)
    assert pg.ready(timeout=30)
    pinned = ray_tpu_torch.remote(_Pinned)
    actors = [[pinned.options(placement_group=pg,
                              placement_group_bundle_index=i,
                              num_gpus=g).remote() for g in gs]
              for i, gs in enumerate(shares)]
    try:
        seen = [ray_tpu_torch.get([a.visible.remote() for a in row],
                                  timeout=60) for row in actors]
    finally:
        for actor in (a for row in actors for a in row):
            ray_tpu_torch.kill(actor)
        remove_placement_group(pg)
    assert len(set(seen[0])) == 1
    cards = {seen[0][0], seen[1][0]}
    assert cards <= {"0", "1"}
    assert len(cards) == (2 if bundles[0]["GPU"] == 1 else 1)


def test_session_and_store_follow_the_tempdir(clusters, monkeypatch):
    """The session lives under the tempdir and the store arena in the
    /dev/shm directory named after that sessions directory (or in the
    session itself): runtimes of two checkouts with their own TMPDIR
    share no directory."""
    from ray_tpu_torch._private import global_state

    cw = global_state.get_core_worker()
    sessions = os.path.dirname(cw.session_dir)
    assert sessions == session_root()
    root = os.path.abspath(cw.store.root)
    assert (root.startswith(shm_root(sessions) + os.sep)
            or root.startswith(cw.session_dir + os.sep)), root
    monkeypatch.delenv("RAY_TPU_TORCH_TMPDIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", "/checkout_a/tmp")
    assert session_root() == "/checkout_a/tmp/ray_tpu_torch"
    assert shm_root(session_root()) != shm_root(sessions)


def test_cpu_task_sees_no_card(clusters):
    @ray_tpu_torch.remote
    def visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray_tpu_torch.get(visible.remote()) == ""


@pytest.mark.parametrize("num_gpus", [-1, 1.5])
def test_num_gpus_is_a_share_or_whole_cards(num_gpus):
    with pytest.raises(ValueError, match="num_gpus"):
        ray_tpu_torch.remote(num_gpus=num_gpus)(_Pinned)


@pytest.mark.parametrize("call", ["task", "actor", "get"])
def test_without_init_raises_as_the_reference(monkeypatch, call):
    """Without init(), submitting a task or an actor and get() raise the
    reference's RuntimeError (whether or not this module's clusters are
    up: the process's core worker is taken away for the test)."""
    from ray_tpu._private import global_state as ref_state
    from ray_tpu_torch._private import global_state as port_state

    monkeypatch.setattr(ref_state, "_core_worker", None)
    monkeypatch.setattr(port_state, "_core_worker", None)
    for rt in (ray_tpu, ray_tpu_torch):
        with pytest.raises(RuntimeError, match="init"):
            if call == "task":
                rt.remote(_probe_modules).remote()
            elif call == "actor":
                rt.remote(_Counter).remote()
            else:
                rt.get([])
