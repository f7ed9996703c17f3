"""Port check: ray_tpu_torch.serve against ray_tpu.serve in one process, no
cluster.

- The KV cache: one seeded script of operations runs on four pools —
  the reference's "numpy" and "jax" backends and the port's "numpy" and
  "torch" (device="cpu") backends: alloc_table, single and multi-row
  append, adopt_prefix/register_prefix, truncate into a shared page
  (copy-on-write), adopt, eviction of the prefix index's LRU leaf under
  its node bound and under pool pressure, export_prefix/import_prefix
  into a fresh pool, exhaustion and free. After every operation the
  page tables, refcounts, free list, prefix_stats, leak_report and
  every owner's gather_sum must be identical, bit for bit. The rows are
  integer-valued float32, as the serve model's KV rows are, so every
  order of summation is exact and the sums check the page indirection.
  prefix_block_hashes agree byte for byte.
- The engine: the port's DecodeEngine streams exactly the reference
  ShardedTokenLM's `generate` (and `generate_batch`) under interleaved
  admission and early retire, session reuse and LRU eviction, a typed
  shed when the waiting queue is full (pinned with the port's
  `serve.decode_step` delay failpoint), and an abort that frees pages.
- The unit helpers: sse_event/iter_sse_lines bytes, _error_response
  status codes and BackendConfig validation equal the reference's (the
  one departure: the admitted kv_backend name, and num_gpus_per_shard);
  failpoint specs parse alike; histogram exemplars snapshot alike.
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu import exceptions as rexc
from ray_tpu._private import failpoints as rfp
from ray_tpu._private import stats as rstats
from ray_tpu.serve import config as rconfig
from ray_tpu.serve import engine as rengine
from ray_tpu.serve import http_proxy as rproxy
from ray_tpu.serve import kv_cache as rkv
from ray_tpu.serve import streaming as rstream
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch._private import failpoints as tfp
from ray_tpu_torch._private import stats as tstats
from ray_tpu_torch._private import tracing as ttracing
from ray_tpu_torch.serve import config as tconfig
from ray_tpu_torch.serve import engine as tengine
from ray_tpu_torch.serve import http_proxy as tproxy
from ray_tpu_torch.serve import kv_cache as tkv
from ray_tpu_torch.serve import streaming as tstream

PAGE, WIDTH, PAGES, NODES = 4, 8, 14, 4
POOLS = ("ref-numpy", "ref-jax", "port-numpy", "port-torch")
DRAIN_S = 30.0


def _make_pool(kind: str, name: str):
    mod, backend = {"ref-numpy": (rkv, "numpy"), "ref-jax": (rkv, "jax"),
                    "port-numpy": (tkv, "numpy"),
                    "port-torch": (tkv, "torch")}[kind]
    kw = {"device": "cpu"} if backend == "torch" else {}
    return mod, mod.PagedKVCache(PAGES, PAGE, WIDTH, name=name,
                                 backend=backend, prefix_max_nodes=NODES,
                                 **kw)


def _state(kv) -> dict:
    """Everything a pool decides: tables, refcounts, free list, index
    flags, prefix stats, leaks and every owner's sum (bytes)."""
    with kv._lock:
        tables = {o: (list(t.pages), t.length) for o, t in kv._tables.items()}
        refs, free = list(kv._refs), list(kv._free)
        flags = bytes(kv._index_flag)
    return {"tables": tables, "refs": refs, "free": free, "flags": flags,
            "prefix": kv.prefix_stats(), "in_use": kv.pages_in_use(),
            "leaks": kv.leak_report(live_owners=["a"]),
            "sums": {o: kv.gather_sum(o).tobytes() for o in sorted(tables)}}


def _kv_script(kind: str) -> list:
    """The seeded script on one pool kind: [(step, state or outcome)]."""
    rng = np.random.default_rng(7)

    def rows(n):
        return rng.integers(-4, 5, (n, WIDTH)).astype(np.float32)

    toks = [int(t) for t in rng.integers(1, 50, 12)]   # 3 full pages
    other = [int(t) for t in rng.integers(50, 99, 9)]  # 2 full pages
    mod, kv = _make_pool(kind, "script")
    _, fresh = _make_pool(kind, "fresh")
    log = []

    def step(name, fn):
        try:
            out = fn()
        except mod.KVCacheExhausted as e:
            out = ("exhausted", e.num_pages)
        if isinstance(out, mod.PageTable):
            out = (out.owner, list(out.pages), out.length)
        log.append((name, out, _state(kv)))

    try:
        step("alloc", lambda: kv.alloc_table("a"))
        step("append-1", lambda: kv.append("a", rows(1)[0]))
        step("append-9", lambda: kv.append("a", rows(9)))
        step("adopt-cold", lambda: kv.adopt_prefix("p1", toks))
        step("prefill", lambda: kv.append("p1", rows(12)))
        step("register", lambda: kv.register_prefix("p1", toks))
        step("adopt-hit", lambda: kv.adopt_prefix("p2", toks + [7, 7]))
        step("append-tail", lambda: kv.append("p2", rows(2)))
        step("truncate-shared", lambda: kv.truncate("p2", 6))
        step("append-cow", lambda: kv.append("p2", rows(2)))
        step("rekey", lambda: kv.adopt("p2", "sess:p2"))
        step("free-p1", lambda: kv.free("p1"))
        step("adopt-other", lambda: kv.adopt_prefix("q", other))
        step("prefill-other", lambda: kv.append("q", rows(9)))
        step("register-evicts", lambda: kv.register_prefix("q", other))
        step("export", lambda: [(e["parent"], e["block"], e["rows"].tobytes())
                                for e in kv.export_prefix(8)])
        step("import", lambda: fresh.import_prefix(kv.export_prefix(8)))
        log.append(("fresh", None, _state(fresh)))
        step("free-q", lambda: kv.free("q"))
        step("alloc-big", lambda: kv.alloc_table("big"))
        step("pressure", lambda: kv.append("big", rows(40)))
        step("exhausted", lambda: kv.append("big", rows(1)))
        step("free-big", lambda: kv.free("big"))
        step("free-again", lambda: kv.free("big"))
        step("free-all", lambda: kv.free_all())
    finally:
        kv.close()
        fresh.close()
    return log


@pytest.fixture(scope="module")
def kv_logs():
    return {kind: _kv_script(kind) for kind in POOLS}


@pytest.mark.parametrize("kind", POOLS[1:])
def test_kv_pools_match_the_reference_numpy_pool(kv_logs, kind):
    want, got = kv_logs["ref-numpy"], kv_logs[kind]
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    for (name, out, state), (_, want_out, want_state) in zip(got, want):
        assert out == want_out, (kind, name)
        assert state == want_state, (kind, name)


def test_kv_script_reaches_every_path(kv_logs):
    """The script's own guard: a hit, a copy-on-write, an eviction, an
    import, pool-pressure reclaim and exhaustion all happened."""
    log = {name: (out, state) for name, out, state in kv_logs["ref-numpy"]}
    assert log["adopt-hit"][0] == 12
    assert log["append-cow"][1]["in_use"] == log["truncate-shared"][1][
        "in_use"] + 1
    assert log["register-evicts"][1]["prefix"]["nodes"] == NODES
    assert log["import"][0] > 0
    assert log["exhausted"][0] == ("exhausted", PAGES)
    assert log["pressure"][1]["prefix"]["nodes"] == 0
    assert log["free-all"][1]["in_use"] == 0


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_prefix_block_hashes_match_byte_for_byte(page_size):
    rng = np.random.default_rng(page_size)
    for n in (0, 3, 17, 64, 200):
        tokens = [int(t) for t in rng.integers(0, 1 << 40, n)]
        assert (tkv.prefix_block_hashes(tokens, page_size)
                == rkv.prefix_block_hashes(tokens, page_size))


def test_torch_pool_refuses_the_host_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.PagedKVCache(4, 4, 4, backend="torch")
    with pytest.raises(ValueError, match="kv backend"):
        tkv.PagedKVCache(4, 4, 4, backend="jax")


# ---------------------------------------------------------------------------
# the engine against the reference model
# ---------------------------------------------------------------------------

def _drain(channel, timeout: float = DRAIN_S) -> list:
    deadline = time.monotonic() + timeout
    toks, cur = [], 0
    while True:
        chunk = channel.wait(cur, 0.5)
        toks.extend(chunk["tokens"])
        cur = chunk["cursor"]
        if chunk["done"]:
            if chunk["error"] is not None:
                raise chunk["error"]
            return toks
        assert time.monotonic() < deadline, "channel never finished"


def _ref(seed):
    return rengine.ShardedTokenLM.make(seed)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_model_and_shards_match_the_reference(shards):
    r, t = _ref(4), tengine.ShardedTokenLM.make(4)
    for k in ("embed", "w_up", "w_out"):
        assert getattr(t, k).tobytes() == getattr(r, k).tobytes()
    prompts, maxs = [[3, 5, 9], [1], [2, 2, 8, 1]], [7, 12, 20]
    assert t.generate_batch(prompts, maxs) == r.generate_batch(prompts, maxs)
    assert t.generate([3, 5, 9], 30) == r.generate([3, 5, 9], 30)
    for rank in range(shards):
        rs = _ref(4).shard(rank, shards)
        ts = tengine.ShardedTokenLM.make(4).shard(rank, shards)
        assert ts.kv_width == rs.kv_width
        assert ts.w_up.tobytes() == rs.w_up.tobytes()
        assert ts.w_out.tobytes() == rs.w_out.tobytes()


def test_engine_interleaved_admission_and_early_retire():
    eng = tengine.DecodeEngine(
        tengine.ShardedTokenLM.make(3),
        {"max_decode_batch": 4, "kv_page_size": 4, "kv_pages_total": 64},
        "unit")
    try:
        long_id = eng.submit([3, 5, 9], 40)
        time.sleep(0.02)
        short_id = eng.submit([1, 2], 5)
        short = _drain(eng.channel(short_id))
        assert not eng._kv.has(short_id), "a retired sequence kept pages"
        long_toks = _drain(eng.channel(long_id))
        assert short == _ref(3).generate([1, 2], 5)
        assert long_toks == _ref(3).generate([3, 5, 9], 40)
        assert [short, long_toks] == _ref(3).generate_batch(
            [[1, 2], [3, 5, 9]], [5, 40])
        assert eng._kv.pages_in_use() == 0
        assert eng.debug_state()["kv_leaked"] == []
    finally:
        eng.close()


def test_engine_shared_prefix_matches_the_reference():
    """Prompts sharing a page-aligned prefix adopt its pages (hits
    counted) and still decode exactly."""
    prefix = [3, 5, 9, 1, 2, 4, 6, 8]
    eng = tengine.DecodeEngine(
        tengine.ShardedTokenLM.make(5),
        {"max_decode_batch": 4, "kv_page_size": 4, "kv_pages_total": 64,
         "prefix_index_max_nodes": 16}, "prefix")
    try:
        for tail in ([7], [11, 12], [13]):
            got = _drain(eng.channel(eng.submit(prefix + tail, 6)))
            assert got == _ref(5).generate(prefix + tail, 6)
        assert eng._kv.prefix_stats()["hits"] == 2
        assert eng._kv.prefix_stats()["tokens_saved"] == 16
    finally:
        eng.close()


def test_engine_session_reuse_and_eviction():
    eng = tengine.DecodeEngine(
        tengine.ShardedTokenLM.make(3),
        {"max_decode_batch": 2, "session_cache_max": 1, "kv_page_size": 4,
         "kv_pages_total": 64}, "sess")
    try:
        t1 = _drain(eng.channel(eng.submit([3, 5], 4, session="a")))
        assert eng.session_info("a") == {"cached": True,
                                         "tokens": 2 + len(t1)}
        t2 = _drain(eng.channel(eng.submit([7], 4, session="a")))
        assert t2 == _ref(3).generate([3, 5] + t1 + [7], 4)
        _drain(eng.channel(eng.submit([1], 3, session="b")))
        assert not eng.session_info("a")["cached"]
        assert eng.drain_evicted_sessions() == ["a"]
    finally:
        eng.close()


def test_engine_sheds_typed_when_waiting_is_full():
    tfp.arm("serve.decode_step", "delay", ms=400)
    eng = tengine.DecodeEngine(
        tengine.ShardedTokenLM.make(3),
        {"max_decode_batch": 1, "max_waiting_sequences": 1,
         "overload_retry_after_s": 2.5}, "shed")
    try:
        first = eng.submit([1], 50)
        deadline = time.monotonic() + DRAIN_S
        while eng.debug_state()["decode_batch"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        eng.submit([2], 50)
        with pytest.raises(texc.ServeOverloadedError) as ei:
            eng.submit([3], 50)
        assert ei.value.retry_after_s == 2.5
        assert tfp.hits("serve.decode_step") >= 1
        eng.abort(first, "test done")
    finally:
        tfp.reset()
        eng.close()


def test_engine_abort_frees_pages_and_finishes_typed():
    tfp.arm("serve.decode_step", "delay", ms=50)
    eng = tengine.DecodeEngine(
        tengine.ShardedTokenLM.make(3),
        {"max_decode_batch": 2, "kv_pages_total": 64}, "abort")
    try:
        sid = eng.submit([3, 5, 9], 500)
        ch = eng.channel(sid)
        ch.wait(0, DRAIN_S)
        assert eng.abort(sid, "client disconnect")
        with pytest.raises(texc.SequenceAborted):
            _drain(ch)
        got = ch.tokens
        assert got == _ref(3).generate([3, 5, 9], len(got))
        deadline = time.monotonic() + DRAIN_S
        while eng._kv.pages_in_use():
            assert time.monotonic() < deadline, "abort leaked KV pages"
            time.sleep(0.02)
    finally:
        tfp.reset()
        eng.close()


# ---------------------------------------------------------------------------
# the unit helpers
# ---------------------------------------------------------------------------

SSE_CASES = [({"tokens": [1, 2]}, None), ({"done": True}, "done"),
             ({"meta": {"seq": "x", "prefix_hashes": ["ab"]}}, "meta"),
             ({"error": "boom", "type": "SequenceAborted"}, "error")]


def test_sse_framing_matches_byte_for_byte():
    for data, event in SSE_CASES:
        assert tstream.sse_event(data, event=event) == rstream.sse_event(
            data, event=event)
    frames = b"".join(rstream.sse_event(d, event=e) for d, e in SSE_CASES)
    lines = frames.splitlines(keepends=True)
    assert (list(tstream.iter_sse_lines(lines))
            == list(rstream.iter_sse_lines(lines)))


def _errors(exc):
    return [exc.ServeOverloadedError("ep", 9, 8, 0.05),
            exc.ServeOverloadedError("ep", 3, 2, 2.5),
            exc.ReplicaGroupDied("b", "g", "lost"),
            exc.ObjectLostError("gone"),
            exc.SequenceAborted("s1", "client gone"),
            exc.TaskError("ValueError", "ValueError('x')", "tb"),
            KeyError("k")]


@pytest.mark.parametrize("i", range(7))
def test_error_response_matches(i):
    got = tproxy._error_response(_errors(texc)[i])
    want = rproxy._error_response(_errors(rexc)[i])
    assert got == want


def test_typed_errors_pickle_as_the_reference():
    import pickle

    for t, r in zip(_errors(texc)[:3] + _errors(texc)[4:5],
                    _errors(rexc)[:3] + _errors(rexc)[4:5]):
        back = pickle.loads(pickle.dumps(t))
        assert type(back) is type(t)
        assert str(back) == str(r) and vars(back) == vars(r)


CONFIGS = [{}, {"num_replicas": -1}, {"max_batch_size": 0},
           {"max_concurrent_queries": 0}, {"max_queued_requests": 0},
           {"num_shards": 0}, {"num_shards": 2, "shard_group_timeout_s": 0},
           {"streaming": True, "max_decode_batch": 0},
           {"streaming": True, "max_waiting_sequences": 0},
           {"streaming": True, "kv_page_size": 0},
           {"streaming": True, "session_cache_max": -1},
           {"streaming": True, "prefix_index_max_nodes": -1},
           {"streaming": True, "kv_warm_pages": -1},
           {"streaming": True, "router_session_cap": 0},
           {"streaming": True, "kv_backend": "other"},
           {"autoscaling": {"min_replicas": 1, "max_replicas": 3}},
           {"streaming": True, "num_shards": 2, "max_decode_batch": 32}]


def _validate(mod, kw):
    try:
        return ("ok", mod.BackendConfig(**kw).to_dict())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_backend_config_validates_as_the_reference(i):
    kind, got = _validate(tconfig, CONFIGS[i])
    want_kind, want = _validate(rconfig, CONFIGS[i])
    assert kind == want_kind
    if kind == "ok":
        assert got.pop("num_gpus_per_shard") == 0.0
        assert got == want
    elif "kv_backend" in got:
        assert want == "kv_backend must be 'numpy' or 'jax'"
        assert got == "kv_backend must be 'numpy' or 'torch'"
    else:
        assert got == want


def test_backend_config_torch_kv_needs_a_card_share():
    with pytest.raises(ValueError, match="num_gpus_per_shard"):
        tconfig.BackendConfig(streaming=True, kv_backend="torch")
    cfg = tconfig.BackendConfig(streaming=True, kv_backend="torch",
                                num_gpus_per_shard=0.5)
    assert tconfig.BackendConfig.from_dict(cfg.to_dict()) == cfg


SPECS = ["serve.decode_step=delay(ms=50)",
         "serve.stream_emit=raise(nth=3,once)",
         "a.b=exit(p=0.25,role=worker);c=drop_conn;d=off",
         "serve.kv_page_alloc=raise(once=1,ms=2)"]


@pytest.mark.parametrize("spec", SPECS)
def test_failpoint_specs_parse_as_the_reference(spec):
    got = {n: f.spec_text() for n, f in tfp.parse(spec).items()}
    want = {n: f.spec_text() for n, f in rfp.parse(spec).items()}
    assert got == want


def test_failpoint_actions_fire_as_the_reference():
    for mod in (tfp, rfp):
        mod.reset()
        mod.arm("x.raise", "raise", nth=2)
        assert mod.fire("x.raise") is None
        with pytest.raises(mod.FailpointError):
            mod.fire("x.raise")
        assert mod.fire("x.raise") is None and mod.hits("x.raise") == 3
        mod.arm("x.drop", "drop_conn", once=True)
        assert mod.fire("x.drop") == "drop_conn"
        assert mod.fire("x.drop") is None
        mod.arm("x.strict", "drop_conn")
        with pytest.raises(mod.FailpointError):
            mod.fire_strict("x.strict")
        mod.reset()
        assert not mod.ARMED


def test_histogram_exemplars_snapshot_as_the_reference():
    ctx = ttracing.new_context()
    tid = ttracing.exemplar_of(ctx)
    with ttracing.use(ctx):
        assert ttracing.current_id() == tid
    snaps = []
    for mod in (tstats, rstats):
        h = mod.Histogram("t.exemplars", [0.1, 1.0])
        for v, ex in ((0.05, "a"), (0.5, None), (0.7, "b"), (0.6, "c"),
                      (3.0, tid)):
            h.observe(v, exemplar=ex)
        snap = h.snapshot()
        for slot in snap["exemplars"].values():
            for e in slot.values():
                e.pop("ts")
        snaps.append((snap, mod.percentile(snap, 0.5),
                      mod.percentile(snap, 0.99, with_saturation=True)))
    assert snaps[0] == snaps[1]
    assert snaps[0][0]["exemplars"]["2"]["max"]["trace_id"] == tid
    ttracing.record_span("t.span", 1.0, 2.0, ctx, {"k": 1})
    ev = ttracing._get_buffer().drain()[-1]
    assert ev["event_type"] == "t.span" and ev["extra_data"]["tid"] == tid
