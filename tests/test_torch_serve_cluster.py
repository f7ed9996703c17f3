"""Port check: ray_tpu_torch.serve on the port's runtime, against the
reference model in this process.

One module-scoped cluster (`tests.test_torch_runtime.port_cluster`, with
its leak check at shutdown) and one `serve.start(http=True)` serve every
case. The reference tokens come from ray_tpu.serve.engine.ShardedTokenLM
in-process (no ray_tpu.init()); the deployments hold its weights in the
port's ShardedTokenLM. Cases:
- a request-level endpoint with batching, and a traffic split over two
  backends;
- a num_shards=2 continuous-batching gang against a request-level
  deployment of the same model, bit for bit, admissions interleaved;
- the SSE round trip (and the aggregate JSON reply) through the proxy;
- session affinity over two streaming replicas: a hit, then a miss;
- overload: a 503 carrying Retry-After from a bounded router queue;
- a LargePayload above large_payload_threshold, both ways;
- a gang whose members fail to construct: create_backend raises and
  no member, reservation or card share is left;
- a member killed mid-decode (`serve.decode_step=exit` armed in a
  follower): every open stream ends in typed ReplicaGroupDied within
  the group timeout, the surviving leader holds no page, and the
  restarted gang decodes exactly with no page leaked.

Left out, as the port lacks them yet: the reference's microbench gates
(tests/test_serve*.py `test_microbench_*`) and its state/doctor rows
(`ray-tpu state serve`, the stall doctor) — ROADMAP.md queue A items 4.6
and 4.7.
"""

import http.client
import json
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.serve.engine import ShardedTokenLM as RefLM
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch import serve
from ray_tpu_torch.serve.engine import ShardedTokenLM
from ray_tpu_torch.serve.streaming import iter_sse_lines
from tests.test_torch_runtime import port_cluster

cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT_S = 60.0
GROUP_TIMEOUT_S = 4.0


def _weights(seed):
    m = RefLM.make(seed)
    return m.embed.copy(), m.w_up.copy(), m.w_out.copy()


class SlowEcho:
    """Holds its replica for `delay` seconds a request."""

    def __init__(self, delay: float):
        self.delay = delay

    def __call__(self, data):
        time.sleep(self.delay)
        return data


class ByteSum:
    """bytes -> bytes of the same length, each byte + 1 (mod 256)."""

    def __call__(self, data):
        return (np.frombuffer(data, np.uint8) + 1).astype(np.uint8).tobytes()


def _deploy(client):
    """Every backend of the module, created once."""
    cfg = serve.BackendConfig
    client.create_backend("lm_a", ShardedTokenLM, *_weights(5),
                          config=cfg(max_batch_size=4,
                                     batch_wait_timeout=0.05))
    client.create_backend("lm_b", ShardedTokenLM, *_weights(6),
                          config=cfg(max_batch_size=4,
                                     batch_wait_timeout=0.05))
    client.create_endpoint("lm", backend="lm_a")
    client.create_endpoint("split", backend="lm_a")
    client.set_traffic("split", {"lm_a": 0.5, "lm_b": 0.5})
    client.create_backend(
        "gang", ShardedTokenLM, *_weights(5),
        config=cfg(streaming=True, num_shards=2, max_decode_batch=4,
                   kv_page_size=4, kv_pages_total=256,
                   shard_group_timeout_s=GROUP_TIMEOUT_S))
    client.create_endpoint("gang", backend="gang")
    client.create_backend(
        "aff", ShardedTokenLM, *_weights(8),
        config=cfg(streaming=True, num_replicas=2, max_decode_batch=4))
    client.create_endpoint("aff", backend="aff", route="/aff",
                           methods=["POST"])
    client.create_backend("slow", SlowEcho, 1.0,
                          config=cfg(max_queued_requests=1,
                                     max_concurrent_queries=1,
                                     overload_retry_after_s=2.5))
    client.create_endpoint("slow", backend="slow", route="/slow",
                           methods=["POST"])
    client.create_backend("bytes", ByteSum,
                          config=cfg(large_payload_threshold=1024))
    client.create_endpoint("bytes", backend="bytes", route="/bytes",
                           methods=["POST"])


@pytest.fixture(scope="module")
def client():
    with port_cluster(num_cpus=4):
        c = serve.start(http=True)
        try:
            _deploy(c)
            yield c
        finally:
            c.shutdown()


def _post(port, path, body: bytes, ctype="application/json", accept=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    headers = {"Content-Type": ctype}
    if accept:
        headers["Accept"] = accept
    conn.request("POST", path, body=body, headers=headers)
    return conn, conn.getresponse()


def _post_json(port, path, doc):
    """(status, headers, parsed body), retried while the proxy's route
    table has not synced yet (404)."""
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        conn, r = _post(port, path, json.dumps(doc).encode())
        body = r.read()
        conn.close()
        if r.status != 404:
            return r.status, dict(r.headers), json.loads(body)
        assert time.monotonic() < deadline, "route never synced"
        time.sleep(0.2)


def test_request_level_endpoint_batches(client):
    handle = client.get_handle("lm")
    cases = [([3, 5, 9], 24), ([1, 2], 5), ([7], 12), ([4, 4], 9)]
    refs = [handle.remote({"prompt": p, "max_tokens": m}) for p, m in cases]
    got = ray_tpu_torch.get(refs, timeout=TIMEOUT_S)
    for (p, m), toks in zip(cases, got):
        assert list(toks) == RefLM.make(5).generate(p, m)


def test_traffic_split_reaches_both_backends(client):
    handle = client.get_handle("split")
    want = {RefLM.make(s).generate([3, 1], 6)[0] for s in (5, 6)}
    assert len(want) == 2  # the two models answer apart
    refs = [handle.remote({"prompt": [3, 1], "max_tokens": 6})
            for _ in range(24)]
    got = [list(t) for t in ray_tpu_torch.get(refs, timeout=TIMEOUT_S)]
    seen = {tuple(t) for t in got}
    assert seen == {tuple(RefLM.make(s).generate([3, 1], 6))
                    for s in (5, 6)}


def test_gang_continuous_batching_matches_request_level(client):
    hs, hr = client.get_handle("gang"), client.get_handle("lm")
    cases = [([3, 5, 9], 24), ([1, 2], 5), ([7], 12)]
    got: dict = {}

    def one(i, prompt, max_tokens):
        got[i] = list(hs.stream({"prompt": prompt, "max_tokens": max_tokens},
                                timeout=TIMEOUT_S))

    threads = []
    for i, (p, m) in enumerate(cases):
        t = threading.Thread(target=one, args=(i, p, m))
        threads.append(t)
        t.start()
        time.sleep(0.05)  # interleaved admission, not one batch
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    reqlvl = ray_tpu_torch.get(
        [hr.remote({"prompt": p, "max_tokens": m}) for p, m in cases],
        timeout=TIMEOUT_S)
    for i, (p, m) in enumerate(cases):
        want = RefLM.make(5).generate(p, m)
        assert got[i] == want and list(reqlvl[i]) == want, i


def test_sse_round_trip_through_the_proxy(client):
    port = client.http_port
    ref = RefLM.make(8).generate([3, 5, 9], 40)
    status, _, doc = _post_json(port, "/aff",
                                {"prompt": [3, 5, 9], "max_tokens": 40})
    assert status == 200 and doc["result"] == ref
    conn, r = _post(port, "/aff", json.dumps(
        {"prompt": [3, 5, 9], "max_tokens": 40, "stream": True}).encode(),
        accept="text/event-stream")
    assert r.status == 200
    assert r.headers.get("Content-Type", "").startswith("text/event-stream")
    toks, events = [], []
    for ev, data in iter_sse_lines(r.fp):
        events.append(ev)
        if ev == "done":
            break
        if ev is None:
            toks.extend(data["tokens"])
    conn.close()
    assert events[0] == "meta" and events[-1] == "done"
    assert toks == ref


def test_session_affinity_hit_then_miss(client):
    handle = client.get_handle("aff")
    router = handle._router
    t1 = list(handle.stream({"prompt": [2, 3], "max_tokens": 4,
                             "session": "alice"}, timeout=TIMEOUT_S))
    assert t1 == RefLM.make(8).generate([2, 3], 4)
    misses = router.debug_state()["affinity_misses"]
    t2 = list(handle.stream({"prompt": [4], "max_tokens": 4,
                             "session": "alice"}, timeout=TIMEOUT_S))
    assert router.debug_state()["affinity_hits"] >= 1
    assert t2 == RefLM.make(8).generate([2, 3] + t1 + [4], 4)
    list(handle.stream({"prompt": [4], "max_tokens": 2, "session": "bob"},
                       timeout=TIMEOUT_S))
    assert router.debug_state()["affinity_misses"] == misses + 1
    state = ray_tpu_torch.get(
        client._controller.get_routing_state.remote("aff"), timeout=TIMEOUT_S)
    infos = ray_tpu_torch.get(
        [r.engine_state.remote() for r in state["backends"]["aff"]["replicas"]],
        timeout=TIMEOUT_S)
    cached = [i["sessions"]["alice"] for i in infos
              if i["sessions"].get("alice")]
    assert cached == [2 + len(t1) + 1 + len(t2)]


def test_overload_is_a_503_with_retry_after(client):
    port = client.http_port
    _post_json(port, "/slow", 0)  # route synced, replica warm
    out = []

    def one():
        out.append(_post_json(port, "/slow", 1))

    threads = [threading.Thread(target=one) for _ in range(5)]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    shed = [(h, d) for s, h, d in out if s == 503]
    assert shed and any(s == 200 for s, _, _ in out), out
    headers, doc = shed[0]
    assert headers["Retry-After"] == "2.5"
    assert doc["type"] == "ServeOverloadedError"


def test_large_payload_rides_the_store(client):
    port = client.http_port
    _post_json(port, "/bytes", None)  # route synced (a JSON 500 is fine)
    body = np.random.default_rng(0).integers(0, 256, 5000,
                                             dtype=np.uint8).tobytes()
    conn, r = _post(port, "/bytes", body, ctype="application/octet-stream")
    got = r.read()
    conn.close()
    assert r.status == 200
    assert r.headers["Content-Type"] == "application/octet-stream"
    assert got == (np.frombuffer(body, np.uint8) + 1).astype(
        np.uint8).tobytes()
    small = b"\x01\x02\x03"
    conn, r = _post(port, "/bytes", small, ctype="application/octet-stream")
    assert r.read() == b"\x02\x03\x04"
    conn.close()


def test_failed_gang_bootstrap_tears_everything_down(client):
    """A gang whose callable has no shard protocol fails in its members'
    constructors: create_backend raises, and no member, reservation or
    card share is left behind."""
    from ray_tpu_torch.util.placement_group import placement_group_table

    before = ray_tpu_torch.available_resources()
    with pytest.raises(Exception, match="shard"):
        client.create_backend("noshard", SlowEcho, 0.0,
                              config=serve.BackendConfig(num_shards=2))
    assert "noshard" not in client.list_backends()
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        live = [pg for pg in placement_group_table().values()
                if pg["name"].startswith("serve-gang-noshard")
                and pg["state"] != "REMOVED"]
        if not live and ray_tpu_torch.available_resources() == before:
            break
        assert time.monotonic() < deadline, (live,
                                             ray_tpu_torch.available_resources())
        time.sleep(0.2)


def test_member_killed_mid_decode_is_typed_and_leaks_nothing(client):
    handle = client.get_handle("gang")
    ref = RefLM.make(5).generate([3, 5], 8)
    assert list(handle.stream({"prompt": [3, 5], "max_tokens": 8},
                              timeout=TIMEOUT_S)) == ref
    gangs = ray_tpu_torch.get(
        client._controller.get_gang_members.remote("gang"), timeout=TIMEOUT_S)
    ray_tpu_torch.get(gangs[0][1].arm_failpoint.remote(
        "serve.decode_step", "exit", nth=3), timeout=TIMEOUT_S)
    errors = []

    def one(prompt):
        try:
            for _ in handle.stream({"prompt": prompt, "max_tokens": 100000},
                                   timeout=TIMEOUT_S):
                pass
        except BaseException as e:
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(p,))
               for p in ([3, 5], [1, 2, 3])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert [type(e) for e in errors] == [exc.ReplicaGroupDied] * 2, errors
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S + 15.0
    # the surviving leader's engine died typed and freed every page
    dead = ray_tpu_torch.get(gangs[0][0].engine_state.remote(),
                             timeout=TIMEOUT_S)
    assert "ReplicaGroupDied" in dead["dead"]
    assert dead["kv"]["pages_in_use"] == 0 and dead["kv"]["owners"] == {}
    assert dead["kv_leaked"] == []

    deadline = time.monotonic() + TIMEOUT_S
    while True:  # the controller restarts the gang
        try:
            out = list(handle.stream({"prompt": [3, 5], "max_tokens": 8},
                                     timeout=20.0))
            break
        except (exc.ReplicaGroupDied, exc.ActorDiedError,
                exc.ActorUnavailableError, exc.SequenceAborted,
                TimeoutError, RuntimeError):
            assert time.monotonic() < deadline, "the gang never came back"
            time.sleep(0.5)
    assert out == ref
    fresh = ray_tpu_torch.get(
        client._controller.get_gang_members.remote("gang"), timeout=TIMEOUT_S)
    assert fresh[0][0] != gangs[0][0]
    for member in fresh[0]:
        deadline = time.monotonic() + TIMEOUT_S
        while True:
            st = ray_tpu_torch.get(member.engine_state.remote(),
                                   timeout=TIMEOUT_S)
            if st["kv"]["pages_in_use"] == 0:
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.2)
        assert st["kv_leaked"] == [] and st["dead"] == ""
