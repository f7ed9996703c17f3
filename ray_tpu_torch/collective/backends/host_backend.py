"""HOST backend: cross-process collectives with a tiered data plane;
port of ray_tpu/collective/backends/host_backend.py (reference:
python/ray/util/collective/collective_group/ — NCCLGroup :115 and the MPI
stub).

One `HostGroup` is one rank, in its own process. Rendezvous goes through
the GCS KV: rank 0 binds a TCP hub, publishes its address under
`collective/<group>`, and every other rank connects. The ranks then
exchange their cards over the hub, once: that fixes which tiers the group
can vote for.

Tiers, tried per op in this order; the two device tiers by a unanimous
1-byte vote (a hub ctl round with its own kind tag, so that ranks whose
routes diverged pair as a loud kind mismatch, never a silent payload
swap); a rank holding a payload the tier cannot take vetoes, and every
rank falls through together. A tier that broke on a rank (its build,
its IPC mapping or process group, a failed op) is no veto: that rank's
vote makes every rank raise, for this op and every later one it would
have carried, so that a CUDA payload never moves to a host tier after a
failure:

pallas — the fused ring kernels (backends/pallas_backend.py), when every
        rank holds a CUDA card (shared or its own) and a CUDA payload of
        a built instance. The peers' buffers are mapped through CUDA IPC.
        The reference's size gate holds where every rank holds a card of
        its own: an op above `PALLAS_MAX_BYTES` (64 KB, from the same
        environment variable) skips the vote and falls through to the
        device tier, NCCL, and a forced "pallas" pin is device-like there
        (host_backend.py:567-568, :789-794). Two cases are the port's
        own decision. Where ranks share a card every size stays here:
        NCCL refuses two ranks on one card, and the host tiers would copy
        every CUDA payload through the host; a TPU chip is never shared
        between processes, so the reference has no such case. A quantized
        op (int8 wire) stays here at every size too: NCCL has no int8
        wire, so the device tier's int8 ring is plain PyTorch over
        point-to-point sends, several times slower than the int8 kernel
        (PERF.md section 6).
device — a torch.distributed process group of the group's own
        (parallel/multihost.py; backends/device_backend.py): NCCL when
        every rank holds a card of its own (NCCL refuses two ranks on one
        card, so such a group never votes for it), gloo when every rank
        is on the CPU and the tier is forced.
shm   — ranks on one node map one tmpfs segment (shm_transport.py).
ring  — direct rank-to-rank TCP ring, chunk-pipelined and zero-copy;
        `ring_unpipelined` is the reference's unpipelined allreduce (the
        A/B control arm). With `quantize="int8"` the pipelined ring's
        allreduce and reduce-scatter wire is block-scaled int8.
hub   — star topology through rank 0's socket; carries every op kind.

Payloads are torch tensors (on the CPU or a card) or numpy arrays. The
host tiers carry numpy: a tensor goes through a host copy (`_to_host`,
as the reference's) and its result comes back as a tensor on the
payload's device; bfloat16 has no numpy dtype and so no host tier.

Every tier keeps the abort-not-hang contract: a dead peer turns into a
TimeoutError within the group timeout on every survivor (hub per-op
timeouts naming the ranks that did not arrive, ring socket timeouts and
teardown, the shm barrier deadline and abort word, the host's bounded
waits for the peers' events of the fused kernels' phases).

Not ported from the reference: the failpoints, the debug-state rows and
the placement-derived transport (`placement_plan`); ROADMAP.md A4 and A5.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import msgpack
import numpy as np
import torch

from ray_tpu_torch.collective import metrics as _cm
from ray_tpu_torch.collective.backends.device_backend import split_bounds
from ray_tpu_torch.collective.backends.shm_transport import (ShmTransport,
                                                              result_dtype)
from ray_tpu_torch.collective.types import (_NUMPY_REDUCE, QUANT_BLOCK,
                                            ReduceOp, Transport,
                                            is_cuda_tensor,
                                            normalize_quantize)
from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.native.store import is_shared_memory_path

_HDR = struct.Struct(">I")

# ops the int8 block-scaled wire format can carry (the reduce happens on
# dequantized float32; PRODUCT would compound the per-hop error
# multiplicatively, so it stays exact)
# a vote of a rank whose device tier broke: every rank raises
_BROKEN = 2
_QUANT_OPS = (ReduceOp.SUM, ReduceOp.MEAN, ReduceOp.MAX, ReduceOp.MIN)


def _quant_np(x: np.ndarray):
    """Block-scaled symmetric int8 (numpy twin of
    xla_backend.quantize_blocks — same block size and scale rule, so the
    host-ring and device-ring formats agree, and so does the analytic
    error bound): flat float32 [n] (n % QUANT_BLOCK == 0) ->
    (int8 [n], float32 scales [n // QUANT_BLOCK])."""
    b = x.reshape(-1, QUANT_BLOCK)
    absmax = np.max(np.abs(b), axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(b / scale[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scale


def _dequant_np(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return (q.reshape(-1, QUANT_BLOCK).astype(np.float32)
            * scale[:, None]).reshape(-1)


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b""):
    h = msgpack.packb(header, use_bin_type=True)
    sock.sendall(_HDR.pack(len(h)) + h + _HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("collective peer disconnected")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    (hlen,) = _HDR.unpack(_recv_exact(sock, 4))
    header = msgpack.unpackb(_recv_exact(sock, hlen), raw=False)
    (plen,) = _HDR.unpack(_recv_exact(sock, 4))
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


def _arr_meta(arr: np.ndarray) -> dict:
    return {"dtype": arr.dtype.str, "shape": list(arr.shape)}


def _arr_from(meta: dict, payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype=np.dtype(meta["dtype"])).reshape(
        meta["shape"]).copy()


def _reduce(arrays: list[np.ndarray], op: ReduceOp) -> np.ndarray:
    if op == ReduceOp.MEAN:
        return np.mean(np.stack(arrays), axis=0)
    ufunc = getattr(np, _NUMPY_REDUCE[ReduceOp(op)])
    out = arrays[0].copy()
    for arr in arrays[1:]:
        out = ufunc(out, arr)
    return out


class _CollectiveState:
    """Hub-side shared op table. contribute() blocks until the op's result
    is ready; the last contributor computes it."""

    def __init__(self, world_size: int, sweep_timeout: float = 600.0):
        self.world_size = world_size
        self.sweep_timeout = sweep_timeout
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.ops: dict[int, dict] = {}
        self.mailboxes: dict[tuple[int, int, int], tuple[dict, bytes]] = {}

    def _sweep_locked(self):
        """Completed-but-unread ops leak when a rank dies after
        contributing but before reading (e.g. rank 0 interrupted inside
        its local contribute — its arrival completes the op later, but
        its reader slot never fills, so `readers` can't reach
        world_size). Drop done ops past the sweep deadline, mirroring
        the timeout-withdraw path for incomplete ones."""
        now = time.monotonic()
        dead = [op_id for op_id, op in self.ops.items()
                if op.get("done")
                and now - op.get("done_at", now) > self.sweep_timeout]
        for op_id in dead:
            del self.ops[op_id]

    def contribute(self, op_id: int, kind: str, rank: int, meta: dict,
                   payload: bytes, timeout: float = 300.0):
        with self.cv:
            self._sweep_locked()
            op = self.ops.setdefault(op_id, {"arrivals": {}, "result": None,
                                             "done": False})
            op["arrivals"][rank] = (kind, meta, payload)
            if len(op["arrivals"]) == self.world_size:
                try:
                    op["result"] = self._compute(kind, op["arrivals"])
                except Exception as e:  # mismatched kinds/dtypes: surface
                    op["error"] = str(e)  # to every rank, don't hang them
                op["done"] = True
                op["done_at"] = time.monotonic()
                self.cv.notify_all()
            else:
                deadline = time.monotonic() + timeout
                while not op["done"]:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # Withdraw this rank's contribution so a late
                        # straggler can't complete the op with data the
                        # timed-out ranks already abandoned (silent
                        # divergence); last withdrawer frees the op.
                        op["arrivals"].pop(rank, None)
                        if not op["arrivals"]:
                            self.ops.pop(op_id, None)
                        missing = sorted(set(range(self.world_size))
                                         - set(op["arrivals"]) - {rank})
                        raise TimeoutError(
                            f"collective op {op_id} ({kind}) timed out: "
                            f"{len(op['arrivals']) + 1}/{self.world_size} "
                            f"arrived; waited for rank(s) {missing}")
                    self.cv.wait(remaining)
            result = op["result"]
            err = op.get("error")
            # last reader cleans up (pop: the sweep may have beaten us)
            op.setdefault("readers", set()).add(rank)
            if len(op["readers"]) == self.world_size:
                self.ops.pop(op_id, None)
        if err is not None:
            raise ValueError(f"collective op {op_id} failed: {err}")
        return result

    def _compute(self, kind: str, arrivals: dict):
        ranks = sorted(arrivals)
        kinds = {arrivals[r][0] for r in ranks}
        if len(kinds) != 1:  # not an assert: must survive python -O —
            # this is the loud-failure net for route divergence
            raise ValueError(f"mismatched collective kinds: {kinds}")
        metas = {r: arrivals[r][1] for r in ranks}
        payloads = {r: arrivals[r][2] for r in ranks}
        if kind == "barrier":
            return {"kind": "barrier"}
        if kind == "broadcast":
            src = metas[ranks[0]]["src"]
            return {"kind": "bcast", "meta": metas[src],
                    "payload": payloads[src]}
        if kind in ("allreduce", "reduce"):
            op = ReduceOp(metas[ranks[0]]["op"])
            arrays = [_arr_from(metas[r], payloads[r]) for r in ranks]
            out = _reduce(arrays, op)
            return {"kind": kind, "meta": _arr_meta(out),
                    "payload": out.tobytes(),
                    "dst": metas[ranks[0]].get("dst", -1)}
        if kind in ("allgather", "allgather_ctl_shm",
                    "allgather_ctl_ring", "allgather_ctl_device",
                    "allgather_ctl_pallas", "allgather_ctl_ident",
                    "allgather_ctl_ipc"):
            # ctl kinds: transport-plumbing exchanges (ring addresses,
            # shm ok flags, the ranks' cards, CUDA IPC handles), one
            # kind EACH so a rank whose ROUTE diverged
            # (ragged sizes straddling RING_MIN_BYTES) pairs with a real
            # allgather as a kind mismatch — a loud ValueError on every
            # rank, never a silent payload swap.
            return {"kind": "allgather",
                    "metas": [metas[r] for r in ranks],
                    "payloads": [payloads[r] for r in ranks]}
        if kind == "allgather_meta":
            # metadata-only control round for the ring data plane: a rank
            # that routed the payload to the ring must never pair with a
            # payload-carrying hub allgather (kind mismatch asserts above)
            return {"kind": "allgather",
                    "metas": [metas[r] for r in ranks],
                    "payloads": [b"" for _ in ranks]}
        if kind == "reducescatter":
            op = ReduceOp(metas[ranks[0]]["op"])
            arrays = [_arr_from(metas[r], payloads[r]) for r in ranks]
            out = _reduce(arrays, op)
            chunks = np.array_split(out, len(ranks), axis=0)
            return {"kind": "reducescatter",
                    "metas": [_arr_meta(c) for c in chunks],
                    "payloads": [np.ascontiguousarray(c).tobytes()
                                 for c in chunks]}
        raise ValueError(f"unknown collective kind {kind!r}")

    # p2p
    def post(self, src: int, dst: int, tag: int, meta: dict, payload: bytes):
        with self.cv:
            self.mailboxes[(src, dst, tag)] = (meta, payload)
            self.cv.notify_all()

    def take(self, src: int, dst: int, tag: int, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        with self.cv:
            while (src, dst, tag) not in self.mailboxes:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"recv from {src} tag {tag} timed out")
                self.cv.wait(remaining)
            return self.mailboxes.pop((src, dst, tag))


class HostGroup:
    """One rank of a collective group, in this process (reference:
    host_backend.py:305)."""

    RING_MIN_BYTES = 1 << 16
    _PIPE_BYTES = 1 << 18  # ring pipeline slice: reduce(k) overlaps recv(k+1)
    # PALLAS tier size ceiling where every rank holds a card of its own:
    # larger unquantized payloads fall through to DEVICE (NCCL), the
    # bandwidth shape.
    # Group-uniform by the collective contract (same-geometry payloads).
    PALLAS_MAX_BYTES = int(os.environ.get(
        "RAY_TPU_COLLECTIVE_PALLAS_MAX_KB", "64")) << 10
    # Segments grow by rebuild but never shrink, so one oversize op would
    # pin (w+2)*slot of tmpfs for the group's life; above the cap the
    # ring carries the op with no resident cost. Forced shm overrides.
    SHM_MAX_SLOT_BYTES = 32 << 20

    def __init__(self, group_name: str, world_size: int, rank: int,
                 timeout: float = 60.0, transport: str = "auto",
                 quantize=None):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a group of {world_size}")
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        # Rendezvous AND per-op timeout: ops abort (not hang) when a peer
        # dies mid-collective, so the SGD layer can resize the group.
        self._timeout = timeout
        self._op_id = 0
        self._key = f"collective/{group_name}"
        self._sock: socket.socket | None = None
        self._destroyed = False
        # force_transport pins every op to one tier (tests, benchmarks,
        # the trainer's collective_transport); "auto" routes per op
        tr = Transport(transport)
        self.force_transport = None if tr == Transport.AUTO else tr.value
        # group-default wire quantization (per-op quantize= overrides)
        self.quantize = normalize_quantize(quantize)
        # device tiers: built lazily at the first unanimous vote; which
        # tiers the group may vote for is decided once, from the ranks'
        # cards (_exchange_cards); *_error is what broke that tier on this
        # rank (its build, its IPC mapping, a launch): from then on every
        # op this rank would give that tier raises on every rank
        self._device = None
        self._device_error = None
        self._device_shaped = False
        self._pallas = None
        self._pallas_error = None
        self._pallas_shaped = False
        self._blocks = 1
        self._shm = None
        self._shm_gen = 0
        self._shm_disabled = False
        self._shm_keys: list[str] = []
        # buffered peer-direct sends awaiting their receiver, ONE per
        # (dst, tag): a re-send overwrites the unclaimed predecessor
        # (hub-mailbox semantics — keeps loop-sends to a wedged receiver
        # from pinning unbounded snapshots/fds); destroy() reaps the rest
        self._p2p_direct: dict[tuple[int, int], socket.socket] = {}
        self._p2p_lock = threading.Lock()
        if world_size == 1:
            self._state = _CollectiveState(1, sweep_timeout=timeout * 2)
            return
        if rank == 0:
            self._state = _CollectiveState(world_size,
                                           sweep_timeout=timeout * 2)
            self._listener = socket.socket()
            self._listener.bind(("127.0.0.1", 0))
            self._listener.listen(world_size)
            port = self._listener.getsockname()[1]
            internal_kv._kv_put(
                self._key,
                msgpack.packb({"addr": f"127.0.0.1:{port}",
                               "world_size": world_size}))
            self._conn_threads = []
            accept_thread = threading.Thread(target=self._accept_loop,
                                             daemon=True)
            accept_thread.start()
        else:
            deadline = time.monotonic() + timeout
            info = None
            while time.monotonic() < deadline:
                data = internal_kv._kv_get(self._key)
                if data:
                    info = msgpack.unpackb(data, raw=False)
                    break
                time.sleep(0.05)
            if info is None:
                raise TimeoutError(
                    f"rendezvous for group {group_name!r} timed out")
            if info["world_size"] != world_size:
                raise ValueError("world_size mismatch at rendezvous")
            host, port = info["addr"].rsplit(":", 1)
            self._sock = socket.create_connection((host, int(port)),
                                                  timeout=timeout)
            self._sock.settimeout(None)
            _send_msg(self._sock, {"hello": rank})
        self._exchange_cards()

    # ---- hub side ----
    def _accept_loop(self):
        joined = 0
        while joined < self.world_size - 1:
            conn, _ = self._listener.accept()
            hello, _ = _recv_msg(conn)
            t = threading.Thread(target=self._serve_conn,
                                 args=(conn, hello["hello"]), daemon=True)
            t.start()
            self._conn_threads.append(t)
            joined += 1

    def _serve_conn(self, conn: socket.socket, peer_rank: int):
        try:
            while True:
                header, payload = _recv_msg(conn)
                kind = header["kind"]
                if kind == "p2p_send":
                    self._state.post(peer_rank, header["dst"], header["tag"],
                                     header["meta"], payload)
                    _send_msg(conn, {"ok": True})
                elif kind == "p2p_recv":
                    try:
                        meta, data = self._state.take(
                            header["src"], peer_rank, header["tag"],
                            timeout=self._timeout)
                    except TimeoutError as e:
                        # TimeoutError is an OSError: without this reply
                        # the outer except would eat it and the client
                        # would block forever on a reply that never comes
                        _send_msg(conn, {"error": str(e), "timeout": True})
                        continue
                    _send_msg(conn, {"meta": meta}, data)
                else:
                    try:
                        result = self._state.contribute(
                            header["op_id"], kind, peer_rank, header["meta"],
                            payload, timeout=self._timeout)
                    except Exception as e:
                        _send_msg(conn, {
                            "error": str(e),
                            "timeout": isinstance(e, TimeoutError)})
                        continue
                    reply, data = self._slice_result(result, peer_rank, kind)
                    _send_msg(conn, reply, data)
        except (ConnectionError, OSError):
            pass

    @staticmethod
    def _slice_result(result: dict, rank: int, kind: str):
        if result["kind"] == "barrier":
            return {"barrier": True}, b""
        if result["kind"] in ("bcast", "allreduce"):
            return {"meta": result["meta"]}, result["payload"]
        if result["kind"] == "reduce":
            if rank == result["dst"]:
                return {"meta": result["meta"]}, result["payload"]
            return {"meta": None}, b""
        if result["kind"] == "allgather":
            return ({"metas": result["metas"],
                     "sizes": [len(p) for p in result["payloads"]]},
                    b"".join(result["payloads"]))
        if result["kind"] == "reducescatter":
            return {"meta": result["metas"][rank]}, result["payloads"][rank]
        raise ValueError(result["kind"])

    # ---- the ranks' cards: which device tiers the group votes for ----

    @staticmethod
    def _card() -> tuple[str, int] | None:
        """This process's current CUDA card (its UUID and SM count), or
        None without CUDA."""
        if not torch.cuda.is_available():
            return None
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return str(props.uuid), int(props.multi_processor_count)

    def _exchange_cards(self):
        """One hub round at construction, so that every rank decides the
        same (the reference reads the multihost runtime's size, a fact of
        the whole group, at this point): the PALLAS tier when every rank
        holds a card; the DEVICE tier when every rank holds a card of its
        own, or when every rank is on the CPU and the tier is forced
        (gloo); the fused kernels' grid cap, SMs / (2 x ranks on the
        busiest card), so that every rank's kernel fits beside the
        others' work."""
        card = self._card()
        mine = msgpack.packb(list(card) if card else None)
        cards = [msgpack.unpackb(bytes(a), raw=False)
                 for a in self._hub_allgather(np.frombuffer(mine, np.uint8),
                                              kind="allgather_ctl_ident")]
        if all(c is not None for c in cards):
            uuids = [c[0] for c in cards]
            per_card = max(uuids.count(u) for u in uuids)
            self._pallas_shaped = True
            self._device_shaped = per_card == 1
            self._blocks = 2 * min(c[1] for c in cards)
        elif all(c is None for c in cards):
            self._device_shaped = (self.force_transport
                                   == Transport.DEVICE.value)

    # ---- participant ----
    def _next_op(self) -> int:
        self._op_id += 1
        return self._op_id

    def _collective(self, kind: str, meta: dict, payload: bytes):
        op_id = self._next_op()
        if self.rank == 0 or self.world_size == 1:
            result = self._state.contribute(op_id, kind, 0, meta, payload,
                                            timeout=self._timeout)
            return self._slice_result(result, 0, kind)
        _send_msg(self._sock, {"kind": kind, "op_id": op_id, "meta": meta},
                  payload)
        reply, data = _recv_msg(self._sock)
        if "error" in reply:
            if reply.get("timeout", True):
                raise TimeoutError(reply["error"])
            raise ValueError(reply["error"])
        return reply, data

    def _hub_allgather(self, arr: np.ndarray,
                       kind: str = "allgather") -> list[np.ndarray]:
        reply, data = self._collective(kind, _arr_meta(arr),
                                       arr.tobytes())
        out, offset = [], 0
        for m, size in zip(reply["metas"], reply["sizes"]):
            out.append(_arr_from(m, data[offset:offset + size]))
            offset += size
        return out

    def _hub_allgather_meta(self, meta: dict) -> list[dict]:
        """Metadata-only allgather (control round for the ring plane)."""
        reply, _ = self._collective("allgather_meta", meta, b"")
        return reply["metas"]

    # ---- transport routing ----
    # The hub is latency-optimal for control-sized tensors but serializes
    # all-to-hub bandwidth through one socket — wrong for gradients
    # (reference role: gloo's ring algorithms behind torch.distributed).
    # Large tensors take the shm segment when the whole group shares a
    # node, else the direct rank-to-rank TCP ring.

    def _route(self, arr: np.ndarray) -> list[str]:
        """Ordered transport candidates for one op. All ranks compute the
        same route (collectives pass same-geometry tensors by contract;
        ragged allgather is caught by the allgather_meta control round)."""
        f = self.force_transport
        if f:
            return [f]
        if (self._destroyed or self.world_size == 1 or arr.ndim == 0
                or arr.ndim > 24 or arr.nbytes < self.RING_MIN_BYTES):
            return [Transport.HUB.value]
        tiers = []
        if (not self._shm_disabled
                and arr.nbytes <= self.SHM_MAX_SLOT_BYTES):
            tiers.append(Transport.SHM.value)
        if self.world_size > 2:  # 2-rank ring degenerates to pairwise
            tiers.append(Transport.RING.value)
        tiers.append(Transport.HUB.value)
        return tiers

    def _forced_unavailable(self, tr: str):
        if self.force_transport == tr:
            raise RuntimeError(
                f"forced collective transport {tr!r} is unavailable for "
                f"group {self.group_name!r} (world={self.world_size})")

    @staticmethod
    def _abort_not_hang(e: Exception):
        """Normalize transport failures: a dead/stalled peer surfaces as
        TimeoutError on every survivor (the contract the SGD resize path
        keys on); programmer errors (dtype/shape mismatch) pass through."""
        if isinstance(e, (ConnectionError, OSError)) and not isinstance(
                e, TimeoutError):
            raise TimeoutError(f"collective aborted: {e}") from e
        raise e

    # ---- payloads: torch tensors to the host tiers and back ----

    @staticmethod
    def _to_host(arr) -> np.ndarray:
        """The payload as a contiguous numpy array: a tensor through a
        host copy (a CUDA tensor's waits for its stream)."""
        if isinstance(arr, torch.Tensor):
            if arr.dtype == torch.bfloat16:
                raise TypeError("bfloat16 has no numpy dtype: the host "
                                "tiers cannot carry it; the device tiers "
                                "can")
            arr = arr.detach().cpu().numpy()
        return np.ascontiguousarray(arr)

    @staticmethod
    def _deliver(out: np.ndarray, like):
        """A host tier's numpy result in the payload's kind: a tensor on
        the payload's device for a tensor, numpy for numpy."""
        if not isinstance(like, torch.Tensor):
            return out
        if not (out.flags.writeable and out.flags.c_contiguous):
            out = np.array(out)
        return torch.from_numpy(out).to(like.device)

    @staticmethod
    def _meta(arr) -> dict:
        """dtype and shape of a payload, for the allgather's meta round."""
        if isinstance(arr, torch.Tensor):
            return {"dtype": str(arr.dtype), "shape": list(arr.shape)}
        return _arr_meta(np.asarray(arr))

    def _quantize_mode(self, quantize):
        """Per-op override (False forces exact) else the group default."""
        return (self.quantize if quantize is None
                else normalize_quantize(quantize))

    # ---- the device tiers and their votes ----

    def _vote(self, vote: int, kind: str, tier: str,
              error: Exception | None) -> bool:
        """One 1-byte hub round: True when every rank voted 1. A rank whose
        tier broke votes _BROKEN, and then every rank raises: a payload
        that tier should carry never moves to another tier."""
        flags = [int(f[0]) for f in self._hub_allgather(
            np.array([vote], np.uint8), kind=kind)]
        broken = [r for r, f in enumerate(flags) if f == _BROKEN]
        if broken:
            msg = (f"collective transport {tier!r} of group "
                   f"{self.group_name!r} failed on rank(s) {broken}")
            if error is None:
                raise RuntimeError(msg)
            cls = TimeoutError if isinstance(error, TimeoutError) \
                else RuntimeError
            raise cls(f"{msg}: {error}") from error
        return all(f == 1 for f in flags)

    def _ensure_device(self):
        if self._device is None:
            from ray_tpu_torch.collective.backends.device_backend import (
                DeviceTransport)
            from ray_tpu_torch.parallel import multihost

            on_cuda = torch.cuda.is_available()
            device = (torch.device("cuda", torch.cuda.current_device())
                      if on_cuda else torch.device("cpu"))
            pg = multihost.process_group(
                self.group_name, self.world_size, self.rank,
                "nccl" if on_cuda else "gloo", timeout=self._timeout)
            self._device = DeviceTransport.over(pg, self.world_size,
                                                self.rank, device)
        return self._device

    def _device_route(self, arr) -> bool:
        """Per-op DEVICE-tier agreement. True when EVERY rank voted device
        (its payload is a CUDA tensor of a dtype the tier carries, or the
        tier is forced). Only groups shaped for the tier pay the round."""
        forced = self.force_transport
        # a PALLAS pin is a refinement of the device plane: op kinds the
        # kernels do not carry fall through HERE, so the pin behaves like
        # a device pin for them instead of raising
        device_like = (Transport.DEVICE.value, Transport.PALLAS.value)
        if forced is not None and forced not in device_like:
            return False
        if not self._device_shaped or self._destroyed:
            if forced in device_like:
                self._forced_unavailable(forced)
            return False
        vote = 0
        if forced in device_like or is_cuda_tensor(arr):
            if self._device_error is None:
                try:
                    vote = int(self._ensure_device().dtype_ok(arr.dtype))
                except Exception as e:
                    self._device_error = e
            if self._device_error is not None:
                vote = _BROKEN
        agreed = self._vote(vote, "allgather_ctl_device", "device",
                            self._device_error)
        if not agreed and forced == Transport.DEVICE.value:
            raise RuntimeError(
                f"forced collective transport 'device' is unavailable "
                f"for group {self.group_name!r}: the placement/dtype "
                f"vote was not unanimous")
        return agreed

    def _device_op(self, fn):
        try:
            return fn()
        except Exception as e:
            # a failed device op leaves the process group's state unknown:
            # every later op this rank would give it raises (_vote)
            self._device_error = e
            self._abort_not_hang(e)

    def _ensure_pallas(self):
        if self._pallas is None:
            from ray_tpu_torch.collective.backends.pallas_backend import (
                PallasTransport)

            self._pallas = PallasTransport(
                self.world_size, self.rank,
                torch.device("cuda", torch.cuda.current_device()),
                self._timeout, self._exchange_bytes, self._blocks)
        return self._pallas

    def _exchange_bytes(self, mine: bytes) -> list[bytes]:
        """Every rank's bytes, in rank order (the kernels' IPC handles)."""
        return [bytes(a) for a in self._hub_allgather(
            np.frombuffer(mine, np.uint8), kind="allgather_ctl_ipc")]

    def _pallas_route(self, arr, kind: str, op=ReduceOp.SUM,
                      quantize=None) -> bool:
        """Per-op PALLAS-tier agreement, mirroring _device_route: a
        1-byte hub ctl round with its own kind tag decides whether EVERY
        rank runs the fused kernel. A rank votes 1 for a CUDA payload whose
        op reaches a built kernel instance; for a CUDA payload a failure of
        the tier (its build, its IPC mapping, an earlier launch) raises on
        every rank instead of sending the payload to another tier. Where
        every rank holds a card of its own, an unquantized op above
        PALLAS_MAX_BYTES skips the round and falls through to
        _device_route, as the reference's (a forced pallas pin is
        device-like there); where ranks share a card, and for a quantized
        op, every size votes here."""
        forced = self.force_transport
        if forced is not None and forced != Transport.PALLAS.value:
            return False
        if not self._pallas_shaped or self._destroyed:
            if forced == Transport.PALLAS.value:
                self._forced_unavailable(forced)
            return False
        if (self._device_shaped and quantize is None
                and getattr(arr, "nbytes", 0) > self.PALLAS_MAX_BYTES):
            return False
        vote = 0
        if is_cuda_tensor(arr):
            if self._pallas_error is None:
                try:
                    vote = int(self._ensure_pallas().supports(
                        kind, arr, op, quantize))
                except Exception as e:
                    self._pallas_error = e
            if self._pallas_error is not None:
                vote = _BROKEN
        agreed = self._vote(vote, "allgather_ctl_pallas", "pallas",
                            self._pallas_error)
        if not agreed and forced == Transport.PALLAS.value:
            raise RuntimeError(
                f"forced collective transport 'pallas' is unavailable "
                f"for group {self.group_name!r}: the placement/dtype "
                f"vote was not unanimous")
        return agreed

    def _pallas_op(self, fn):
        try:
            return fn()
        except Exception as e:
            # the peers' phase counters are out of step now: every later
            # op this rank would give the kernels raises (_vote)
            self._pallas_error = e
            self._abort_not_hang(e)

    def _shm_op(self, fn):
        try:
            out = fn()
        except Exception as e:
            # any failure mid-op leaves ranks at different barrier phases:
            # poison the segment (peers abort, not hang) and never reuse it
            t, self._shm = self._shm, None
            if t is not None:
                try:
                    t.abort()
                finally:
                    # EVERY survivor unlinks, not just rank 0: rank 0 may
                    # be the rank that died between the segment's map and
                    # its unlink (unlink is idempotent)
                    t.close(unlink=True)
            self._shm_disabled = True
            self._abort_not_hang(e)
        _cm.SHM_OPS += 1
        return out

    def _ring_op(self, fn):
        try:
            return fn()
        except Exception as e:
            # a failed ring op leaves peers at different steps: the
            # connections are unusable, rebuild from scratch next op
            self._ring_teardown()
            self._abort_not_hang(e)

    # ---- shm data plane ----

    @staticmethod
    def _node_token() -> str | None:
        from ray_tpu_torch._private import global_state

        cw = global_state.get_core_worker()
        if cw is not None and cw.node_id is not None:
            return cw.node_id.hex()
        return None

    def _ensure_shm(self, need_bytes: int):
        """Map (or grow) the group's shared segment. Every rank computes
        the same need (collective contract), so rebuild generations stay
        aligned without extra coordination; the ok-flag allgather through
        the hub makes enable/disable unanimous."""
        if self._shm_disabled or self.world_size == 1 or self._destroyed:
            return None
        if (need_bytes > self.SHM_MAX_SLOT_BYTES
                and self.force_transport != Transport.SHM.value):
            # result-dtype promotion (e.g. int8 MEAN -> float64) can
            # inflate the slot well past the routed nbytes; enforce the
            # tmpfs budget on the real slot need (forced shm overrides)
            return None
        if self._shm is not None and self._shm.slot_bytes >= need_bytes:
            return self._shm
        if self._shm is not None:  # grow: all ranks rebuild together
            self._shm.close()
            self._shm = None
        slot = max(1 << 20, 1 << (need_bytes - 1).bit_length())
        self._shm_gen += 1
        key = f"{self._key}/shm{self._shm_gen}"
        seg, ok = None, 0
        if self.rank == 0:
            self._shm_keys.append(key)  # destroy() clears even fail markers
        try:
            if self.rank == 0:
                cookie = os.urandom(16)
                name = (f"{self.group_name}_g{self._shm_gen}_"
                        f"{cookie.hex()[:8]}.seg")
                try:
                    seg = ShmTransport.create(name, cookie, self.world_size,
                                              0, slot, self._timeout)
                    token = self._node_token()
                    if token is None and not is_shared_memory_path(seg.path):
                        # without a node id, only /dev/shm placement
                        # proves the mapping is node-local memory
                        raise RuntimeError(
                            "no node identity and segment not on /dev/shm")
                    internal_kv._kv_put(key, msgpack.packb(
                        {"path": seg.path, "cookie": cookie, "slot": slot,
                         "node": token}, use_bin_type=True))
                except Exception:
                    internal_kv._kv_put(key, msgpack.packb(
                        {"fail": True}, use_bin_type=True))
                    raise
            else:
                deadline = time.monotonic() + self._timeout
                info = None
                while time.monotonic() < deadline:
                    data = internal_kv._kv_get(key)
                    if data:
                        info = msgpack.unpackb(data, raw=False)
                        break
                    time.sleep(0.02)
                if info is None:
                    raise TimeoutError("shm segment rendezvous timed out")
                if info.get("fail"):
                    raise RuntimeError("rank 0 could not create the segment")
                token = self._node_token()
                if info["node"] is not None and token is not None:
                    if info["node"] != token:
                        raise RuntimeError(
                            "rank is on a different node than rank 0")
                elif not is_shared_memory_path(info["path"]):
                    raise RuntimeError(
                        "cannot prove node locality for shm segment")
                seg = ShmTransport.open(info["path"], info["cookie"],
                                        self.world_size, self.rank,
                                        info["slot"], self._timeout)
            ok = 1
        except Exception:
            ok = 0
        try:
            flags = self._hub_allgather(np.array([ok], np.uint8),
                                        kind="allgather_ctl_shm")
        except BaseException:
            if seg is not None:
                # every survivor unlinks: rank 0 (the owner) may be the
                # peer that just died mid-exchange
                seg.close(unlink=True)
            raise
        if all(int(f[0]) for f in flags):
            try:
                seg.barrier()  # join fence: everyone mapped before first op
            except BaseException:
                # a peer died between the flag exchange and the fence:
                # every survivor unlinks (rank 0 may BE the dead peer —
                # its segment file must not outlive the group)
                seg.close(unlink=True)
                self._shm_disabled = True
                raise
            if self.rank == 0:
                # every rank is mapped (the fence proves it) and nothing
                # reopens this generation: unlink NOW so the tmpfs bytes
                # die with the last mapping even if rank 0 is SIGKILLed
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
            self._shm = seg
            return seg
        if seg is not None:
            seg.close()
        self._shm_disabled = True  # unanimous: don't pay the probe again
        return None

    def _shm_need(self, arr: np.ndarray, op: ReduceOp | None) -> int:
        """Slot bytes that fit both the contribution and half the result
        region (the result region is 2 slots; MEAN promotes integers to
        float64, which can outgrow the input slot)."""
        need = arr.nbytes
        if op is not None:
            need = max(need, (arr.size * result_dtype(arr.dtype, op).itemsize
                              + 1) // 2)
        return max(need, 1)

    # ---- ring data plane ----

    def _ensure_ring(self) -> bool:
        if self.world_size <= 2:
            return False  # ring degenerates to pairwise; hub is fine
        if getattr(self, "_ring_next", None) is not None:
            return True
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(2)
        port = listener.getsockname()[1]
        addr = f"127.0.0.1:{port}".encode().ljust(32, b"\0")
        addrs = self._hub_allgather(np.frombuffer(addr, np.uint8),
                                    kind="allgather_ctl_ring")
        nxt = bytes(addrs[(self.rank + 1) % self.world_size]
                    ).rstrip(b"\0").decode()
        host, p = nxt.rsplit(":", 1)

        out: dict = {}

        lock = threading.Lock()

        def _connect():
            try:
                sock = socket.create_connection(
                    (host, int(p)), timeout=self._timeout)
            except OSError as e:  # surfaced by the join below
                out["err"] = e
                return
            with lock:
                if out.get("abandoned"):  # caller already gave up
                    sock.close()
                else:
                    out["sock"] = sock

        t = threading.Thread(target=_connect, daemon=True)
        t.start()
        prev_sock = None
        try:
            listener.settimeout(self._timeout)
            prev_sock, _ = listener.accept()
            # keep the configured timeout on both ring sockets so a
            # stalled (connected but silent) peer raises socket.timeout
            # instead of hanging recv forever — abort-not-hang applies
            # to the data plane
            prev_sock.settimeout(self._timeout)
            t.join(self._timeout)
            with lock:
                if "sock" not in out:
                    out["abandoned"] = True  # late connect self-closes
                    raise ConnectionError(
                        f"ring connect to rank "
                        f"{(self.rank + 1) % self.world_size}"
                        f" failed: {out.get('err')}")
        except BaseException:
            if prev_sock is not None:
                prev_sock.close()
            sock = out.get("sock")
            if sock is not None:
                sock.close()
            raise
        finally:
            listener.close()
        out["sock"].settimeout(self._timeout)
        # pipelined slices are small; don't let Nagle hold the tail
        for s in (out["sock"], prev_sock):
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._ring_next = out["sock"]
        self._ring_prev = prev_sock
        return True

    def _ring_teardown(self):
        """Close and forget both ring sockets. A failed ring op leaves
        peers at different steps, so the connections are unusable; the
        next large allreduce rebuilds the ring from scratch (or fails the
        collective setup, which the caller handles)."""
        for name in ("_ring_next", "_ring_prev"):
            sock = getattr(self, name, None)
            if sock is not None:
                try:
                    sock.close()
                except Exception:
                    pass
            setattr(self, name, None)

    # -- legacy (unpipelined) ring: the A/B control arm ----------------

    @staticmethod
    def _ring_send(sock: socket.socket, data: bytes):
        sock.sendall(_HDR.pack(len(data)) + data)

    @staticmethod
    def _ring_recv(sock: socket.socket) -> bytes:
        (n,) = _HDR.unpack(_recv_exact(sock, 4))
        return _recv_exact(sock, n)

    def _ring_step(self, send_bytes: bytes) -> bytes:
        """Full-duplex: push to next while pulling from prev (the send
        rides a thread so neither side can deadlock on full buffers;
        socket timeouts bound both directions)."""
        err: list = []

        def _send():
            try:
                self._ring_send(self._ring_next, send_bytes)
            except Exception as e:
                err.append(e)

        t = threading.Thread(target=_send, daemon=True)
        t.start()
        data = self._ring_recv(self._ring_prev)
        t.join(self._timeout)
        if t.is_alive() or err:
            # a lingering send thread would interleave with the next
            # step's frames — the ring is no longer trustworthy
            raise TimeoutError(
                f"ring send stalled/failed: {err or 'timeout'}")
        return data

    def _ring_allreduce(self, arr: np.ndarray, op: ReduceOp) -> np.ndarray:
        """Unpipelined ring allreduce — one tobytes frame per step.
        Preserved as the control arm of the pipelined-ring perf A/B
        (force_transport='ring_unpipelined')."""
        w = self.world_size
        flat = arr.reshape(-1)
        pad = (-len(flat)) % w
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, arr.dtype)])
        # MEAN matches the hub's np.mean semantics: float64 accumulate
        # and a float result for integer inputs (also dodges overflow)
        if op == ReduceOp.MEAN and not np.issubdtype(arr.dtype,
                                                     np.floating):
            flat = flat.astype(np.float64)
        work = flat.copy()
        chunk = len(work) // w
        combine = getattr(
            np, _NUMPY_REDUCE[ReduceOp.SUM if op == ReduceOp.MEAN
                              else ReduceOp(op)])

        def view(i):
            i %= w
            return work[i * chunk:(i + 1) * chunk]

        for step in range(w - 1):  # reduce-scatter
            send_idx = self.rank - step
            recv_idx = self.rank - step - 1
            incoming = self._ring_step(view(send_idx).tobytes())
            recv = view(recv_idx)
            # parse with the wire dtype (work.dtype): for integer MEAN the
            # work buffer — and therefore every frame on the ring — is
            # float64, not arr.dtype
            np.copyto(recv, combine(
                recv, np.frombuffer(incoming, work.dtype)))
        for step in range(w - 1):  # allgather of reduced chunks
            send_idx = self.rank + 1 - step
            recv_idx = self.rank - step
            incoming = self._ring_step(view(send_idx).tobytes())
            np.copyto(view(recv_idx), np.frombuffer(incoming, work.dtype))
        if op == ReduceOp.MEAN:
            work = work / w  # float result, like the hub's np.mean
        out = work[:arr.size].reshape(arr.shape)
        if op == ReduceOp.MEAN:
            return out
        return out.astype(arr.dtype, copy=False)

    # -- pipelined zero-copy ring --------------------------------------

    def _ring_recv_into(self, mv: memoryview):
        sock = self._ring_prev
        got, n = 0, len(mv)
        while got < n:
            r = sock.recv_into(mv[got:], n - got)
            if not r:
                raise ConnectionError("collective peer disconnected")
            got += r

    def _ring_send_async(self, send_mv: memoryview):
        """Stream a work-buffer slice to the next rank in _PIPE_BYTES
        pieces (memoryview slices — no tobytes copy), off-thread so the
        caller can consume the previous rank's stream concurrently.
        Small steps send inline: a <=16KB sendall into a peer buffer
        that the previous step fully drained cannot block (SO_SNDBUF
        floors are far larger), and skipping the thread keeps
        just-over-threshold collectives from paying thread churn per
        step."""
        if not len(send_mv):
            return None, []
        if len(send_mv) <= (1 << 14):
            self._ring_next.sendall(send_mv)
            return None, []
        err: list = []

        def _send():
            try:
                off, n = 0, len(send_mv)
                while off < n:
                    self._ring_next.sendall(
                        send_mv[off:off + self._PIPE_BYTES])
                    off += self._PIPE_BYTES
            except Exception as e:
                err.append(e)

        t = threading.Thread(target=_send, daemon=True)
        t.start()
        return t, err

    def _ring_join(self, t, err):
        if t is None:
            return
        t.join(self._timeout)
        if t.is_alive() or err:
            raise TimeoutError(
                f"ring send stalled/failed: {err or 'timeout'}")

    def _ring_step_reduce(self, send_mv: memoryview, dst: np.ndarray,
                          scratch: np.ndarray, combine):
        """One pipelined reduce step: stream `send_mv` out while pulling
        dst.nbytes from prev in slices; each slice is combined into `dst`
        the moment it lands, so the reduce of slice k overlaps the
        receive of slice k+1 (the peer keeps filling the socket buffer
        while we compute). No frame headers: both sides derive the same
        chunk schedule, so the stream is self-describing."""
        t, err = self._ring_send_async(send_mv)
        smv = memoryview(scratch).cast("B")
        isz = dst.itemsize
        total, off = dst.nbytes, 0
        while off < total:
            n = min(self._PIPE_BYTES, total - off)
            self._ring_recv_into(smv[:n])
            k = n // isz
            lo = off // isz
            combine(dst[lo:lo + k], scratch[:k], out=dst[lo:lo + k])
            off += n
        self._ring_join(t, err)

    def _ring_step_gather(self, send_mv: memoryview, recv_mv: memoryview):
        """One pipelined gather step: stream out while receiving straight
        into the destination region (recv_into — zero-copy)."""
        t, err = self._ring_send_async(send_mv)
        self._ring_recv_into(recv_mv)
        self._ring_join(t, err)

    def _prep_ring_work(self, arr: np.ndarray, op: ReduceOp):
        flat = arr.reshape(-1)
        # MEAN matches hub np.mean semantics: float64 accumulate and a
        # float result for integer inputs (also dodges overflow), f32
        # intermediates for f16 (np.mean does the same; a raw f16 add
        # chain loses whole units at a few thousand)
        if op == ReduceOp.MEAN and not np.issubdtype(arr.dtype,
                                                     np.floating):
            work = flat.astype(np.float64)
        elif op == ReduceOp.MEAN and arr.dtype == np.float16:
            work = flat.astype(np.float32)
        else:
            work = flat.copy()
        combine = getattr(
            np, _NUMPY_REDUCE[ReduceOp.SUM if op == ReduceOp.MEAN
                              else ReduceOp(op)])
        return work, combine

    def _ring_scratch(self, work: np.ndarray, bounds: list[int]):
        maxel = max((bounds[i + 1] - bounds[i] for i in range(len(bounds) - 1)),
                    default=0)
        n = min(maxel, self._PIPE_BYTES // work.itemsize)
        return np.empty(max(n, 1), work.dtype)

    def _ring_reduce_scatter_phase(self, work, bounds, combine, scratch,
                                   delta: int):
        """w-1 pipelined reduce steps; with delta=0 rank r ends holding
        reduced chunk r+1 (the allreduce schedule), with delta=-1 it ends
        holding chunk r (the reducescatter schedule)."""
        w = self.world_size
        wv = memoryview(work).cast("B")
        isz = work.itemsize

        def mv(i):
            i %= w
            return wv[bounds[i] * isz:bounds[i + 1] * isz]

        def el(i):
            i %= w
            return work[bounds[i]:bounds[i + 1]]

        for step in range(w - 1):
            send_i = self.rank - step + delta
            recv_i = send_i - 1
            self._ring_step_reduce(mv(send_i), el(recv_i), scratch, combine)

    def _ring_allreduce_pipelined(self, arr: np.ndarray,
                                  op: ReduceOp) -> np.ndarray:
        w = self.world_size
        work, combine = self._prep_ring_work(arr, op)
        bounds = split_bounds(work.size, w)
        scratch = self._ring_scratch(work, bounds)
        self._ring_reduce_scatter_phase(work, bounds, combine, scratch, 0)
        wv = memoryview(work).cast("B")
        isz = work.itemsize

        def mv(i):
            i %= w
            return wv[bounds[i] * isz:bounds[i + 1] * isz]

        for step in range(w - 1):  # allgather of reduced chunks
            self._ring_step_gather(mv(self.rank + 1 - step),
                                   mv(self.rank - step))
        if op == ReduceOp.MEAN:
            work = work / w  # float result, like the hub's np.mean
            if arr.dtype == np.float16:
                work = work.astype(np.float16)  # f32 accumulate, f16 out
        return work.reshape(arr.shape)

    def _ring_reducescatter_pipelined(self, arr: np.ndarray,
                                      op: ReduceOp) -> np.ndarray:
        w = self.world_size
        work, combine = self._prep_ring_work(arr, op)
        # hub semantics: np.array_split along axis 0 — row blocks are
        # contiguous element ranges in C order
        rows = arr.shape[0] if arr.ndim else 1
        rowsz = arr.size // rows if rows else 0
        rb = split_bounds(rows, w)
        bounds = [r * rowsz for r in rb]
        scratch = self._ring_scratch(work, bounds)
        self._ring_reduce_scatter_phase(work, bounds, combine, scratch, -1)
        res = work[bounds[self.rank]:bounds[self.rank + 1]]
        if op == ReduceOp.MEAN:
            res = res / w
            if arr.dtype == np.float16:
                res = res.astype(np.float16)  # f32 accumulate, f16 out
        return res.reshape((rb[self.rank + 1] - rb[self.rank],)
                           + arr.shape[1:]).copy()

    def _ring_allgather_pipelined(self, arr: np.ndarray):
        """Block-rotation allgather over uniform-shape contributions
        (the caller's meta round guarantees uniformity)."""
        w = self.world_size
        n = arr.nbytes
        out = np.empty(w * arr.size, arr.dtype)
        ov = memoryview(out).cast("B")
        ov[self.rank * n:(self.rank + 1) * n] = memoryview(arr).cast("B")

        def mv(i):
            i %= w
            return ov[i * n:(i + 1) * n]

        for step in range(w - 1):
            self._ring_step_gather(mv(self.rank - step),
                                   mv(self.rank - step - 1))
        return [out[i * arr.size:(i + 1) * arr.size].reshape(arr.shape)
                for i in range(w)]

    def _ring_broadcast_pipelined(self, arr: np.ndarray,
                                  src_rank: int) -> np.ndarray:
        """Pipelined relay chain src → src+1 → … → src-1: each slice is
        forwarded the moment it lands, so after the w-hop fill the whole
        chain streams concurrently. Acyclic per slice — no deadlock."""
        w = self.world_size
        out = arr if self.rank == src_rank else np.empty_like(arr)
        ov = memoryview(out).cast("B")
        do_recv = self.rank != src_rank
        do_send = (self.rank + 1) % w != src_rank
        total, off = out.nbytes, 0
        while off < total:
            n = min(self._PIPE_BYTES, total - off)
            if do_recv:
                self._ring_recv_into(ov[off:off + n])
            if do_send:
                self._ring_next.sendall(ov[off:off + n])
            off += n
        # fresh writable result on every rank/tier, like the hub
        return out.copy() if out is arr else out

    # -- quantized (int8 block-scaled) pipelined ring ------------------

    def _ring_send_seq_async(self, parts: list[memoryview]):
        """Stream a sequence of buffers (scales header, then payload) to
        the next rank in order. Like _ring_send_async, tiny totals send
        inline; anything larger rides one thread — the HEADER must not
        be a blocking main-thread sendall, or every rank can sit in it
        simultaneously once scales outgrow the socket buffers (circular
        stall, spurious timeout) while nobody drains its peer."""
        if sum(len(p) for p in parts) <= (1 << 14):
            for p in parts:
                self._ring_next.sendall(p)
            return None, []
        err: list = []

        def _send():
            try:
                for p in parts:
                    off, n = 0, len(p)
                    while off < n:
                        self._ring_next.sendall(
                            p[off:off + self._PIPE_BYTES])
                        off += self._PIPE_BYTES
            except Exception as e:
                err.append(e)

        t = threading.Thread(target=_send, daemon=True)
        t.start()
        return t, err

    def _ring_step_qreduce(self, send_chunk: np.ndarray, dst: np.ndarray,
                           combine):
        """One quantized ring step: quantize and stream the outgoing
        chunk (per-block f32 scales ride ahead of the int8 payload)
        while receiving the peer's, dequantizing and combining
        pipeline-slice by slice into `dst` (float32). Wire bytes per
        chunk: elems * (1 + 4/QUANT_BLOCK) instead of elems * 4."""
        q, scales = _quant_np(send_chunk)
        t, err = self._ring_send_seq_async(
            [memoryview(scales).cast("B"), memoryview(q).cast("B")])
        n = dst.size  # elements == int8 payload bytes
        rscales = np.empty(n // QUANT_BLOCK, np.float32)
        self._ring_recv_into(memoryview(rscales).cast("B"))
        rq = np.empty(min(self._PIPE_BYTES, n), np.int8)
        off = 0
        while off < n:  # slices stay QUANT_BLOCK-aligned (2^18 % 256 == 0)
            k = min(self._PIPE_BYTES, n - off)
            self._ring_recv_into(memoryview(rq).cast("B")[:k])
            deq = (rq[:k].reshape(-1, QUANT_BLOCK).astype(np.float32)
                   * rscales[off // QUANT_BLOCK:
                             (off + k) // QUANT_BLOCK, None]).reshape(-1)
            combine(dst[off:off + k], deq, out=dst[off:off + k])
            off += k
        self._ring_join(t, err)

    def _ring_allreduce_quantized(self, arr: np.ndarray,
                                  op: ReduceOp) -> np.ndarray:
        """EQuARX-style quantized pipelined ring allreduce: every hop of
        the reduce-scatter phase re-quantizes the partial chunk to
        int8 + per-block f32 scales and combines on the dequantized
        float32 values; the allgather phase quantizes the reduced chunk
        ONCE and relays the same bytes, so every rank dequantizes
        identical data and the (lossy) result agrees bitwise across
        ranks. Analytic error bound: each of the <= world quantization
        steps that touch an output element perturbs it by at most
        scale/2 <= absmax/254 of the partial it quantized."""
        w = self.world_size
        in_dt = arr.dtype
        n = arr.size
        # uniform block-aligned chunks (zero padding never inflates a
        # block's absmax, and the pad region is sliced off at the end)
        per_rank = -(-n // w)
        C = -(-per_rank // QUANT_BLOCK) * QUANT_BLOCK
        work = np.zeros(w * C, np.float32)
        work[:n] = arr.reshape(-1)
        combine = getattr(np, _NUMPY_REDUCE[
            ReduceOp.SUM if op == ReduceOp.MEAN else ReduceOp(op)])

        def chunk(i):
            i %= w
            return work[i * C:(i + 1) * C]

        # reduce-scatter (delta=0 schedule): w-1 quantized hops — rank r
        # ends holding the fully-reduced chunk (r+1) % w
        for step in range(w - 1):
            send_i = self.rank - step
            self._ring_step_qreduce(chunk(send_i), chunk(send_i - 1),
                                    combine)
        # allgather: quantize the reduced chunk once, relay the same
        # bytes around the ring; the own chunk goes through the same
        # dequant so all ranks hold bit-identical results
        own = (self.rank + 1) % w
        q, scales = _quant_np(chunk(own))
        work[own * C:(own + 1) * C] = _dequant_np(q, scales)
        rq = np.empty(C, np.int8)
        rscales = np.empty(C // QUANT_BLOCK, np.float32)
        for step in range(w - 1):
            t, err = self._ring_send_seq_async(
                [memoryview(scales).cast("B"), memoryview(q).cast("B")])
            self._ring_recv_into(memoryview(rscales).cast("B"))
            self._ring_recv_into(memoryview(rq).cast("B"))
            self._ring_join(t, err)
            idx = (self.rank - step) % w
            work[idx * C:(idx + 1) * C] = _dequant_np(rq, rscales)
            q, scales = rq.copy(), rscales.copy()  # relay onward
        # socket bytes saved vs the exact tier's wire dtype
        wire_elems = 2 * (w - 1) * C
        exact_item = (4 if (op == ReduceOp.MEAN and in_dt == np.float16)
                      else in_dt.itemsize)
        saved = wire_elems * exact_item - wire_elems * (
            1 + 4 / QUANT_BLOCK)
        if saved > 0:
            _cm.QUANT_SAVED += int(saved)
        out = work[:n]
        if op == ReduceOp.MEAN:
            out = out / w
        return out.astype(in_dt, copy=False).reshape(arr.shape).copy()

    def _ring_reducescatter_quantized(self, arr: np.ndarray,
                                      op: ReduceOp) -> np.ndarray:
        """Quantized pipelined ring reduce-scatter — the reduce half of
        _ring_allreduce_quantized on the delta=-1 schedule, so rank r
        ends holding reduced chunk r (hub/np.array_split semantics).
        The dispatch admits only flat buckets whose size is a multiple
        of world * QUANT_BLOCK — exactly the sharded trainer's padded
        grad bucket (train/sharding.py layout) — so chunks are uniform
        and block-aligned with no re-marshalling. Lossy, but each output
        element is perturbed by <= scale/2 per hop that touched it, and
        the result is rank-local (no cross-rank divergence to agree
        on)."""
        w = self.world_size
        in_dt = arr.dtype
        C = arr.size // w
        work = arr.reshape(-1).astype(np.float32)  # fresh f32 accumulator
        combine = getattr(np, _NUMPY_REDUCE[
            ReduceOp.SUM if op == ReduceOp.MEAN else ReduceOp(op)])

        def chunk(i):
            i %= w
            return work[i * C:(i + 1) * C]

        for step in range(w - 1):
            send_i = self.rank - step - 1
            self._ring_step_qreduce(chunk(send_i), chunk(send_i - 1),
                                    combine)
        # socket bytes saved vs the exact pipelined tier's wire dtype
        wire_elems = (w - 1) * C
        saved = wire_elems * in_dt.itemsize - wire_elems * (
            1 + 4 / QUANT_BLOCK)
        if saved > 0:
            _cm.QUANT_SAVED += int(saved)
        res = chunk(self.rank)
        if op == ReduceOp.MEAN:
            res = res / w
        return res.astype(in_dt, copy=False).reshape(
            (arr.shape[0] // w,) + arr.shape[1:]).copy()

    # ---- collectives (routed) ----

    def _run_routed(self, arr: np.ndarray, shm_need: int, shm_fn, ring_fn,
                    hub_fn):
        """One route/fallback/poison dispatch for the uniform-geometry
        collectives (allgather is bespoke: its geometry may be ragged).
        shm_fn(transport), ring_fn(pipelined: bool), hub_fn()."""
        for tr in self._route(arr):
            if tr == Transport.SHM.value:
                t = self._ensure_shm(shm_need)
                if t is None:
                    self._forced_unavailable(tr)
                    continue
                return self._shm_op(lambda: shm_fn(t))
            if tr in (Transport.RING.value,
                      Transport.RING_UNPIPELINED.value):
                if not self._ring_op(self._ensure_ring):
                    self._forced_unavailable(tr)
                    continue
                pipelined = tr == Transport.RING.value
                out = self._ring_op(lambda: ring_fn(pipelined))
                _cm.RING_OPS += 1
                return out
            if tr == Transport.HUB.value:
                out = hub_fn()
                _cm.HUB_OPS += 1
                return out
            # a device tier pinned for an op its vote turned down
            self._forced_unavailable(tr)
        raise RuntimeError("no collective transport available")

    def allreduce(self, arr, op: ReduceOp = ReduceOp.SUM, quantize=None):
        op = ReduceOp(op)
        q = self._quantize_mode(quantize)
        if self._pallas_route(arr, "allreduce", op, q):
            return self._pallas_op(
                lambda: self._pallas.allreduce(arr, op, quantize=q))
        if self._device_route(arr):
            return self._device_op(
                lambda: self._device.allreduce(arr, op, quantize=q))
        like, arr = arr, self._to_host(arr)

        def hub():
            reply, data = self._collective(
                "allreduce", {**_arr_meta(arr), "op": op.value},
                arr.tobytes())
            return _arr_from(reply["meta"], data)

        def ring(pipelined):
            # the quantized wire format lives on the pipelined ring (the
            # unpipelined arm is the exact A/B control); int payloads
            # and PRODUCT stay exact by definition
            if (pipelined and q and op in _QUANT_OPS
                    and np.issubdtype(arr.dtype, np.floating)):
                return self._ring_allreduce_quantized(arr, op)
            return (self._ring_allreduce_pipelined(arr, op) if pipelined
                    else self._ring_allreduce(arr, op))

        return self._deliver(self._run_routed(
            arr, self._shm_need(arr, op),
            lambda t: t.allreduce(arr, op),
            ring, hub), like)

    def reduce(self, arr, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        like, arr = arr, self._to_host(arr)
        reply, data = self._collective(
            "reduce", {**_arr_meta(arr), "op": ReduceOp(op).value,
                       "dst": dst_rank},
            arr.tobytes())
        _cm.HUB_OPS += 1
        if self.rank == dst_rank:
            return self._deliver(_arr_from(reply["meta"], data), like)
        return like

    def broadcast(self, arr, src_rank: int = 0):
        if self._device_route(arr):
            return self._device_op(
                lambda: self._device.broadcast(arr, src_rank))
        like, arr = arr, self._to_host(arr)

        def hub():
            payload = arr.tobytes() if self.rank == src_rank else b""
            meta = {**_arr_meta(arr), "src": src_rank}
            reply, data = self._collective("broadcast", meta, payload)
            return _arr_from(reply["meta"], data)

        return self._deliver(self._run_routed(
            arr, self._shm_need(arr, None),
            lambda t: t.broadcast(arr, src_rank),
            lambda pipelined: self._ring_broadcast_pipelined(arr, src_rank),
            hub), like)

    def allgather(self, arr) -> list:
        # allgather is the one op whose per-rank GEOMETRY may
        # legitimately differ, so local-size routing can diverge (ragged
        # sizes straddling RING_MIN_BYTES). Every rank therefore opens
        # with the SAME metadata-only hub round and routes on the union:
        # fast tiers only for uniform shapes, the hub (which supports
        # ragged gathers natively) otherwise.
        like = arr
        if self.world_size == 1 or self._destroyed:
            return [self._deliver(o, like) for o in
                    self._hub_allgather(self._to_host(arr))]
        metas = self._hub_allgather_meta(self._meta(arr))
        uniform = all(m == metas[0] for m in metas[1:])
        # the pallas/device votes only happen on the uniform path, so
        # every rank enters (or skips) the ctl rounds together
        if uniform and self._pallas_route(arr, "allgather"):
            return self._pallas_op(lambda: self._pallas.allgather(arr))
        if uniform and self._device_route(arr):
            return self._device_op(lambda: self._device.allgather(arr))
        arr = self._to_host(arr)
        out = None
        for tr in self._route(arr) if uniform else [Transport.HUB.value]:
            if tr == Transport.SHM.value:
                t = self._ensure_shm(self._shm_need(arr, None))
                if t is None:
                    self._forced_unavailable(tr)
                    continue
                out = self._shm_op(lambda: t.allgather(arr))
                if out is not None:
                    break
                continue  # defense-in-depth: shm saw ragged metas
            if tr in (Transport.RING.value, Transport.RING_UNPIPELINED.value):
                if not self._ring_op(self._ensure_ring):
                    self._forced_unavailable(tr)
                    continue
                out = self._ring_op(
                    lambda: self._ring_allgather_pipelined(arr))
                _cm.RING_OPS += 1
                break
            if tr == Transport.HUB.value:
                break
            self._forced_unavailable(tr)
        if out is None:
            # the hub, also where a pinned tier cannot express the op
            # (forced shm + ragged)
            out = self._hub_allgather(arr)
            _cm.HUB_OPS += 1
        return [self._deliver(o, like) for o in out]

    def reducescatter(self, arr, op: ReduceOp = ReduceOp.SUM,
                      quantize=None):
        op = ReduceOp(op)
        q = self._quantize_mode(quantize)
        if self._pallas_route(arr, "reducescatter", op, q):
            return self._pallas_op(
                lambda: self._pallas.reducescatter(arr, op, quantize=q))
        if self._device_route(arr):
            return self._device_op(
                lambda: self._device.reducescatter(arr, op, quantize=q))
        like, arr = arr, self._to_host(arr)

        def hub():
            reply, data = self._collective(
                "reducescatter", {**_arr_meta(arr), "op": op.value},
                arr.tobytes())
            return _arr_from(reply["meta"], data)

        def ring(pipelined):
            # quantized wire only on the pipelined ring, and only for
            # flat world*QUANT_BLOCK-aligned float buckets (uniform
            # block-aligned chunks — the sharded-trainer grad layout);
            # anything else takes the exact tier
            if (pipelined and q and op in _QUANT_OPS
                    and np.issubdtype(arr.dtype, np.floating)
                    and arr.ndim == 1
                    and arr.size % (self.world_size * QUANT_BLOCK) == 0):
                return self._ring_reducescatter_quantized(arr, op)
            return self._ring_reducescatter_pipelined(arr, op)

        return self._deliver(self._run_routed(
            arr, self._shm_need(arr, op),
            lambda t: t.reducescatter(arr, op),
            ring, hub), like)

    def barrier(self):
        self._collective("barrier", {}, b"")
        _cm.HUB_OPS += 1

    def check(self):
        """Waits for this rank's work on the device tiers: the one host
        sync of a CUDA epoch. (A peer that does not come raises at the
        call: the fused kernels' phases are ordered by the host's bounded
        waits.)"""
        for t in (self._pallas, self._device):
            if t is not None:
                t.check()

    # ---- p2p ----
    # The hub mailbox always carries the rendezvous/control message;
    # payloads above RING_MIN_BYTES go peer-direct (one rank-to-rank
    # connection) instead of double-copying through rank 0.

    def send(self, arr, dst_rank: int, tag: int = 0):
        arr = self._to_host(arr)
        if (arr.nbytes >= self.RING_MIN_BYTES and self.world_size > 1
                and dst_rank != self.rank and not self._destroyed):
            return self._send_direct(arr, dst_rank, tag)
        if self.rank == 0:
            self._state.post(0, dst_rank, tag, _arr_meta(arr), arr.tobytes())
            return
        _send_msg(self._sock, {"kind": "p2p_send", "dst": dst_rank,
                               "tag": tag, "meta": _arr_meta(arr)},
                  arr.tobytes())
        _recv_msg(self._sock)  # ack

    def _send_direct(self, arr: np.ndarray, dst_rank: int, tag: int):
        """Post the rendezvous control message to the hub mailbox, then
        serve the payload from a background thread — send() keeps the
        hub path's buffered semantics (returns without waiting for the
        receiver, so symmetric send/send-then-recv/recv patterns can't
        deadlock). The payload is snapshotted first, so mutating the
        tensor after send() returns cannot corrupt the transfer. The
        listener has NO deadline of its own: like a hub mailbox entry,
        the buffered payload stays claimable until the receiver takes it
        or the group is destroyed (destroy() closes the listener, which
        frees the thread and the snapshot) — recv-side timeouts still
        bound every blocking reader, so there is no expiry cliff at the
        RING_MIN_BYTES threshold."""
        arr = arr.copy()
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        key = (dst_rank, tag)
        with self._p2p_lock:
            stale = self._p2p_direct.pop(key, None)
            self._p2p_direct[key] = listener
        if stale is not None:
            try:  # overwrite the unclaimed predecessor, like the mailbox
                stale.close()  # (an in-flight transfer keeps its conn fd)
            except Exception:
                pass
        port = listener.getsockname()[1]
        ctrl = {**_arr_meta(arr), "peer_direct": f"127.0.0.1:{port}"}

        def _serve():
            conn = None
            try:
                conn, _ = listener.accept()  # until taken/overwritten/
                conn.settimeout(self._timeout)  # destroyed
                conn.sendall(memoryview(arr).cast("B"))
                conn.recv(1)  # receiver ack bounds arr's lifetime
            except OSError:
                pass  # abort-not-hang: the receiver sees a short read
            finally:
                if conn is not None:
                    conn.close()
                listener.close()
                with self._p2p_lock:
                    if self._p2p_direct.get(key) is listener:
                        del self._p2p_direct[key]

        t = threading.Thread(target=_serve, daemon=True)
        t.start()
        try:
            if self.rank == 0:
                self._state.post(0, dst_rank, tag, ctrl, b"")
            else:
                _send_msg(self._sock, {"kind": "p2p_send", "dst": dst_rank,
                                       "tag": tag, "meta": ctrl})
                _recv_msg(self._sock)  # hub ack
        except BaseException:
            listener.close()  # unblocks the serve thread
            raise

    def recv(self, src_rank: int, tag: int = 0) -> np.ndarray:
        """The payload `src_rank` sent with `tag`, as numpy (a torch
        sender's tensor arrives as its numpy twin)."""
        if self.rank == 0:
            meta, data = self._state.take(src_rank, 0, tag,
                                          timeout=self._timeout)
        else:
            _send_msg(self._sock, {"kind": "p2p_recv", "src": src_rank,
                                   "tag": tag})
            reply, data = _recv_msg(self._sock)
            if "error" in reply:
                raise TimeoutError(reply["error"])
            meta = reply["meta"]
        if meta and meta.get("peer_direct"):
            return self._recv_direct(meta)
        return _arr_from(meta, data)

    def _recv_direct(self, meta: dict) -> np.ndarray:
        host, port = meta["peer_direct"].rsplit(":", 1)
        out = np.empty(meta["shape"], np.dtype(meta["dtype"]))
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=self._timeout)
        except OSError as e:
            raise TimeoutError(
                f"peer-direct recv: sender unreachable: {e}") from e
        try:
            sock.settimeout(self._timeout)
            mv = memoryview(out).cast("B")
            got, n = 0, out.nbytes
            while got < n:
                r = sock.recv_into(mv[got:], n - got)
                if not r:
                    raise TimeoutError(  # abort-not-hang: peer died
                        "peer-direct sender disconnected mid-transfer")
                got += r
            sock.sendall(b"\x01")
        finally:
            sock.close()
        return out

    def destroy(self):
        if self._destroyed:
            return
        self._destroyed = True
        self._ring_teardown()
        for t in (self._pallas, self._device):
            if t is not None:
                try:
                    t.destroy()
                except Exception:
                    pass
        self._pallas = self._device = None
        from ray_tpu_torch.parallel import multihost

        multihost.destroy_process_group(self.group_name)
        with self._p2p_lock:
            pending = list(self._p2p_direct.values())
            self._p2p_direct.clear()
        for listener in pending:
            try:
                listener.close()  # frees the serve thread + snapshot
            except Exception:
                pass
        if self._shm is not None:
            try:
                # unlink from every rank (idempotent): rank 0 may already
                # be gone, and group destroy is the last chance to keep
                # the segment's tmpfs bytes from outliving the group
                self._shm.close(unlink=True)
            except Exception:
                pass
            self._shm = None
        if self.rank == 0 and self.world_size > 1:
            try:
                self._listener.close()
            except Exception:
                pass
            for key in [self._key, *self._shm_keys]:
                try:
                    internal_kv._kv_del(key)
                except Exception:
                    pass
        if self._sock is not None:
            try:
                self._sock.close()
            except Exception:
                pass
