"""Intra-node shared-memory collective transport; port of
ray_tpu/collective/backends/shm_transport.py.

Every rank of a group that lands on one node maps the same tmpfs
segment (native/store segment alloc — the arena directory that makes
the object store do multi-GB/s).  A collective is then pure memory
traffic: each rank memcpys its contribution into its slot, synchronizes
through a counter barrier living in the segment header, reduces its
1/w stripe of the element range in place, and memcpys the result out —
zero socket syscalls, zero serialization, zero per-step copies.

Layout (one file, created zero-filled by rank 0):

    [0:32)            magic u64 | version u32 | world u32 | slot u64
                      | abort u64
    [32:48)           group cookie (16 random bytes, rendezvous check)
    [64 + r*64)       per-rank barrier counter (u64, cacheline stride)
    meta0 + r*256     per-rank op meta (u32 len | u64 seq | msgpack)
    data0 + r*slot    per-rank contribution slot
    res0  = data0 + w*slot, 2*slot bytes: reduction output stripes

Synchronization is a monotonic counter barrier: phase k of the group's
op stream is "every counter >= k".  Ranks execute the same collective
sequence by contract, so the phase numbers line up without any central
coordinator.  Abort-not-hang: a rank that times out (peer died) or hits
a hard error stamps the abort word; every other rank's barrier spin
sees it and raises TimeoutError instead of waiting out its full
deadline.  A tripped segment is never reused — the owning HostGroup
tears it down and rebuilds (or falls back to the TCP tiers).

Reduction order is fixed at rank 0..w-1 for every stripe, matching the
hub's sequential reduce, so SUM/MAX/MIN results are bit-identical to
the hub path even for non-associative float addition.  MEAN matches hub
np.mean semantics: float64 accumulate + float64 result for integer
inputs, float32 intermediates for float16, native-dtype accumulate for
wider floats.
"""

from __future__ import annotations

import struct
import time

import msgpack
import numpy as np

from ray_tpu_torch.collective.backends.device_backend import split_bounds
from ray_tpu_torch.collective.types import _NUMPY_REDUCE, ReduceOp

_MAGIC = 0x52545053484D5347  # "RTPSHMSG"
_VERSION = 1
_HDR = struct.Struct("<QIIQQ")  # magic, version, world, slot_bytes, abort
_ABORT_OFF = 24
_COOKIE_OFF = 32
_CTR0 = 64
_CTR_STRIDE = 64
_META_BYTES = 256


def _align(n: int, a: int = 4096) -> int:
    return (n + a - 1) // a * a


def segment_size(world_size: int, slot_bytes: int) -> int:
    return _data0(world_size) + (world_size + 2) * slot_bytes


def _meta0(world_size: int) -> int:
    return _CTR0 + world_size * _CTR_STRIDE


def _data0(world_size: int) -> int:
    return _align(_meta0(world_size) + world_size * _META_BYTES)


def result_dtype(dtype: np.dtype, op: ReduceOp) -> np.dtype:
    """Reduction output dtype under hub semantics (np.mean promotes
    integer inputs to float64; everything else keeps the input dtype)."""
    if op == ReduceOp.MEAN and not np.issubdtype(dtype, np.floating):
        return np.dtype(np.float64)
    return np.dtype(dtype)


class ShmTransport:
    """One rank's handle on the group's shared segment."""

    def __init__(self, seg, world_size: int, rank: int, slot_bytes: int,
                 timeout: float):
        self._seg = seg
        self._view = seg.view
        self.world_size = world_size
        self.rank = rank
        self.slot_bytes = slot_bytes
        self._timeout = timeout
        self._seq = 0
        self._meta0 = _meta0(world_size)
        self._data0 = _data0(world_size)
        self._res0 = self._data0 + world_size * slot_bytes

    # -- setup ----------------------------------------------------------

    @classmethod
    def create(cls, name: str, cookie: bytes, world_size: int, rank: int,
               slot_bytes: int, timeout: float) -> "ShmTransport":
        from ray_tpu_torch.native.store import create_segment

        seg = create_segment(name, segment_size(world_size, slot_bytes))
        _HDR.pack_into(seg.view, 0, _MAGIC, _VERSION, world_size,
                       slot_bytes, 0)
        seg.view[_COOKIE_OFF:_COOKIE_OFF + 16] = cookie[:16]
        return cls(seg, world_size, rank, slot_bytes, timeout)

    @classmethod
    def open(cls, path: str, cookie: bytes, world_size: int, rank: int,
             slot_bytes: int, timeout: float) -> "ShmTransport":
        from ray_tpu_torch.native.store import open_segment

        seg = open_segment(path, segment_size(world_size, slot_bytes))
        magic, version, world, slot, _ = _HDR.unpack_from(seg.view, 0)
        if (magic != _MAGIC or version != _VERSION or world != world_size
                or slot != slot_bytes
                or bytes(seg.view[_COOKIE_OFF:_COOKIE_OFF + 16])
                != cookie[:16]):
            seg.close(unlink=False)
            raise ValueError(f"segment {path} failed the rendezvous check")
        return cls(seg, world_size, rank, slot_bytes, timeout)

    def close(self, unlink: bool | None = None):
        """Release the mapping. `unlink=None` keeps the creator-only
        default; survivors of a crashed peer pass unlink=True (idempotent)
        so the segment file cannot outlive the group when rank 0 — the
        owner — is the rank that died."""
        seg, self._seg, self._view = self._seg, None, None
        if seg is not None:
            seg.close(unlink=unlink)

    @property
    def path(self) -> str:
        return self._seg.path

    # -- barrier --------------------------------------------------------

    def _counter(self, r: int) -> int:
        return struct.unpack_from("<Q", self._view,
                                  _CTR0 + r * _CTR_STRIDE)[0]

    def _abort_word(self) -> int:
        return struct.unpack_from("<Q", self._view, _ABORT_OFF)[0]

    def abort(self):
        """Stamp the segment so every rank's barrier fails fast."""
        if self._view is not None:
            struct.pack_into("<Q", self._view, _ABORT_OFF, 1)

    def barrier(self, deadline: float | None = None,
                coarse: bool = False):
        """Advance to the next phase and wait for every rank to reach it.

        Spin-then-sleep: on an oversubscribed box (all ranks timeshare
        one core here) a pure spin would starve the very peers being
        waited on, so after a short yield phase the wait backs off to
        millisecond sleeps. `coarse` skips the yield phase entirely —
        for multi-MB ops the expected wait is tens of ms of peer
        memcpy, and every yield spin steals the core those memcpys
        need; a 1ms sleep costs nothing against that baseline.
        Timeout stamps the abort word (so peers abort too, not hang)
        and raises."""
        if deadline is None:
            deadline = time.monotonic() + self._timeout
        self._seq += 1
        seq = self._seq
        struct.pack_into("<Q", self._view, _CTR0 + self.rank * _CTR_STRIDE,
                         seq)
        spins = 0
        while True:
            if all(self._counter(r) >= seq for r in range(self.world_size)):
                return
            if self._abort_word():
                raise TimeoutError(
                    "shm collective aborted by a peer (rank died or timed "
                    "out mid-op)")
            if time.monotonic() > deadline:
                self.abort()
                lag = [r for r in range(self.world_size)
                       if self._counter(r) < seq]
                raise TimeoutError(
                    f"shm barrier (phase {seq}) timed out waiting for "
                    f"ranks {lag}")
            spins += 1
            if coarse:
                time.sleep(0.0005)
            elif spins < 500:
                time.sleep(0)  # yield: peers share these cores
            else:
                time.sleep(min(0.001, 1e-5 * (spins - 500)))

    # -- per-op meta + payload ------------------------------------------

    def _slot(self, r: int) -> int:
        return self._data0 + r * self.slot_bytes

    _COARSE_BYTES = 1 << 20  # above this, barrier waits sleep coarsely

    def _post(self, meta: dict, payload: np.ndarray | None,
              deadline: float, coarse: bool = False):
        packed = msgpack.packb({**meta, "_seq": self._seq + 1},
                               use_bin_type=True)
        if len(packed) > _META_BYTES - 12:
            raise ValueError("collective meta too large for shm transport")
        off = self._meta0 + self.rank * _META_BYTES
        struct.pack_into("<IQ", self._view, off, len(packed), self._seq + 1)
        self._view[off + 12:off + 12 + len(packed)] = packed
        if payload is not None and payload.nbytes:
            # dtype-wide copy: measurably faster than a byte-view memcpy
            dst = np.frombuffer(self._view, payload.dtype, payload.size,
                                self._slot(self.rank))
            np.copyto(dst, payload.reshape(-1))
        self.barrier(deadline, coarse)

    def _read_metas(self, deadline: float) -> list[dict]:
        metas = []
        for r in range(self.world_size):
            off = self._meta0 + r * _META_BYTES
            while True:
                mlen, mseq = struct.unpack_from("<IQ", self._view, off)
                if mseq == self._seq and 0 < mlen <= _META_BYTES - 12:
                    meta = msgpack.unpackb(
                        bytes(self._view[off + 12:off + 12 + mlen]),
                        raw=False)
                    if meta.get("_seq") == self._seq:
                        metas.append(meta)
                        break
                # barrier ordering makes this unreachable on TSO hardware;
                # retry covers weaker memory models
                if time.monotonic() > deadline:
                    self.abort()
                    raise TimeoutError(f"shm meta from rank {r} not visible")
                time.sleep(0.0002)
        return metas

    def _validate(self, metas: list[dict], keys: tuple[str, ...]):
        head = {k: metas[0].get(k) for k in keys}
        for r, m in enumerate(metas[1:], 1):
            got = {k: m.get(k) for k in keys}
            if got != head:
                self.abort()
                raise ValueError(
                    f"mismatched shm collective: rank 0 {head} vs "
                    f"rank {r} {got}")

    def _in_view(self, r: int, dtype: np.dtype, lo: int, hi: int):
        isz = dtype.itemsize
        off = self._slot(r)
        return np.frombuffer(self._view, dtype, hi - lo, off + lo * isz)

    # -- collectives ----------------------------------------------------

    def _reduce_stripe(self, dtype: np.dtype, op: ReduceOp, lo: int,
                       hi: int, out: np.ndarray):
        """Reduce [lo, hi) of the flat element range across all slots
        into `out`, rank order 0..w-1 (hub-identical bits). Blocked into
        cache-sized chunks so the accumulator stays resident across the
        w passes — ~2.5x less memory traffic than streaming the full
        stripe through RAM once per rank."""
        if hi <= lo:
            return
        combine = getattr(np, _NUMPY_REDUCE[
            ReduceOp.SUM if op == ReduceOp.MEAN else op])
        # f16 MEAN accumulates in f32 like np.mean's intermediates (a
        # raw f16 add chain loses whole units at a few thousand)
        wide16 = op == ReduceOp.MEAN and dtype == np.float16
        blk = max(1, (1 << 16) // dtype.itemsize)
        for blo in range(lo, hi, blk):
            bhi = min(hi, blo + blk)
            ob = out[blo - lo:bhi - lo]
            acc = (self._in_view(0, dtype, blo, bhi).astype(np.float32)
                   if wide16 else ob)
            if not wide16:
                np.copyto(ob, self._in_view(0, dtype, blo, bhi),
                          casting="same_kind")
            for r in range(1, self.world_size):
                combine(acc, self._in_view(r, dtype, blo, bhi), out=acc,
                        casting="same_kind")
            if op == ReduceOp.MEAN:
                np.divide(acc, self.world_size, out=acc,
                          casting="same_kind")
            if wide16:
                np.copyto(ob, acc, casting="same_kind")

    def allreduce(self, arr: np.ndarray, op: ReduceOp) -> np.ndarray:
        deadline = time.monotonic() + self._timeout
        w = self.world_size
        rdt = result_dtype(arr.dtype, op)
        coarse = arr.nbytes >= self._COARSE_BYTES
        self._post({"k": "allreduce", "o": op.value, "d": arr.dtype.str,
                    "s": list(arr.shape)}, arr, deadline, coarse)
        self._validate(self._read_metas(deadline), ("k", "o", "d", "s"))
        bounds = split_bounds(arr.size, w)
        lo, hi = bounds[self.rank], bounds[self.rank + 1]
        res = np.frombuffer(self._view, rdt, hi - lo,
                            self._res0 + lo * rdt.itemsize)
        self._reduce_stripe(arr.dtype, op, lo, hi, res)
        self.barrier(deadline, coarse)  # all stripes written
        out = np.empty(arr.size, rdt)
        np.copyto(out, np.frombuffer(self._view, rdt, arr.size, self._res0))
        # No read-done barrier: a rank only posts the NEXT op after this
        # copy returns, and result-region writes for that op happen only
        # after its post barrier — which waits for every rank's post. The
        # slot-reading ops below do need their read fence (their slots
        # are overwritten by the very next post).
        return out.reshape(arr.shape)

    def reducescatter(self, arr: np.ndarray, op: ReduceOp) -> np.ndarray:
        deadline = time.monotonic() + self._timeout
        w = self.world_size
        rdt = result_dtype(arr.dtype, op)
        coarse = arr.nbytes >= self._COARSE_BYTES
        self._post({"k": "reducescatter", "o": op.value, "d": arr.dtype.str,
                    "s": list(arr.shape)}, arr, deadline, coarse)
        self._validate(self._read_metas(deadline), ("k", "o", "d", "s"))
        # hub semantics: np.array_split along axis 0 — row blocks are
        # contiguous element ranges in C order
        rows = arr.shape[0] if arr.ndim else 1
        rowsz = arr.size // rows if rows else 0
        rb = split_bounds(rows, w)
        lo, hi = rb[self.rank] * rowsz, rb[self.rank + 1] * rowsz
        out = np.empty(hi - lo, rdt)
        self._reduce_stripe(arr.dtype, op, lo, hi, out)
        self.barrier(deadline, coarse)  # reads done; segment reusable
        return out.reshape((rb[self.rank + 1] - rb[self.rank],)
                           + arr.shape[1:])

    def allgather(self, arr: np.ndarray) -> list[np.ndarray]:
        deadline = time.monotonic() + self._timeout
        coarse = arr.nbytes >= self._COARSE_BYTES
        self._post({"k": "allgather", "d": arr.dtype.str,
                    "s": list(arr.shape), "n": arr.nbytes}, arr, deadline,
                   coarse)
        metas = self._read_metas(deadline)
        self._validate(metas, ("k",))
        if any(m["n"] != metas[0]["n"] for m in metas[1:]):
            # ragged gather: every rank sees the same metas, so all fall
            # back to the hub together. The fence keeps barrier phases
            # aligned with the normal path (post + one more = 2).
            self.barrier(deadline, coarse)
            return None
        out = []
        for r, m in enumerate(metas):
            dt = np.dtype(m["d"])
            a = np.empty(m["n"] // dt.itemsize, dt)
            np.copyto(a, np.frombuffer(self._view, dt, a.size,
                                       self._slot(r)))
            out.append(a.reshape(m["s"]))
        self.barrier(deadline, coarse)
        return out

    def broadcast(self, arr: np.ndarray, src_rank: int) -> np.ndarray:
        deadline = time.monotonic() + self._timeout
        coarse = arr.nbytes >= self._COARSE_BYTES
        self._post({"k": "broadcast", "src": src_rank, "n": arr.nbytes},
                   arr if self.rank == src_rank else None, deadline, coarse)
        metas = self._read_metas(deadline)
        self._validate(metas, ("k", "src", "n"))
        if self.rank == src_rank:
            out = arr.copy()  # fresh writable result on every rank/tier
        else:
            out = np.empty(arr.size, arr.dtype)
            np.copyto(out, np.frombuffer(self._view, arr.dtype, arr.size,
                                         self._slot(src_rank)))
            out = out.reshape(arr.shape)
        self.barrier(deadline, coarse)
        return out
