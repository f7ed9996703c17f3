"""Transport.PALLAS: the fused collectives as hand-written CUDA kernels;
port of ray_tpu/collective/backends/pallas_backend.py.

The JAX package fuses each ring collective's whole schedule (combine,
remote DMA to the ring neighbour, wait, relay) into one `pallas_call`.
Here each op is one CUDA kernel a rank (`ops/csrc/ring_collectives.cu`):

  allreduce            <- _make_allreduce_kernel (B5), direct
  reducescatter_even   <- _make_reducescatter_kernel (B6), direct
  allgather            <- _make_allgather_kernel (B7), direct
  allreduce_quantized  <- _make_quantized_allreduce_kernel (B8), the
                          ring's reduce hops, a direct gather

The reference's ring schedule (w ranks, each rank's flat payload cut into
w chunks of C elements), which the plain versions below run hop by hop:

  reduce-scatter: acc := own chunk; for s in 1..w-1: [quantize acc ->]
      send to the right neighbour's slot for this hop, receive the left
      neighbour's, acc := combine(received [dequantized], chunk (r - s)
      mod w). Rank r ends with reduced chunk (r + 1) mod w (delta = 0;
      the reduce-scatter alone uses delta = -1 and ends with chunk r).
  relay-gather: [quantize acc once ->] w-1 hops forwarding the same
      bytes, each rank writing the received chunk into its output, so
      that in the quantized ring every rank dequantizes identical data.

Only the quantized allreduce keeps the reduce hops on the card (each
re-quantizes its partial, and its wire stays int8). The reference's
rings follow the TPU's ICI, while the port's ranks reach each other all
to all (one card, or cards with peer access), so the exact collectives
are direct, with the ring's results: rank r folds chunk r itself from
every rank's input, in the order the ring combines it (allreduce: x_r,
x_{r+1}, ..., x_{r+w-1}, into chunk r of every rank's output;
reduce-scatter: x_{r+1}, ..., x_r, into its own output), and the
allgather stores each rank's payload straight into slot r of every
output. The quantized allreduce's gather is direct too: the rank that
ends with reduced chunk (r + 1) mod w quantizes it once into its staging
buffer, and every peer dequantizes those bytes from there, which is the
relay's result. A rank learns the peers' addresses of the call (input
and output, or the staging buffer) from their mailboxes (csrc header).

Two ways to hold a group's ranks, one kernel protocol (csrc header):

- `_IpcPallasOps`, one rank a process (`PallasTransport`, the tier of the
  runtime's per-process `HostGroup`; the reference's layout). Each rank
  allocates one buffer region a (op, dtype, chunk) class: its mailbox,
  flags, the quantized allreduce's hop slots and staging buffer, and the
  input and output buffers the direct kernels read and write across
  ranks. The peers map it once through CUDA IPC (the handles go round the
  group's hub at the class's first call), and the kernel takes a table of
  the peers' buffers as this process maps them. A call copies its payload
  into the region (B5, B6) and its result out of it (B5, B7): two passes
  over the payload, the price of addresses that are fixed per class; B8
  reads and writes the caller's tensors, since its peers touch only its
  slots and staging buffer. The rank computes on its process's current
  device and stream, and its host waits for nothing: a kernel spins until
  the peers' kernels of the same call have started.
- `_PallasOps`, every rank in this process (`LocalPallasTransport`, the
  counterpart of the reference's single-controller device group): each
  rank's device (rank r on cuda:(r % device_count)), its own stream, and
  the peers' addresses from the mailboxes. A rank's kernel runs on the
  rank's stream, which must be the current stream when the rank calls:
  its blocks spin until the peers' kernels, on their own streams, have
  published their buffers, so two ranks on one stream would wait on each
  other forever (until the timeout). One host thread drives every rank,
  so the caller must make every rank's call before it waits on any.

Each wrapper of `_PallasOps` takes its plain PyTorch version for CPU
tensors and launches its kernel for CUDA tensors, or raises; there is no
other path (`_IpcPallasOps` takes CUDA tensors only: the HOST group sends
it nothing else). On the CPU a rank's call returns its output tensor at
once and the group fills every rank's output when the last rank has
called, by running the plain version over all ranks' inputs. In one
process, `check(rank)` is where a rank's calls are known to be complete:
it waits for the rank's stream and raises TimeoutError, naming the rank
waited for, if one of its kernels gave up waiting for a peer (or, on the
CPU, if a call still lacks a rank after the timeout); across processes
the host's wait for a peer's event raises so at the call.
The plain versions run the reference's schedule over the w ranks'
tensors, hop by hop; `chip_smoke.py` holds every kernel against them bit
for bit, and the CPU tests hold the direct fold order and the quantized
allreduce's direct gather against them.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import struct
import time

import torch

from ray_tpu_torch.collective import metrics as _cm
from ray_tpu_torch.collective.backends.device_backend import (
    DeviceTransport, GroupSemantics, _QRING_OPS, dequantize_blocks,
    quantize_blocks)
from ray_tpu_torch.collective.types import (QUANT_BLOCK, ReduceOp,
                                            is_cuda_tensor)
from ray_tpu_torch.ops import _build

# Launches of each CUDA kernel (one a rank a call); the wrappers add one
# per launch and nowhere else, so a run can show that its path went
# through the kernels.
ALLREDUCE_LAUNCHES = 0
REDUCESCATTER_LAUNCHES = 0
ALLGATHER_LAUNCHES = 0
QUANTIZED_LAUNCHES = 0

# combine step per reduce op (MEAN accumulates with add; the transport
# divides by world afterwards)
_COMBINE = {
    ReduceOp.SUM: "add",
    ReduceOp.MEAN: "add",
    ReduceOp.MAX: "max",
    ReduceOp.MIN: "min",
    ReduceOp.PRODUCT: "mul",
}
_COMBINE_FNS = {"add": torch.add, "max": torch.maximum,
                "min": torch.minimum, "mul": torch.mul}

# csrc codes, and the instances the source builds (chip_smoke.py holds
# each against its plain version on the card)
_KIND = {"allreduce": 0, "reducescatter": 1, "allgather": 2}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OP = {"add": 0, "max": 1, "min": 2, "mul": 3}
_BUILT = {("allreduce", torch.float32, c) for c in _OP} | {
    ("allreduce", torch.bfloat16, "add"), ("allreduce", torch.int32, "add"),
    ("reducescatter", torch.float32, "add"),
    ("allgather", torch.float32, "add"),
    ("quantized", torch.float32, "add"), ("quantized", torch.float32, "max"),
    ("quantized", torch.float32, "min")}
# what a timed-out block waited for (csrc: Waited, status word 0; word 1
# is the awaited rank)
WAITED_MAIL, WAITED_ADDRS, WAITED_STAGE = 1, 2, 3
WAITED_PARTIAL, WAITED_CHUNK, WAITED_DONE = 4, 5, 6
_WAITED = {WAITED_MAIL: "the output address",
           WAITED_ADDRS: "the input and output addresses",
           WAITED_STAGE: "the staging addresses",
           WAITED_PARTIAL: "the int8 partial",
           WAITED_CHUNK: "the reduced int8 chunk",
           WAITED_DONE: "the done flag"}

# A block's share of a chunk before the grid grows (elements; quant
# blocks for the quantized allreduce): small payloads take few blocks, so
# few flags.
_ELEMS_PER_BLOCK = 4096
_QBLOCKS_PER_BLOCK = 16


# ---------------------------------------------------------------------------
# plain versions: the ring schedule over the w ranks' tensors
# ---------------------------------------------------------------------------

def allreduce_plain(xs: list[torch.Tensor], op) -> list[torch.Tensor]:
    """The exact ring allreduce over ranks' flat [w*C] payloads -> each
    rank's [w*C] output (B5's schedule)."""
    w = len(xs)
    cmb = _COMBINE_FNS[_COMBINE[ReduceOp(op)]]
    chunks = [x.reshape(w, -1) for x in xs]
    send = [chunks[r][r] for r in range(w)]
    for s in range(1, w):
        send = [cmb(send[(r - 1) % w], chunks[r][(r - s) % w])
                for r in range(w)]
    outs = [torch.empty_like(c) for c in chunks]
    for r in range(w):
        outs[r][(r + 1) % w] = send[r]
    for s in range(1, w):
        send = [send[(r - 1) % w] for r in range(w)]
        for r in range(w):
            outs[r][(r - s + 1) % w] = send[r]
    return [o.reshape(-1) for o in outs]


def reducescatter_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The reduce-scatter (SUM, delta = -1) over ranks' [w*C] payloads ->
    rank r's reduced chunk r, [C] (B6's schedule)."""
    w = len(xs)
    chunks = [x.reshape(w, -1) for x in xs]
    send = [chunks[r][(r - 1) % w] for r in range(w)]
    for s in range(1, w):
        send = [send[(r - 1) % w] + chunks[r][(r - 1 - s) % w]
                for r in range(w)]
    return [t.clone() for t in send]


def allgather_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The direct allgather over ranks' [B] payloads -> each rank's [w, B]
    (B7's schedule): rank p's payload into slot p of every output."""
    w = len(xs)
    outs = [x.new_empty((w, x.numel())) for x in xs]
    for p in range(w):
        for out in outs:
            out[p] = xs[p]
    return outs


def describe_wait(status) -> tuple[int, str]:
    """The rank that a timed-out kernel waited for, and what it waited
    for, from the rank's status words [waited, awaited rank, block, call]:
    a peer's mailbox (the allgather's holds the output address it needs,
    the allreduce's and reduce-scatter's the input and output addresses,
    the quantized allreduce's the staging addresses), the quantized
    allreduce's int8 partial of a hop (from the left neighbour) or a
    peer's staged reduced chunk, or a peer's done flag."""
    waited, peer, block, call = (int(v) for v in status)
    if waited not in _WAITED:
        raise ValueError(f"status {waited} names no wait")
    return peer, (f"{_WAITED[waited]} of rank {peer} "
                  f"(call {call}, block {block})")


def allreduce_quantized_plain(xs: list[torch.Tensor], op
                              ) -> list[torch.Tensor]:
    """The EQuARX int8 ring over ranks' f32 [w*C] payloads (C % 256 == 0)
    -> each rank's f32 [w*C] output (the reference's schedule): each
    reduce hop quantizes the partial, the receiver dequantizes and
    combines; the reduced chunk is quantized once and relayed as the same
    bytes (B8 reads those bytes from the owner instead: the same
    result)."""
    w = len(xs)
    cmb = _COMBINE_FNS[_COMBINE[ReduceOp(op)]]
    chunks = [x.reshape(w, -1) for x in xs]
    acc = [chunks[r][r] for r in range(w)]
    for s in range(1, w):
        sent = [quantize_blocks(a) for a in acc]
        acc = [cmb(dequantize_blocks(*sent[(r - 1) % w]),
                   chunks[r][(r - s) % w]) for r in range(w)]
    send = [quantize_blocks(a) for a in acc]
    outs = [torch.empty_like(c) for c in chunks]
    for r in range(w):
        outs[r][(r + 1) % w] = dequantize_blocks(*send[r])
    for s in range(1, w):
        send = [send[(r - 1) % w] for r in range(w)]
        for r in range(w):
            outs[r][(r - s + 1) % w] = dequantize_blocks(*send[r])
    return [o.reshape(-1) for o in outs]


# ---------------------------------------------------------------------------
# the kernels' library
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("ring_collectives")
    if lib.direct_launch.argtypes is None:  # first use: C signatures
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_void_p]
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.direct_launch.argtypes = [i] * 3 + [vp] * 4 + [i, vp] + tail
        lib.direct_launch.restype = ctypes.c_int
        lib.quantized_launch.argtypes = [i] + [vp] * 5 + [i, vp] + tail
        lib.quantized_launch.restype = ctypes.c_int
        vpp = ctypes.POINTER(ctypes.c_void_p)
        lib.ring_ipc_alloc.argtypes = [ctypes.c_ulonglong, vpp]
        lib.ring_ipc_handle.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ring_ipc_open.argtypes = [ctypes.c_char_p, vpp]
        lib.ring_ipc_close.argtypes = [ctypes.c_void_p]
        lib.ring_ipc_free.argtypes = [ctypes.c_void_p]
        lib.ring_event_create.argtypes = [vpp, ctypes.c_char_p]
        lib.ring_event_open.argtypes = [ctypes.c_char_p, vpp]
        lib.ring_event_record.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ring_stream_wait.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ring_event_destroy.argtypes = [ctypes.c_void_p]
        for f in (lib.ring_ipc_alloc, lib.ring_ipc_handle, lib.ring_ipc_open,
                  lib.ring_ipc_close, lib.ring_ipc_free,
                  lib.ring_event_create, lib.ring_event_open,
                  lib.ring_event_record, lib.ring_stream_wait,
                  lib.ring_event_destroy):
            f.restype = ctypes.c_int
        lib.ring_enable_peer_access.argtypes = [ctypes.c_int]
        lib.ring_enable_peer_access.restype = ctypes.c_int
        lib.ring_error_string.argtypes = [ctypes.c_int]
        lib.ring_error_string.restype = ctypes.c_char_p
    return lib


class _PallasOps:
    """The fused ring collectives of one group and its in-process
    rendezvous (the counterpart of the reference's `_PallasOps`, same
    flat layouts): `allreduce(rank, x [B], op)`, `reducescatter_even(rank,
    x [P])`, `allgather(rank, x [B]) -> [w, B]`, `allreduce_quantized(rank,
    x [w*C] f32, op)`. Every rank must make the same calls in the same
    order; a call whose op, dtype or size differs from another rank's
    call of the same index raises."""

    def __init__(self, world: int, devices: list[torch.device],
                 timeout: float):
        self.world = world
        self.devices = list(devices)
        self.timeout = float(timeout)
        self.on_cuda = self.devices[0].type == "cuda"
        self.broken: str | None = None
        self._calls = [0] * world          # calls made by each rank
        self._sigs: dict[int, list] = {}   # call index -> [signature, ranks]
        self._pending: dict[int, dict] = {}  # CPU: call index -> inputs
        self._bufs: dict[tuple, list[dict]] = {}
        self._seqs: dict[tuple, list[int]] = {}
        if not self.on_cuda:
            self.streams = [None] * world
            return
        self.streams = [torch.cuda.Stream(device=d) for d in self.devices]
        self._status = [torch.zeros(4, dtype=torch.int32, device=d)
                        for d in self.devices]
        cards = sorted({d.index for d in self.devices})
        if len(cards) > 1:
            lib = _lib()
            for d in cards:
                with torch.cuda.device(d):
                    for p in cards:
                        rc = lib.ring_enable_peer_access(p) if p != d else 0
                        if rc:
                            raise RuntimeError(
                                f"peer access from cuda:{d} to cuda:{p}: "
                                f"{lib.ring_error_string(rc).decode()}")
        sms = min(torch.cuda.get_device_properties(d).multi_processor_count
                  for d in cards)
        per_card = max(self.devices.count(torch.device("cuda", d))
                       for d in cards)
        # every rank's ring kernel must fit beside the others' work: at
        # most half the card's SMs spin for the ranks on it
        self._max_blocks = max(1, sms // (2 * per_card))
        for d in cards:
            torch.cuda.synchronize(d)

    def device_of(self, rank: int) -> torch.device:
        return self.devices[rank]

    # -- rendezvous -------------------------------------------------------

    def _register(self, rank: int, sig: tuple) -> int:
        if self.broken:
            raise RuntimeError("collective group unusable after an earlier "
                               f"failure: {self.broken}")
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a group of {self.world}")
        idx = self._calls[rank]
        self._calls[rank] += 1
        entry = self._sigs.setdefault(idx, [sig, set()])
        if entry[0] != sig:
            self.broken = (f"rank {rank}'s call {idx} is {sig}, another "
                           f"rank's is {entry[0]}")
            raise ValueError(f"{self.broken}; every rank must make the same "
                             "collective calls in the same order")
        entry[1].add(rank)
        if len(entry[1]) == self.world:
            del self._sigs[idx]
        return idx

    def _post_plain(self, rank, sig, x, out, plain):
        """CPU: records the rank's input; the last rank of the call runs
        the plain version over every rank's input and fills each output."""
        if x.device != self.devices[rank]:
            raise ValueError(f"rank {rank}'s payload must be on "
                             f"{self.devices[rank]}, got {x.device}")
        idx = self._register(rank, sig)
        call = self._pending.setdefault(
            idx, {"t": time.monotonic(), "ranks": {}, "then": []})
        call["ranks"][rank] = (x, out)
        if len(call["ranks"]) == self.world:
            del self._pending[idx]
            ios = [call["ranks"][r] for r in range(self.world)]
            for (_, o), res in zip(ios, plain([x for x, _ in ios])):
                o.copy_(res.reshape(o.shape))
            for redo in call["then"]:
                redo()
        return out

    def defer(self, rank: int, fn, src: torch.Tensor) -> torch.Tensor:
        """fn(src) for a transform of the rank's latest output. On the CPU
        that output is filled only when the last rank calls, so there the
        result is computed again then, in place; on CUDA the stream orders
        it."""
        res = fn(src)
        if not self.on_cuda:
            call = self._pending.get(self._calls[rank] - 1)
            if call is not None and rank in call["ranks"]:
                call["then"].append(lambda: res.copy_(fn(src)))
        return res

    def _buffers(self, key: tuple, chunk: int) -> list[dict]:
        """The buffers of one (op, dtype, chunk) class on every rank, made
        at its first call: the mailbox ([two addresses, sequence number]),
        the flags ([w, nblocks] done flags; the quantized allreduce's
        [3w - 1, nblocks]: done, staged chunk by owner, hop), the quantized
        allreduce's hop slots ([w - 1] quantized chunks) and staging buffer
        (one), each chunk int8 [C] then f32 scales [C / 256], and the
        device table of every rank's mailbox, flags (and slots) addresses.
        They are made and zeroed on each card's default stream, and every
        rank's stream waits for that before its next launch: so no rank's
        kernel can store into a peer's buffer before the peer's zeroing
        has run, and the host does not wait."""
        bufs = self._bufs.get(key)
        if bufs is not None:
            return bufs
        w = self.world
        quantized = key[0] == "quantized"
        units = chunk // QUANT_BLOCK if quantized else chunk
        per = _QBLOCKS_PER_BLOCK if quantized else _ELEMS_PER_BLOCK
        nblocks = max(1, min(self._max_blocks, -(-units // per)))
        rows = 3 * w - 1 if quantized else w
        qchunk = chunk + 4 * (chunk // QUANT_BLOCK)  # bytes
        bufs = []
        for d in self.devices:
            with torch.cuda.device(d), torch.cuda.stream(
                    torch.cuda.default_stream(d)):
                b = {"nblocks": nblocks,
                     "mail": torch.zeros(3, dtype=torch.int64, device=d),
                     "flags": torch.zeros((rows, nblocks), dtype=torch.int32,
                                          device=d)}
                if quantized:
                    b["slots"] = torch.empty(max(1, w - 1) * qchunk,
                                             dtype=torch.uint8, device=d)
                    b["stage"] = torch.empty(qchunk, dtype=torch.uint8,
                                             device=d)
            bufs.append(b)
        table = [b[k].data_ptr() for k in ("mail", "flags", "slots")
                 if k in bufs[0] for b in bufs]
        for b, d in zip(bufs, self.devices):
            with torch.cuda.device(d), torch.cuda.stream(
                    torch.cuda.default_stream(d)):
                b["peers"] = torch.tensor(table, dtype=torch.int64, device=d)
        done = []
        for d in sorted(set(self.devices), key=lambda d: d.index):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.default_stream(d))
            done.append(ev)
        for s in self.streams:
            for ev in done:
                s.wait_event(ev)
        self._bufs[key] = bufs
        self._seqs[key] = [0] * w
        return bufs

    def _validate(self, rank, kind, combine, x):
        """Checks one rank's CUDA call before it counts as made."""
        dtype = x.dtype
        if (kind, dtype, combine) not in _BUILT:
            raise TypeError(f"{kind} with {combine} on {dtype}: no CUDA "
                            "instance is built (csrc: direct_launch, "
                            "quantized_launch)")
        dev = self.devices[rank]
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"rank {rank}'s payload must be contiguous on "
                             f"{dev}, got {x.device}")
        stream = self.streams[rank]
        if torch.cuda.current_stream(dev) != stream:
            raise ValueError(
                f"rank {rank}'s collectives run on its own stream: call "
                "under torch.cuda.stream(handle.stream); two ranks on one "
                "stream would wait on each other")

    def _launch(self, rank, kind, combine, x, out, chunk):
        """Launches one rank's kernel on its stream."""
        dtype, dev, stream = x.dtype, self.devices[rank], self.streams[rank]
        key = (kind, dtype, chunk)
        bufs = self._buffers(key, chunk)
        w = self.world
        own = bufs[rank]
        seqs = self._seqs[key]
        seqs[rank] += 1
        seq, timeout_ns = seqs[rank] & 0xFFFFFFFF, int(self.timeout * 1e9)
        status = self._status[rank].data_ptr()
        lib = _lib()
        with torch.cuda.device(dev):
            if kind in _KIND:
                rc = lib.direct_launch(
                    _KIND[kind], _DTYPE[dtype], _OP[combine], x.data_ptr(),
                    out.data_ptr(), own["peers"].data_ptr(), None, -1,
                    status, chunk, w, rank, own["nblocks"], seq, timeout_ns,
                    stream.cuda_stream)
            else:
                rc = lib.quantized_launch(
                    _OP[combine], x.data_ptr(), out.data_ptr(),
                    own["peers"].data_ptr(), own["stage"].data_ptr(), None,
                    -1, status, chunk, w, rank, own["nblocks"], seq,
                    timeout_ns, stream.cuda_stream)
        if rc != 0:
            self.broken = f"rank {rank}'s {kind} did not launch"
            raise RuntimeError(f"{kind} launch failed: "
                               f"{lib.ring_error_string(rc).decode()} "
                               f"(rank {rank}, chunk {chunk}, {dtype})")

    # -- the four wrappers ----------------------------------------------

    def allreduce(self, rank: int, x: torch.Tensor, op) -> torch.Tensor:
        """B5: x [B] -> the reduced [B] (padded to w chunks inside)."""
        global ALLREDUCE_LAUNCHES
        op = ReduceOp(op)
        combine = _COMBINE[op]
        w, n = self.world, x.numel()
        bp = w * -(-n // w)
        if bp > n:
            x = torch.cat([x, x.new_zeros(bp - n)])
        out = x.new_empty(bp)
        sig = ("allreduce", combine, x.dtype, bp)
        if not is_cuda_tensor(x):
            self._post_plain(rank, sig, x, out,
                             lambda xs: allreduce_plain(xs, op))
            return out[:n]
        self._validate(rank, "allreduce", combine, x)
        self._register(rank, sig)
        self._launch(rank, "allreduce", combine, x, out, bp // w)
        ALLREDUCE_LAUNCHES += 1
        return out[:n]

    def reducescatter_even(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """B6: x [P], P % w == 0 -> this rank's summed chunk [P / w]."""
        global REDUCESCATTER_LAUNCHES
        w, p = self.world, x.numel()
        if p % w:
            raise ValueError(f"reducescatter_even: {p} elements do not "
                             f"split evenly over {w} ranks")
        out = x.new_empty(p // w)
        sig = ("reducescatter", x.dtype, p)
        if not is_cuda_tensor(x):
            return self._post_plain(rank, sig, x, out, reducescatter_plain)
        self._validate(rank, "reducescatter", "add", x)
        self._register(rank, sig)
        self._launch(rank, "reducescatter", "add", x, out, p // w)
        REDUCESCATTER_LAUNCHES += 1
        return out

    def allgather(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """B7: x [B] -> every rank's payload, [w, B] in rank order."""
        global ALLGATHER_LAUNCHES
        w, b = self.world, x.numel()
        out = x.new_empty((w, b))
        sig = ("allgather", x.dtype, b)
        if not is_cuda_tensor(x):
            return self._post_plain(rank, sig, x, out, allgather_plain)
        self._validate(rank, "allgather", "add", x)
        self._register(rank, sig)
        self._launch(rank, "allgather", "add", x, out, b)
        ALLGATHER_LAUNCHES += 1
        return out

    def allreduce_quantized(self, rank: int, x: torch.Tensor,
                            op) -> torch.Tensor:
        """B8: x f32 [w*C] with C % QUANT_BLOCK == 0 (the transport pads
        with `_qring_pad`) -> the int8-wire reduced [w*C] f32."""
        global QUANTIZED_LAUNCHES
        op = ReduceOp(op)
        w, b = self.world, x.numel()
        if op not in _QRING_OPS:
            raise ValueError(f"the quantized allreduce has no {op.value}")
        if x.dtype != torch.float32 or b % (w * QUANT_BLOCK):
            raise ValueError(f"allreduce_quantized takes f32 [w*C] with "
                             f"C % {QUANT_BLOCK} == 0, got {x.dtype} [{b}]")
        combine = _COMBINE[op]
        out = torch.empty_like(x)
        sig = ("quantized", combine, b)
        if not is_cuda_tensor(x):
            return self._post_plain(
                rank, sig, x, out,
                lambda xs: allreduce_quantized_plain(xs, op))
        if x.data_ptr() % 16:
            x = x.clone()
        self._validate(rank, "quantized", combine, x)
        self._register(rank, sig)
        self._launch(rank, "quantized", combine, x, out, b // w)
        QUANTIZED_LAUNCHES += 1
        return out

    # -- completion and teardown ------------------------------------------

    def check(self, rank: int):
        """Waits until the rank's calls have run and raises TimeoutError if
        one of them waited longer than the timeout for a peer."""
        w = self.world
        if not self.on_cuda:
            for idx, call in sorted(self._pending.items()):
                if rank not in call["ranks"]:
                    continue
                missing = sorted(set(range(w)) - set(call["ranks"]))
                # nothing can arrive while this thread waits; the wait
                # keeps the timeout's meaning
                time.sleep(max(0.0, self.timeout
                               - (time.monotonic() - call["t"])))
                self.broken = (f"rank {rank}'s call {idx} timed out waiting "
                               f"for rank(s) {missing}")
                raise TimeoutError(f"{self.broken} ({self.timeout} s)")
            return
        self.streams[rank].synchronize()
        status = self._status[rank].tolist()
        if status[0]:
            _, what = describe_wait(status)
            self.broken = (f"rank {rank}'s collective waited more than "
                           f"{self.timeout} s for {what}")
            raise TimeoutError(self.broken)

    def close(self):
        """Waits for every rank's stream, then frees the buffers."""
        if self.on_cuda:
            for s in self.streams:
                s.synchronize()
        self._bufs.clear()
        self._seqs.clear()
        self._pending.clear()


class LocalPallasTransport(GroupSemantics):
    """Every rank of a group in this process (the counterpart of the
    reference's single-controller `XlaGroup`): the device plane's op
    semantics (`GroupSemantics`) over the fused ring kernels of
    `_PallasOps`, each op taking the calling rank."""

    def __init__(self, world_size: int, devices: list[torch.device],
                 timeout: float):
        super().__init__(world_size, _PallasOps(world_size, devices,
                                                timeout))

    @property
    def streams(self):
        return self._ops.streams

    @property
    def devices(self):
        return self._ops.devices

    def check(self, rank: int):
        """Waits for the rank's collectives and raises TimeoutError if one
        of them timed out (see `_PallasOps.check`)."""
        self._ops.check(rank)

    def close(self):
        self._ops.close()


# ---------------------------------------------------------------------------
# one rank a process: the peers' buffers through CUDA IPC
# ---------------------------------------------------------------------------

_ALIGN = 256  # bytes: each buffer of a region starts on this boundary
_IPC_HANDLE_BYTES = 64


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _raw(ptr: int, nbytes: int, dtype: torch.dtype) -> torch.Tensor:
    """A tensor over `nbytes` of device memory at `ptr` (a region's
    buffer), without a copy."""

    class _View:
        __cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                    "data": (ptr, False), "version": 3,
                                    "strides": None}

    return torch.as_tensor(_View(), device="cuda").view(dtype)


class _IpcPallasOps:
    """The fused ring collectives of one rank in its own process (the
    counterpart of the reference's `_PallasOps`, same flat layouts),
    `rank` always this process's: `allreduce(rank, x [B], op)`,
    `reducescatter_even(rank, x [P])`, `allgather(rank, x [B]) -> [w, B]`,
    `allreduce_quantized(rank, x [w*C] f32, op)`.

    No kernel waits for another process (csrc header): each call is one
    or more phase launches, ordered by rounds of CUDA IPC events. Every
    rank has an event a slot (READY, DONE, then one a phase of B8), which
    it records on its stream, and a counter a slot in a shared segment,
    which it sets to the call's number just after. In a round a rank
    records its event, waits on the host until every peer it needs has
    set its counter to this call (a bounded wait: TimeoutError naming the
    rank that did not come), and makes its stream wait for those peers'
    events; the card then orders the phases without any kernel spinning.
    B5-B7: READY (every input in its buffer, every previous output read
    out), the fold or scatter, DONE (every rank's phase done: outputs
    complete, inputs free). B8: phase 0, then each hop after the left
    neighbour's previous phase, the gather after every peer staged its
    chunk, DONE.

    The peers' buffers of a class, and the events, are mapped at the
    first use, which every rank makes at the same point of its op stream:
    `allgather(bytes) -> [bytes of every rank]` is the group's exchange.
    `blocks` is the grid of a phase launch."""

    READY, DONE, HOP = 0, 1, 2  # event slots; HOP + s: B8's phase s

    def __init__(self, world: int, rank: int, device: torch.device,
                 timeout: float, allgather, blocks: int):
        self.world = world
        self.rank = rank
        self.device = device
        self.timeout = float(timeout)
        self.broken: str | None = None
        self._allgather = allgather
        self._blocks = blocks
        self._classes: dict[tuple, dict] = {}
        self._call = 0
        self._events = None  # [rank][slot] events (own created, peers')
        self._counters = None

    def device_of(self, rank: int) -> torch.device:
        return self.device

    def defer(self, rank: int, fn, src: torch.Tensor) -> torch.Tensor:
        return fn(src)

    # -- the event rounds -------------------------------------------------

    def _slots(self) -> int:
        return self.HOP + self.world

    def _setup_events(self):
        """This rank's events and the group's counter segment (made by
        rank 0), exchanged once; every peer's events opened."""
        import msgpack

        from ray_tpu_torch.native.store import create_segment, open_segment

        lib = _lib()
        w, slots = self.world, self._slots()
        size = 8 * w * slots
        own, handles = [], b""
        with torch.cuda.device(self.device):
            for _ in range(slots):
                ev = ctypes.c_void_p()
                h = ctypes.create_string_buffer(_IPC_HANDLE_BYTES)
                _ipc_check(lib, lib.ring_event_create(ctypes.byref(ev), h),
                           "creating an interprocess event")
                own.append(ev.value)
                handles += h.raw
            seg = None
            if self.rank == 0:
                seg = create_segment(f"ring_events_{os.getpid()}_"
                                     f"{os.urandom(4).hex()}.seg", size)
        try:
            with torch.cuda.device(self.device):
                mine = msgpack.packb({"events": handles,
                                      "path": seg.path if seg else None})
                infos = [msgpack.unpackb(b, raw=False)
                         for b in self._allgather(mine)]
                if seg is None:
                    seg = open_segment(infos[0]["path"], size)
                events = []
                for p, info in enumerate(infos):
                    if p == self.rank:
                        events.append(own)
                        continue
                    peer = []
                    for j in range(slots):
                        ev = ctypes.c_void_p()
                        h = info["events"][j * _IPC_HANDLE_BYTES:
                                           (j + 1) * _IPC_HANDLE_BYTES]
                        _ipc_check(lib, lib.ring_event_open(
                            h, ctypes.byref(ev)), f"opening rank {p}'s event")
                        peer.append(ev.value)
                    events.append(peer)
            self._allgather(b"mapped")  # every rank has the segment open
        finally:
            # rank 0 unlinks once every rank has mapped the segment, and
            # also when a peer failed or died before: the file must not
            # outlive the group
            if self.rank == 0:
                with contextlib.suppress(OSError):
                    os.unlink(seg.path)
        self._events, self._counters = events, seg

    def _counter_off(self, rank: int, slot: int) -> int:
        return 8 * (rank * self._slots() + slot)

    def _record(self, slot: int):
        """Records this rank's event of `slot` on the current stream, then
        says so to the peers: the counter of (rank, slot) := this call."""
        if self._events is None:
            self._setup_events()
        lib = _lib()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            _ipc_check(lib, lib.ring_event_record(
                self._events[self.rank][slot], stream), "recording an event")
        struct.pack_into("<Q", self._counters.view,
                         self._counter_off(self.rank, slot), self._call)

    def _counter(self, rank: int, slot: int) -> int:
        return struct.unpack_from("<Q", self._counters.view,
                                  self._counter_off(rank, slot))[0]

    def _await(self, slot: int, peers, what: str):
        """The current stream waits for each peer's event of `slot` of this
        call, once the peer has recorded it; TimeoutError naming the peer
        that did not record it within the timeout, and every rank that
        has not come to this call at all (each call records an event at
        its start: READY, or B8's phase 0)."""
        lib = _lib()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        deadline = time.monotonic() + self.timeout
        for p in peers:
            spins = 0
            while self._counter(p, slot) < self._call:
                if time.monotonic() > deadline:
                    absent = [q for q in range(self.world) if max(
                        self._counter(q, j) for j in range(self._slots()))
                        < self._call]
                    self.broken = (
                        f"rank {self.rank}'s collective waited more than "
                        f"{self.timeout} s for {what} of rank {p} (call "
                        f"{self._call})" + "".join(
                            f"; rank {q} has not come to the call"
                            for q in absent))
                    raise TimeoutError(self.broken)
                spins += 1
                time.sleep(0 if spins < 1000 else 5e-5)
            with torch.cuda.device(self.device):
                _ipc_check(lib, lib.ring_stream_wait(
                    stream, self._events[p][slot]), "waiting on an event")

    def _round(self, slot: int, what: str):
        """Records `slot`, then waits for every peer's."""
        self._record(slot)
        self._await(slot, [p for p in range(self.world) if p != self.rank],
                    what)

    # -- buffers and launches ---------------------------------------------

    def _class(self, kind: str, dtype: torch.dtype, chunk: int) -> dict:
        """The buffers of one (op, dtype, chunk) class: this rank's region
        (B8's hop slots and staging buffer; B5's and B6's input buffer;
        B5's and B7's output buffer), every peer's mapped, and the device
        tables of their addresses: `peers` ([3][w]: row 2 the hop slots)
        and `fixed` ([2][w]: B5 inputs and outputs, B6 inputs, B7 outputs,
        B8 staging payloads and scales)."""
        key = (kind, dtype, chunk)
        cls = self._classes.get(key)
        if cls is not None:
            return cls
        w = self.world
        quantized = kind == "quantized"
        qchunk = chunk + 4 * (chunk // QUANT_BLOCK)
        payload = w * chunk * dtype.itemsize
        sizes = {"slots": max(1, w - 1) * qchunk if quantized else 0,
                 "stage": qchunk if quantized else 0,
                 "in": payload if kind in ("allreduce", "reducescatter")
                 else 0,
                 "out": payload if kind in ("allreduce", "allgather") else 0}
        offs, total = {}, 0
        for name, size in sizes.items():
            offs[name] = total
            total += _aligned(size)
        lib = _lib()
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(
            _IPC_HANDLE_BYTES)
        with torch.cuda.device(self.device):
            _ipc_check(lib, lib.ring_ipc_alloc(total, ctypes.byref(ptr)),
                       "allocating the buffers of a class")
            own = ptr.value
            _ipc_check(lib, lib.ring_ipc_handle(own, handle),
                       "exporting the buffers of a class")
            handles = self._allgather(handle.raw)
            bases = []
            for p, h in enumerate(handles):
                if p == self.rank:
                    bases.append(own)
                    continue
                peer = ctypes.c_void_p()
                _ipc_check(lib, lib.ring_ipc_open(h, ctypes.byref(peer)),
                           f"mapping rank {p}'s buffers")
                bases.append(peer.value)
        table = [0] * (2 * w) + [b + offs["slots"] for b in bases]
        if quantized:
            fixed = ([b + offs["stage"] for b in bases]
                     + [b + offs["stage"] + chunk for b in bases])
        else:
            fixed = ([b + offs["in"] if sizes["in"] else 0 for b in bases]
                     + [b + offs["out"] if sizes["out"] else 0
                        for b in bases])
        units = chunk // QUANT_BLOCK if quantized else chunk
        per = _QBLOCKS_PER_BLOCK if quantized else _ELEMS_PER_BLOCK
        cls = self._classes[key] = {
            "nblocks": max(1, min(self._blocks, -(-units // per))),
            "base": own, "bases": bases,
            "peers": torch.tensor(table, dtype=torch.int64,
                                  device=self.device),
            "fixed": torch.tensor(fixed, dtype=torch.int64,
                                  device=self.device),
            "stage": own + offs["stage"],
            "in": (_raw(own + offs["in"], payload, dtype)
                   if sizes["in"] else None),
            "out": (_raw(own + offs["out"], payload, dtype)
                    if sizes["out"] else None)}
        return cls

    def _validate(self, rank, kind, combine, x):
        if rank != self.rank:
            raise ValueError(f"this process holds rank {self.rank}, not "
                             f"rank {rank}")
        if self.broken:
            raise RuntimeError("collective group unusable after an earlier "
                               f"failure: {self.broken}")
        if (kind, x.dtype, combine) not in _BUILT:
            raise TypeError(f"{kind} with {combine} on {x.dtype}: no CUDA "
                            "instance is built (csrc: direct_launch, "
                            "quantized_launch)")
        if not is_cuda_tensor(x) or x.device != self.device:
            raise ValueError(f"rank {rank}'s payload must be on "
                             f"{self.device}, got {x.device}")
        self._call += 1

    def _launch(self, kind, combine, x, out, chunk, cls, phase):
        """One phase launch of this rank's kernel on the current stream."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        lib = _lib()
        # a phase launch waits for nothing, so it records no timeout
        # status
        args = (cls["peers"].data_ptr(), cls["fixed"].data_ptr(), phase,
                None, chunk, self.world, self.rank, cls["nblocks"],
                self._call & 0xFFFFFFFF, int(self.timeout * 1e9), stream)
        with torch.cuda.device(self.device):
            if kind in _KIND:
                rc = lib.direct_launch(
                    _KIND[kind], _DTYPE[x.dtype], _OP[combine], x.data_ptr(),
                    out.data_ptr(), *args)
            else:
                rc = lib.quantized_launch(
                    _OP[combine], x.data_ptr(), out.data_ptr(), args[0],
                    cls["stage"], *args[1:])
        if rc != 0:
            self.broken = f"rank {self.rank}'s {kind} did not launch"
            raise RuntimeError(f"{kind} launch failed: "
                               f"{lib.ring_error_string(rc).decode()} "
                               f"(rank {self.rank}, chunk {chunk}, "
                               f"{x.dtype})")

    def _direct(self, kind, combine, x, out, chunk, cls):
        """B5-B7: READY, the one phase, DONE."""
        self._round(self.READY, "the buffers (inputs in, outputs out)")
        self._launch(kind, combine, x, out, chunk, cls, 0)
        self._round(self.DONE, "the end of its phase")

    # -- the four wrappers ------------------------------------------------

    def allreduce(self, rank: int, x: torch.Tensor, op) -> torch.Tensor:
        """B5: x [B] -> the reduced [B]: x into the region's input
        buffer, the kernel, the region's output buffer out."""
        global ALLREDUCE_LAUNCHES
        combine = _COMBINE[ReduceOp(op)]
        w, n = self.world, x.numel()
        bp = w * -(-n // w)
        self._validate(rank, "allreduce", combine, x)
        cls = self._class("allreduce", x.dtype, bp // w)
        cls["in"][:n].copy_(x)
        if bp > n:
            cls["in"][n:].zero_()
        self._direct("allreduce", combine, cls["in"], cls["out"], bp // w,
                     cls)
        ALLREDUCE_LAUNCHES += 1
        return cls["out"][:n].clone()

    def reducescatter_even(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """B6: x [P], P % w == 0 -> this rank's summed chunk [P / w]."""
        global REDUCESCATTER_LAUNCHES
        w, p = self.world, x.numel()
        if p % w:
            raise ValueError(f"reducescatter_even: {p} elements do not "
                             f"split evenly over {w} ranks")
        self._validate(rank, "reducescatter", "add", x)
        cls = self._class("reducescatter", x.dtype, p // w)
        cls["in"].copy_(x)
        out = x.new_empty(p // w)
        self._direct("reducescatter", "add", cls["in"], out, p // w, cls)
        REDUCESCATTER_LAUNCHES += 1
        return out

    def allgather(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """B7: x [B] -> every rank's payload, [w, B] in rank order."""
        global ALLGATHER_LAUNCHES
        w, b = self.world, x.numel()
        self._validate(rank, "allgather", "add", x)
        cls = self._class("allgather", x.dtype, b)
        self._direct("allgather", "add", x.contiguous(), cls["out"], b, cls)
        ALLGATHER_LAUNCHES += 1
        return cls["out"].view(w, b).clone()

    def allreduce_quantized(self, rank: int, x: torch.Tensor,
                            op) -> torch.Tensor:
        """B8: x f32 [w*C] with C % QUANT_BLOCK == 0 -> the int8-wire
        reduced [w*C] f32, in w + 1 phases (csrc header); x and the
        output are the caller's. Each phase launch counts."""
        global QUANTIZED_LAUNCHES
        op = ReduceOp(op)
        w, b = self.world, x.numel()
        if op not in _QRING_OPS:
            raise ValueError(f"the quantized allreduce has no {op.value}")
        if x.dtype != torch.float32 or b % (w * QUANT_BLOCK):
            raise ValueError(f"allreduce_quantized takes f32 [w*C] with "
                             f"C % {QUANT_BLOCK} == 0, got {x.dtype} [{b}]")
        combine = _COMBINE[op]
        if x.data_ptr() % 16:
            x = x.clone()
        self._validate(rank, "quantized", combine, x)
        cls = self._class("quantized", x.dtype, b // w)
        out = torch.empty_like(x)
        c, left = b // w, (self.rank - 1) % w
        if w == 1:
            self._launch("quantized", combine, x, out, c, cls, 0)
            QUANTIZED_LAUNCHES += 1
            return out
        for s in range(w):  # phase 0, then hops 1 .. w - 1
            if s:
                self._await(self.HOP + s - 1, [left],
                            f"the int8 partial of hop {s}")
            self._launch("quantized", combine, x, out, c, cls, s)
            self._record(self.HOP + s)
        self._await(self.HOP + w - 1,
                    [p for p in range(w) if p != self.rank],
                    "the staged reduced chunk")
        self._launch("quantized", combine, x, out, c, cls, w)
        self._round(self.DONE, "the end of its gather")
        QUANTIZED_LAUNCHES += w + 1
        return out

    # -- completion and teardown ------------------------------------------

    def check(self, rank: int):
        """Waits until this rank's calls have run. (A peer that does not
        come is found by the host's bounded waits, which raise at the
        call.)"""
        torch.cuda.synchronize(self.device)

    def close(self):
        """Waits for this rank's work, unmaps the peers' buffers and
        events and frees its own. Every peer's phase that touched them
        ended before this rank's last DONE round did."""
        lib = _lib()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            for cls in self._classes.values():
                for p, base in enumerate(cls["bases"]):
                    if p != self.rank:
                        lib.ring_ipc_close(base)
                lib.ring_ipc_free(cls["base"])
            if self._events is not None:
                for p, events in enumerate(self._events):
                    for ev in events:
                        lib.ring_event_destroy(ev)
                self._counters.close(unlink=False)
        self._classes.clear()
        self._events = None


def _ipc_check(lib, rc: int, what: str):
    if rc:
        raise RuntimeError(f"CUDA IPC, {what}: "
                           f"{lib.ring_error_string(rc).decode()}")


def supported(kind: str, dtype: torch.dtype, op=ReduceOp.SUM,
              quantize=None, even: bool = False) -> bool:
    """Whether one op of the device semantics reaches a built kernel
    instance: the PALLAS tier votes for nothing else. kind: "allreduce",
    "reducescatter" (even: the even-split reduce-scatter, B6) or
    "allgather"."""
    op = ReduceOp(op)
    floating = dtype.is_floating_point
    if kind in ("allreduce", "reducescatter") and quantize and floating \
            and op in _QRING_OPS:
        return True  # B8, in f32
    if kind == "reducescatter" and even:
        return dtype == torch.float32  # B6
    if kind == "allgather":
        return dtype == torch.float32  # B7
    work = dtype
    if op == ReduceOp.MEAN and dtype == torch.float16:
        work = torch.float32
    if op == ReduceOp.MEAN and not floating:
        op = ReduceOp.SUM
    return ("allreduce", work, _COMBINE[op]) in _BUILT


class PallasTransport(DeviceTransport):
    """Transport.PALLAS: one rank in this process; the device plane's op
    semantics over the fused ring kernels of `_IpcPallasOps` (the
    reference's `PallasTransport`, pallas_backend.py:487-502)."""

    def __init__(self, world_size: int, rank: int, device: torch.device,
                 timeout: float, allgather, blocks: int):
        super().__init__(world_size, rank, _IpcPallasOps(
            world_size, rank, device, timeout, allgather, blocks))

    def _counted(self):
        _cm.PALLAS_OPS += 1

    def supports(self, kind: str, arr, op=ReduceOp.SUM, quantize=None):
        rows = arr.shape[0] if arr.dim() else 1
        even = (kind == "reducescatter" and ReduceOp(op) == ReduceOp.SUM
                and arr.dim() and rows and rows % self.world_size == 0
                and not quantize)
        return supported(kind, arr.dtype, op, quantize, bool(even))


def reset_launches():
    """Sets every launch counter to 0."""
    global ALLREDUCE_LAUNCHES, REDUCESCATTER_LAUNCHES, ALLGATHER_LAUNCHES
    global QUANTIZED_LAUNCHES
    ALLREDUCE_LAUNCHES = REDUCESCATTER_LAUNCHES = ALLGATHER_LAUNCHES = 0
    QUANTIZED_LAUNCHES = 0
