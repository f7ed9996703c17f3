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

Every rank of a group lives in this process. `_PallasOps` is the group's
rendezvous: each rank's device (rank r on cuda:(r % device_count)), its
stream, its status words, the buffers of every (op, dtype, chunk) class
(mailboxes, flags, the quantized allreduce's hop slots and staging
buffers, and a device table of their addresses), and the calls' sequence
numbers. A rank's kernel runs on the rank's stream, which must be the
current stream when the rank calls: its blocks spin until the peers'
kernels, on their own streams, have published their buffers or sent
their data, so two ranks on one stream would wait on each other forever
(until the timeout). A rank's kernel of a call finishes only once every
rank has launched its own, and the ranks are driven by one host thread;
so nothing here waits on the host, and the caller must not either before
every rank has made the call (the trainer steps its ranks in lockstep).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, or raises; there is no other path. On the CPU
a rank's call returns its output tensor at once and the group fills every
rank's output when the last rank has called, by running the plain version
over all ranks' inputs. `check(rank)` is where a rank's calls are known
to be complete: it waits for the rank's stream and raises TimeoutError,
naming the rank waited for, if one of its kernels gave up waiting for a
peer (or, on the CPU, if a call still lacks a rank after the timeout).
The plain versions run the reference's schedule over the w ranks'
tensors, hop by hop; `chip_smoke.py` holds every kernel against them bit
for bit, and the CPU tests hold the direct fold order and the quantized
allreduce's direct gather against them.
"""

from __future__ import annotations

import ctypes
import time

import torch

from ray_tpu_torch.collective.backends.device_backend import (
    DeviceTransport, _QRING_OPS, dequantize_blocks, quantize_blocks)
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
        lib.direct_launch.argtypes = ([ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 4 + tail)
        lib.direct_launch.restype = ctypes.c_int
        lib.quantized_launch.argtypes = ([ctypes.c_int]
                                         + [ctypes.c_void_p] * 5 + tail)
        lib.quantized_launch.restype = ctypes.c_int
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
                    out.data_ptr(), own["peers"].data_ptr(), status, chunk,
                    w, rank, own["nblocks"], seq, timeout_ns,
                    stream.cuda_stream)
            else:
                rc = lib.quantized_launch(
                    _OP[combine], x.data_ptr(), out.data_ptr(),
                    own["peers"].data_ptr(), own["stage"].data_ptr(), status,
                    chunk, w, rank, own["nblocks"], seq, timeout_ns,
                    stream.cuda_stream)
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


class PallasTransport(DeviceTransport):
    """Transport.PALLAS: the device plane's op semantics
    (`DeviceTransport`) over the fused ring kernels of `_PallasOps`."""

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


def reset_launches():
    """Sets every launch counter to 0."""
    global ALLREDUCE_LAUNCHES, REDUCESCATTER_LAUNCHES, ALLGATHER_LAUNCHES
    global QUANTIZED_LAUNCHES
    ALLREDUCE_LAUNCHES = REDUCESCATTER_LAUNCHES = ALLGATHER_LAUNCHES = 0
    QUANTIZED_LAUNCHES = 0
