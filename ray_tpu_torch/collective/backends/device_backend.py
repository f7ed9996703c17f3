"""The device plane: its op semantics and the DEVICE tier; port of
ray_tpu/collective/backends/xla_backend.py.

The JAX package has two device tiers with one set of semantics:
`DeviceTransport` (XLA collectives, `_DeviceOps`) and its subclass
`PallasTransport` (the fused ring kernels, `_PallasOps`), which differ
only in what one op costs, never in what it returns. This module keeps
those semantics for the port: the shape classes (`_bucket`), the
block-scaled int8 format (`quantize_blocks`, `dequantize_blocks`), the
quantized ring's padding and wire accounting (`_qring_pad`,
`_qring_saved_bytes`), and `GroupSemantics`, which pads, promotes and
slices around an `ops` object that does the ring work for the calling
rank. Three ops objects exist: `_ProcessGroupOps` (this module), the
DEVICE tier over a torch.distributed process group of the group's
processes (NCCL between cards, gloo on the CPU); and the fused ring
kernels of `pallas_backend`, one rank a process (`_IpcPallasOps`) or
every rank in one process (`_PallasOps`).

`DeviceTransport` is one rank of the DEVICE tier in its own process (the
reference's `DeviceTransport`): the per-process `HostGroup` routes an op
here when every rank voted for it (host_backend.py). Its process group is
the group's own (parallel/multihost.py), never the process's default
one. NCCL refuses two ranks on one card, so a group whose ranks share a
card never votes for this tier.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.collective import metrics as _cm
from ray_tpu_torch.collective.types import (QUANT_BLOCK, ReduceOp,
                                            normalize_quantize)


def _bucket(n: int) -> int:
    """Shape-class: next power of two >= n (floor 16)."""
    return 1 << max(4, (max(n, 1) - 1).bit_length())


def quantize_blocks(x: torch.Tensor, block: int = QUANT_BLOCK):
    """Block-scaled symmetric int8: flat float [n] (n % block == 0) ->
    (int8 [n], float32 scales [n // block]); scale = absmax/127 per
    block (1.0 for all-zero blocks so dequant stays exact zeros).

    Every division is a true division by a tensor: PyTorch's CUDA
    kernels compute a division by a Python scalar as a product with its
    reciprocal, which rounds differently from the reference's and the
    ring kernel's IEEE division."""
    b = x.reshape(-1, block).float()
    absmax = b.abs().amax(1)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(b / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      block: int = QUANT_BLOCK) -> torch.Tensor:
    return (q.reshape(-1, block).float() * scale[:, None]).reshape(-1)


# ops the quantized ring carries (MEAN accumulates with add; the caller
# divides by world size at the end)
_QRING_OPS = (ReduceOp.SUM, ReduceOp.MEAN, ReduceOp.MAX, ReduceOp.MIN)


def _qring_pad(n: int, w: int) -> int:
    """Padded per-rank payload length for the quantized ring: bucket the
    size class, then round the per-rank chunk up to the quant block."""
    c = -(-_bucket(n) // w)
    c = -(-c // QUANT_BLOCK) * QUANT_BLOCK
    return w * c


def _qring_saved_bytes(n_padded: int, w: int, in_dtype: torch.dtype,
                       op) -> int:
    """Wire bytes the int8 format avoids for one quantized ring
    allreduce: 2(w-1) chunk hops of C elements each, the EXACT tier's
    wire dtype (input dtype, except f16 MEAN which accumulates f32 on
    the exact paths) vs int8 payload + one f32 scale per block."""
    if ReduceOp(op) == ReduceOp.MEAN and in_dtype == torch.float16:
        itemsize = 4
    else:
        itemsize = torch.empty((), dtype=in_dtype).element_size()
    c = n_padded // w
    hops = 2 * max(w - 1, 0)
    exact = hops * c * itemsize
    quant = hops * (c + 4 * (c // QUANT_BLOCK))
    return max(exact - quant, 0)


def split_bounds(n: int, w: int) -> list[int]:
    """np.array_split partition points: the first n % w parts get the
    extra element (ray_tpu/collective/backends/shm_transport.py)."""
    base, extra = divmod(n, w)
    bounds = [0]
    for i in range(w):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


def _pad(flat: torch.Tensor, length: int, dtype: torch.dtype):
    """flat [n] as `dtype`, zero-padded to [length]."""
    flat = flat.to(dtype)
    n = flat.shape[0]
    if n == length:
        return flat.contiguous()
    out = flat.new_zeros(length)
    out[:n] = flat
    return out


class GroupSemantics:
    """The device plane's host-parity op surface (xla_backend.py:470-561)
    for the calling rank, over an `ops` object with the fused-kernel
    signatures of `_PallasOps`: `allreduce(rank, x [B], op)`,
    `reducescatter_even(rank, x [P])`, `allgather(rank, x [B]) -> [w, B]`,
    `allreduce_quantized(rank, x [w*C] f32, op)`, `defer(rank, fn, src)`
    and `device_of(rank)`.

    Semantics kept from the reference: payloads pad to `_bucket(n)`;
    integer MEAN sums exactly and divides in float64 (on the rank's
    device: a host division would wait for peers that the same host
    thread has not driven yet); f16 MEAN accumulates in f32; MEAN
    combines with add and divides afterwards; reducescatter takes the
    even-split path only for SUM on rows % w == 0 without quantize, and
    otherwise allreduces and slices by `split_bounds`; allgather returns
    a list; broadcast is an allreduce SUM of the source's payload and
    every other rank's zeros (xla_backend.py:180-190)."""

    def __init__(self, world_size: int, ops):
        self.world_size = world_size
        self._ops = ops

    # -- op surface ------------------------------------------------------

    def allreduce(self, rank: int, arr: torch.Tensor,
                  op: ReduceOp = ReduceOp.SUM, quantize=None):
        op = ReduceOp(op)
        q = normalize_quantize(quantize)
        in_dt = arr.dtype
        shape, n = tuple(arr.shape), arr.numel()
        floating = arr.is_floating_point()
        flat = arr.reshape(-1)
        if q and floating and op in _QRING_OPS:
            return self._allreduce_quantized(rank, flat, n, shape, in_dt,
                                             op)
        if op == ReduceOp.MEAN and not floating:
            total = self.allreduce(rank, arr, ReduceOp.SUM)
            return self._ops.defer(
                rank, lambda t: t.to(torch.float64) / self.world_size, total)
        work_dt = in_dt
        if op == ReduceOp.MEAN and in_dt == torch.float16:
            work_dt = torch.float32  # f32 accumulate, f16 out
        x = _pad(flat, _bucket(n), work_dt)
        row = self._ops.allreduce(rank, x, op)[:n]
        if op == ReduceOp.MEAN:
            row = self._ops.defer(
                rank, lambda t: (t / self.world_size).to(in_dt), row)
        return row.reshape(shape)

    def _allreduce_quantized(self, rank, flat, n, shape, in_dt, op):
        w = self.world_size
        padded = _qring_pad(n, w)
        x = _pad(flat, padded, torch.float32)
        row = self._ops.allreduce_quantized(rank, x, op)[:n]
        _cm.QUANT_SAVED += _qring_saved_bytes(padded, w, in_dt, op)
        mean = op == ReduceOp.MEAN
        return self._ops.defer(
            rank, lambda t: (t / w if mean else t).to(in_dt).reshape(shape),
            row)

    def reduce(self, rank: int, arr: torch.Tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM, quantize=None):
        out = self.allreduce(rank, arr, op, quantize=quantize)
        return out if rank == dst_rank else arr

    def allgather(self, rank: int, arr: torch.Tensor) -> list:
        shape, n = tuple(arr.shape), arr.numel()
        x = _pad(arr.reshape(-1), _bucket(n), arr.dtype)
        local = self._ops.allgather(rank, x)  # [w, B]
        return [local[i, :n].reshape(shape) for i in range(self.world_size)]

    def reducescatter(self, rank: int, arr: torch.Tensor,
                      op: ReduceOp = ReduceOp.SUM, quantize=None):
        op = ReduceOp(op)
        w = self.world_size
        rows = arr.shape[0] if arr.dim() else 1
        if (op == ReduceOp.SUM and arr.dim() and rows and rows % w == 0
                and not normalize_quantize(quantize)):
            # even split: the reduce-scatter moves 1/w of the bytes an
            # allreduce would
            mine = self._ops.reducescatter_even(
                rank, arr.reshape(-1).contiguous())
            return mine.reshape((rows // w,) + tuple(arr.shape[1:]))
        rb = split_bounds(rows, w)
        total = self.allreduce(rank, arr, op, quantize=quantize)
        return total[rb[rank]:rb[rank + 1]]

    def barrier(self, rank: int):
        """Orders the rank's stream after every rank's barrier: a
        one-element allreduce. The host does not wait (the reference
        reads the result back; in one process that would wait for ranks
        the same host thread has not driven yet)."""
        self.allreduce(rank, torch.zeros(1, device=self._ops.device_of(rank)))

    def broadcast(self, rank: int, arr: torch.Tensor, src_rank: int = 0):
        if not 0 <= src_rank < self.world_size:
            raise ValueError(f"src_rank {src_rank} outside a group of "
                             f"{self.world_size}")
        mine = arr if rank == src_rank else torch.zeros_like(arr)
        return self.allreduce(rank, mine, ReduceOp.SUM)

    def shift_right(self, rank: int, arr: torch.Tensor):
        """Ring permute (xla_backend.py:192, :354): rank r's tensor moves to
        rank (r + 1) % w, so the caller gets rank (r - 1) % w's. An ops
        object with a point-to-point `shift` sends it there; the fused
        kernels carry it as an allgather of which the rank keeps its left
        neighbour's row."""
        shape, n = tuple(arr.shape), arr.numel()
        shift = getattr(self._ops, "shift", None)
        if shift is not None:
            return shift(rank, arr.reshape(-1).contiguous()).reshape(shape)
        x = _pad(arr.reshape(-1), _bucket(n), arr.dtype)
        rows = self._ops.allgather(rank, x)  # [w, B]
        return rows[(rank - 1) % self.world_size, :n].reshape(shape)


# ---------------------------------------------------------------------------
# the DEVICE tier: one rank a process, over a torch.distributed group
# ---------------------------------------------------------------------------

_PG_REDUCE = {"add": "SUM", "max": "MAX", "min": "MIN", "mul": "PRODUCT"}
_COMBINE = {ReduceOp.SUM: "add", ReduceOp.MEAN: "add", ReduceOp.MAX: "max",
            ReduceOp.MIN: "min", ReduceOp.PRODUCT: "mul"}
_COMBINE_FNS = {"add": torch.add, "max": torch.maximum,
                "min": torch.minimum, "mul": torch.mul}
# payload dtypes the tier carries (NCCL's and gloo's)
_PG_DTYPES = {torch.float16, torch.bfloat16, torch.float32, torch.float64,
              torch.int8, torch.uint8, torch.int32, torch.int64}


class _ProcessGroupOps:
    """The DEVICE tier's ring work for this process's rank: the
    collectives of a torch.distributed process group (NCCL on CUDA, gloo
    on the CPU). The quantized allreduce runs the reference's ring schedule
    (xla_backend.py:204-241) on an int8 wire over the group's
    point-to-point sends: every hop quantizes the partial, the receiver
    dequantizes and combines, and the reduced chunk is quantized once and
    relayed as the same bytes, which gives `allreduce_quantized_plain`'s
    bytes. NCCL's and gloo's own allreduce fold in their own order, so the
    exact ops agree with the other tiers within float rounding (integers,
    MAX and MIN exactly)."""

    def __init__(self, pg, world: int, rank: int, device: torch.device):
        self.pg = pg
        self.world = world
        self.rank = rank
        self.device = device

    def device_of(self, rank: int) -> torch.device:
        return self.device

    def _wait(self, work):
        work.wait()  # NCCL: the current stream waits; gloo: the host

    def _reduce_opts(self, combine: str):
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = getattr(dist.ReduceOp, _PG_REDUCE[combine])
        return opts

    def allreduce(self, rank: int, x: torch.Tensor, op) -> torch.Tensor:
        out = x.clone()
        self._wait(self.pg.allreduce([out], self._reduce_opts(
            _COMBINE[ReduceOp(op)])))
        return out

    def reducescatter_even(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty(x.numel() // self.world)
        self._wait(self.pg._reduce_scatter_base(out, x))
        return out

    def allgather(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.world, x.numel()))
        self._wait(self.pg.allgather([list(out.unbind(0))], [x]))
        return out

    def _shift(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Sends `tensors` to the right neighbour and returns the left
        neighbour's. Even ranks send first and odd ranks receive first,
        so that no ring of blocking sends can close (w = 2 included)."""
        w, r = self.world, self.rank
        got = [torch.empty_like(t) for t in tensors]
        sends = lambda: [self.pg.send([t], (r + 1) % w, 0) for t in tensors]
        recvs = lambda: [self.pg.recv([t], (r - 1) % w, 0) for t in got]
        works = sends() + recvs() if r % 2 == 0 else recvs() + sends()
        for work in works:
            self._wait(work)
        return got

    def shift(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """The left neighbour's x (the ring permute of shift_right)."""
        if self.world == 1:
            return x.clone()
        return self._shift([x])[0]

    def allreduce_quantized(self, rank: int, x: torch.Tensor,
                            op) -> torch.Tensor:
        w, r = self.world, self.rank
        cmb = _COMBINE_FNS[_COMBINE[ReduceOp(op)]]
        chunks = x.reshape(w, -1)
        acc = chunks[r]
        for s in range(1, w):
            rq, rs = self._shift(list(quantize_blocks(acc)))
            acc = cmb(dequantize_blocks(rq, rs), chunks[(r - s) % w])
        send = list(quantize_blocks(acc))
        out = torch.empty_like(chunks)
        out[(r + 1) % w] = dequantize_blocks(*send)
        for s in range(1, w):
            send = self._shift(send)
            out[(r - s + 1) % w] = dequantize_blocks(*send)
        return out.reshape(-1)

    def broadcast(self, rank: int, x: torch.Tensor, src: int) -> torch.Tensor:
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = src
        out = x.clone()
        self._wait(self.pg.broadcast([out], opts))
        return out

    def defer(self, rank: int, fn, src: torch.Tensor) -> torch.Tensor:
        return fn(src)

    def check(self, rank: int):
        pass

    def close(self):
        pass


class DeviceTransport:
    """Transport.DEVICE: one collective rank in this process over the
    group's own torch.distributed process group (the reference's
    `DeviceTransport`, xla_backend.py:374-571). A payload on another
    device than the rank's moves to it and its result comes back, as the
    reference lifts host arrays onto the device and delivers numpy."""

    def __init__(self, world_size: int, rank: int, ops):
        self.world_size = world_size
        self.rank = rank
        self._ops = ops
        self._sem = GroupSemantics(world_size, ops)

    @classmethod
    def over(cls, pg, world_size: int, rank: int, device: torch.device):
        return cls(world_size, rank,
                   _ProcessGroupOps(pg, world_size, rank, device))

    def dtype_ok(self, dtype) -> bool:
        return dtype in _PG_DTYPES

    def _counted(self):
        _cm.DEVICE_OPS += 1

    def _lift(self, arr):
        return arr.to(self._ops.device_of(self.rank)).contiguous()

    def _run(self, fn, arr, *args, **kwargs):
        self._counted()
        out = fn(self.rank, self._lift(arr), *args, **kwargs)
        if isinstance(out, list):
            return [o.to(arr.device) for o in out]
        return out.to(arr.device)

    def allreduce(self, arr, op: ReduceOp = ReduceOp.SUM, quantize=None):
        return self._run(self._sem.allreduce, arr, op, quantize=quantize)

    def allgather(self, arr) -> list:
        return self._run(self._sem.allgather, arr)

    def reducescatter(self, arr, op: ReduceOp = ReduceOp.SUM,
                      quantize=None):
        return self._run(self._sem.reducescatter, arr, op, quantize=quantize)

    def shift_right(self, arr):
        """Rank r's tensor to rank (r + 1) % w; returns rank (r - 1) % w's."""
        return self._run(self._sem.shift_right, arr)

    def broadcast(self, arr, src_rank: int = 0):
        self._counted()
        n = arr.numel()
        x = _pad(self._lift(arr).reshape(-1), _bucket(n), arr.dtype)
        out = self._ops.broadcast(self.rank, x, src_rank)[:n]
        return out.reshape(arr.shape).to(arr.device)

    def check(self):
        """Waits for the rank's collectives; raises TimeoutError if one of
        them timed out (the fused kernels' status words)."""
        self._ops.check(self.rank)

    def destroy(self):
        self._ops.close()


class ProcessMeshGroup:
    """Backend "xla" across actor PROCESSES (reference:
    xla_backend.py:575-628): N processes joined one multihost runtime
    (parallel/multihost.initialize) are one collective rank each, and every
    op goes to the DEVICE tier over the runtime's default process group
    (NCCL between cards, gloo on the CPU), with no per-op vote and never
    through the HOST hub. Payloads are tensors (the result on the payload's
    device) or numpy arrays (a numpy result)."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 quantize=None):
        import torch.distributed as dist

        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.quantize = normalize_quantize(quantize)
        pg = dist.distributed_c10d._get_default_group()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        self.transport = DeviceTransport.over(pg, world_size, rank, device)

    def _q(self, quantize):
        return self.quantize if quantize is None else quantize

    @staticmethod
    def _call(fn, arr, *args, **kwargs):
        if isinstance(arr, torch.Tensor):
            return fn(arr, *args, **kwargs)
        import numpy as np

        out = fn(torch.from_numpy(np.ascontiguousarray(arr)), *args,
                 **kwargs)
        if isinstance(out, list):
            return [o.numpy() for o in out]
        return out.numpy()

    def allreduce(self, arr, op: ReduceOp = ReduceOp.SUM, quantize=None):
        return self._call(self.transport.allreduce, arr, op,
                          quantize=self._q(quantize))

    def reduce(self, arr, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM,
               quantize=None):
        out = self.allreduce(arr, op, quantize=quantize)
        return out if self.rank == dst_rank else arr

    def broadcast(self, arr, src_rank: int = 0):
        return self._call(self.transport.broadcast, arr, src_rank)

    def allgather(self, arr) -> list:
        return self._call(self.transport.allgather, arr)

    def reducescatter(self, arr, op: ReduceOp = ReduceOp.SUM,
                      quantize=None):
        return self._call(self.transport.reducescatter, arr, op,
                          quantize=self._q(quantize))

    def shift_right(self, arr):
        return self._call(self.transport.shift_right, arr)

    def barrier(self):
        self.allreduce(torch.zeros(1))

    def send(self, arr, dst_rank: int, tag: int = 0):
        raise NotImplementedError(
            "point-to-point ops are HOST-backend only; the global mesh "
            "expresses transfers as collectives")

    recv = send

    def destroy(self):
        self.transport.destroy()


# the reference's continuity alias
GlobalMeshGroup = ProcessMeshGroup
