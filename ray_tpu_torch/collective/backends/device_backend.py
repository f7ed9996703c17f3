"""The device plane's op semantics; port of the semantics of
ray_tpu/collective/backends/xla_backend.py.

The JAX package has two device tiers with one set of semantics:
`DeviceTransport` (XLA collectives, `_DeviceOps`) and its subclass
`PallasTransport` (the fused ring kernels, `_PallasOps`), which differ
only in what one op costs, never in what it returns. This module keeps
those semantics for the port: the shape classes (`_bucket`), the
block-scaled int8 format (`quantize_blocks`, `dequantize_blocks`), the
quantized ring's padding and wire accounting (`_qring_pad`,
`_qring_saved_bytes`), and `DeviceTransport`, which pads, promotes and
slices around an `ops` object that does the ring work. The port's only
ops object is `pallas_backend._PallasOps`; the XLA tier's counterpart
(NCCL) is ROADMAP.md A5.

Every rank of a group lives in one process here, so each op takes the
calling rank. A rank's ops run on its own CUDA stream, and nothing here
waits on the host: a rank's ring kernel only finishes once every rank
has launched its own, and the ranks are driven by one host thread.
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


class DeviceTransport:
    """The device plane's host-parity op surface (xla_backend.py:470-561)
    over an `ops` object with the fused-kernel signatures of
    `_PallasOps`: `allreduce(rank, x [B], op)`, `reducescatter_even(rank,
    x [P])`, `allgather(rank, x [B]) -> [w, B]` and
    `allreduce_quantized(rank, x [w*C] f32, op)`.

    Semantics kept from the reference: payloads pad to `_bucket(n)`;
    integer MEAN sums exactly and divides in float64 (on the rank's
    device: a host division would wait for peers that the same host
    thread has not driven yet); f16 MEAN accumulates in f32; MEAN
    combines with add and divides afterwards; reducescatter takes the
    even-split path only for SUM on rows % w == 0 without quantize, and
    otherwise allreduces and slices by `split_bounds`; allgather returns
    a list."""

    def __init__(self, world_size: int, ops):
        self.world_size = world_size
        self._ops = ops

    def _counted(self):
        _cm.PALLAS_OPS += 1

    # -- op surface ------------------------------------------------------

    def allreduce(self, rank: int, arr: torch.Tensor,
                  op: ReduceOp = ReduceOp.SUM, quantize=None):
        op = ReduceOp(op)
        q = normalize_quantize(quantize)
        in_dt = arr.dtype
        shape, n = tuple(arr.shape), arr.numel()
        floating = arr.is_floating_point()
        flat = arr.reshape(-1)
        self._counted()
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
        self._counted()
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
            self._counted()
            mine = self._ops.reducescatter_even(
                rank, arr.reshape(-1).contiguous())
            return mine.reshape((rows // w,) + tuple(arr.shape[1:]))
        rb = split_bounds(rows, w)
        total = self.allreduce(rank, arr, op, quantize=quantize)
        return total[rb[rank]:rb[rank + 1]]

    def barrier(self, rank: int):
        """Orders the rank's stream after every rank's barrier: a
        one-element allreduce. The host does not wait (the reference
        reads the result back; here that would wait for ranks the same
        host thread has not driven yet)."""
        self.allreduce(rank, torch.zeros(1, device=self._ops.devices[rank]))

    def broadcast(self, rank: int, arr, src_rank: int = 0):
        raise NotImplementedError(
            "broadcast: the JAX package hands it to the XLA device tier, "
            "whose port (NCCL) is ROADMAP.md A5")

    def shift_right(self, rank: int, arr):
        raise NotImplementedError(
            "shift_right: the JAX package hands it to the XLA device tier, "
            "whose port (NCCL) is ROADMAP.md A5")

    def check(self, rank: int):
        """Waits for the rank's collectives and raises TimeoutError if one
        of them timed out (see `_PallasOps.check`)."""
        self._ops.check(rank)

    def close(self):
        self._ops.close()
