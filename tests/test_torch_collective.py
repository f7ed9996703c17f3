"""Port check: the fused ring collectives of ray_tpu_torch (their plain
versions, through the port's collective group on the CPU) against the JAX
package's `_PallasOps` in interpret mode.

The JAX side runs `_PallasOps` over `jax.devices()[:w]` of the 8 CPU
devices that conftest forces, with each rank's payload lifted as the
JAX DeviceTransport lifts it (zero-padded to `_bucket(n)`, or to
`_qring_pad(n, w)` for the quantized ring). Under JAX 0.9 its
`_pallas_call` names `pltpu.TPUMemorySpace.ANY`, which was renamed
`MemorySpace`; the module fixture aliases it for the JAX calls, through
a MonkeyPatch, and changes nothing in the JAX package. Every JAX result
is computed once, in that fixture. The port runs each case through its
in-process group of every rank, `init_collective_group(...,
backend="xla", device="cpu")`, one handle per rank (the per-process
HOST groups are tests/test_torch_collective_procs.py's).

Tolerances:
- exact allreduce, reduce-scatter and allgather: bit-exact, for every
  op and dtype (the ring fixes the combine order, and each combine is
  one IEEE operation in both packages).
- quantized allreduce (SUM at w = 2, 3, 4, MAX at 3, MIN at 4): XLA
  compiles the reference kernel's `absmax / 127.0` into a product with
  the rounded reciprocal and contracts its dequantize-and-combine
  `q*scale + x` into one FMA. The port (like its CUDA kernel) keeps the
  source's rounding: an IEEE division and a product then the combine. So
  each element of the port lies within (w - 1) quantization steps
  (absmax / 127 of its 256-block of the JAX output) of the JAX value, at
  every w, and the port's ranks stay bit-identical to each other. The
  port's ring schedule run with XLA's rounding (the reciprocal scale, and
  the combine in float64 rounded once to f32, which is the FMA here:
  q*scale is exact in float64; a max or min of the float64 product and
  an f32 value rounds to what the f32 product would give) matches JAX
  bit for bit in every case.
- block quantization, padding and wire accounting: exact.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.collective.backends import xla_backend as jxla
from ray_tpu_torch import collective as col
from ray_tpu_torch.collective.backends import device_backend as db

F32, BF16, I32 = np.float32, jnp.bfloat16, np.int32
TORCH = {F32: torch.float32, BF16: torch.bfloat16, I32: torch.int32}

# (world, op, dtype, n): each op and dtype at one world size, SUM f32 at
# the ragged size through the _bucket padding. Each case costs an XLA
# compile of the interpret-mode kernel (about 1.2 s on one core), so the
# matrix is spread over the world sizes, not crossed.
ALLREDUCE = [(4, "sum", F32, 10007), (3, "max", F32, 4096),
             (2, "min", F32, 4096), (3, "product", F32, 4096),
             (2, "sum", BF16, 4096), (3, "sum", I32, 4096)]
REDUCESCATTER = [(2, 4096), (3, 3072)]
ALLGATHER = [(2, 1000), (4, 4096)]
QUANTIZED = [(2, "sum", 4096), (3, "sum", 4096), (4, "sum", 4096),
             (3, "max", 4096), (4, "min", 4096)]


def _inputs(seed, w, n, dtype, op="sum"):
    rng = np.random.default_rng(seed)
    if dtype == I32:
        return rng.integers(-1000, 1000, (w, n), dtype=np.int32)
    x = rng.standard_normal((w, n)).astype(np.float32)
    if op == "product":
        x = 1 + 0.01 * x
    return np.asarray(x, dtype)  # bf16 rounds here, once


def _to_torch(x):
    if x.dtype == BF16:
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x):
    """The bytes of a result, bf16 widened exactly to f32."""
    if isinstance(x, torch.Tensor):
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return np.asarray(x, np.float32 if x.dtype == BF16 else x.dtype)


def _lift(x, length):
    out = np.zeros((x.shape[0], length), x.dtype)
    out[:, :x.shape[1]] = x
    return out


@pytest.fixture(scope="module")
def jax_results():
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ray_tpu.collective.backends.pallas_backend import _PallasOps
    from ray_tpu.collective.types import ReduceOp

    ops, out = {}, {}

    def run(w, fn, x):
        if w not in ops:
            mesh = Mesh(np.asarray(jax.devices()[:w]), ("ranks",))
            ops[w] = (_PallasOps(mesh, "ranks", w), mesh)
        pops, mesh = ops[w]
        garr = jax.device_put(x, NamedSharding(mesh, P("ranks", None)))
        return np.asarray(fn(pops)(garr))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
        for i, (w, op, dt, n) in enumerate(ALLREDUCE):
            x = _lift(_inputs(i, w, n, dt, op), jxla._bucket(n))
            out["ar", i] = run(w, lambda p, op=op: (
                lambda g: p.allreduce(g, ReduceOp(op))), x)
        for i, (w, n) in enumerate(REDUCESCATTER):
            out["rs", i] = run(w, lambda p: p.reducescatter_even,
                               _inputs(100 + i, w, n, F32))
        for i, (w, n) in enumerate(ALLGATHER):
            x = _lift(_inputs(200 + i, w, n, F32), jxla._bucket(n))
            out["ag", i] = run(w, lambda p: p.allgather, x)
        for i, (w, op, n) in enumerate(QUANTIZED):
            x = _lift(_inputs(300 + i, w, n, F32), jxla._qring_pad(n, w))
            out["q", i] = run(w, lambda p, op=op: (
                lambda g: p.allreduce_quantized(g, ReduceOp(op))), x)
    return out


@contextlib.contextmanager
def _group(w, **kwargs):
    name = f"test_{w}_{id(kwargs)}"
    handles = [col.init_collective_group(w, r, backend="xla",
                                         group_name=name, device="cpu",
                                         **kwargs)
               for r in range(w)]
    try:
        yield handles
    finally:
        col.destroy_collective_group(name)


@pytest.mark.parametrize("i", range(len(ALLREDUCE)),
                         ids=[f"w{w}-{op}-{np.dtype(dt).name}-{n}"
                              for w, op, dt, n in ALLREDUCE])
def test_allreduce_bit_exact(jax_results, i):
    w, op, dt, n = ALLREDUCE[i]
    x = _inputs(i, w, n, dt, op)
    with _group(w) as hs:
        outs = [h.allreduce(_to_torch(x[r]), op) for r, h in enumerate(hs)]
    want = jax_results["ar", i]
    for r in range(w):
        assert outs[r].dtype == TORCH[dt]
        assert np.array_equal(_bits(outs[r]), _bits(want[r, :n]))


@pytest.mark.parametrize("i", range(len(REDUCESCATTER)))
def test_reducescatter_bit_exact(jax_results, i):
    w, n = REDUCESCATTER[i]
    x = _inputs(100 + i, w, n, F32)
    with _group(w) as hs:
        outs = [h.reducescatter(_to_torch(x[r])) for r, h in enumerate(hs)]
    for r in range(w):
        assert outs[r].shape == (n // w,)
        assert outs[r].numpy().tobytes() == jax_results["rs", i][r].tobytes()


@pytest.mark.parametrize("i", range(len(ALLGATHER)))
def test_allgather_bit_exact(jax_results, i):
    w, n = ALLGATHER[i]
    x = _inputs(200 + i, w, n, F32)
    with _group(w) as hs:
        outs = [h.allgather(_to_torch(x[r])) for r, h in enumerate(hs)]
    want = jax_results["ag", i]  # [w ranks, w rows, B]
    for r in range(w):
        assert len(outs[r]) == w
        for j in range(w):
            assert outs[r][j].numpy().tobytes() == want[r, j, :n].tobytes()


@pytest.mark.parametrize("i", range(len(QUANTIZED)))
def test_quantized_allreduce_against_jax(jax_results, i):
    w, op, n = QUANTIZED[i]
    x = _inputs(300 + i, w, n, F32)
    with _group(w, quantize="int8") as hs:
        outs = [h.allreduce(_to_torch(x[r]), op).numpy()
                for r, h in enumerate(hs)]
    want = jax_results["q", i][:, :n]
    for r in range(w):
        assert outs[r].tobytes() == outs[0].tobytes()
        step = np.abs(want[r]).reshape(-1, 256).max(1) / 127
        diff = np.abs(outs[r] - want[r]).reshape(-1, 256)
        assert (diff <= (w - 1) * step[:, None]).all()


def _xla_rounding(mp):
    """The port's quantized plain ring with XLA's CPU rounding of the
    reference kernel: the scale as absmax times the rounded 1/127, and
    the dequantized values in float64, so that the combine rounds once
    (torch.add promotes to float64; the output rows and the next
    quantize round to f32)."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    def quantize(x, block=256):
        b = x.reshape(-1, block).float()
        absmax = b.abs().amax(1)
        scale = torch.where(absmax > 0, absmax * np.float32(1 / 127),
                            torch.ones_like(absmax))
        q = torch.clamp(torch.round(b / scale[:, None]), -127, 127)
        return q.to(torch.int8).reshape(-1), scale

    def dequantize(q, scale, block=256):
        return (q.reshape(-1, block).double()
                * scale.double()[:, None]).reshape(-1)

    mp.setattr(pb, "quantize_blocks", quantize)
    mp.setattr(pb, "dequantize_blocks", dequantize)


@pytest.mark.parametrize("i", range(len(QUANTIZED)))
def test_quantized_ring_schedule_bit_exact_under_xla_rounding(jax_results,
                                                              i):
    w, op, n = QUANTIZED[i]
    x = _inputs(300 + i, w, n, F32)
    with pytest.MonkeyPatch.context() as mp, _group(w, quantize="int8") as hs:
        _xla_rounding(mp)
        outs = [h.allreduce(_to_torch(x[r]), op).numpy()
                for r, h in enumerate(hs)]
    want = jax_results["q", i][:, :n]
    for r in range(w):
        assert outs[r].tobytes() == want[r].tobytes()


def _quant_input():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(6 * 256).astype(np.float32).reshape(6, 256)
    x[1] = 0.0                                  # all-zero block: scale 1
    x[2, :3] = [127.0, -127.0, 2.5]             # scale 1: ±127, half-even
    x[2, 3:] = np.clip(x[2, 3:], -100, 100)
    x[3] *= 1e-30                               # tiny scale
    x[4, 0] = -2 * np.abs(x[4]).max()           # -127 at the block's edge
    x[5, :4] = [0.5, 1.5, -0.5, -1.5]           # halves against scale
    x[5, 4] = 127.0
    return x.reshape(-1)


def test_quantize_blocks_bit_exact():
    x = _quant_input()
    jq, js = jxla.quantize_blocks(jnp.asarray(x))
    tq, ts = db.quantize_blocks(torch.from_numpy(x))
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert np.asarray(jq)[256:512].tolist() == [0] * 256
    assert sorted(set(np.asarray(jq)[512:514].tolist())) == [-127, 127]
    assert np.asarray(jq)[514] == 2  # 2.5 rounds half to even
    back = db.dequantize_blocks(tq, ts).numpy()
    assert back.tobytes() == np.asarray(jxla.dequantize_blocks(jq, js)
                                        ).tobytes()


@pytest.mark.parametrize("n,w", [(1, 1), (1000, 2), (4096, 3), (10007, 4),
                                 (124402944, 2)])
def test_qring_pad_and_saved_bytes_match_reference(n, w):
    assert db._bucket(n) == jxla._bucket(n)
    assert db._qring_pad(n, w) == jxla._qring_pad(n, w)
    p = db._qring_pad(n, w)
    for tdt, ndt, op in ((torch.float32, np.float32, "sum"),
                         (torch.bfloat16, jnp.bfloat16, "sum"),
                         (torch.float16, np.float16, "mean"),
                         (torch.float16, np.float16, "max")):
        assert db._qring_saved_bytes(p, w, tdt, op) == \
            jxla._qring_saved_bytes(p, w, ndt, op)


def test_mean_semantics():
    """Integer MEAN sums exactly and divides in float64; f16 MEAN
    accumulates in f32 (a sum past f16's range still averages)."""
    with _group(2) as hs:
        ints = [h.allreduce(torch.tensor([1, 2, -7], dtype=torch.int32),
                            "mean") for h in hs]
        halves = [h.allreduce(torch.full((5,), 60000.0,
                                         dtype=torch.float16), "mean")
                  for h in hs]
    for got in ints:
        assert got.dtype == torch.float64
        assert got.tolist() == [1.0, 2.0, -7.0]
    for got in halves:
        assert got.dtype == torch.float16
        assert got.tolist() == [60000.0] * 5


def test_reducescatter_uneven_slices_an_allreduce():
    x = [torch.arange(10.0).reshape(5, 2) * (r + 1) for r in range(3)]
    with _group(3) as hs:
        outs = [h.reducescatter(x[r]) for r, h in enumerate(hs)]
    total = x[0] + x[1] + x[2]
    assert [o.shape[0] for o in outs] == [2, 2, 1]
    assert torch.equal(torch.cat(outs), total)


def test_group_lifecycle():
    name = "lifecycle"
    assert not col.is_group_initialized(name)
    h0 = col.init_collective_group(2, 0, backend="xla", group_name=name,
                                   device="cpu")
    assert col.is_group_initialized(name)
    assert col.get_collective_group_size(name) == 2
    assert col.get_rank(name) == 0
    h1 = col.init_collective_group(2, 1, backend="xla", group_name=name,
                                   device="cpu")
    with pytest.raises(ValueError, match="holds ranks"):
        col.get_rank(name)
    with pytest.raises(RuntimeError, match="already joined"):
        col.init_collective_group(2, 1, backend="xla", group_name=name,
                                  device="cpu")
    with pytest.raises(ValueError, match="rank="):
        col.allreduce(torch.ones(3), name)
    a = col.allreduce(torch.ones(3), name, rank=0)
    b = col.allreduce(torch.ones(3) * 2, name, rank=1)
    col.barrier(name, rank=0)
    col.barrier(name, rank=1)
    h0.check()
    h1.check()
    assert a.tolist() == b.tolist() == [3.0] * 3
    assert h0.stream is None and h0.device == torch.device("cpu")
    col.destroy_collective_group(name)
    assert not col.is_group_initialized(name)


@pytest.mark.parametrize("transport,err,match", [
    ("device", ValueError, "backend 'host'"),
    ("ring", ValueError, "backend 'host'"),
    ("shm", ValueError, "backend 'host'"),
    ("bogus", ValueError, "bogus")])
def test_unported_transports_raise(transport, err, match):
    """The host and NCCL tiers carry ranks in processes of their own
    (backend "host"); the in-process group refuses them, and a name that
    is no tier."""
    with pytest.raises(err, match=match):
        col.init_collective_group(2, 0, backend="xla",
                                  group_name=f"t_{transport}",
                                  device="cpu", transport=transport)
    assert not col.is_group_initialized(f"t_{transport}")


def test_broadcast_raises():
    """broadcast is the reference's masked allreduce (the source's payload
    and every other rank's zeros), bit for bit the source's; a source
    outside the group raises; shift_right (the reference's ring permute)
    moves rank r's tensor to rank (r + 1) % w, bit for bit."""
    x = torch.randn(5, generator=torch.Generator().manual_seed(0))
    with _group(3) as hs:
        outs = [h.broadcast(x * (r + 1), src_rank=1)
                for r, h in enumerate(hs)]
        assert all(torch.equal(o, x * 2) for o in outs)
        with pytest.raises(ValueError, match="src_rank 3"):
            hs[0].broadcast(x, src_rank=3)
        outs = [h.shift_right(x * (r + 1)) for r, h in enumerate(hs)]
        assert all(torch.equal(o, x * ((r - 1) % 3 + 1))
                   for r, o in enumerate(outs))


def test_withheld_rank_times_out_and_next_group_works():
    with _group(2, timeout=0.05) as hs:
        hs[0].allreduce(torch.ones(4))
        with pytest.raises(TimeoutError, match=r"rank\(s\) \[1\]"):
            hs[0].check()
        with pytest.raises(RuntimeError, match="unusable"):
            hs[1].allreduce(torch.ones(4))
    with _group(2, timeout=0.05) as hs:
        outs = [h.allreduce(torch.ones(4)) for h in hs]
        hs[0].check()
        assert outs[0].tolist() == [2.0] * 4


def test_mismatched_calls_raise():
    with _group(2) as hs:
        hs[0].allreduce(torch.ones(4))
        with pytest.raises(ValueError, match="same collective calls"):
            hs[1].allreduce(torch.ones(100))


@pytest.mark.parametrize("w", [2, 3, 4])
def test_timeout_status_names_the_awaited_rank(w):
    """The status words [waited, awaited rank, block, call] of a timed-out
    kernel name the rank it waited for: in the quantized allreduce a
    peer's staging addresses (its mailbox, awaited first, so a withheld
    rank is named by every peer), the left neighbour's int8 partial of a
    hop, a peer's staged reduced chunk or its done flag; in the direct
    allgather a peer's output address (mailbox) or done flag. A status
    word that names no wait raises."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    for other in range(w):
        for waited, text in ((pb.WAITED_STAGE, "staging addresses"),
                             (pb.WAITED_PARTIAL, "int8 partial"),
                             (pb.WAITED_CHUNK, "reduced int8 chunk"),
                             (pb.WAITED_MAIL, "output address"),
                             (pb.WAITED_DONE, "done flag")):
            peer, what = pb.describe_wait([waited, other, 5, 9])
            assert peer == other
            assert what == f"the {text} of rank {other} (call 9, block 5)"
    with pytest.raises(ValueError, match="names no wait"):
        pb.describe_wait([0, w - 1, 0, 1])


def test_allgather_plain_writes_every_payload_to_every_rank():
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    xs = [torch.arange(5, dtype=torch.float32) + 10 * r for r in range(3)]
    for out in pb.allgather_plain(xs):
        assert torch.equal(out, torch.stack(xs))


@pytest.mark.parametrize("w", [2, 3, 4])
def test_timeout_status_names_the_awaited_rank_direct_reduce(w):
    """The direct allreduce and reduce-scatter wait for every peer's input
    and output addresses (mailbox) and for its done flag; the status
    names that peer."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    for other in range(w):
        for waited, text in ((pb.WAITED_ADDRS, "input and output addresses"),
                             (pb.WAITED_DONE, "done flag")):
            peer, what = pb.describe_wait([waited, other, 2, 4])
            assert peer == other
            assert what == f"the {text} of rank {other} (call 4, block 2)"


def _spread(w, n, dtype, seed):
    """w payloads whose magnitudes span 2^30, so that the order of a sum
    changes its rounding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((w, n)) * 2.0 ** rng.integers(-15, 16, (w, n))
    return [torch.from_numpy(r.astype(np.float32)).to(dtype) for r in x]


def _direct_fold(xs, first):
    """Chunk r of w folded as the direct kernels fold it: over ranks
    first(r), first(r) + 1, ... (mod w), acc = acc + x_p[chunk r]."""
    w = len(xs)
    chunks = [x.reshape(w, -1) for x in xs]
    out = []
    for r in range(w):
        acc = chunks[first(r)][r]
        for k in range(1, w):
            acc = acc + chunks[(first(r) + k) % w][r]
        out.append(acc)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [3, 4])
def test_direct_fold_order_reproduces_the_ring(w, dtype):
    """B5 and B6 fold chunk r themselves instead of relaying it round the
    ring; the order (allreduce: r, r + 1, ...; reduce-scatter: r + 1, ...,
    r) gives the ring's plain versions bit for bit, and another order
    does not."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    xs = _spread(w, 64 * w, dtype, seed=w)
    ring = pb.allreduce_plain(xs, "sum")
    direct = torch.cat(_direct_fold(xs, lambda r: r))
    for out in ring:
        assert torch.equal(out, direct)
    ring = pb.reducescatter_plain(xs)
    direct = _direct_fold(xs, lambda r: (r + 1) % w)
    for r in range(w):
        assert torch.equal(ring[r], direct[r])
    if dtype == torch.float32:
        other = torch.cat(_direct_fold(xs, lambda r: (r + 1) % w))
        assert not torch.equal(pb.allreduce_plain(xs, "sum")[0], other)


def _wire(q):
    """int8 [n] in value order -> the quantized allreduce kernel's wire
    order: in each 256-value block, lane l's bytes 8l..8l+7 hold values
    4l..4l+3 and 128+4l..128+4l+3 (csrc header)."""
    return q.reshape(-1, 2, 32, 4).transpose(1, 2).reshape(-1)


def _unwire(q):
    return q.reshape(-1, 32, 2, 4).transpose(1, 2).reshape(-1)


def _quantized_direct_gather(xs, op):
    """B8's schedule in PyTorch: the ring's reduce hops, rank r quantizing
    its partial into its right neighbour's slot in wire order; rank r's
    reduced chunk r + 1 quantized once into its staging buffer; every rank
    dequantizing every owner's staged bytes into its output."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    w = len(xs)
    cmb = pb._COMBINE_FNS[pb._COMBINE[col.ReduceOp(op)]]
    chunks = [x.reshape(w, -1) for x in xs]
    acc = [chunks[r][r] for r in range(w)]
    for s in range(1, w):
        slots = {(r + 1) % w: (_wire(q), sc) for r, (q, sc) in
                 enumerate(map(db.quantize_blocks, acc))}
        acc = [cmb(db.dequantize_blocks(_unwire(slots[r][0]), slots[r][1]),
                   chunks[r][(r - s) % w]) for r in range(w)]
    stages = [(_wire(q), sc) for q, sc in map(db.quantize_blocks, acc)]
    outs = [torch.empty_like(c) for c in chunks]
    for out in outs:
        for o, (q, sc) in enumerate(stages):
            out[(o + 1) % w] = db.dequantize_blocks(_unwire(q), sc)
    return [o.reshape(-1) for o in outs]


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("w", [2, 3, 4])
def test_quantized_direct_gather_reproduces_the_ring(w, op):
    """B8 keeps the ring's reduce hops but reads each reduced chunk's
    quantized bytes from its owner instead of relaying them round the
    ring: that gives `allreduce_quantized_plain` (the reference's
    schedule) bit for bit, on every rank, for add, max and min."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    xs = _spread(w, 512 * w, torch.float32, seed=10 * w + len(op))
    ring = pb.allreduce_quantized_plain(xs, op)
    for got, want in zip(_quantized_direct_gather(xs, op), ring):
        assert torch.equal(got, want)
        assert torch.equal(got, ring[0])


def test_every_quantized_op_has_a_cuda_instance():
    """Every op the transport sends to the quantized allreduce (SUM, MEAN,
    MAX, MIN) has a built CUDA instance: a CUDA tensor's MIN raised
    TypeError before, while the CPU ran it through the plain version."""
    from ray_tpu_torch.collective.backends import pallas_backend as pb

    for op in db._QRING_OPS:
        assert ("quantized", torch.float32, pb._COMBINE[op]) in pb._BUILT
