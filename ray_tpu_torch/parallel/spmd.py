"""The collectives of a shard_map body, with their gradients.

JAX differentiates its collectives: the transpose of `ppermute` sends the
cotangent along the inverse permutation, that of `all_to_all` is the
all_to_all with split and concat axes swapped, that of `psum` is `psum`,
and that of `all_gather` is `psum_scatter`. torch.distributed's calls have
no gradients, so each one here is a torch.autograd.Function whose backward
is that transpose, built on the public calls (`batch_isend_irecv`,
`all_to_all_single`, `all_reduce`, `all_gather`) over the process group of
the axes (`parallel.mesh.Layout.group`). At axis size 1 none of them
communicates.

`shard_in` and `shard_out` are shard_map's boundaries, with the transpose
rule of an unchecked shard_map (jax/_src/shard_map.py `_shard_map_transpose`
with check_vma=False): an output's cotangent is divided by the size of the
axes its spec leaves out, and an input's cotangent is psum'd over the axes
its spec leaves out and then gathered into the global tensor on every
rank. `pvary` is that input rule for a tensor a rank already holds as its
block (a rank-local program's parameters).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import mesh as _mesh


def _reorder(chunks, order, group):
    """chunks in axis-index order -> in the group's rank order."""
    granks = dist.get_process_group_ranks(group)
    if granks == order:
        return list(chunks)
    return [chunks[order.index(r)] for r in granks]


def _unorder(chunks, order, group):
    """chunks in the group's rank order -> in axis-index order."""
    granks = dist.get_process_group_ranks(group)
    if granks == order:
        return list(chunks)
    return [chunks[granks.index(r)] for r in order]


def _all_reduce(x, lay, axes):
    pg, _ = lay.group(axes)
    x = x.contiguous().clone()
    if pg is not None:
        dist.all_reduce(x, group=pg)
    return x


def _all_gather(x, lay, axes, dim):
    """The ranks' x concatenated along dim in axis-index order."""
    pg, order = lay.group(axes)
    if pg is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in order]
    dist.all_gather(parts, x, group=pg)
    return torch.cat(_unorder(parts, order, pg), dim=dim)


def _block(x, lay, axes, dim):
    """This rank's block of x along dim over the axes."""
    n = lay.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over axes {axes} of size {n}")
    s = x.shape[dim] // n
    return x.narrow(dim, lay.index(axes) * s, s)


def _psum_scatter(x, lay, axes, dim):
    return _block(_all_reduce(x, lay, axes), lay, axes, dim)


def _spec_dims(spec, ndim):
    """[(tensor dim, axes)] of the dims a spec shards, and every axis it
    names."""
    dims, named = [], []
    for d, entry in enumerate(tuple(spec)[:ndim]):
        axes = _mesh.axis_names(entry)
        if axes:
            dims.append((d, axes))
            named += axes
    if len(spec) > ndim and any(e is not None for e in tuple(spec)[ndim:]):
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    return dims, named


def _unmentioned(lay, named):
    return tuple(a for a in lay.names if a not in named and lay.sizes[a] > 1)


# ---------------------------------------------------------------------------
# shard_map's boundaries
# ---------------------------------------------------------------------------

class _ShardIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, lay):
        dims, named = _spec_dims(spec, x.dim())
        ctx.lay, ctx.dims, ctx.rest = lay, dims, _unmentioned(lay, named)
        for d, axes in dims:
            x = _block(x, lay, axes, d)
        return x.clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.lay, ctx.rest) if ctx.rest else g
        for d, axes in reversed(ctx.dims):
            g = _all_gather(g, ctx.lay, axes, d)
        return g, None, None


class _ShardOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, spec, lay):
        dims, named = _spec_dims(spec, y.dim())
        ctx.lay, ctx.dims = lay, dims
        ctx.div = math.prod(lay.sizes[a] for a in _unmentioned(lay, named))
        for d, axes in reversed(dims):
            y = _all_gather(y, lay, axes, d)
        return y if dims else y.clone()

    @staticmethod
    def backward(ctx, g):
        for d, axes in ctx.dims:
            g = _block(g, ctx.lay, axes, d)
        g = g / ctx.div if ctx.div != 1 else g
        return g.contiguous(), None, None


def shard_in(x, spec, lay):
    """A rank's block of the global tensor x by spec."""
    if not torch.is_tensor(x):
        raise TypeError(f"shard_map takes tensors, got {type(x)}")
    return _ShardIn.apply(x, spec, lay)


def shard_out(y, spec, lay):
    """The global tensor of every rank's block y by spec."""
    return _ShardOut.apply(y, spec, lay)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, axes):
        ctx.lay, ctx.axes = lay, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.lay, ctx.axes), None, None


def pvary(x, spec=None):
    """x, a rank's block of a tensor laid out by spec (default
    replicated), as a shard_map input: the identity forward, its
    cotangent psum'd over the axes spec leaves out (jax.lax.pvary's
    transpose). A rank-local program passes each parameter through it once
    a step, so that every rank's .grad is the parameter's global
    gradient."""
    lay = _mesh.current_layout()
    _, named = _spec_dims(spec or _mesh.PartitionSpec(), x.dim())
    rest = _unmentioned(lay, named)
    return _PVary.apply(x, lay, rest) if rest else x


# ---------------------------------------------------------------------------
# collectives inside the body
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, axes):
        ctx.lay, ctx.axes = lay, axes
        return _all_reduce(x, lay, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.lay, ctx.axes), None, None


def psum(x, axis_name):
    """The sum of x over the axes (jax.lax.psum); its transpose is psum."""
    lay = _mesh.current_layout()
    return _PSum.apply(x, lay, lay._axes(axis_name))


def _ppermute(x, lay, axes, perm):
    pg, order = lay.group(axes)
    # perm's indices count the group's ranks in mesh order, which over a
    # tuple of axes is not axis-index order: JAX's lowering sorts the
    # group's devices (jax/_src/lax/parallel.py _pcollectives_lowering_common)
    ranks = sorted(order)
    me = ranks.index(lay.rank)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x)
    if pg is None:
        return x.clone() if src else out
    ops = [dist.P2POp(dist.isend, x, ranks[d], pg) for d in dst if d != me]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], pg)
            for s in src if s != me]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if me in src:
        out.copy_(x)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, axes, perm):
        ctx.lay, ctx.axes = lay, axes
        ctx.inverse = [(d, s) for s, d in perm]
        return _ppermute(x, lay, axes, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.lay, ctx.axes, ctx.inverse), None, None, None


def ppermute(x, axis_name, perm):
    """Sends x from axis index s to d for each (s, d) of perm
    (jax.lax.ppermute; over a tuple of axes, an index counts the ranks in
    mesh order, as JAX's); a rank no pair sends to gets zeros. Its
    transpose sends the cotangent along the inverse permutation."""
    lay = _mesh.current_layout()
    perm = [(int(s), int(d)) for s, d in perm]
    for k in (0, 1):
        if len({p[k] for p in perm}) != len(perm):
            raise ValueError(f"ppermute: {perm} is not a permutation")
    return _PPermute.apply(x, lay, lay._axes(axis_name), perm)


def _all_to_all(x, lay, axes, split_axis, concat_axis, tiled):
    n = lay.size(axes)
    split_axis %= x.dim()
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of size "
                             f"{x.shape[split_axis]} does not split over "
                             f"{n}")
        shape = list(x.shape)
        shape[split_axis:split_axis + 1] = [n, shape[split_axis] // n]
        chunks = x.reshape(shape).movedim(split_axis, 0)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all: untiled split dimension "
                             f"{split_axis} of size {x.shape[split_axis]} "
                             f"must equal the axis size {n}")
        chunks = x.movedim(split_axis, 0)
    pg, order = lay.group(axes)
    if pg is not None:
        send = torch.stack(_reorder(list(chunks), order, pg)).contiguous()
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(recv, send, group=pg)
        chunks = torch.stack(_unorder(list(recv), order, pg))
    if not tiled:
        return chunks.movedim(0, concat_axis % x.dim()).contiguous()
    concat_axis %= x.dim()
    # chunks: [n(source), ...] with the split dim divided by n; put the
    # sources before concat_axis and merge them into it, source-major
    moved = chunks.movedim(0, concat_axis)
    shape = list(moved.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis]
                                          * shape[concat_axis + 1]]
    return moved.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, axes, split_axis, concat_axis, tiled):
        ctx.args = lay, axes, concat_axis, split_axis, tiled
        return _all_to_all(x, lay, axes, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None, None


def all_to_all(x, axis_name, split_axis: int, concat_axis: int, *,
               tiled: bool = False):
    """jax.lax.all_to_all: x's split_axis in axis-size chunks, chunk j to
    axis index j; the chunks received concatenated along concat_axis in
    source order (tiled), or, untiled (split_axis of the axis size), the
    one-wide chunks stacked at concat_axis. Its transpose swaps the two
    axes."""
    lay = _mesh.current_layout()
    return _AllToAll.apply(x, lay, lay._axes(axis_name), split_axis,
                           concat_axis, tiled)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, axes, dim):
        ctx.args = lay, axes, dim
        return _all_gather(x, lay, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, *ctx.args), None, None, None


def all_gather(x, axis_name, axis: int = 0):
    """The ranks' x concatenated along `axis` in axis-index order
    (jax.lax.all_gather with tiled=True); its transpose is psum_scatter."""
    lay = _mesh.current_layout()
    return _AllGather.apply(x, lay, lay._axes(axis_name), axis % x.dim())


def _all_to_all_v(x, lay, axes, send_rows, recv_rows):
    pg, order = lay.group(axes)
    if pg is None:
        return x.clone()
    x = x.contiguous()
    send = _reorder(list(x.split(send_rows)), order, pg)
    sizes = _reorder(list(recv_rows), order, pg)
    recv = x.new_empty((sum(recv_rows),) + tuple(x.shape[1:]))
    dist.all_to_all_single(recv, torch.cat(send).contiguous(), sizes,
                           [len(c) for c in send], group=pg)
    return torch.cat(_unorder(list(recv.split(sizes)), order, pg))


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, axes, send_rows, recv_rows):
        ctx.args = lay, axes, recv_rows, send_rows
        return _all_to_all_v(x, lay, axes, send_rows, recv_rows)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_v(g, *ctx.args), None, None, None, None


def all_to_all_rows(x, axis_name, send_rows, recv_rows):
    """Rows of x to the axis's ranks: the first send_rows[0] rows to axis
    index 0, the next send_rows[1] to index 1, ...; the rows received
    concatenated in source order (recv_rows[j] from index j). Its
    transpose sends the cotangent's rows back."""
    lay = _mesh.current_layout()
    return _AllToAllV.apply(x, lay, lay._axes(axis_name),
                            [int(r) for r in send_rows],
                            [int(r) for r in recv_rows])
