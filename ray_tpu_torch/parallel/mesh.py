"""Device meshes; port of ray_tpu/parallel/mesh.py:66-167.

The JAX package builds one `jax.sharding.Mesh` with named axes

    dp — data parallel (gradient allreduce; the outer axis)
    pp — pipeline stages
    sp — sequence/context parallel
    tp — tensor parallel (the innermost axis)
    ep — expert parallel

over `jax.devices()`. The port builds a torch
`torch.distributed.device_mesh.DeviceMesh` with the same names over the
ranks of the process's runtime: the default process group, which is the
multihost group a worker joined (`parallel.multihost.initialize`) or,
without one, a group of this process alone (as JAX's local runtime). A
rank is one device: the port runs one device a process. `DeviceMesh`
reads the process's rank from the default group (torch 2.13's
`DeviceMesh.from_group` does too), so the mesh is built over it.

A layout is a `PartitionSpec`, which mirrors JAX's: one entry per tensor
dimension, a mesh axis name, a tuple of names, or None; dimensions past
its length are not sharded. `placements` turns one into the DTensor
placements of a mesh, and `NamedSharding` pairs the two.

`shard_map(fn, mesh, in_specs, out_specs)` is the counterpart of the
reference's (mesh.py:51, `check_vma=False`): every rank of the mesh calls
it with the same global tensors; each rank's body runs on its own blocks
of them, with `axis_index`/`axis_size` and the collectives of
`parallel.spmd` over the sub-groups of the mesh's axes; the outputs are
assembled into global tensors again on every rank. Its gradients follow
JAX's transpose rule for an unchecked shard_map: an output's cotangent is
divided by the size of the axes its spec leaves out, and an input's is
summed over the axes its spec leaves out (`parallel.spmd`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from ray_tpu_torch._private.device import check_device
from ray_tpu_torch._private.topology import (  # noqa: F401  (re-export)
    MESH_SHAPES, mesh_shape_for)

AXES = ("dp", "pp", "sp", "tp", "ep")


class PartitionSpec(tuple):
    """A tensor's layout on a mesh (jax.sharding.PartitionSpec): one entry
    per tensor dimension, a mesh axis name, a tuple of axis names (major
    first) or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _ranks(device=None) -> int:
    """The number of ranks of this process's runtime (one device each),
    starting a runtime of this process alone where none is."""
    from ray_tpu_torch.parallel import multihost

    multihost.ensure_runtime(device)
    import torch.distributed as dist

    return dist.get_world_size()


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...], device):
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = _ranks(device)
    if have < n:
        raise ValueError(f"mesh needs {n} devices, have {have}")
    return DeviceMesh(check_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.tp, self.ep)

    @classmethod
    def auto(cls, n_devices: int, *, tp: int = 1, pp: int = 1, sp: int = 1,
             ep: int = 1) -> "MeshSpec":
        """Fill dp with whatever devices remain after the model axes."""
        model = tp * pp * sp * ep
        if n_devices % model:
            raise ValueError(
                f"{n_devices} devices not divisible by tp*pp*sp*ep={model}")
        return cls(dp=n_devices // model, pp=pp, sp=sp, tp=tp, ep=ep)

    def build(self, device=None):
        """The DeviceMesh of the first `size` ranks, axes AXES. device:
        None for CUDA, "cpu" for the plain versions."""
        return _device_mesh(self.axis_sizes(), AXES, device)

    @classmethod
    def from_placement_group(cls, pg, *, tp: int | None = None, pp: int = 1,
                             sp: int = 1, ep: int = 1) -> "MeshSpec":
        """The mesh of a reservation: each bundle is one host contributing
        its GPUs (the reference counts TPU chips). tp defaults to GPUs a
        bundle, the innermost axis; dp fills the rest."""
        bundles = pg.bundle_specs if hasattr(pg, "bundle_specs") else pg
        gpus = [int(b.get("GPU", 0)) for b in bundles]
        if not gpus or any(c <= 0 for c in gpus):
            raise ValueError(
                "placement group has bundles without GPUs; "
                f"bundle resources: {bundles}")
        if len(set(gpus)) != 1:
            raise ValueError(
                f"heterogeneous GPUs per bundle {gpus}: a mesh needs "
                "equal GPUs per host")
        if tp is None:
            tp = gpus[0]
        return cls.auto(sum(gpus), tp=tp, pp=pp, sp=sp, ep=ep)


def fsdp_mesh(device=None):
    """The ('data', 'fsdp') mesh of Trainer(mesh_mode="fsdp"): the runtime's
    rank count -> mesh_shape_for's (data, fsdp) factorization. Batch
    shards over 'data', parameters and optimizer state over 'fsdp'."""
    return _device_mesh(mesh_shape_for(_ranks(device)), ("data", "fsdp"),
                        device)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of an object whose `shape` is
    already that dict, as a jax Mesh's)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def fsdp_param_specs(params, mesh):
    """Per-leaf PartitionSpecs sharding each parameter over the 'fsdp' axis
    along its leading dimension where that divides evenly; small or
    indivisible leaves (biases, scalars) stay replicated. `params`: a
    nest of dicts, lists and tuples of arrays or tensors."""
    fsdp = axis_sizes(mesh)["fsdp"]

    def spec(p):
        shape = tuple(getattr(p, "shape", ()))
        if shape and shape[0] % fsdp == 0 and shape[0] >= fsdp > 1:
            return P("fsdp", *([None] * (len(shape) - 1)))
        return P()

    return _tree_map(spec, params)


def placements(spec, mesh) -> list:
    """The DTensor placements of `spec` on `mesh`: Shard(d) for each mesh
    axis that tensor dimension d's entry names, Replicate() for the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec or ()):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec (jax.sharding.NamedSharding)."""

    mesh: object
    spec: PartitionSpec

    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def batch_sharding(mesh) -> NamedSharding:
    """Inputs: batch over dp, sequence over sp."""
    return NamedSharding(mesh, P("dp", "sp"))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_mesh_spec(*, tp: int = 1, pp: int = 1, sp: int = 1,
                    ep: int = 1, device=None) -> MeshSpec:
    return MeshSpec.auto(_ranks(device), tp=tp, pp=pp, sp=sp, ep=ep)


# ---------------------------------------------------------------------------
# shard_map: a rank-local body over the mesh's axes
# ---------------------------------------------------------------------------

def axis_names(axis_name) -> tuple[str, ...]:
    """A spec entry or axis argument as a tuple of axis names (major
    first): a name, a tuple of names, or None (no axis)."""
    if axis_name is None:
        return ()
    if isinstance(axis_name, str):
        return (axis_name,)
    return tuple(axis_name)


class Layout:
    """This rank's place on a DeviceMesh: its coordinate along each axis
    and, for each set of axes, the process group of the ranks that differ
    from it only there, in axis-index order (the set's first axis major).
    Every rank builds a set's groups at once, in the same order, as
    torch.distributed.new_group asks."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.ranks = np.asarray(mesh.mesh.tolist(), dtype=np.int64)
        self.sizes = dict(zip(self.names, self.ranks.shape))
        self.rank = dist.get_rank()
        where = np.argwhere(self.ranks == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not on the mesh "
                             f"{self.ranks.tolist()}")
        self.coord = dict(zip(self.names, (int(c) for c in where[0])))
        self._groups: dict[tuple[str, ...], tuple] = {}

    def _axes(self, axis_name) -> tuple[str, ...]:
        axes = axis_names(axis_name)
        unknown = [a for a in axes if a not in self.sizes]
        if unknown:
            raise ValueError(f"axes {unknown} are not on the mesh "
                             f"{self.names}")
        return axes

    def size(self, axis_name) -> int:
        return math.prod(self.sizes[a] for a in self._axes(axis_name))

    def index(self, axis_name) -> int:
        """This rank's index along the axes, the first one major."""
        idx = 0
        for a in self._axes(axis_name):
            idx = idx * self.sizes[a] + self.coord[a]
        return idx

    def group(self, axis_name):
        """(process group or None at size 1, the global ranks of the group
        in axis-index order)."""
        import torch.distributed as dist

        axes = self._axes(axis_name)
        if axes not in self._groups:
            others = [self.names.index(a) for a in self.names
                      if a not in axes]
            inner = [self.names.index(a) for a in axes]
            rows = self.ranks.transpose(others + inner).reshape(
                -1, self.size(axes))
            mine = None
            for row in rows.tolist():
                pg = dist.new_group(row) if len(row) > 1 else None
                if self.rank in row:
                    mine = (pg, row)
            self._groups[axes] = mine
        return self._groups[axes]


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`: its CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


_LAYOUTS: dict[int, tuple[object, Layout]] = {}
_MANUAL: list[Layout] = []


def layout(mesh) -> Layout:
    """The Layout of this rank on `mesh`, built once a mesh."""
    entry = _LAYOUTS.get(id(mesh))
    if entry is None or entry[0] is not mesh:
        entry = _LAYOUTS[id(mesh)] = (mesh, Layout(mesh))
    return entry[1]


@contextlib.contextmanager
def manual(mesh):
    """The body of a shard_map: inside, axis_size, axis_index and the
    collectives of parallel.spmd act on `mesh`'s axes. A rank-local
    program (the MoE transformer) runs under it directly."""
    _MANUAL.append(layout(mesh))
    try:
        yield _MANUAL[-1]
    finally:
        _MANUAL.pop()


def current_layout() -> Layout:
    if not _MANUAL:
        raise RuntimeError("axis_size, axis_index and the collectives of "
                           "parallel.spmd run inside shard_map (or "
                           "mesh.manual)")
    return _MANUAL[-1]


def axis_size(axis_name) -> int:
    """The size of a mapped axis (or the product over a tuple of axes);
    call inside shard_map."""
    return current_layout().size(axis_name)


def axis_index(axis_name) -> int:
    """This rank's index along a mapped axis (a tuple: the first axis
    major); call inside shard_map."""
    return current_layout().index(axis_name)


def map_specs(fn, tree, specs):
    """fn(leaf, spec) over a tree of tensors and its specs: a spec stands
    for every leaf of the subtree it sits at (a prefix, as in JAX)."""
    if specs is None or isinstance(specs, PartitionSpec):
        return _tree_map(lambda x: fn(x, specs or PartitionSpec()), tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"{len(specs)} specs for {len(tree)} values")
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    raise ValueError(f"spec tree {specs!r} does not match {type(tree)}")


def shard_map(fn, mesh, in_specs, out_specs):
    """fn over each rank's blocks of global tensors (jax.shard_map with
    check_vma=False). Every rank of the mesh calls the result with the
    same global tensors; each input is cut to the rank's block by its
    spec, fn runs under `manual(mesh)`, and each output is assembled from
    the ranks' blocks by its spec (along an axis its spec leaves out, a
    rank keeps its own value: the reference assumes those equal)."""
    from ray_tpu_torch.parallel import spmd

    def run(*args):
        lay = layout(mesh)
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "in_specs")
        local = [map_specs(lambda x, s: spmd.shard_in(x, s, lay), a, s)
                 for a, s in zip(args, in_specs)]
        with manual(mesh):
            out = fn(*local)
        return map_specs(lambda y, s: spmd.shard_out(y, s, lay), out,
                         out_specs)

    return run
