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

`shard_map` and `axis_size` belong to the parallel axes (ROADMAP.md queue
A item 8) and wait for them.
"""

from __future__ import annotations

import dataclasses
import math

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
