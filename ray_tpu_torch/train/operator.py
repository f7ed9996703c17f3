"""TrainingOperator — user training logic run by a TrainWorker; port of
ray_tpu/train/operator.py (reference: python/ray/util/sgd/torch/
training_operator.py).

The user's `setup` registers an `nn.Module`, an optimizer factory and a
loss. One step is forward, backward and the optimizer's in-place update;
the loss stays on the device, so an epoch issues no host sync until its
end, where all losses come over at once (as the JAX operator's one
`float` per loss after the loop).

With world_size > 1 the operator is one rank of a collective group
(`group_name`; collective/collective.py), the only rank of its process:
it computes on its process's current device and stream, and its
collective calls block as the reference's do. A step is the gradient
step, which flattens every gradient into one f32 bucket, then:
- replicated: `_allreduce_grads` (the group's allreduce, int8 under the
  group's quantize default) divided by world_size, then the optimizer's
  update of every parameter;
- sharded (ZeRO, config["sharded_update"]): `_reducescatter_grads` over
  the bucket padded to the shard layout (train/sharding.py), the user's
  optimizer updating this rank's flat span with g / world_size, then
  `_allgather_params`. The JAX operator takes the gathered shards through
  host numpy; here a CUDA rank's stay on the device, through the fused
  allgather, relaying the same bytes.
On the card a collective call returns once the rank's kernels are
enqueued (a peer that does not come raises TimeoutError at the call);
the host syncs once, at the epoch's end (`HostGroup.check`).

On a mesh (`register(mesh=)`, or config["mesh_mode"] == "fsdp", which
builds parallel.mesh.fsdp_mesh and fsdp_param_specs), the step runs
SPMD over the mesh's ranks, with no collective group: the ranks of a
multihost generation, whose runtime is their default process group
(parallel/multihost.py), or one rank alone. Each rank feeds its local
rows of the batch (the batch's leading dimension sharded over the batch
spec's axes). A parameter whose spec shards its leading dimension keeps
only its rows between steps (`_MeshLayout`): the optimizer holds that
shard, and its state with it; the full tensor is all-gathered before the
forward and freed after the backward, whose gradient is reduce-scattered
back to the shard. Replicated parameters keep the full tensor and
allreduce their gradient. Either gradient is the mean over the batch
axes, the full-batch gradient of the reference's psum. Of the three ways
to carry this (FSDP2's `fully_shard` on the submodules whose parameters
all divide, a step on DTensor, or collectives by hand) the port takes
the third: torch.distributed's all-gather, reduce-scatter and allreduce
over the mesh's groups (NCCL, or gloo on the CPU), one bucket per axis
set and dtype; the reference leaves them to XLA and hand-wrote no kernel
for them. `state_dict` gathers the parameters and the optimizer state,
so on a mesh it is a collective: every rank calls it.

The compile cache of the JAX operator is a later slice of the port
(ROADMAP.md).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.train import metrics as _tm
from ray_tpu_torch.train import sharding as _shard


class TrainingOperator:
    """Subclass and implement setup(); call self.register(...) there."""

    def __init__(self, config: dict, world_rank: int, world_size: int,
                 device=None, group_name: str | None = None):
        self.config = config or {}
        self.world_rank = world_rank
        self.world_size = world_size
        self.device = resolve_device(device)
        self._group_name = group_name
        self._group = None
        self._mesh = None
        # a multihost generation has no collective group: its ranks step
        # SPMD over a mesh of their runtime
        if world_size > 1 and not self.config.get("multihost"):
            if group_name is None:
                raise ValueError("world_size > 1 needs the collective group "
                                 "of the ranks (group_name)")
            self._group = col.get_group(group_name)
            if (self._group.rank, self._group.world_size) != (world_rank,
                                                              world_size):
                raise ValueError(
                    f"group {group_name!r} holds rank {self._group.rank} of "
                    f"{self._group.world_size}, not {world_rank} of "
                    f"{world_size}")
        # sharded stays on at world_size == 1 (collectives degenerate to
        # identity), as in the JAX operator
        self._sharded = bool(self.config.get("sharded_update"))
        self._registered = False
        self._train_loader = None
        self._val_loader = None
        self.epoch = 0
        self.global_step = 0
        self.setup(self.config)
        if not self._registered:
            raise RuntimeError(
                "TrainingOperator.setup() must call self.register(...)")

    # ------------------------------------------------------------------
    # user surface
    # ------------------------------------------------------------------

    def setup(self, config: dict):
        raise NotImplementedError

    def register(self, *, model: nn.Module,
                 optimizer: Callable[[Iterable], torch.optim.Optimizer],
                 loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                 to_tree: Callable[[nn.Module], tuple],
                 from_tree: Callable[[nn.Module, dict, dict], Any],
                 eval_fn: Callable[[nn.Module, Any], dict] | None = None,
                 mesh=None, param_spec=None, batch_spec=None):
        """Register the model.

        model: an nn.Module; it moves to the operator's device. Mutable
            state (batchnorm statistics) lives in its buffers.
        optimizer: optimizer factory, called with model.parameters()
            (under config["sharded_update"], with the rank's flat f32
            span of the parameters instead).
        loss_fn(model, batch) -> scalar loss tensor.
        eval_fn(model, batch) -> metrics dict (values tensors or numbers);
            defaults to {"val_loss": loss_fn(model, batch)}.
        to_tree(model) -> (params, model_state) and from_tree(model,
            params, model_state): the checkpoint layout of state_dict(),
            the JAX package's pytrees (for ResNet, `params_to_jax` and
            `load_jax_params`), so both packages' checkpoints match.
        mesh: a DeviceMesh of the ranks (parallel.mesh): the step runs SPMD
            over it (module docstring). param_spec: a PartitionSpec for
            every parameter, or a dict of them by parameter name (default
            replicated); a spec may shard a parameter's leading dimension
            only. batch_spec: the batch's PartitionSpec (default
            P("dp"): rows over the data axis).
        """
        from ray_tpu_torch.parallel import mesh as _meshlib

        self._registered = True
        self.model = model.to(self.device).train()
        self._params = list(self.model.parameters())
        if mesh is None and self.config.get("mesh_mode") == "fsdp":
            # the topology-derived ('data','fsdp') mesh: parameters over
            # fsdp, batch over data
            mesh = _meshlib.fsdp_mesh(self.device)
            if param_spec is None:
                param_spec = _meshlib.fsdp_param_specs(
                    dict(self.model.named_parameters()), mesh)
            if batch_spec is None:
                batch_spec = _meshlib.P("data")
        self._mesh = mesh
        # sharded stays on at world_size == 1 (collectives degenerate to
        # identity), as in the JAX operator; a mesh shards by its specs
        self._sharded = self._sharded and mesh is None
        if mesh is not None:
            self._layout = _MeshLayout(
                self.model, mesh, param_spec,
                batch_spec if batch_spec is not None else _meshlib.P("dp"))
            self.optimizer = optimizer(self._layout.trained)
        elif self._sharded:
            self._init_sharded_state(optimizer)
        else:
            self.optimizer = optimizer(self._params)
        self._observe_opt_bytes()
        self._loss_fn = loss_fn
        self._eval_fn = eval_fn or (
            lambda model, batch: {"val_loss": loss_fn(model, batch)})
        self._to_tree = to_tree
        self._from_tree = from_tree

    def _observe_opt_bytes(self):
        """train.optim_shard_bytes: the bytes of this rank's optimizer
        state. torch's optimizers make their state at the first step, so
        it reads 0 until then and is set again after each epoch."""
        _tm.OPT_SHARD_BYTES.set(_shard.opt_nbytes(
            self.optimizer.state_dict()["state"]))

    def _init_sharded_state(self, optimizer):
        """ZeRO weight-update sharding (arXiv:2004.13336): this rank keeps
        the full parameters (the forward needs them) but only 1/N of the
        optimizer state: the user's optimizer over the rank's uniform span
        of the padded flat f32 parameter bucket (train/sharding.py)."""
        if any(p.dtype != torch.float32 for p in self._params):
            raise TypeError("sharded_update flattens the parameters into "
                            "one f32 bucket; every parameter must be f32")
        with torch.no_grad():
            flat = torch.cat([p.reshape(-1) for p in self._params])
        self._numel = flat.numel()
        self._pad_numel = _shard.padded_numel(self._numel, self.world_size)
        self._shard_lo, self._shard_hi = _shard.shard_span(
            self._numel, self.world_size, self.world_rank)
        self._param_shard = nn.Parameter(self._span_of(flat))
        self._optimizer_factory = optimizer
        self.optimizer = optimizer([self._param_shard])

    def _span_of(self, flat):
        """This rank's span of the flat parameters, padded to _pad_numel."""
        padded = torch.cat([flat, flat.new_zeros(self._pad_numel
                                                  - self._numel)])
        return padded[self._shard_lo:self._shard_hi].clone()

    def register_data(self, *, train_loader: Iterable | None = None,
                      validation_loader: Iterable | None = None):
        self._train_loader = train_loader
        self._val_loader = validation_loader

    # ------------------------------------------------------------------
    # train/validate loops
    # ------------------------------------------------------------------

    def _to_device(self, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(b) for b in batch)
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def _grad_step(self, batch):
        """Loss (on the device) and every gradient in one flat f32
        bucket, in parameter order."""
        self.model.zero_grad(set_to_none=True)
        loss = self._loss_fn(self.model, batch)
        loss.backward()
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in self._params])
        return loss.detach(), flat

    def _allreduce_grads(self, flat_grads):
        """The gradient bucket averaged over the ranks (the group's
        quantize default applies to the wire)."""
        total = col.allreduce(flat_grads, group_name=self._group_name)
        return total / self.world_size

    def _reducescatter_grads(self, flat_grads):
        """Sharded step, wire half 1: the bucket padded to the shard
        layout, reduce-scattered: this rank receives the summed span it
        updates."""
        padded = torch.cat([flat_grads, flat_grads.new_zeros(
            self._pad_numel - self._numel)])
        if self.world_size == 1:
            return padded  # the whole padded bucket IS the rank's span
        return col.reducescatter(padded, group_name=self._group_name)

    def _allgather_params(self):
        """Sharded step, wire half 2: every rank's updated shard, in rank
        order, through the fused allgather (exact bytes, so the ranks'
        parameters stay bit-identical under a quantized gradient wire)."""
        shard = self._param_shard.detach()
        if self.world_size == 1:
            return [shard]
        return col.allgather(shard, group_name=self._group_name)

    def _set_params(self, shards):
        flat = torch.cat(shards)[:self._numel]
        with torch.no_grad():
            for p, v in zip(self._params, flat.split(
                    [p.numel() for p in self._params])):
                p.copy_(v.view_as(p))

    def _apply_grads(self, flat):
        for p, g in zip(self._params, flat.split(
                [p.numel() for p in self._params])):
            p.grad = g.view_as(p)
        self.optimizer.step()

    def _mesh_step(self, batch):
        """One SPMD step over the mesh: the sharded parameters gathered,
        forward and backward on this rank's rows, every gradient averaged
        over the batch axes (a sharded one reduce-scattered to its rows),
        the full tensors freed, the optimizer's update of what this rank
        holds."""
        self._layout.gather()
        self.optimizer.zero_grad(set_to_none=True)
        self.model.zero_grad(set_to_none=True)
        loss = self._loss_fn(self.model, batch)
        loss.backward()
        self._layout.reduce_grads()
        self._layout.release()
        self.optimizer.step()
        return loss.detach()

    def _step(self, batch):
        """One step; returns the loss, still on the device."""
        batch = self._to_device(batch)  # this rank's rows, on its device
        if self._mesh is not None:
            return self._mesh_step(batch)
        if self.world_size == 1 and not self._sharded:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self._loss_fn(self.model, batch)
            loss.backward()
            self.optimizer.step()
            return loss.detach()
        loss, flat = self._grad_step(batch)
        if not self._sharded:
            self._apply_grads(self._allreduce_grads(flat))
            return loss
        # ZeRO: update this rank's 1/N of (params, optimizer state),
        # elementwise the same arithmetic as the replicated update
        self._param_shard.grad = (self._reducescatter_grads(flat)
                                  / self.world_size)
        self.optimizer.step()
        self._set_params(self._allgather_params())
        return loss

    def train_batch(self, batch) -> dict:
        """Sync path for step-at-a-time callers; returns a host float."""
        loss = self._step(batch)
        self.global_step += 1
        return {"train_loss": float(loss)}

    def train_epoch(self, num_steps: int | None = None) -> dict:
        if self._train_loader is None:
            raise RuntimeError("no train_loader registered")
        self.model.train()
        t0 = time.perf_counter()
        losses, samples = [], 0
        t_step = t0
        for step, batch in enumerate(self._train_loader, 1):
            # step_s spans the loader's wait and the dispatch: with
            # ingest_wait_s (observed in IngestStream's get) the pair says
            # whether training is input-bound
            losses.append(self._step(batch))
            self.global_step += 1
            bs = _batch_size(batch)
            samples += bs
            if bs:
                _tm.TOKENS_TOTAL.inc(bs)
            now = time.perf_counter()
            _tm.STEP_S.observe(now - t_step)
            t_step = now
            if num_steps is not None and step >= num_steps:
                break
        # One sync for the whole epoch: the loop only enqueued work.
        losses = torch.stack(losses).tolist() if losses else []
        if self._group is not None:
            self._group.check()  # the epoch's one wait for the card
        dt = time.perf_counter() - t0
        self.epoch += 1
        self._observe_opt_bytes()
        return {
            "epoch": self.epoch,
            "batch_count": len(losses),
            "num_samples": samples,
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "last_train_loss": losses[-1] if losses else float("nan"),
            "samples_per_s": samples / dt if dt > 0 else 0.0,
        }

    def validate(self, num_steps: int | None = None) -> dict:
        """Mean of each eval_fn metric over the validation loader, as the
        JAX operator: the model stays in train mode (batch statistics), runs
        under no_grad, and every buffer the pass changes (batchnorm running
        statistics) is put back afterwards, as the JAX operator discards its
        new model state."""
        if self._val_loader is None:
            raise RuntimeError("no validation_loader registered")
        saved = {n: b.clone() for n, b in self.model.named_buffers()}
        metrics, samples = [], 0
        if self._mesh is not None:
            self._layout.gather()
        try:
            with torch.no_grad():
                for step, batch in enumerate(self._val_loader, 1):
                    metrics.append(self._eval_fn(self.model,
                                                 self._to_device(batch)))
                    samples += _batch_size(batch)
                    if num_steps is not None and step >= num_steps:
                        break
        finally:
            with torch.no_grad():
                for n, b in self.model.named_buffers():
                    b.copy_(saved[n])
            if self._mesh is not None:
                self._layout.release()
        # to the host after the loop: the loop only enqueued work
        host = [{k: float(v) for k, v in m.items()} for m in metrics]
        out = {k: float(np.mean([m[k] for m in host]))
               for k in (host[0] if host else {})}
        out["num_samples"] = samples
        return out

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """Parameters and model state in the JAX layout, and the
        optimizer's state: `opt_state` when replicated; under
        sharded_update, `sharded_update: True` and this rank's
        `opt_shard` (opt_shard_state), as the JAX operator writes it."""
        if self._mesh is not None:
            # a collective on a mesh: every rank gathers the parameters
            # and the optimizer state (the reference's process_allgather)
            self._layout.gather()
            try:
                params, model_state = self._to_tree(self.model)
            finally:
                self._layout.release()
            opt_state = self._layout.full_opt_state(
                self.optimizer.state_dict())
        else:
            params, model_state = self._to_tree(self.model)
        out = {"params": params, "model_state": model_state,
               "epoch": self.epoch, "global_step": self.global_step}
        if self._sharded:
            out["sharded_update"] = True
            out["opt_shard"] = self.opt_shard_state()
        elif self._mesh is not None:
            out["opt_state"] = _to_host(opt_state)
        else:
            out["opt_state"] = _to_host(self.optimizer.state_dict())
        return out

    def load_state_dict(self, state: dict):
        """Restores a state_dict. Under sharded_update the rank's
        parameter shard is rebuilt from the restored parameters, and the
        state's `opt_shard` is installed only where its world size and
        rank are this rank's (the same state goes to every rank); a
        replicated checkpoint is refused, and the reverse."""
        if self._sharded and "opt_state" in state:
            raise ValueError(
                "replicated checkpoint (full opt_state) cannot load "
                "into a sharded-update trainer; re-save it sharded "
                "or construct Trainer(sharded=False)")
        if not self._sharded and state.get("sharded_update"):
            raise ValueError(
                "sharded checkpoint cannot load into an unsharded "
                "trainer; construct Trainer(sharded=True) or load "
                "the sharded manifest via Trainer.load()")
        if self._mesh is not None:
            self._layout.materialize()
            try:
                self._from_tree(self.model, state["params"],
                                state["model_state"])
                self._layout.take_shards()
            finally:
                self._layout.release()
            self.optimizer.load_state_dict(
                self._layout.shard_opt_state(state["opt_state"]))
            self.epoch = state["epoch"]
            self.global_step = state["global_step"]
            return
        self._from_tree(self.model, state["params"], state["model_state"])
        if self._sharded:
            # in place: the optimizer holds this Parameter
            with torch.no_grad():
                self._param_shard.copy_(self._span_of(torch.cat(
                    [p.reshape(-1) for p in self._params])))
            sh = state.get("opt_shard")
            if (sh is not None and sh["world_size"] == self.world_size
                    and sh["rank"] == self.world_rank):
                self.load_opt_shard(sh)
        else:
            self.optimizer.load_state_dict(state["opt_state"])
        self.epoch = state["epoch"]
        self.global_step = state["global_step"]

    def _opt_state_names(self) -> list[str]:
        """The names of the optimizer's per-parameter state, sorted: those
        a fresh optimizer of the user's factory holds after one step."""
        probe = nn.Parameter(torch.zeros(1, device=self.device))
        opt = self._optimizer_factory([probe])
        probe.grad = torch.zeros_like(probe)
        opt.step()
        return sorted(opt.state[probe])

    def opt_shard_state(self) -> dict:
        """This rank's optimizer shard in the JAX operator's dict format:
        rank, world_size, span, numel, pad_numel, leaves. The leaves are
        the torch optimizer's state of the rank's flat span, on the host,
        one a state name in sorted order (AdamW: exp_avg, exp_avg_sq,
        step; SGD with momentum: momentum_buffer); empty before the first
        step. (optax's leaves differ: the two packages' optimizer states
        are not interchangeable.)"""
        state = self.optimizer.state_dict()["state"].get(0, {})
        leaves = [_to_host(state[k]) for k in sorted(state)]
        return {"rank": self.world_rank, "world_size": self.world_size,
                "span": (self._shard_lo, self._shard_hi),
                "numel": self._numel, "pad_numel": self._pad_numel,
                "leaves": leaves}

    def load_opt_shard(self, shard: dict):
        """Installs a shard from opt_shard_state; its geometry must be
        this rank's."""
        if (int(shard["world_size"]) != self.world_size
                or tuple(shard["span"]) != (self._shard_lo, self._shard_hi)
                or int(shard["numel"]) != self._numel):
            raise ValueError(
                f"optimizer shard geometry {shard['world_size']}x"
                f"{tuple(shard['span'])} (numel {shard['numel']}) does "
                f"not match rank {self.world_rank}: expected "
                f"{self.world_size}x({self._shard_lo}, {self._shard_hi}) "
                f"numel {self._numel}; reshard with "
                "train.sharding.reshard_opt_shards first")
        leaves = list(shard["leaves"])
        names = self._opt_state_names() if leaves else []
        if len(names) != len(leaves):
            raise ValueError(f"optimizer shard holds {len(leaves)} state "
                             f"leaves; this optimizer's state has {names}")
        groups = self.optimizer.state_dict()["param_groups"]
        self.optimizer.load_state_dict({
            "state": {0: dict(zip(names, leaves))} if leaves else {},
            "param_groups": groups})


def _leading_axes(spec, sizes: dict, what: str) -> tuple:
    """The mesh axes a PartitionSpec shards a tensor's leading dimension
    over (major first). The port's mesh step shards no other dimension:
    a later entry naming an axis of more than one rank raises."""
    entries = tuple(spec or ())
    for entry in entries[1:]:
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if sizes[axis] > 1:
                raise NotImplementedError(
                    f"{what} {spec} shards a dimension past the first; the "
                    "port's mesh step shards the leading dimension only")
    first = entries[0] if entries else None
    axes = (first,) if isinstance(first, str) else tuple(first or ())
    for axis in axes:
        if axis not in sizes:
            raise ValueError(f"{what} {spec} names axis {axis!r}, not one "
                             f"of the mesh's {tuple(sizes)}")
    return axes


class _MeshLayout:
    """A module's parameters on a mesh: which are sharded (their leading
    dimension over the axes of their spec; the rank keeps its rows in a
    shard Parameter that the optimizer updates) and which replicated, and
    the collectives of the step over the mesh's per-axis groups, one
    bucket per axis set and dtype. A group of several axes is composed
    axis by axis: the all-gather minor axis first, the reduce-scatter
    major axis first, so the rows come out in the spec's order."""

    def __init__(self, model: nn.Module, mesh, param_spec, batch_spec):
        from ray_tpu_torch.parallel import mesh as _meshlib

        self._sizes = _meshlib.axis_sizes(mesh)
        self._mesh = mesh
        self._coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self._batch = [a for a in _leading_axes(batch_spec, self._sizes,
                                                "batch_spec")
                       if self._sizes[a] > 1]
        self._n_batch = math.prod(self._sizes[a] for a in self._batch)
        # (param, its full shape, its axes, its shard Parameter or None)
        self._entries = []
        self.trained = []
        for name, p in model.named_parameters():
            spec = (param_spec[name] if isinstance(param_spec, dict)
                    else param_spec)
            axes = _leading_axes(spec, self._sizes, f"param_spec of {name}")
            k = math.prod(self._sizes[a] for a in axes)
            shard = None
            if k > 1:
                if p.dim() == 0 or p.shape[0] % k:
                    raise ValueError(
                        f"parameter {name} {tuple(p.shape)}: its leading "
                        f"dimension does not split over {axes} ({k} ways)")
                shard = nn.Parameter(self._rows(p.detach(), axes).clone())
            self._entries.append((p, tuple(p.shape), axes, shard))
            self.trained.append(p if shard is None else shard)
        self.release()

    def _group(self, axis):
        return self._mesh.get_group(axis)

    def _index(self, axes) -> int:
        """This rank's shard index over `axes` (major first)."""
        idx = 0
        for a in axes:
            idx = idx * self._sizes[a] + self._coord[a]
        return idx

    def _rows(self, t: torch.Tensor, axes) -> torch.Tensor:
        k = math.prod(self._sizes[a] for a in axes)
        return t.reshape(k, -1)[self._index(axes)].reshape(
            (t.shape[0] // k,) + tuple(t.shape[1:]))

    def _all_gather(self, flat: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's flat over `axes`, in shard order: [k, M]."""
        import torch.distributed as dist

        x = flat
        for a in reversed(axes):
            if self._sizes[a] > 1:
                out = x.new_empty(self._sizes[a] * x.numel())
                dist.all_gather_into_tensor(out, x, group=self._group(a))
                x = out
        return x.view(math.prod(self._sizes[a] for a in axes), -1)

    def _buckets(self, sharded: bool):
        """(axes, [(param, full shape, shard), ...]) of one axis set and
        dtype each, in parameter order."""
        out: dict = {}
        for p, shape, axes, shard in self._entries:
            if (shard is not None) == sharded:
                out.setdefault((axes, p.dtype), []).append((p, shape, shard))
        return [(axes, items) for (axes, _), items in out.items()]

    def gather(self):
        """Every sharded parameter's full tensor, all-gathered from the
        ranks' shards into the module."""
        for axes, items in self._buckets(True):
            flat = torch.cat([sh.detach().reshape(-1) for _, _, sh in items])
            full, off = self._all_gather(flat, axes), 0
            for p, shape, sh in items:
                m = sh.numel()
                p.data = full[:, off:off + m].reshape(shape)
                off += m

    def materialize(self):
        """Full-size storage for every sharded parameter (to load into)."""
        for p, shape, _, shard in self._entries:
            if shard is not None:
                p.data = shard.new_empty(shape)

    def take_shards(self):
        """Each shard from its parameter's full tensor in the module."""
        with torch.no_grad():
            for p, _, axes, shard in self._entries:
                if shard is not None:
                    shard.copy_(self._rows(p.data, axes))

    def release(self):
        """Frees the sharded parameters' full tensors (and gradients)."""
        for p, _, _, shard in self._entries:
            if shard is not None:
                p.data = shard.new_empty(0)
                p.grad = None

    def _mean_over_batch(self, x: torch.Tensor, skip=()) -> torch.Tensor:
        import torch.distributed as dist

        for a in self._batch:
            if a not in skip:
                dist.all_reduce(x, group=self._group(a))
        return x / self._n_batch if self._n_batch > 1 else x

    def reduce_grads(self):
        """Each trained tensor's gradient: the mean over the batch axes of
        the ranks' gradients; a sharded parameter's only its rows
        (reduce-scattered over the axes that are batch axes, sliced over
        the others, on which every rank holds the same gradient)."""
        import torch.distributed as dist

        def grad(p):
            return p.grad if p.grad is not None else torch.zeros_like(p)

        for _, items in self._buckets(False):
            flat = self._mean_over_batch(
                torch.cat([grad(p).reshape(-1) for p, _, _ in items]))
            off = 0
            for p, shape, _ in items:
                p.grad = flat[off:off + p.numel()].view(shape)
                off += p.numel()
        for axes, items in self._buckets(True):
            k = math.prod(self._sizes[a] for a in axes)
            x = torch.cat([grad(p).reshape(k, -1) for p, _, _ in items],
                          dim=1).reshape(-1)
            for a in axes:
                n = self._sizes[a]
                if a in self._batch:
                    out = x.new_empty(x.numel() // n)
                    dist.reduce_scatter_tensor(out, x, group=self._group(a))
                    x = out
                else:
                    x = x.view(n, -1)[self._coord[a]].contiguous()
            x, off = self._mean_over_batch(x, skip=axes), 0
            for _, _, sh in items:
                sh.grad = x[off:off + sh.numel()].view_as(sh)
                off += sh.numel()

    def _sharded_state(self, opt_state: dict, fn) -> dict:
        """opt_state with fn(tensor, full shape, axes) applied to every
        tensor state of a sharded parameter, in index and name order (the
        same on every rank, since fn may be a collective)."""
        state = {}
        for i, st in sorted(opt_state["state"].items()):
            _, shape, axes, shard = self._entries[i]
            state[i] = ({k: (fn(v, shape, axes)
                             if isinstance(v, torch.Tensor) and v.dim()
                             else v) for k, v in sorted(st.items())}
                        if shard is not None else st)
        return {"state": state, "param_groups": opt_state["param_groups"]}

    def full_opt_state(self, opt_state: dict) -> dict:
        """The optimizer's state with every shard's tensors all-gathered
        to their parameter's full shape: the layout of an optimizer over
        the whole module (a collective: every rank calls it)."""
        return self._sharded_state(opt_state, lambda v, shape, axes: (
            self._all_gather(v.reshape(-1), axes).reshape(shape)))

    def shard_opt_state(self, opt_state: dict) -> dict:
        """full_opt_state's inverse: this rank's rows of each tensor."""
        return self._sharded_state(opt_state, lambda v, shape, axes: (
            self._rows(v, axes).clone()))


def _to_host(obj):
    """Optimizer state with every tensor copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _batch_size(batch) -> int:
    leaf = batch
    while isinstance(leaf, (tuple, list)) and leaf:
        leaf = leaf[0]
    shape = getattr(leaf, "shape", ())
    return int(shape[0]) if len(shape) else 0
