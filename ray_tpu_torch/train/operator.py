"""TrainingOperator — user training logic run by a TrainWorker; port of
ray_tpu/train/operator.py (reference: python/ray/util/sgd/torch/
training_operator.py).

The user's `setup` registers an `nn.Module`, an optimizer factory and a
loss. One step is forward, backward and the optimizer's in-place update;
the loss stays on the device, so an epoch issues no host sync until its
end, where all losses come over at once (as the JAX operator's one
`float` per loss after the loop).

This slice runs one worker: the multi-worker gradient allreduce, the
ZeRO-sharded update, mesh mode and the compile cache of the JAX operator
are later slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._private.device import resolve_device


class TrainingOperator:
    """Subclass and implement setup(); call self.register(...) there."""

    def __init__(self, config: dict, world_rank: int, world_size: int,
                 device=None):
        if world_size != 1:
            raise NotImplementedError(
                "TrainingOperator runs one worker in this slice; "
                "multi-GPU data-parallel training is a later slice "
                "(ROADMAP.md queue A)")
        self.config = config or {}
        self.world_rank = world_rank
        self.world_size = world_size
        self.device = resolve_device(device)
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
                 eval_fn: Callable[[nn.Module, Any], dict] | None = None):
        """Register the model.

        model: an nn.Module; it moves to the operator's device. Mutable
            state (batchnorm statistics) lives in its buffers.
        optimizer: optimizer factory, called with model.parameters().
        loss_fn(model, batch) -> scalar loss tensor.
        eval_fn(model, batch) -> metrics dict (values tensors or numbers);
            defaults to {"val_loss": loss_fn(model, batch)}.
        to_tree(model) -> (params, model_state) and from_tree(model,
            params, model_state): the checkpoint layout of state_dict(),
            the JAX package's pytrees (for ResNet, `params_to_jax` and
            `load_jax_params`), so both packages' checkpoints match.
        """
        self._registered = True
        self.model = model.to(self.device).train()
        self.optimizer = optimizer(self.model.parameters())
        self._loss_fn = loss_fn
        self._eval_fn = eval_fn or (
            lambda model, batch: {"val_loss": loss_fn(model, batch)})
        self._to_tree = to_tree
        self._from_tree = from_tree

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

    def _dispatch_batch(self, batch) -> torch.Tensor:
        """One fused step; returns the loss, still on the device."""
        batch = self._to_device(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss_fn(self.model, batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_batch(self, batch) -> dict:
        """Sync path for step-at-a-time callers; returns a host float."""
        loss = self._dispatch_batch(batch)
        self.global_step += 1
        return {"train_loss": float(loss)}

    def train_epoch(self, num_steps: int | None = None) -> dict:
        if self._train_loader is None:
            raise RuntimeError("no train_loader registered")
        self.model.train()
        t0 = time.perf_counter()
        losses, samples = [], 0
        for step, batch in enumerate(self._train_loader, 1):
            losses.append(self._dispatch_batch(batch))
            self.global_step += 1
            samples += _batch_size(batch)
            if num_steps is not None and step >= num_steps:
                break
        # One sync for the whole epoch: the loop only enqueued work.
        losses = torch.stack(losses).tolist() if losses else []
        dt = time.perf_counter() - t0
        self.epoch += 1
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
        params, model_state = self._to_tree(self.model)
        return {
            "params": params,
            "model_state": model_state,
            "opt_state": _to_host(self.optimizer.state_dict()),
            "epoch": self.epoch,
            "global_step": self.global_step,
        }

    def load_state_dict(self, state: dict):
        self._from_tree(self.model, state["params"], state["model_state"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.epoch = state["epoch"]
        self.global_step = state["global_step"]


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
